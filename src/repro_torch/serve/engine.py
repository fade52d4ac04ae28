"""Batched serving engine: continuous batching over a static KV-cache ring.

The port of `repro.serve.engine`, with the same rules: a fixed decode batch of
`slots`; requests are admitted into free slots (prefill writes the slot's KV
range), every engine step decodes one token for all active slots, and a slot
is freed and refilled from the queue when its request ends at EOS, at
`max_new_tokens`, or one short of `max_seq`.

The engine is model-agnostic: it takes the prefill and decode callables, so
tests drive it with a tiny CPU model.  Here the prefill callable writes the
slot's range of the cache in place (the JAX engine builds a new cache with
`dynamic_update_slice`); both callables still return the cache, and the
engine keeps what they return.  A model served on an engine mesh (the
counterpart of serving inside `jax.set_mesh`) gets it through its callables
(`launch.serve.build_engine(..., mesh=)`).  Greedy choice is `torch.argmax` on the
logits where they lie (first maximum on ties, as `np.argmax`), with one copy
of the chosen ids to the host a step.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int = 32
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(
        self,
        *,
        slots: int,
        max_seq: int,
        init_cache: typing.Callable[[], dict],
        prefill_one: typing.Callable,  # (cache, slot, tokens (1, P)) -> (cache, last_logits (1, V))
        decode: typing.Callable,  # (cache, tokens (S, 1), pos (S,)) -> (logits (S, V), cache)
        eos_id: int = 1,
        greedy: bool = True,
    ):
        self.slots = slots
        self.max_seq = max_seq
        self.cache = init_cache()
        self.prefill_one = prefill_one
        self.decode = decode
        self.eos_id = eos_id
        self.greedy = greedy
        self.active: list[Request | None] = [None] * slots
        self.pos = np.zeros(slots, np.int32)  # next write position per slot
        self.queue: list[Request] = []
        self.completed: list[Request] = []

    # ------------------------------ admission ------------------------------

    def submit(self, req: Request) -> None:
        if req.prompt.size + req.max_new_tokens > self.max_seq:
            raise ValueError("request exceeds max_seq")
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.slots):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.cache, last_logits = self.prefill_one(
                    self.cache, slot, torch.from_numpy(np.asarray(req.prompt, np.int64)[None, :])
                )
                self.pos[slot] = req.prompt.size
                req.out_tokens.append(int(torch.argmax(last_logits[0])))
                self.active[slot] = req

    # ------------------------------ stepping -------------------------------

    def step(self) -> int:
        """One engine iteration: admit, decode one token for all active slots.
        Returns the number of active slots."""
        self._admit()
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return 0
        tokens = np.zeros((self.slots, 1), np.int64)
        for s in live:
            tokens[s, 0] = self.active[s].out_tokens[-1]
        logits, self.cache = self.decode(
            self.cache, torch.from_numpy(tokens), torch.from_numpy(self.pos.astype(np.int64))
        )
        nxt_all = torch.argmax(logits, dim=-1).tolist()
        for s in live:
            req = self.active[s]
            self.pos[s] += 1
            nxt = int(nxt_all[s])
            req.out_tokens.append(nxt)
            if (
                nxt == self.eos_id
                or len(req.out_tokens) >= req.max_new_tokens
                or self.pos[s] + 1 >= self.max_seq
            ):
                req.done = True
                self.completed.append(req)
                self.active[s] = None  # slot freed → refilled next step
        return len(live)

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        for _ in range(max_steps):
            if not self.queue and all(a is None for a in self.active):
                break
            self.step()
        return self.completed
