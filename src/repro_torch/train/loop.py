"""Training loop: step factory + fault-tolerant driver.

The port of `repro.train.loop`.  `make_train_step` builds one step:
    state', metrics = step(state, batch)
with the loss in fp32, gradients by autograd (`torch.autograd.grad`, in
place of `jax.value_and_grad`), optional int8 gradient compression (error
feedback carried in the state), and the optimizer of `repro_torch.train.optim`,
which updates the params in place.  There is no `jit`: PyTorch runs eagerly.
On an engine mesh the step takes no mesh of its own: the loss function
closes over it, and the optimizer takes it where the global norm needs it
(`optim.adamw(..., mesh=, sharded=)`).

`TrainLoop` is the driver a launcher runs: checkpoint/restore (atomic,
async), preemption handling (SIGTERM → final checkpoint → exit 143), and the
step time in the `train.step_ms` histogram of `repro_torch.obs`.
"""
from __future__ import annotations

import dataclasses
import signal
import typing

import torch

from repro_torch import obs
from repro_torch.train import optim as optim_lib
from repro_torch.train.checkpoint import Checkpointer, latest_step, restore_checkpoint
from repro_torch.train.pytree import tree_leaves, tree_map, tree_unflatten

__all__ = ["TrainState", "make_train_step", "TrainLoop"]

PyTree = typing.Any


@dataclasses.dataclass
class TrainState:
    params: PyTree
    opt_state: PyTree
    step: int
    compress_residual: PyTree | None = None

    def tree(self):
        t = {"params": self.params, "opt_state": self.opt_state,
             "step": torch.tensor(self.step, dtype=torch.int32)}
        if self.compress_residual is not None:
            t["compress_residual"] = self.compress_residual
        return t


def make_train_step(
    loss_fn: typing.Callable[[PyTree, dict], torch.Tensor],
    optimizer: optim_lib.Optimizer,
    *,
    compress: bool = False,
):
    """loss_fn(params, batch) → scalar.  Returns (init_state, step); the step
    updates the state's tensors in place and returns the state with its
    `step` advanced, and metrics {"loss": 0-d fp32 tensor on the params'
    device, "step": int} (reading the loss is the caller's host sync)."""

    def init_state(params) -> TrainState:
        residual = (
            tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            if compress else None
        )
        return TrainState(params, optimizer.init(params), 0, residual)

    def step_fn(state: TrainState, batch: dict):
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(state.params, batch)
        # a leaf the loss does not read (graphcast's output MLP has no final norm) gets a zero gradient, as
        # jax.grad gives it, and AdamW then decays it only
        grads = tree_unflatten(state.params, torch.autograd.grad(loss, leaves, allow_unused=True,
                                                                 materialize_grads=True))
        residual = state.compress_residual
        if compress:
            grads, new_res = optim_lib.int8_compress(grads, optim_lib.Int8State(residual))
            residual = new_res.residual
        params, opt_state = optimizer.update(grads, state.opt_state, state.params, state.step)
        metrics = {"loss": loss.detach().float(), "step": state.step}
        return TrainState(params, opt_state, state.step + 1, residual), metrics

    return init_state, step_fn


class _PreemptionFlag:
    """Sets `raised` on SIGTERM while installed; `restore()` puts the
    previous handler back."""

    def __init__(self):
        self.raised = False
        self._previous = None
        try:
            self._previous = signal.signal(signal.SIGTERM, self._handler)
        except ValueError:  # not on the main thread
            pass

    def _handler(self, *_):
        self.raised = True

    def restore(self):
        if self._previous is not None:
            signal.signal(signal.SIGTERM, self._previous)


@dataclasses.dataclass
class TrainLoop:
    """Checkpointed, preemption-safe training driver.  `on_step(state,
    metrics, batch)`, where given, is called after every step."""

    step_fn: typing.Callable
    checkpointer: Checkpointer | None = None
    log_every: int = 10
    log_fn: typing.Callable[[str], None] = print
    on_step: typing.Callable | None = None

    def run(self, state: TrainState, batches: typing.Iterable[dict], *, num_steps: int,
            resume: bool = True) -> TrainState:
        ckpt = self.checkpointer
        if ckpt is not None and resume and latest_step(ckpt.directory) is not None:
            tree, step = restore_checkpoint(ckpt.directory, state.tree())
            state = TrainState(tree["params"], tree["opt_state"], int(tree["step"]),
                               tree.get("compress_residual"))
            self.log_fn(f"[resume] restored step {step}")
        flag = _PreemptionFlag()
        # Step timing goes through obs (the tree's one timing idiom): the
        # logged ms/step also lands in the `train.step_ms` histogram.
        step_ms = obs.metrics.get_registry().histogram("train.step_ms", non_comparable=True)
        t0 = obs.now_s()
        start = state.step
        try:
            for batch in batches:
                if state.step >= num_steps:
                    break
                state, metrics = self.step_fn(state, batch)
                if self.on_step is not None:
                    self.on_step(state, metrics, batch)
                s = metrics["step"]
                if s % self.log_every == 0:
                    loss = float(metrics["loss"])  # the host waits for the step here
                    dt = (obs.now_s() - t0) / max(s - start + 1, 1)
                    step_ms.observe(dt * 1e3)
                    self.log_fn(f"[step {s}] loss={loss:.4f} {dt*1e3:.1f} ms/step")
                if ckpt is not None:
                    ckpt.maybe_save(state.step, state.tree())
                if flag.raised:
                    self.log_fn("[preempt] SIGTERM — writing final checkpoint")
                    if ckpt is not None:
                        ckpt.maybe_save(state.step, state.tree(), force=True)
                        ckpt.wait()
                    raise SystemExit(143)
        finally:
            flag.restore()
        if ckpt is not None:
            ckpt.maybe_save(state.step, state.tree(), force=True)
            ckpt.wait()
        return state
