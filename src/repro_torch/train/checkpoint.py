"""Atomic, resumable checkpoints (fault-tolerance substrate).

The port of `repro.train.checkpoint`, with the same on-disk layout:

  <dir>/step_<N>/
    manifest.json     — leaves (file, shape, dtype, crc32), step, extra
    <leaf-key>.npy    — one file per tree leaf, the key's "/" written "__"
  <dir>/LATEST        — atomic pointer (tmp + rename)

Leaf keys are the same `a/b/0` paths as the JAX package's (dict keys sorted,
list indices), so one tree saved by either package gives the same files,
shapes, dtypes and checksums.  A checkpoint is visible only after the LATEST
rename; `save(..., blocking=False)` copies the tree to the host at once (the
optimizer updates the params in place right after) and writes it on a
background thread; every leaf's crc32 is checked on load.  What is dropped:
`restore_checkpoint(shardings=)` — there is no mesh; leaves come back on the
device of the matching leaf of `tree_like`.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import typing
import zlib

import numpy as np
import torch

from repro_torch.train.pytree import tree_leaves_with_path

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "Checkpointer"]


def _flatten(tree) -> dict[str, typing.Any]:
    return {"/".join(str(p) for p in path): leaf for path, leaf in tree_leaves_with_path(tree)}


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def save_checkpoint(
    directory: str,
    step: int,
    tree,
    *,
    extra: dict | None = None,
    blocking: bool = True,
) -> threading.Thread | None:
    """Copy `tree` to the host and persist it under step_<step> atomically."""
    flat = {k: _host(v) for k, v in _flatten(tree).items()}

    def _write():
        tmp = os.path.join(directory, f"_tmp_step_{step}")
        final = os.path.join(directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}, "extra": extra or {}, "treedef": sorted(flat)}
        for key, arr in flat.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF,
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic on POSIX
        latest_tmp = os.path.join(directory, "_LATEST_tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.replace(latest_tmp, os.path.join(directory, "LATEST"))

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(directory: str) -> int | None:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore_checkpoint(directory: str, tree_like, *, step: int | None = None) -> tuple[typing.Any, int]:
    """Restore into the structure of `tree_like`: a tensor leaf comes back as a
    tensor on that leaf's device, any other leaf as a numpy array."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    loaded = {}
    for key in _flatten(tree_like):
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(d, meta["file"]))
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF
        if crc != meta["crc32"]:
            raise IOError(f"checksum mismatch for {key!r} (corrupt checkpoint)")
        loaded[key] = arr
    return _unflatten_like(tree_like, loaded), step


def _unflatten_like(tree_like, loaded: dict, prefix: tuple = ()):
    if tree_like is None:
        return None
    if isinstance(tree_like, dict):
        return {k: _unflatten_like(v, loaded, (*prefix, k)) for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten_like(v, loaded, (*prefix, i)) for i, v in enumerate(tree_like))
    arr = loaded["/".join(str(p) for p in prefix)]
    return torch.from_numpy(arr).to(tree_like.device) if isinstance(tree_like, torch.Tensor) else arr


class Checkpointer:
    """Every-N-steps async checkpointing with bounded in-flight writes."""

    def __init__(self, directory: str, *, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        self._inflight: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, tree, *, extra=None, force=False) -> bool:
        if not force and (step % self.every != 0):
            return False
        if self._inflight is not None:
            self._inflight.join()  # bound to one in-flight write
        self._inflight = save_checkpoint(self.directory, step, tree, extra=extra, blocking=False)
        self._gc(step)
        return True

    def wait(self):
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

    def _gc(self, current: int):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_")
        )
        for s in steps[: -self.keep] if len(steps) > self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)
