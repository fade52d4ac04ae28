"""PyTorch/CUDA port of the paper pipeline (trace → partition → traffic →
place → simulate), beside the JAX package `repro`, which stays the reference.

Sub-packages and modules carry the names of their counterparts in `repro`.
This package imports `torch`, never `jax`, and nothing of `repro`.  Entry
points take an explicit `device=`; `None` means the CUDA device and raises
when there is none (see `repro_torch.device`).
"""
from repro_torch.device import probe, resolve_backend, resolve_device

__all__ = ["probe", "resolve_backend", "resolve_device"]
