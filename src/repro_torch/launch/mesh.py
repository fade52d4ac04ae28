"""Production engine meshes (the port of `repro.launch.mesh`).

Functions, not module constants, so importing touches no device.  Axis
semantics (`models.sharding.MeshRules`):
  pod   — data parallelism across pods
  data  — data parallelism / FSDP within a pod
  model — tensor/expert/sequence parallelism

The meshes are `graph.distributed.EngineMesh`es: "stacked" (the default)
puts every engine on one device, the counterpart of the reference's
placeholder devices, and "process_group" runs one engine a rank of the
caller's `torch.distributed` group.  `device_permutation[p]` is the device
of engine p (p the row-major engine index), the paper's placement applied at
mesh-build time: feed it `core.mapping.DeviceMapper.device_permutation` or
`models.moe.expert_device_permutation`.  The default is the identity.
"""
from __future__ import annotations

import torch

from repro_torch.graph.distributed import EngineMesh, make_mesh

__all__ = ["make_production_mesh", "make_smoke_mesh", "mesh_devices"]


def make_production_mesh(*, multi_pod: bool = False, device_permutation=None, backend: str = "stacked",
                         device: str | torch.device | None = None) -> EngineMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model"), on `device` (None: the card)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, site_permutation=device_permutation, backend=backend, device=device)


def make_smoke_mesh(shape=(1, 1), axes=("data", "model"), *, backend: str = "stacked",
                    device: str | torch.device | None = None) -> EngineMesh:
    """A small mesh for tests (the same code path, trivial axes by default)."""
    return make_mesh(shape, axes, backend=backend, device=device)


def mesh_devices(mesh: EngineMesh) -> int:
    return mesh.num_engines
