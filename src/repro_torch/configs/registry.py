"""--arch registry: the dense LM archs, the GNNs and dcn-v2, which the port
can run.

The JAX package's other archs are known by name and raise
`NotImplementedError` naming the ROADMAP.md item that brings them.
"""
from __future__ import annotations

import importlib

__all__ = ["ARCH_IDS", "PENDING", "get_arch", "arch_ids"]

_MODULES = {
    "granite-34b": "granite_34b",
    "llama3.2-3b": "llama3_2_3b",
    "yi-34b": "yi_34b",
    "gin-tu": "gin_tu",
    "graphcast": "graphcast",
    "gat-cora": "gat_cora",
    "pna": "pna",
    "dcn-v2": "dcn_v2",
}

PENDING = {
    "qwen2-moe-a2.7b": "MoE layers (ROADMAP.md Queue A 8, MoE impl='local')",
    "olmoe-1b-7b": "MoE layers (ROADMAP.md Queue A 8, MoE impl='local')",
}

ARCH_IDS = list(_MODULES)


def get_arch(arch_id: str):
    if arch_id in PENDING:
        raise NotImplementedError(f"arch {arch_id!r} is not ported yet: {PENDING[arch_id]}")
    try:
        mod = _MODULES[arch_id]
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; options: {ARCH_IDS}") from None
    return importlib.import_module(f"repro_torch.configs.{mod}").ARCH


def arch_ids(family: str) -> list[str]:
    """The ported archs of one family ("lm", "gnn" or "recsys")."""
    return [a for a in ARCH_IDS if get_arch(a).family == family]
