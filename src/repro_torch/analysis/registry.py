"""The port's parity-pair registry: stacked function ↔ serial reference,
declared at the definition site.

Every public stacked function (`*_batch` / `batch_*` in the layers `core`,
`experiments`, `nocsim`, `faults`) names its serial counterpart with
`@parity_pair_torch(serial=..., kind=...)`.  The decorator returns the
function unchanged; its value is the registry it fills:

  * `repro_torch.analysis.rules` RPL006 fails the lint when a public stacked
    function lacks the decorator, and RPL008 resolves every `serial=` path
    against the scanned tree;
  * `repro_torch.analysis.parity_table` renders the README's port parity
    table from the registry (`--check` gates staleness).

The decorator is named `parity_pair_torch`, not `parity_pair`: the JAX
package's lint (`repro.analysis`) checks every decorator whose last dotted
part is `parity_pair` against a `repro` package root, and it lints the
port's files too.

`kind` is the strength of the tested contract:

  * "bit" — bit-identical outputs per config;
  * "rel" — equal within a relative tolerance (`tol`, default 1e-6).

Nothing here imports the port's modules at import time; `load_registry()`
imports the kernel modules so that the decorated definitions run.
"""
from __future__ import annotations

import dataclasses
import importlib

__all__ = [
    "KERNEL_MODULES",
    "PARITY_KINDS",
    "ParityEntry",
    "load_registry",
    "parity_pair_torch",
    "registered_pairs",
]

PARITY_KINDS = ("bit", "rel")

# The modules whose import fills the whole registry (every module that
# defines a decorated stacked function).  A function decorated elsewhere
# must be listed here or the parity table will not see it.
KERNEL_MODULES = (
    "repro_torch.experiments.batched",
    "repro_torch.experiments.placement_batch",
    "repro_torch.nocsim.batch",
    "repro_torch.faults.degraded",
)


@dataclasses.dataclass(frozen=True)
class ParityEntry:
    """One stacked function ↔ serial reference registration."""

    batched: str  # dotted qualname of the decorated stacked function
    serial: str  # dotted path of the serial reference it is tested against
    kind: str  # "bit" | "rel"
    note: str = ""  # contract prose rendered into the parity table
    tol: float | None = None  # relative tolerance for kind="rel"

    def contract(self) -> str:
        """The human-readable contract cell of the parity table."""
        if self.kind == "bit":
            head = "**bit-identical** (numpy backend)"
        else:
            tol = self.tol if self.tol is not None else 1e-6
            head = f"within {tol:g} relative"
        return f"{head} — {self.note}" if self.note else head


_REGISTRY: dict[str, ParityEntry] = {}


def parity_pair_torch(
    *,
    serial: str,
    kind: str,
    note: str = "",
    tol: float | None = None,
):
    """Register the decorated stacked function against its serial reference.

    `serial` is the full dotted path of the reference callable (e.g.
    ``"repro_torch.core.placement.greedy_placement"``), which the lint's
    RPL008 resolves against the source tree; `kind` is "bit" or "rel";
    `note` is the contract prose for the parity table; `tol` overrides the
    1e-6 default for "rel"."""
    if kind not in PARITY_KINDS:
        raise ValueError(f"kind must be one of {PARITY_KINDS}, got {kind!r}")
    if not serial or "." not in serial:
        raise ValueError(f"serial must be a dotted path, got {serial!r}")

    def deco(fn):
        entry = ParityEntry(
            batched=f"{fn.__module__}.{fn.__qualname__}",
            serial=serial,
            kind=kind,
            note=note,
            tol=tol,
        )
        _REGISTRY[entry.batched] = entry
        fn.__parity_pair__ = entry
        return fn

    return deco


def registered_pairs() -> dict[str, ParityEntry]:
    """The registrations made so far (no imports triggered)."""
    return dict(_REGISTRY)


def load_registry() -> dict[str, ParityEntry]:
    """Import every kernel module and return the whole registry, keyed by
    the stacked function's dotted qualname."""
    for mod in KERNEL_MODULES:
        importlib.import_module(mod)
    return dict(_REGISTRY)
