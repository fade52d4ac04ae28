"""Static enforcement of the port's parity and determinism contract.

The counterpart of `repro.analysis` for `repro_torch`:

  * `repro_torch.analysis.lint` — an AST linter (`python -m
    repro_torch.analysis.lint`) with the RPL rules RPL002–RPL009 keyed on
    `repro_torch/<pkg>/` paths, inline `# repro-torch-lint: disable=RPL00X
    <reason>` suppressions and the committed, empty
    `artifacts/torch_lint_baseline.json`.  RPL001 (tracer leaks in
    `lax.scan` bodies) has no counterpart in eager PyTorch.
  * `repro_torch.analysis.registry` — the `@parity_pair_torch` decorator
    every public stacked function carries, naming its serial reference and
    contract kind.
  * `repro_torch.analysis.parity_table` — renders the README's port parity
    table from the registry (`--check` gates staleness).

The kernel layers import this package, so nothing here imports a port
module at import time: `registry.load_registry()` imports them lazily.
"""
from repro_torch.analysis.registry import ParityEntry, parity_pair_torch

__all__ = ["ParityEntry", "parity_pair_torch"]
