"""The port's RPL rule catalogue — each rule enforces one clause of the
parity/determinism contract on `repro_torch` (the clauses of
`repro.analysis.rules`, keyed on `repro_torch/<pkg>/` path segments).

Rules are pluggable: subclass `Rule`, implement `check(module)`, add the
class to `ALL_RULES`.  Rules receive a parsed `ModuleUnit` (see
`repro_torch.analysis.engine`) and yield `Finding`s; the engine owns
suppression filtering (`# repro-torch-lint: disable=RPL00X <reason>`) and
baselines, so rules report every violation they see.

| id | clause it enforces |
|---|---|
| RPL002 | no order-nondeterministic reductions / set iteration in artifact paths |
| RPL003 | dtype discipline: float64 references in `core`, `nocsim`, `faults`; one audited depth coercion |
| RPL004 | RNG hygiene: seeded generators only (numpy, stdlib `random`, torch) |
| RPL005 | no wall-clock/entropy in resumable artifact payload modules |
| RPL006 | every public stacked function carries `@parity_pair_torch` |
| RPL007 | suppression hygiene (engine-enforced: reason required, no stale/unknown) |
| RPL008 | `@parity_pair_torch` declarations resolve: serial path exists, kind valid |
| RPL009 | one timing idiom: raw clock reads outside `repro_torch/obs/` go through obs |

RPL001 (tracer leaks in `lax.scan`/`while_loop`/`fori_loop` bodies) is not
ported: eager PyTorch traces no loop bodies.
"""
from __future__ import annotations

import ast
import os
from collections.abc import Iterator
from typing import TYPE_CHECKING

from repro_torch.analysis.astutil import dotted_name, enclosing_functions
from repro_torch.analysis.registry import PARITY_KINDS

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.analysis.engine import Finding, ModuleUnit

__all__ = ["ALL_RULES", "NOT_PORTED", "Rule", "rule_catalog"]

PACKAGE = "repro_torch"
DECORATOR = "parity_pair_torch"

# The reference's rules this catalogue leaves out, with the reason.
NOT_PORTED = {
    "RPL001": "not ported: tracer leaks in jax control-flow bodies have no counterpart in eager PyTorch",
}


def _posix(relpath: str) -> str:
    return relpath.replace(os.sep, "/")


def _in_package(relpath: str, *packages: str) -> bool:
    """True when the module lives under any `repro_torch/<package>/` tree."""
    p = _posix(relpath)
    return any(f"{PACKAGE}/{pkg}/" in p for pkg in packages)


def _is_module(relpath: str, modules: tuple[str, ...]) -> bool:
    """True when the module is one of `modules` (`<pkg>/<file>.py` under
    `repro_torch/`)."""
    return _posix(relpath).endswith(tuple(f"{PACKAGE}/{m}" for m in modules))


def _decorator_name(d: ast.AST) -> str:
    """The last dotted part of a decorator (`@a.b(...)` → "b")."""
    return (dotted_name(d.func if isinstance(d, ast.Call) else d) or "").split(".")[-1]


class Rule:
    """One contract clause.  `rule_id`/`title` feed the catalogue and the
    `--list-rules` output; `check` yields raw findings."""

    rule_id: str = ""
    title: str = ""

    def check(self, module: "ModuleUnit") -> Iterator["Finding"]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, module: "ModuleUnit", node: ast.AST, message: str) -> "Finding":
        from repro_torch.analysis.engine import Finding

        return Finding(
            path=module.relpath,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            rule=self.rule_id,
            message=message,
        )


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return dotted_name(node.func) in ("set", "frozenset")
    return False


def _is_unordered_view(node: ast.AST) -> bool:
    """set exprs, plus `.keys()`/`.values()` calls (builtin `sum` over
    float dict values re-associates in whatever order the dict was built)."""
    if _is_set_expr(node):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr in ("keys", "values")
    return False


class NondeterministicReductionRule(Rule):
    """RPL002 — reference paths must reduce in a defined order: builtin
    `sum` over sets/dict views re-associates floats in hash/insertion
    order, `min`/`max` over a set has hash-dependent tie identity, and any
    hash fed from a set expression is run-to-run nondeterministic
    (PYTHONHASHSEED).  Artifact-payload modules may not iterate sets at
    all — their outputs are compared byte for byte by the crash-resume
    contract."""

    rule_id = "RPL002"
    title = "order-nondeterministic reduction or set iteration"

    # Modules whose outputs are compared byte for byte (journals, cache
    # shards, rendered reports): set iteration of any kind is banned there.
    ARTIFACT_MODULES = (
        "experiments/cache.py",
        "experiments/journal.py",
        "experiments/report.py",
        "experiments/resilience.py",
        "experiments/run.py",
    )
    _REDUCERS = frozenset({"sum", "min", "max"})
    _HASHES = frozenset({"sha256", "sha1", "md5", "blake2b", "blake2s"})

    @staticmethod
    def _arg_of_interest(call: ast.Call) -> ast.AST | None:
        if not call.args:
            return None
        arg = call.args[0]
        if isinstance(arg, (ast.GeneratorExp, ast.ListComp)):
            return arg.generators[0].iter
        return arg

    def check(self, module: "ModuleUnit") -> Iterator["Finding"]:
        is_artifact = _is_module(module.relpath, self.ARTIFACT_MODULES)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                leaf = name.split(".")[-1] if name else ""
                if name in self._REDUCERS:
                    src = self._arg_of_interest(node)
                    if src is not None and (
                        _is_unordered_view(src) if name == "sum" else _is_set_expr(src)
                    ):
                        yield self.finding(
                            module, node,
                            f"builtin `{name}()` over an unordered collection "
                            "re-associates in hash/insertion order — sort "
                            "first or reduce over an ordered array",
                        )
                elif leaf in self._HASHES:
                    for arg in node.args:
                        if any(_is_set_expr(n) for n in ast.walk(arg)):
                            yield self.finding(
                                module, node,
                                f"`{leaf}()` fed from a set expression — "
                                "iteration order is PYTHONHASHSEED-dependent; "
                                "hash a sorted sequence instead",
                            )
            elif isinstance(node, ast.For) and is_artifact:
                if _is_set_expr(node.iter):
                    yield self.finding(
                        module, node,
                        "iterating a set in an artifact-payload module — "
                        "payloads are compared byte for byte, sort the "
                        "elements first",
                    )
            elif isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.DictComp)):
                if is_artifact and any(_is_set_expr(g.iter) for g in node.generators):
                    yield self.finding(
                        module, node,
                        "comprehension over a set in an artifact-payload "
                        "module — payloads are compared byte for byte, sort "
                        "the elements first",
                    )


class DtypeDisciplineRule(Rule):
    """RPL003 — the reference layers (`core`, `nocsim`, `faults`) are
    float64 by contract: a stray float32 (or half) cast there silently
    weakens the reference every parity test compares against.  That covers
    numpy (`np.float32`, `.astype("float32")`, `dtype="float32"`) and torch
    (`torch.float32`/`float16`/`bfloat16`, `.float()`/`.half()`/
    `.bfloat16()`).  The credit arm's buffer-depth coercion has ONE audited
    code path (`nocsim.model.normalize_buffer_depth`); ad-hoc
    `float(depth)` casts in `nocsim/` bypass its validation.

    The reference's third clause (`jnp.float64` needs the `jax_enable_x64`
    guard) has no counterpart: torch has float64 without a global flag."""

    rule_id = "RPL003"
    title = "dtype discipline violation"

    _REFERENCE_PACKAGES = ("core", "nocsim", "faults")
    _TORCH_NARROW = frozenset({"float32", "float16", "bfloat16", "half"})
    _NARROWING_METHODS = frozenset({"float", "half", "bfloat16"})

    @staticmethod
    def _mentions_depth(node: ast.AST) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and "depth" in n.id:
                return True
            if isinstance(n, ast.Attribute) and "depth" in n.attr:
                return True
        return False

    def check(self, module: "ModuleUnit") -> Iterator["Finding"]:
        in_reference = _in_package(module.relpath, *self._REFERENCE_PACKAGES)
        in_nocsim = _in_package(module.relpath, "nocsim")
        if not in_reference:
            return
        enclosing = enclosing_functions(module.tree) if in_nocsim else {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Attribute):
                base = dotted_name(node.value)
                if node.attr == "float32" and base in ("np", "numpy"):
                    yield self.finding(
                        module, node,
                        "`np.float32` in a float64 reference path — the "
                        "float64 reference defines the semantics the torch "
                        "backend is measured against",
                    )
                elif node.attr in self._TORCH_NARROW and base == "torch":
                    yield self.finding(
                        module, node,
                        f"`torch.{node.attr}` in a float64 reference path — "
                        "the reference layers compute in float64",
                    )
            elif isinstance(node, ast.Call):
                func = node.func
                if isinstance(func, ast.Attribute):
                    if func.attr == "astype" and any(
                        isinstance(a, ast.Constant) and a.value == "float32" for a in node.args
                    ):
                        yield self.finding(module, node, '`.astype("float32")` in a float64 reference path')
                    elif (
                        func.attr in self._NARROWING_METHODS
                        and not node.args
                        and not node.keywords
                        and dotted_name(func.value) not in ("np", "numpy", "torch")
                    ):
                        yield self.finding(
                            module, node,
                            f"`.{func.attr}()` narrows a tensor in a float64 reference path",
                        )
                for kw in node.keywords:
                    if kw.arg == "dtype" and isinstance(kw.value, ast.Constant) and kw.value.value == "float32":
                        yield self.finding(module, node, 'dtype="float32" in a float64 reference path')
                if (
                    in_nocsim
                    and dotted_name(func) == "float"
                    and node.args
                    and enclosing.get(id(node)) != "normalize_buffer_depth"
                    and self._mentions_depth(node.args[0])
                ):
                    yield self.finding(
                        module, node,
                        "ad-hoc `float(...depth...)` coercion — "
                        "`nocsim.model.normalize_buffer_depth` is the one "
                        "audited code path for credit-arm depths",
                    )


class RngHygieneRule(Rule):
    """RPL004 — every random draw must come from a seeded generator: a
    `np.random.Generator`, a `random.Random(seed)`, or a `torch.Generator`
    passed as `generator=` (or the sha256 per-unit derivation in `faults/`).
    The global-state APIs — numpy's legacy `np.random.seed`/`rand`/...,
    stdlib `random`'s module functions, torch's `manual_seed`/`seed` and its
    draws without `generator=` (the `*_like` forms take none) — make
    results depend on call order across the whole process: unreproducible
    under resume, re-ordering, or parallelism."""

    rule_id = "RPL004"
    title = "global-state RNG"

    _NP_ALLOWED = frozenset(
        {"default_rng", "Generator", "SeedSequence", "PCG64", "PCG64DXSM",
         "Philox", "MT19937", "SFC64", "BitGenerator", "bit_generator"}
    )
    _STDLIB_GLOBAL = frozenset(
        {"random", "seed", "randint", "randrange", "choice", "choices",
         "shuffle", "sample", "uniform", "gauss", "normalvariate",
         "getrandbits", "betavariate", "expovariate", "triangular"}
    )
    _TORCH_SEEDS = frozenset(
        {"torch.manual_seed", "torch.seed", "torch.random.manual_seed", "torch.random.seed",
         "torch.cuda.manual_seed", "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all"}
    )
    _TORCH_DRAWS = frozenset(
        {"rand", "randn", "randint", "randperm", "normal", "bernoulli", "multinomial", "poisson"}
    )
    _TORCH_LIKE = frozenset({"rand_like", "randn_like", "randint_like"})

    def check(self, module: "ModuleUnit") -> Iterator["Finding"]:
        imports_random = any(
            isinstance(n, ast.Import) and any(a.name == "random" for a in n.names)
            for n in ast.walk(module.tree)
        )
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Attribute):
                base = dotted_name(node.value)
                if base in ("np.random", "numpy.random"):
                    if node.attr not in self._NP_ALLOWED:
                        yield self.finding(
                            module, node,
                            f"`{base}.{node.attr}` uses numpy's global RNG state "
                            "— derive a seeded `np.random.default_rng(seed)` instead",
                        )
                elif imports_random and base == "random" and node.attr in self._STDLIB_GLOBAL:
                    yield self.finding(
                        module, node,
                        f"stdlib `random.{node.attr}` uses process-global state "
                        "— use a seeded `random.Random(seed)` or numpy Generator",
                    )
            elif isinstance(node, ast.Call):
                name = dotted_name(node.func) or ""
                if name in self._TORCH_SEEDS:
                    yield self.finding(
                        module, node,
                        f"`{name}` seeds torch's global generator — pass a seeded "
                        "`torch.Generator` as `generator=` instead",
                    )
                elif name.startswith("torch.") and name.count(".") == 1:
                    leaf = name.split(".")[1]
                    if leaf in self._TORCH_LIKE:
                        yield self.finding(
                            module, node,
                            f"`{name}` draws from torch's global generator (it takes "
                            "no `generator=`) — draw with a seeded `torch.Generator`",
                        )
                    elif leaf in self._TORCH_DRAWS and not any(kw.arg == "generator" for kw in node.keywords):
                        yield self.finding(
                            module, node,
                            f"`{name}` without `generator=` draws from torch's global "
                            "generator — pass a seeded `torch.Generator`",
                        )


class WallClockPayloadRule(Rule):
    """RPL005 — journals and cache shards are pure functions of config +
    seed: `--resume` must reproduce an interrupted sweep byte for byte.
    Wall-clock or entropy flowing into those payloads breaks that.  Entropy
    sources (`os.urandom`, `uuid.uuid4`, `secrets`) are banned everywhere."""

    rule_id = "RPL005"
    title = "wall-clock/entropy in artifact payload path"

    PAYLOAD_MODULES = ("experiments/cache.py", "experiments/journal.py")
    _CLOCKS = frozenset(
        {"time.time", "time.time_ns", "datetime.now", "datetime.utcnow",
         "datetime.datetime.now", "datetime.datetime.utcnow", "time.ctime"}
    )
    _ENTROPY = frozenset({"os.urandom", "uuid.uuid1", "uuid.uuid4"})

    def check(self, module: "ModuleUnit") -> Iterator["Finding"]:
        is_payload = _is_module(module.relpath, self.PAYLOAD_MODULES)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            if name in self._ENTROPY or name.startswith("secrets."):
                yield self.finding(
                    module, node,
                    f"`{name}` draws OS entropy — committed artifacts must "
                    "be pure functions of config + seed",
                )
            elif is_payload and name in self._CLOCKS:
                yield self.finding(
                    module, node,
                    f"`{name}` in a byte-compared payload module — resumed "
                    "runs must reproduce artifacts byte for byte",
                )


class ParityRegistrationRule(Rule):
    """RPL006 — every public stacked function (`*_batch` / `batch_*`) in
    `core`, `experiments`, `nocsim` and `faults` must declare its serial
    counterpart with `@parity_pair_torch(serial=..., kind=...)`: the
    registry is what renders the port's parity table, and an unregistered
    stacked function is a path with no audited reference."""

    rule_id = "RPL006"
    title = "public stacked function without @parity_pair_torch registration"

    _PACKAGES = ("core", "experiments", "nocsim", "faults")

    @staticmethod
    def _is_batch_kernel(name: str) -> bool:
        return not name.startswith("_") and (name.endswith("_batch") or name.startswith("batch_"))

    def check(self, module: "ModuleUnit") -> Iterator["Finding"]:
        if not _in_package(module.relpath, *self._PACKAGES):
            return
        for node in module.tree.body:
            if not isinstance(node, ast.FunctionDef) or not self._is_batch_kernel(node.name):
                continue
            if not any(_decorator_name(d) == DECORATOR for d in node.decorator_list):
                yield self.finding(
                    module, node,
                    f"public stacked function `{node.name}` has no "
                    f"`@{DECORATOR}(serial=..., kind=...)` registration — "
                    "every stacked path needs an audited serial reference",
                )


class SuppressionHygieneRule(Rule):
    """RPL007 — suppression comments name known rule ids AND carry a
    one-line justification, and may not outlive the violation they excuse.
    Enforced by the engine (it owns the suppression table); this class puts
    the rule in the catalogue and `--list-rules`."""

    rule_id = "RPL007"
    title = "suppression hygiene (malformed/unknown/stale, engine-enforced)"

    def check(self, module: "ModuleUnit") -> Iterator["Finding"]:
        return iter(())


class ParityReferenceRule(Rule):
    """RPL008 — a `@parity_pair_torch` declaration must resolve: `serial=`
    is a literal `repro_torch.<pkg>.<module>.<name>` path whose module file
    is in the scanned tree (the directory holding `repro_torch`) and defines
    the named attribute at top level, and `kind` is a known contract
    strength."""

    rule_id = "RPL008"
    title = "unresolvable @parity_pair_torch declaration"

    @staticmethod
    def _package_root(module: "ModuleUnit") -> str | None:
        """The directory that CONTAINS the `repro_torch` package this file lives in."""
        d = os.path.dirname(os.path.abspath(module.path))
        while True:
            if os.path.basename(d) == PACKAGE:
                return os.path.dirname(d)
            parent = os.path.dirname(d)
            if parent == d:
                return None
            d = parent

    @staticmethod
    def _top_level_names(tree: ast.Module) -> set[str]:
        names = set()
        for n in tree.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(n.name)
            elif isinstance(n, ast.Assign):
                names.update(t.id for t in n.targets if isinstance(t, ast.Name))
            elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
                names.add(n.target.id)
        return names

    def _resolve(self, root: str, serial: str) -> str | None:
        """None when resolvable, else the failure reason."""
        parts = serial.split(".")
        if parts[0] != PACKAGE or len(parts) < 3:
            return f"must be a full `{PACKAGE}.<pkg>.<module>.<name>` dotted path"
        for split in range(len(parts) - 1, 1, -1):
            for candidate in (os.path.join(root, *parts[:split]) + ".py",
                              os.path.join(root, *parts[:split], "__init__.py")):
                if not os.path.isfile(candidate):
                    continue
                try:
                    with open(candidate, encoding="utf-8") as fh:
                        tree = ast.parse(fh.read())
                except SyntaxError:
                    return f"reference module `{candidate}` does not parse"
                if parts[split] not in self._top_level_names(tree):
                    return f"module `{'.'.join(parts[:split])}` defines no top-level `{parts[split]}`"
                return None
        return f"no module file found for `{serial}` under the scanned tree"

    def check(self, module: "ModuleUnit") -> Iterator["Finding"]:
        decos = [
            (node, d)
            for node in ast.walk(module.tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            for d in node.decorator_list
            if _decorator_name(d) == DECORATOR
        ]
        if not decos:
            return
        root = self._package_root(module)
        for fn, deco in decos:
            where = f"`@{DECORATOR}` on `{fn.name}`"
            if not isinstance(deco, ast.Call):
                yield self.finding(module, deco, f"{where} must be called with serial=/kind= keywords")
                continue
            kwargs = {kw.arg: kw.value for kw in deco.keywords}
            serial = kwargs.get("serial")
            kind = kwargs.get("kind")
            if not (isinstance(serial, ast.Constant) and isinstance(serial.value, str)):
                yield self.finding(
                    module, deco,
                    f"{where}: serial= must be a string literal dotted path "
                    "(the linter resolves it statically)",
                )
            elif root is None:
                yield self.finding(
                    module, deco,
                    f"{where}: file is not inside a `{PACKAGE}` package, serial path cannot be resolved",
                )
            else:
                why = self._resolve(root, serial.value)
                if why is not None:
                    yield self.finding(
                        module, deco,
                        f"{where}: serial reference `{serial.value}` is unresolvable — {why}",
                    )
            if not (isinstance(kind, ast.Constant) and kind.value in PARITY_KINDS):
                yield self.finding(module, deco, f"{where}: kind= must be a literal in {PARITY_KINDS}")


class TimingIdiomRule(Rule):
    """RPL009 — one timing idiom in the tree: every duration is measured
    off `repro_torch.obs`'s clock (`obs.now_s`/`obs.now_ns`/`obs.span`).  A
    raw `time.perf_counter()` elsewhere forks the clock — it bypasses the
    deterministic-clock mode that the recording-on ≡ recording-off
    byte-identity checks rely on, and its durations never reach the
    exporters.  `time.sleep` is not a clock read and stays allowed."""

    rule_id = "RPL009"
    title = "raw clock read outside repro_torch.obs (use obs.now_s/obs.span)"

    _RAW_CLOCKS = frozenset(
        {"time.perf_counter", "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
         "time.process_time", "time.process_time_ns", "time.thread_time", "time.thread_time_ns"}
    )

    def check(self, module: "ModuleUnit") -> Iterator["Finding"]:
        if _in_package(module.relpath, "obs"):
            return  # the clock's one owner
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) and dotted_name(node.func) in self._RAW_CLOCKS:
                yield self.finding(
                    module, node,
                    f"`{dotted_name(node.func)}` bypasses the obs clock — use `obs.now_s()` "
                    "or a `with obs.span(...)` block so timings honor the "
                    "deterministic-clock mode and reach the exporters",
                )


ALL_RULES: tuple[type[Rule], ...] = (
    NondeterministicReductionRule,
    DtypeDisciplineRule,
    RngHygieneRule,
    WallClockPayloadRule,
    ParityRegistrationRule,
    SuppressionHygieneRule,
    ParityReferenceRule,
    TimingIdiomRule,
)


def rule_catalog() -> dict[str, str]:
    """rule id -> one-line title, for --list-rules and suppression checks."""
    return {r.rule_id: r.title for r in ALL_RULES}
