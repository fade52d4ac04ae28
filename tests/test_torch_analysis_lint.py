"""The port's analysis layer (`repro_torch.analysis`): its rules RPL002–RPL009
on fixtures shaped like `repro_torch/<pkg>/` trees, suppressions and the
baseline lifecycle, the `@parity_pair_torch` registry against the JAX
package's nine pairs, the README's generated parity table, two mutations of
a copy of the real `src/repro_torch`, the four AST helpers against the JAX
package's, and the real tree: the port's lint clean against its empty
baseline, and the JAX package's lint still clean over the port's files.
"""
from __future__ import annotations

import json
import shutil
import textwrap
from pathlib import Path

import pytest

from repro.analysis.lint import main as ref_lint_main
from repro.analysis.registry import load_registry as ref_load_registry
from repro_torch.analysis import parity_table
from repro_torch.analysis.engine import Finding, diff_vs_baseline, lint_paths, load_baseline, write_baseline
from repro_torch.analysis.lint import main as lint_main
from repro_torch.analysis.registry import PARITY_KINDS, ParityEntry, load_registry, parity_pair_torch
from repro_torch.analysis.rules import ALL_RULES, NOT_PORTED, rule_catalog

REPO_ROOT = Path(__file__).resolve().parents[1]
SRC = REPO_ROOT / "src"
BASELINE = REPO_ROOT / "artifacts" / "torch_lint_baseline.json"


def lint_snippet(tmp_path, source, relname="repro_torch/nocsim/mod_under_test.py"):
    """Write `source` into a tmp tree shaped like the port's layout (the rules
    key on `repro_torch/<pkg>/` path segments) and lint the whole tree."""
    target = tmp_path / relname
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(textwrap.dedent(source))
    return lint_paths([str(tmp_path)]).findings


def rules_fired(findings):
    return {f.rule for f in findings}


# --------------------------------------------------------------------------- one positive, one negative a rule

# (rule, path, source that violates exactly that clause, its minimal compliant rewrite)
FIXTURES = [
    ("RPL002", "repro_torch/core/totals.py", """
        def totals(loads):
            return sum({1.0, 2.0}) + sum(loads.values())
     """, """
        def totals(loads):
            return sum(sorted({1.0, 2.0})) + sum(sorted(loads.values()))
     """),
    ("RPL002", "repro_torch/experiments/cache.py", """
        def payload(units):
            return [u for u in set(units)]
     """, """
        def payload(units):
            return [u for u in sorted(set(units))]
     """),
    ("RPL003", "repro_torch/core/weaken.py", """
        import numpy as np
        import torch

        def weaken(x, t):
            return np.float32(x), x.astype("float32"), torch.zeros(3, dtype=torch.float32), t.float(), t.half()
     """, """
        import numpy as np
        import torch

        def keep(x, t):
            return np.float64(x), x.astype("float64"), torch.zeros(3, dtype=torch.float64), t.double()
     """),
    ("RPL003", "repro_torch/nocsim/schedule.py", """
        def schedule(params):
            return float(params.buffer_depth)
     """, """
        def normalize_buffer_depth(depth):
            return float("inf") if depth is None else float(depth)
     """),
    ("RPL004", "repro_torch/core/jitter.py", """
        import numpy as np
        import random
        import torch

        def jitter(n):
            np.random.seed(0)
            torch.manual_seed(0)
            return np.random.rand(n), random.choice([1, 2]), torch.randn(n), torch.rand_like(torch.ones(n))
     """, """
        import numpy as np
        import random
        import torch

        def jitter(n, seed):
            g = torch.Generator().manual_seed(seed)
            return (np.random.default_rng(seed).random(n), random.Random(seed).choice([1, 2]),
                    torch.randn(n, generator=g), torch.randperm(n, generator=g))
     """),
    ("RPL005", "repro_torch/experiments/journal.py", """
        import os
        import time

        def stamp():
            return time.time(), os.urandom(8)
     """, """
        def stamp(config, seed):
            return {"config": config, "seed": seed}
     """),
    ("RPL006", "repro_torch/experiments/solve.py", """
        def solve_batch(stack):
            return stack
     """, """
        from repro_torch.analysis.registry import parity_pair_torch

        @parity_pair_torch(serial="repro_torch.experiments.solve.solve_serial", kind="bit")
        def solve_batch(stack):
            return stack

        def solve_serial(x):
            return x

        def _solve_batch(s):
            return s
     """),
    ("RPL008", "repro_torch/experiments/solve.py", """
        from repro_torch.analysis.registry import parity_pair_torch

        TARGET = "repro_torch.experiments.solve.solve_serial"

        @parity_pair_torch(serial="repro_torch.experiments.solve.renamed_away", kind="exact")
        def solve_batch(stack):
            return stack

        @parity_pair_torch(serial=TARGET, kind="bit")
        def batch_other(stack):
            return stack

        @parity_pair_torch
        def batch_bare(stack):
            return stack

        def solve_serial(x):
            return x
     """, """
        from repro_torch.analysis.registry import parity_pair_torch

        @parity_pair_torch(serial="repro_torch.experiments.solve.solve_serial", kind="rel", tol=1e-9)
        def solve_batch(stack):
            return stack

        def solve_serial(x):
            return x
     """),
    ("RPL009", "repro_torch/experiments/sweep.py", """
        import time

        def timed(fn):
            t0 = time.perf_counter()
            return fn(), time.monotonic_ns() - t0
     """, """
        import time

        from repro_torch import obs

        def timed(fn):
            time.sleep(0.0)
            with obs.span("stage") as sp:
                out = fn()
            return out, sp.duration_s
     """),
]


@pytest.mark.parametrize("rule,path,bad,good", FIXTURES, ids=[f"{r}-{p.split('/')[1]}" for r, p, _, _ in FIXTURES])
def test_each_rule_fires_on_its_fixture_and_not_on_the_rewrite(tmp_path, rule, path, bad, good):
    fired = lint_snippet(tmp_path / "bad", bad, path)
    assert fired and rules_fired(fired) == {rule}, [f.render() for f in fired]
    assert lint_snippet(tmp_path / "good", good, path) == []


@pytest.mark.parametrize("rule,path,source", [
    ("RPL002", "repro_torch/core/free.py", "def payload(units):\n    return [u for u in set(units)]\n"),
    ("RPL003", "repro_torch/models/accel.py", "import torch\n\ndef f(t):\n    return t.float(), torch.bfloat16\n"),
    ("RPL005", "repro_torch/launch/stamp.py", "import time\n\ndef stamp():\n    return time.time()\n"),
    ("RPL006", "repro_torch/models/packing.py", "def pack_batch(s):\n    return s\n"),
    ("RPL009", "repro_torch/obs/trace.py", "import time\n\ndef now_ns():\n    return time.perf_counter_ns()\n"),
])
def test_package_keyed_clauses_stay_in_their_packages(tmp_path, rule, path, source):
    """A clause keyed on a package or module does not fire outside it (RPL009:
    `repro_torch/obs/` is the clock's one owner)."""
    findings = lint_snippet(tmp_path, source, path)
    assert rule not in rules_fired(findings) and findings == []


def test_catalogue_has_rpl002_to_rpl009_and_says_why_rpl001_is_not_ported(capsys):
    catalog = rule_catalog()
    assert sorted(catalog) == [f"RPL00{i}" for i in range(2, 10)] and len(ALL_RULES) == 8
    assert set(NOT_PORTED) == {"RPL001"}
    assert lint_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in listed] == [f"RPL00{i}" for i in range(1, 10)]
    assert "not ported" in listed[0]


# --------------------------------------------------------------------------- suppressions and the baseline


BAD = """
    import torch

    def jitter(n):
        return torch.randn(n){directive}
"""


@pytest.mark.parametrize("directive,want", [
    ("  # repro-torch-lint: disable=RPL004 perf probe, seed irrelevant", set()),
    ("  # repro-torch-lint: disable=RPL004", {"RPL004", "RPL007"}),  # no reason: malformed
    ("  # repro-torch-lint: disable=RPL999 because", {"RPL004", "RPL007"}),  # unknown id
    ("  # repro-torch-lint: disable=RPL001 no traced bodies here", {"RPL004", "RPL007"}),  # not ported: unknown
    ("  # repro-lint: disable=RPL004 the JAX package's syntax", {"RPL004"}),  # not this lint's grammar
])
def test_suppressions(tmp_path, directive, want):
    findings = lint_snippet(tmp_path, BAD.format(directive=directive), "repro_torch/core/jitter.py")
    assert rules_fired(findings) == want


def test_suppression_above_applies_and_stale_ones_are_findings(tmp_path):
    above = lint_snippet(tmp_path / "a", """
        import torch

        def jitter(n):
            # repro-torch-lint: disable=RPL004 perf probe, seed irrelevant
            return torch.randn(n)
    """, "repro_torch/core/jitter.py")
    assert above == []
    stale = lint_snippet(tmp_path / "b", """
        def fine():  # repro-torch-lint: disable=RPL004 nothing here draws randomness
            return 1
    """, "repro_torch/core/fine.py")
    assert rules_fired(stale) == {"RPL007"} and "stale" in stale[0].message
    doc = lint_snippet(tmp_path / "c", '''
        """Suppress with `# repro-torch-lint: disable=RPL004 <reason>` inline."""

        def fine():
            return 1
    ''', "repro_torch/core/doc.py")
    assert doc == []


def test_baseline_round_trip_shrink_only_and_errors(tmp_path):
    def finding(msg):
        return Finding(path="repro_torch/core/x.py", line=3, col=1, rule="RPL004", message=msg)

    path = tmp_path / "baseline.json"
    old = [finding("old"), finding("old")]
    write_baseline(str(path), old)
    baseline = load_baseline(str(path))
    assert diff_vs_baseline(old, baseline).ok
    assert [f.message for f in diff_vs_baseline(old + [finding("new")], baseline).new] == ["new"]
    fixed = diff_vs_baseline([finding("old")], baseline)
    assert not fixed.ok and fixed.stale[0]["count"] == 1  # a fixed finding must leave the baseline
    assert load_baseline(str(tmp_path / "absent.json")) == {}
    path.write_text(json.dumps({"version": 99, "findings": []}))
    with pytest.raises(ValueError, match="version"):
        load_baseline(str(path))
    assert rules_fired(lint_snippet(tmp_path / "t", "def broken(:\n", "repro_torch/core/bad.py")) == {"RPL000"}


def test_cli_check_baseline_and_json(tmp_path, capsys):
    bad = tmp_path / "repro_torch" / "core" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\nx = torch.rand(3)\n")
    assert lint_main([str(tmp_path), "--format", "json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert not out["ok"] and out["findings"][0]["rule"] == "RPL004"
    base = tmp_path / "b.json"
    assert lint_main([str(tmp_path), "--write-baseline", "--baseline", str(base)]) == 0
    assert lint_main([str(tmp_path), "--check-baseline", "--baseline", str(base)]) == 0
    bad.write_text("x = 3\n")  # fixed: the baseline entry is now stale
    assert lint_main([str(tmp_path), "--check-baseline", "--baseline", str(base)]) == 1
    assert "STALE" in capsys.readouterr().out


# --------------------------------------------------------------------------- the registry and the parity table


def test_registry_is_the_references_nine_pairs_no_weaker():
    ref = ref_load_registry()
    mine = load_registry()
    swap = lambda name: "repro_torch." + name.removeprefix("repro.")  # noqa: E731
    assert len(ref) == 9 and sorted(mine) == sorted(swap(k) for k in ref)
    for name, r in ref.items():
        e = mine[swap(name)]
        assert e.serial == swap(r.serial) and e.kind in PARITY_KINDS and e.note
        if r.kind == "bit":
            assert e.kind == "bit", name
        elif e.kind == "rel":
            assert (e.tol or 1e-6) <= (r.tol or 1e-6), name


def test_decorator_is_zero_cost_and_validates_inputs():
    from repro_torch.analysis import registry as reg

    @parity_pair_torch(serial="repro_torch.core.placement.greedy_placement", kind="bit")
    def probe_batch(x):
        return x + 1

    reg._REGISTRY.pop(probe_batch.__parity_pair__.batched)  # keep the rendered table the committed one
    assert probe_batch(1) == 2 and probe_batch.__parity_pair__.kind == "bit"
    with pytest.raises(ValueError, match="kind"):
        parity_pair_torch(serial="repro_torch.core.x.y", kind="exact")
    with pytest.raises(ValueError, match="dotted"):
        parity_pair_torch(serial="bare", kind="bit")


def test_parity_table_is_fresh_renders_sorted_and_gates_staleness(tmp_path, capsys):
    assert parity_table.main(["--check", "--doc", str(REPO_ROOT / "README.md")]) == 0
    table = parity_table.render_parity_table({
        "p.b_batch": ParityEntry(batched="p.b_batch", serial="p.core.b", kind="bit", note="same tie-breaks"),
        "p.a_batch": ParityEntry(batched="p.a_batch", serial="p.core.a", kind="rel", tol=1e-9),
    }).splitlines()
    assert "`p.a_batch`" in table[2] and "within 1e-09 relative" in table[2]
    assert "**bit-identical** (numpy backend) — same tie-breaks" in table[3]
    doc = tmp_path / "doc.md"
    doc.write_text(f"intro\n{parity_table.MARK_BEGIN}\nstale rows\n{parity_table.MARK_END}\nout\n")
    assert parity_table.main(["--check", "--doc", str(doc)]) == 1
    assert "STALE" in capsys.readouterr().err
    assert parity_table.main(["--doc", str(doc)]) == 0
    assert parity_table.main(["--check", "--doc", str(doc)]) == 0
    (tmp_path / "bare.md").write_text("no markers\n")
    assert parity_table.main(["--check", "--doc", str(tmp_path / "bare.md")]) == 2


# --------------------------------------------------------------------------- the real tree and two mutations of it


@pytest.fixture(scope="module")
def mutated(tmp_path_factory) -> list:
    """A copy of the real `src/repro_torch` with two mutations, linted once:
    one `@parity_pair_torch` stripped (repair_batch), and a draw from torch's
    global generator injected into `nocsim/batch.py`."""
    root = tmp_path_factory.mktemp("mutated")
    tree = root / "repro_torch"
    shutil.copytree(SRC / "repro_torch", tree, ignore=shutil.ignore_patterns("__pycache__"))
    target = tree / "experiments" / "placement_batch.py"
    text = target.read_text()
    idx_def = text.index("def repair_batch(")
    idx_dec = text.rindex("@parity_pair_torch(", 0, idx_def)
    target.write_text(text[:idx_dec] + text[idx_def:])
    target = tree / "nocsim" / "batch.py"
    text = target.read_text()
    anchor = "def _step_numpy(\n"
    assert anchor in text
    target.write_text(text.replace(anchor, "_NOISE = torch.randn(3)\n\n\n" + anchor, 1))
    return lint_paths([str(root)]).findings


def test_stripping_a_parity_pair_torch_decorator_trips_rpl006(mutated):
    hits = [f for f in mutated if f.path.endswith("experiments/placement_batch.py")]
    assert [f.rule for f in hits] == ["RPL006"] and "repair_batch" in hits[0].message


def test_injecting_a_global_torch_draw_trips_rpl004(mutated):
    hits = [f for f in mutated if f.path.endswith("nocsim/batch.py")]
    assert [f.rule for f in hits] == ["RPL004"] and "torch.randn" in hits[0].message
    assert len(mutated) == 2  # nothing else in the copy fires


def test_the_port_lints_clean_against_its_empty_baseline():
    assert json.loads(BASELINE.read_text()) == {"version": 1, "findings": []}
    assert lint_main([str(SRC / "repro_torch"), "--check-baseline", "--baseline", str(BASELINE)]) == 0


def test_the_reference_lint_over_the_port_stays_clean():
    """The reference's RPL008 checks every `parity_pair` decorator against a
    `repro` root and its RPL007 reports `# repro-lint:` suppressions that match
    nothing: the port's decorator and suppressions are out of its sight.  (The
    whole of `src` against the same baseline is `tests/test_analysis_lint.py`'s.)"""
    assert ref_lint_main([str(SRC / "repro_torch"), "--check-baseline", "--baseline",
                          str(REPO_ROOT / "artifacts" / "lint_baseline.json")]) == 0


ASTUTIL_SOURCE = """
import os.path as osp
from a.b import c as d, e


def outer(x, /, y, *args, z=1, **kw):
    w = osp.join(x, y)
    for i, (j, k) in enumerate(args):
        w += i + j + k
    with open(w) as fh, ctx() as (g, h):
        pass
    vals = [m * n for m in kw for n in z.attr.chain]

    def inner(q):
        return q + lam(lambda r, s=2: r + s + t)

    class Local:
        pass

    return a.b.c(d, e, inner, Local, fh, g, h, vals)
"""


@pytest.mark.parametrize("helper", ["dotted_name", "names_in", "local_bindings", "enclosing_functions"])
def test_astutil_helpers_agree_with_the_reference(helper):
    """Each helper kept from `repro.analysis.astutil` gives the reference's
    answer on every node (or function) of one source."""
    import ast

    from repro.analysis import astutil as ref
    from repro_torch.analysis import astutil as port

    tree = ast.parse(ASTUTIL_SOURCE)
    mine, theirs = getattr(port, helper), getattr(ref, helper)
    if helper == "enclosing_functions":
        got = mine(tree)
        assert got == theirs(tree) and set(got.values()) == {"outer", "inner"}
        return
    kinds = (ast.FunctionDef, ast.Lambda) if helper == "local_bindings" else ast.AST
    nodes = [n for n in ast.walk(tree) if isinstance(n, kinds)]
    got = [mine(n) for n in nodes]
    assert got == [theirs(n) for n in nodes] and any(got)
    if helper == "local_bindings":
        assert {"x", "y", "args", "z", "kw", "w", "i", "j", "k", "fh", "g", "h", "m", "n", "vals", "inner",
                "Local"} <= got[0]
