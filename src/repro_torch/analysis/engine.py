"""The port's lint engine: file walking, suppression table, baseline
lifecycle (the counterpart of `repro.analysis.engine`).

Rules (repro_torch.analysis.rules) see one `ModuleUnit` per file and yield
raw `Finding`s; the engine owns everything around them:

  * **suppressions** — `# repro-torch-lint: disable=RPL002[,RPL003] <reason>`
    on the finding's line or on a pure-comment line directly above it.
    The reason is mandatory; a suppression that is malformed, names an
    unknown rule id, or matches no finding is itself a finding (RPL007) —
    suppressions cannot rot silently.
    The JAX package's lint reads `# repro-lint:` comments only, and this
    engine reads `# repro-torch-lint:` comments only, so neither sees (or
    reports stale) the other's suppressions.
  * **baseline** — `artifacts/torch_lint_baseline.json` grandfathers known
    findings by (rule, path, message) fingerprint.  `--check-baseline`
    fails on findings NOT in the baseline *and* on baseline entries no
    longer found (a fixed violation must leave the baseline, keeping the
    file shrink-only).

Paths in findings are relative to the current working directory when
possible, so a baseline written from the repo root matches verify runs.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import re
import tokenize
from collections import Counter
from collections.abc import Iterator

from repro_torch.analysis.rules import ALL_RULES, Rule, rule_catalog

__all__ = [
    "BaselineDiff",
    "Finding",
    "LintResult",
    "ModuleUnit",
    "diff_vs_baseline",
    "lint_paths",
    "load_baseline",
    "write_baseline",
]

BASELINE_VERSION = 1

_SUPPRESS_RE = re.compile(r"#\s*repro-torch-lint:\s*(?P<body>.*)$")
_DIRECTIVE_RE = re.compile(
    r"^disable=(?P<rules>RPL\d{3}(?:\s*,\s*RPL\d{3})*)\s+(?P<reason>\S.*)$"
)


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One contract violation, stable under reformatting: the baseline
    identity is (rule, path, message), not the line number."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path.replace(os.sep, "/"), self.message)

    def fingerprint(self) -> str:
        return hashlib.sha256("|".join(self.key()).encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {
            "path": self.path.replace(os.sep, "/"),
            "line": self.line,
            "col": self.col,
            "rule": self.rule,
            "message": self.message,
            "fingerprint": self.fingerprint(),
        }

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col} {self.rule} {self.message}"


@dataclasses.dataclass
class _Suppression:
    line: int
    rules: tuple[str, ...]
    reason: str
    used: bool = False


class ModuleUnit:
    """One parsed source file as the rules see it."""

    def __init__(self, path: str, relpath: str, source: str, tree: ast.Module):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]
    files_scanned: int

    @property
    def ok(self) -> bool:
        return not self.findings


def _display_path(path: str) -> str:
    """Relative to cwd when the file is under it (stable baselines from the
    repo root), absolute otherwise (tmp trees in tests)."""
    rel = os.path.relpath(os.path.abspath(path), os.getcwd())
    return path if rel.startswith("..") else rel


def _iter_py_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(
                d for d in dirnames if not d.startswith((".", "__pycache__"))
            )
            out.extend(
                os.path.join(dirpath, f)
                for f in sorted(filenames)
                if f.endswith(".py")
            )
    return out


def _iter_comments(source: str) -> Iterator[tuple[int, int, str]]:
    """(line, col, text) for every real COMMENT token — docstrings that
    merely *mention* the suppression grammar must not parse as directives."""
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.start[1], tok.string
    except (tokenize.TokenizeError, IndentationError):  # pragma: no cover
        return


def _parse_suppressions(
    relpath: str, source: str, known_rules: set[str]
) -> tuple[dict[int, _Suppression], list[Finding]]:
    sups: dict[int, _Suppression] = {}
    findings: list[Finding] = []
    for lineno, col, comment in _iter_comments(source):
        m = _SUPPRESS_RE.search(comment)
        if not m:
            continue
        d = _DIRECTIVE_RE.match(m.group("body").strip())
        if not d:
            findings.append(
                Finding(
                    path=relpath, line=lineno, col=col + 1, rule="RPL007",
                    message=(
                        "malformed suppression — grammar is `# repro-torch-lint: "
                        "disable=RPL00X[,RPL00Y] <reason>` (the reason is "
                        "mandatory)"
                    ),
                )
            )
            continue
        rules = tuple(r.strip() for r in d.group("rules").split(","))
        unknown = [r for r in rules if r not in known_rules]
        if unknown:
            findings.append(
                Finding(
                    path=relpath, line=lineno, col=col + 1, rule="RPL007",
                    message=f"suppression names unknown rule id(s) {unknown}",
                )
            )
            continue
        sups[lineno] = _Suppression(
            line=lineno, rules=rules, reason=d.group("reason").strip()
        )
    return sups, findings


def _suppression_for(
    finding: Finding, sups: dict[int, _Suppression], lines: list[str]
) -> _Suppression | None:
    """The suppression covering a finding: on its own line, or on the run of
    pure-comment lines directly above it."""
    line = finding.line
    s = sups.get(line)
    if s is not None and finding.rule in s.rules:
        return s
    probe = line - 1
    while probe >= 1 and lines[probe - 1].strip().startswith("#"):
        s = sups.get(probe)
        if s is not None and finding.rule in s.rules:
            return s
        probe -= 1
    return None


def lint_paths(
    paths: list[str], *, rules: list[Rule] | None = None
) -> LintResult:
    """Run the rule catalogue over every .py file under `paths` and return
    suppression-filtered findings (sorted by path/line/rule)."""
    active = rules if rules is not None else [cls() for cls in ALL_RULES]
    known = set(rule_catalog())
    findings: list[Finding] = []
    files = _iter_py_files(paths)
    for path in files:
        relpath = _display_path(path).replace(os.sep, "/")
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=path)
        except (SyntaxError, UnicodeDecodeError, OSError) as exc:
            findings.append(
                Finding(
                    path=relpath, line=getattr(exc, "lineno", 1) or 1, col=1,
                    rule="RPL000",
                    message=f"file does not parse: {exc.__class__.__name__}: {exc}",
                )
            )
            continue
        unit = ModuleUnit(path, relpath, source, tree)
        sups, sup_findings = _parse_suppressions(relpath, source, known)
        raw: list[Finding] = []
        for rule in active:
            raw.extend(rule.check(unit))
        kept: list[Finding] = []
        for f in raw:
            s = _suppression_for(f, sups, unit.lines)
            if s is None:
                kept.append(f)
            else:
                s.used = True
        for s in sups.values():
            if not s.used:
                sup_findings.append(
                    Finding(
                        path=relpath, line=s.line, col=1, rule="RPL007",
                        message=(
                            f"stale suppression for {','.join(s.rules)} — it "
                            "matches no finding; remove it (reason was: "
                            f"{s.reason!r})"
                        ),
                    )
                )
        findings.extend(kept)
        findings.extend(sup_findings)
    return LintResult(findings=sorted(findings), files_scanned=len(files))


# ---------------------------------------------------------------------------
# baseline lifecycle
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BaselineDiff:
    new: list[Finding]  # found now, not grandfathered
    stale: list[dict]  # baseline entries no longer found

    @property
    def ok(self) -> bool:
        return not self.new and not self.stale


def load_baseline(path: str) -> Counter:
    """(rule, path, message) -> grandfathered count.  Missing file ≡ empty
    baseline (the clean-tree steady state)."""
    if not os.path.exists(path):
        return Counter()
    with open(path, encoding="utf-8") as fh:
        payload = json.load(fh)
    if payload.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"unsupported lint baseline version {payload.get('version')!r} "
            f"in {path} (expected {BASELINE_VERSION})"
        )
    c: Counter = Counter()
    for entry in payload.get("findings", ()):
        c[(entry["rule"], entry["path"], entry["message"])] += int(
            entry.get("count", 1)
        )
    return c


def write_baseline(path: str, findings: list[Finding]) -> dict:
    """Aggregate findings by identity and write the grandfather file
    (sorted, trailing newline — byte-stable across regenerations)."""
    counts = Counter(f.key() for f in findings)
    payload = {
        "version": BASELINE_VERSION,
        "findings": [
            {"rule": rule, "path": rel, "message": message, "count": n}
            for (rule, rel, message), n in sorted(counts.items())
        ],
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2)
        fh.write("\n")
    return payload


def diff_vs_baseline(findings: list[Finding], baseline: Counter) -> BaselineDiff:
    remaining = Counter(baseline)
    new: list[Finding] = []
    for f in sorted(findings):
        if remaining[f.key()] > 0:
            remaining[f.key()] -= 1
        else:
            new.append(f)
    stale = [
        {"rule": rule, "path": rel, "message": message, "count": n}
        for (rule, rel, message), n in sorted(remaining.items())
        if n > 0
    ]
    return BaselineDiff(new=new, stale=stale)
