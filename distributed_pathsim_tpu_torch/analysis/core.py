"""Framework core: module loading, the Finding model, baseline, renderers.

Design constraints (the satellites' contracts):

- **Deterministic**: the file walk is sorted, findings are sorted by
  (path, line, rule, message), and the JSON renderer emits sorted keys —
  two runs over the same tree produce byte-identical output, so lint
  diffs in CI are real diffs.
- **One parse**: every file is read and parsed ONCE into a
  :class:`Module` shared by all passes (and, warm, not at all: cache.py).
- **Adoptable**: a checked-in baseline file
  (``analysis/baseline.json``) suppresses known findings so legacy code
  doesn't block turning a new rule on — but every entry needs a
  ``reason``, entries expire LOUDLY (an expired entry is itself an
  error finding), and an entry that no longer matches anything is also
  an error (stale suppressions must not accumulate).

Baseline entry shape::

    {"rule": "LD002", "path": "distributed_pathsim_tpu_torch/obs/trace.py",
     "symbol": "Tracer.start_span",          # optional: enclosing qualname
     "match": "self.enabled",                # optional: message substring
     "reason": "benign racy read: ...",      # required
     "expires": "2027-01-01"}                # optional ISO date

A finding is suppressed by the first entry whose rule and path match it
exactly and whose ``symbol``/``match`` (when present) also match.
"""

from __future__ import annotations

import ast
import dataclasses
import datetime
import functools
import json
import pathlib


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at one site. ``path`` is repo-relative;
    ``symbol`` is the enclosing ``Class.method`` / function qualname
    (or "<module>") — the baseline's line-drift-proof anchor."""

    path: str
    line: int
    rule: str
    message: str
    symbol: str = "<module>"
    severity: str = "error"

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: [{self.rule}] {self.symbol}: "
            f"{self.message}"
        )


@dataclasses.dataclass
class Module:
    """One parsed source file, shared by every pass: ``rel`` is the
    path relative to its root ("serving/cache.py" for package files),
    ``repo_rel`` the repo-relative path findings report, ``root_kind``
    one of "package" / "scripts" / "tests"."""

    path: pathlib.Path
    rel: str
    repo_rel: str
    root_kind: str
    text: str
    tree: ast.Module

    @property
    def lines(self) -> list[str]:
        return self.text.splitlines()

    @functools.cached_property
    def nodes(self) -> tuple:
        """Flat walk of the whole tree, computed once and shared by
        every pass — full-module scans dominate the tier-1 analysis
        budget, so passes iterate this instead of re-walking."""
        return tuple(ast.walk(self.tree))


def repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2]


def default_roots(repo: pathlib.Path | None = None) -> dict:
    """The trees ``dpathsim-torch lint`` walks: the port's package, its
    chip script (``chip_smoke.py``, a script like the JAX package's
    ``scripts/``) and the port's own tests (``tests/test_torch_*.py``;
    the JAX package's tests are not the port's code). A root is a
    directory (every ``*.py`` under it, fixture corpora skipped), one
    file, or a file glob in one directory — see :func:`root_files`."""
    repo = repo or repo_root()
    return {
        "package": repo / "distributed_pathsim_tpu_torch",
        "scripts": repo / "chip_smoke.py",
        "tests": repo / "tests" / "test_torch_*.py",
    }


def root_files(root: pathlib.Path) -> tuple[pathlib.Path, list[pathlib.Path]]:
    """(base, sorted files) of one walk root: a directory walks every
    ``*.py`` under it (fixture corpora under a scanned root are test
    DATA, not code under analysis — but a root that IS a fixture tree,
    as the corpus tests point the analyzer at, scans fully); a file is
    itself; a name with a ``*`` globs its directory. ``base`` is what
    :attr:`Module.rel` is relative to. A missing root walks nothing."""
    root = pathlib.Path(root)
    if "*" in root.name:
        return root.parent, sorted(
            p for p in root.parent.glob(root.name) if p.is_file()
        )
    if root.is_file():
        return root.parent, [root]
    if not root.is_dir():
        return root, []
    return root, [
        p for p in sorted(root.rglob("*.py"))
        if "fixtures" not in p.relative_to(root).parts
    ]


def load_modules(roots: dict, repo: pathlib.Path | None = None) -> list[Module]:
    """Parse every file of the given roots, sorted (the determinism
    contract starts at the walk). Unreadable/unparseable files are
    skipped — a syntax error in one file must not hide findings in the
    rest (the compiler will be plenty loud about it)."""
    repo = repo or repo_root()
    modules: list[Module] = []
    for kind in sorted(roots):
        base, paths = root_files(roots[kind])
        for path in paths:
            try:
                text = path.read_text(encoding="utf-8")
                tree = ast.parse(text, filename=str(path))
            except (OSError, SyntaxError):
                continue
            try:
                repo_rel = path.resolve().relative_to(repo.resolve()).as_posix()
            except ValueError:
                repo_rel = path.as_posix()
            modules.append(
                Module(
                    path=path,
                    rel=path.relative_to(base).as_posix(),
                    repo_rel=repo_rel,
                    root_kind=kind,
                    text=text,
                    tree=tree,
                )
            )
    return modules


# -- symbol resolution -------------------------------------------------------


def qualname_index(tree: ast.Module) -> dict[int, str]:
    """line → enclosing "Class.method"/function qualname, for every
    line covered by a def/class. Built once per module; passes anchor
    findings with :func:`symbol_at`."""
    index: dict[int, str] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                name = f"{prefix}.{child.name}" if prefix else child.name
                end = getattr(child, "end_lineno", child.lineno) or child.lineno
                for ln in range(child.lineno, end + 1):
                    index[ln] = name
                visit(child, name)
            else:
                visit(child, prefix)

    visit(tree, "")
    return index


def symbol_at(index: dict[int, str], line: int) -> str:
    return index.get(line, "<module>")


# -- baseline ----------------------------------------------------------------

BASELINE_PATH = pathlib.Path(__file__).resolve().parent / "baseline.json"


def load_baseline(path: pathlib.Path | str | None = None) -> list[dict]:
    p = pathlib.Path(path) if path is not None else BASELINE_PATH
    if not p.exists():
        return []
    doc = json.loads(p.read_text(encoding="utf-8"))
    entries = doc["suppressions"] if isinstance(doc, dict) else doc
    for e in entries:
        if "reason" not in e or not str(e["reason"]).strip():
            raise ValueError(
                f"baseline entry without a reason: {e!r} — every "
                "suppression must say why it is not a bug"
            )
    return entries


def _entry_matches(entry: dict, f: Finding) -> bool:
    if entry.get("rule") != f.rule or entry.get("path") != f.path:
        return False
    if entry.get("symbol") is not None and entry["symbol"] != f.symbol:
        return False
    if entry.get("match") is not None and entry["match"] not in f.message:
        return False
    return True


def apply_baseline(
    findings: list[Finding],
    entries: list[dict],
    today: datetime.date | None = None,
) -> tuple[list[Finding], list[Finding]]:
    """(kept, suppressed). Expired entries and entries that matched
    nothing come back as synthetic error findings appended to ``kept``
    — the loud half of the suppression story."""
    today = today or datetime.date.today()
    kept: list[Finding] = []
    suppressed: list[Finding] = []
    used = [0] * len(entries)
    active = []
    for i, e in enumerate(entries):
        exp = e.get("expires")
        expired = (
            exp is not None and datetime.date.fromisoformat(exp) < today
        )
        active.append(not expired)
    for f in findings:
        hit = None
        for i, e in enumerate(entries):
            if active[i] and _entry_matches(e, f):
                hit = i
                break
        if hit is not None:
            used[hit] += 1
            suppressed.append(f)
        else:
            kept.append(f)
    for i, e in enumerate(entries):
        if not active[i]:
            kept.append(Finding(
                path=str(e.get("path")), line=0, rule="BASELINE",
                symbol=str(e.get("symbol") or "<entry>"),
                message=(
                    f"suppression for {e.get('rule')} expired on "
                    f"{e.get('expires')} — fix the finding or renew the "
                    f"entry (reason was: {e.get('reason')})"
                ),
            ))
        elif used[i] == 0:
            kept.append(Finding(
                path=str(e.get("path")), line=0, rule="BASELINE",
                symbol=str(e.get("symbol") or "<entry>"),
                message=(
                    f"stale suppression: no {e.get('rule')} finding "
                    "matches this entry any more — delete it"
                ),
            ))
    return sorted(kept), sorted(suppressed)


# -- driving -----------------------------------------------------------------


def run_analysis(
    roots: dict | None = None,
    rules: set[str] | None = None,
    baseline: list[dict] | None = None,
    repo: pathlib.Path | None = None,
    modules: list[Module] | None = None,
) -> dict:
    """Load once, run every pass, apply the baseline. Returns
    ``{"findings": [...], "suppressed": [...], "files": int}`` with
    both lists sorted. ``rules`` filters by rule id (a pass whose rules
    are all filtered out is skipped entirely)."""
    from .registry import ALL_PASSES

    repo = repo or repo_root()
    if modules is None:
        modules = load_modules(roots or default_roots(repo), repo)
    findings: list[Finding] = []
    for p in ALL_PASSES:
        pass_rules = set(p.rules)
        if rules is not None and not (pass_rules & rules):
            continue
        got = p.run(modules)
        if rules is not None:
            got = [f for f in got if f.rule in rules]
        findings.extend(got)
    findings.sort()
    if baseline is None:
        kept, suppressed = findings, []
    else:
        kept, suppressed = apply_baseline(findings, baseline)
    return {"findings": kept, "suppressed": suppressed,
            "files": len(modules)}


# -- renderers ---------------------------------------------------------------


def render_human(result: dict) -> str:
    from .registry import RULES

    out = []
    for f in result["findings"]:
        doc = RULES.get(f.rule)
        out.append(f.render())
        if doc is not None:
            out.append(f"    -> {doc.why}")
    out.append(
        f"dpathsim-torch lint: {len(result['findings'])} finding(s), "
        f"{len(result['suppressed'])} baselined, "
        f"{result['files']} files"
    )
    return "\n".join(out)


def render_json(result: dict) -> str:
    """Stable, diffable: sorted findings (Finding is order-able), sorted
    keys, no timestamps."""
    doc = {
        "findings": [dataclasses.asdict(f) for f in result["findings"]],
        "suppressed": [dataclasses.asdict(f) for f in result["suppressed"]],
        "files": result["files"],
    }
    return json.dumps(doc, indent=2, sort_keys=True)
