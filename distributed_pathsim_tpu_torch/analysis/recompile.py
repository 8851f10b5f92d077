"""Recompile-safety pass: the zero-steady-state-recompile contracts.

The port compiles at run time in three ways, and
``utils/compile_counter.KINDS`` counts each: an ``nvcc`` build of a
kernel source, the load of the built library, and a CUDA-graph capture.
The first two happen once, behind a compile cache; the third records a
fixed sequence of launches that every replay repeats. A warm service
must read 0 new compiles. These rules hold the code to that at the AST,
not only by compile-counter smoke tests after the fact:

- **RS001 knob-in-capture**: tuning-knob resolution
  (``tuning.dispatch.choose()`` and friends) must happen OUTSIDE what a
  CUDA graph captures: the body of ``with torch.cuda.graph(...)``, a
  function handed to ``torch.cuda.make_graphed_callables``, and what
  either calls by name in the same module. The capture freezes the
  knob's value into the recorded launches — the table changes, the
  replay silently doesn't (and re-capturing to honor it is exactly the
  steady-state recompile the contract forbids).
- **RS002 unbucketed-shape**: in the serving tier (``serving/``, the
  index probe path), batch padding and device-shape construction go
  through the sanctioned bucket helpers (``bucket_for``/``pad_rows``/
  ``bucket_ladder``/``resolve_ladder``). A raw ``np.pad``/``F.pad`` or a
  ``torch.zeros(len(...))``-style Python-value-dependent shape in a
  function that never consults the ladder gives the card one new shape
  per distinct size — a new allocation and kernel configuration per
  size, and one capture per size for any graph recorded over it: the
  unbounded set the pow-2 buckets exist to prevent.
- **RS003 mutable-cache-arg**: every argument of a function behind a
  compile cache (``functools.lru_cache``/``functools.cache``, as the
  native build is) is a cache key. A list/dict/set default or annotation
  is unhashable — it fails at call time at best, and at worst invites a
  "fix" by list→tuple conversion per call, defeating the cache.
"""

from __future__ import annotations

import ast

from .astutil import (
    cache_decorated,
    call_name,
    dotted,
    functions_by_name,
    graph_captures,
    walk_functions,
)
from .core import Finding, Module

RULE_DOCS = {
    "RS001": (
        "tuning-knob resolution inside a CUDA-graph capture",
        "choose()/active_table() inside what a CUDA graph captures "
        "freezes the knob at capture time — resolve knobs before the "
        "capture and hand the value in (see tuning/dispatch.py's "
        "contract)",
    ),
    "RS002": (
        "unbucketed pad/shape in the serving tier",
        "serving-tier shapes must come from the bucket ladder "
        "(bucket_for/pad_rows/resolve_ladder) — a Python-value-"
        "dependent shape gives the card a new shape, and a graph a new "
        "capture, per distinct size",
    ),
    "RS003": (
        "unhashable argument of a compile-cached function",
        "every argument of an lru_cache/cache function (a kernel "
        "build, a library load) is a cache key and must be hashable — "
        "a list/dict/set default or annotation will fail (or invite "
        "per-call conversions that defeat the cache)",
    ),
}

_KNOB_CALLS = frozenset({
    "choose", "dispatch.choose", "tuning.choose",
    "active_table", "dispatch.active_table",
    "install_table", "install_from_env",
})
_BUCKET_HELPERS = frozenset({
    "bucket_for", "pad_rows", "bucket_ladder", "resolve_ladder",
    "bk.bucket_for", "bk.pad_rows", "bk.bucket_ladder",
    "buckets.bucket_for", "buckets.pad_rows", "buckets.bucket_ladder",
})
# the helpers themselves (and the registry's one implementation) are
# where the raw pad/shape code is SUPPOSED to live
_HELPER_DEFS = frozenset({
    "bucket_for", "pad_rows", "bucket_ladder", "resolve_ladder",
})
_PAD_CALLS = frozenset({
    "np.pad", "numpy.pad", "torch.nn.functional.pad", "nn.functional.pad",
    "F.pad",
})
_SHAPE_CTORS = frozenset({
    "torch.zeros", "torch.ones", "torch.full", "torch.empty",
    "torch.arange",
})
_RS002_SCOPE = ("serving/", "index/mips.py")
_UNHASHABLE = frozenset({"list", "dict", "set", "List", "Dict", "Set"})


def _is_knob_call(cn: str) -> bool:
    return cn in _KNOB_CALLS or cn.endswith(".dispatch.choose")


class RecompileSafetyPass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        findings: list[Finding] = []
        for m in modules:
            if m.root_kind == "tests":
                continue
            self._rs001(m, findings)
            if m.root_kind == "package" and m.rel.startswith(_RS002_SCOPE):
                self._rs002(m, findings)
            self._rs003(m, findings)
        return findings

    def _rs001(self, m: Module, findings: list[Finding]) -> None:
        if "cuda.graph" not in m.text and "graphed_callables" not in m.text:
            return  # no capture is spelled without one of these
        defs = functions_by_name(m.tree)
        reported: set[int] = set()
        for site, label, region in graph_captures(m.tree, defs):
            # the region, then every same-module function it reaches by
            # name: what the capture records is everything it runs
            work = [(site, region)]
            followed: set[str] = set()
            while work:
                qual, stmts = work.pop(0)
                for node in (n for s in stmts for n in ast.walk(s)):
                    if not isinstance(node, ast.Call):
                        continue
                    cn = call_name(node) or ""
                    if _is_knob_call(cn):
                        if node.lineno in reported:
                            continue
                        reported.add(node.lineno)
                        findings.append(Finding(
                            path=m.repo_rel, line=node.lineno,
                            rule="RS001", symbol=qual,
                            message=(
                                f"{cn}() inside {label} — the knob's "
                                "value is frozen at capture time; "
                                "resolve it before the capture and hand "
                                "the value in"
                            ),
                        ))
                        continue
                    tail = cn.rsplit(".", 1)[-1]
                    for q, fn in defs.get(tail, ()):
                        if q not in followed:
                            followed.add(q)
                            work.append((q, fn.body))

    def _rs002(self, m: Module, findings: list[Finding]) -> None:
        for qual, fn in walk_functions(m.tree):
            if fn.name in _HELPER_DEFS:
                continue
            params = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
            bucket_sane = "bucket" in params or any(
                isinstance(n, ast.Call)
                and (call_name(n) or "") in _BUCKET_HELPERS
                for n in ast.walk(fn)
            )
            if bucket_sane:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                cn = call_name(node) or ""
                if cn in _PAD_CALLS:
                    findings.append(Finding(
                        path=m.repo_rel, line=node.lineno, rule="RS002",
                        symbol=qual,
                        message=(
                            f"{cn}() without a bucket-ladder-derived "
                            "size — pad through serving.buckets."
                            "pad_rows/bucket_for so the device-shape "
                            "set stays bounded"
                        ),
                    ))
                elif cn in _SHAPE_CTORS and any(
                    isinstance(sub, ast.Call)
                    and call_name(sub) == "len"
                    for a in node.args[:1]
                    for sub in ast.walk(a)
                ):
                    findings.append(Finding(
                        path=m.repo_rel, line=node.lineno, rule="RS002",
                        symbol=qual,
                        message=(
                            f"{cn}(len(...)) — a Python-value-dependent "
                            "device shape is a new shape per distinct "
                            "size; round it through the bucket ladder"
                        ),
                    ))

    def _rs003(self, m: Module, findings: list[Finding]) -> None:
        if "cache" not in m.text:
            return  # nor a compile cache without this word
        for qual, fn in walk_functions(m.tree):
            if not cache_decorated(fn):
                continue
            params = [
                a for a in (fn.args.posonlyargs + fn.args.args
                            + fn.args.kwonlyargs)
                if a.arg not in ("self", "cls")
            ]
            keyed = {a.arg for a in params}
            for a in params:
                ann = a.annotation
                if isinstance(ann, ast.Subscript):
                    ann = ann.value
                base = (dotted(ann) or "").rsplit(".", 1)[-1] if ann else ""
                if base in _UNHASHABLE:
                    findings.append(Finding(
                        path=m.repo_rel, line=a.lineno, rule="RS003",
                        symbol=qual,
                        message=(
                            f"argument {a.arg!r} of compile-cached "
                            f"{fn.name!r} annotated as unhashable {base} "
                            "— its arguments are cache keys; use a "
                            "tuple/frozenset"
                        ),
                    ))
            positional = fn.args.posonlyargs + fn.args.args
            defaults = fn.args.defaults
            pairs = list(zip(positional[len(positional) - len(defaults):],
                             defaults))
            pairs += [
                (a, d) for a, d in zip(fn.args.kwonlyargs,
                                       fn.args.kw_defaults)
                if d is not None
            ]
            for a, d in pairs:
                if a.arg in keyed and isinstance(
                    d, (ast.List, ast.Dict, ast.Set, ast.DictComp,
                        ast.ListComp, ast.SetComp)
                ):
                    findings.append(Finding(
                        path=m.repo_rel, line=d.lineno, rule="RS003",
                        symbol=qual,
                        message=(
                            f"argument {a.arg!r} of compile-cached "
                            f"{fn.name!r} defaults to an unhashable "
                            "literal — its arguments are cache keys; "
                            "use a tuple/frozenset"
                        ),
                    ))
