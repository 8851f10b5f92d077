"""Determinism pass: bit-identical answers need order-identical inputs.

- **DT001 unordered-iteration**: iterating a provably set-typed
  expression (set literal / comprehension, ``set(...)``/
  ``frozenset(...)`` call, or a local assigned from one) without
  ``sorted(...)`` inside a function that feeds a fingerprint, a digest,
  or the wire (calls ``hashlib``/``json.dumps``, or is named like
  ``*fingerprint*``/``*digest*``/``*to_wire*``/``*serialize*``). Python
  set order varies with PYTHONHASHSEED and insertion history, so the
  same graph could hash or serialize differently across processes.
- **DT002 selection-outside-primitives**: score selection/tie-break
  (``np.argsort``/``lexsort``/``argpartition``/``partition``, and the
  port's own ``torch.topk``/``sort``/``argsort``/``kthvalue`` — called
  from ``torch`` or as a method of a provable tensor: the result of a
  ``torch.*`` call, or a local assigned from one or annotated
  ``torch.Tensor``) in ``serving/``/``router/`` code instead of the shared
  ``ops/pathsim`` primitives — the one place the (descending score,
  ascending column) oracle order is implemented; a local reimplementation
  is how tie order silently forks. Also flags float32 casts inside
  functions that call the f64 ``pathsim.score_*`` primitives.
- **DT003 wall-clock**: ``time.time()`` outside the two sanctioned
  sites (migrated from scripts/lint_telemetry.py R1) — wall time steps
  under NTP, so durations/orderings must use perf_counter/monotonic.
- **DT004 unseeded-rng**: module-global RNG state (``random.<fn>()``,
  legacy ``np.random.<fn>()``) or ``np.random.default_rng()`` with no
  seed in package code — deterministic paths take an explicit seed.
"""

from __future__ import annotations

import ast

from .astutil import call_name, dotted, own_nodes, walk_functions
from .core import Finding, Module, qualname_index, symbol_at

RULE_DOCS = {
    "DT001": (
        "unordered set iteration into a fingerprint/wire payload",
        "set iteration order varies per process (hash seed, insertion "
        "history); wrap the iterable in sorted(...) so fingerprints and "
        "wire payloads are order-identical fleet-wide",
    ),
    "DT002": (
        "score selection outside the ops/pathsim primitives",
        "top-k/tie order must come from the shared f64 primitives "
        "(pathsim.topk_from_score_rows / topk_from_candidate_scores); "
        "a local argsort/partition (or an f32 cast in an f64 scoring "
        "path) forks the bit-exact contract",
    ),
    "DT003": (
        "wall-clock time.time() in library code",
        "time.time() is wall clock — durations/ordering must use "
        "perf_counter/monotonic; stamp events via "
        "utils.logging.timestamps() (sanctioned: utils/logging.py, "
        "obs/trace.py's wall anchor)",
    ),
    "DT004": (
        "unseeded / global-state RNG in package code",
        "deterministic paths take an explicit seed: use "
        "np.random.default_rng(seed) or random.Random(seed), never the "
        "module-global RNG",
    ),
}

_WALLCLOCK_ALLOWED = frozenset({"utils/logging.py", "obs/trace.py"})
_CONTEXT_NAME_TOKENS = ("fingerprint", "digest", "to_wire", "serialize")
_HASH_SINKS = ("hashlib.", "json.dumps")
_SELECTION_CALLS = frozenset({
    "np.argsort", "np.lexsort", "np.argpartition", "np.partition",
    "numpy.argsort", "numpy.lexsort", "numpy.argpartition",
    "numpy.partition", "jnp.argsort", "jnp.lexsort",
    "torch.topk", "torch.sort", "torch.argsort", "torch.kthvalue",
    "torch.Tensor.topk", "torch.Tensor.sort", "torch.Tensor.argsort",
    "torch.Tensor.kthvalue",
})
# The same selections as methods of a tensor (``scores.topk(k)``).
_TENSOR_SELECTION_METHODS = frozenset({"topk", "sort", "argsort", "kthvalue"})
# Tensor methods whose result is not a tensor.
_TENSOR_EXITS = frozenset({"tolist", "item", "numpy", "size", "dim",
                           "numel", "data_ptr"})
_LEGACY_NP_RANDOM = frozenset({
    "seed", "rand", "randn", "randint", "random", "choice", "shuffle",
    "permutation", "standard_normal", "uniform", "normal",
})
_GLOBAL_RANDOM_FNS = frozenset({
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "getrandbits", "seed", "betavariate",
})


def _is_set_expr(node: ast.AST, set_locals: set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and call_name(node) in ("set", "frozenset"):
        return True
    if isinstance(node, ast.Name) and node.id in set_locals:
        return True
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.BitOr, ast.BitAnd, ast.Sub)
    ):
        return _is_set_expr(node.left, set_locals) or _is_set_expr(
            node.right, set_locals
        )
    return False


def _set_locals(fn: ast.AST) -> set[str]:
    """Names assigned from a provably-set expression in this function."""
    out: set[str] = set()
    for _ in range(2):  # one extra sweep: set-from-set assignments
        for node in own_nodes(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name) and _is_set_expr(node.value, out):
                    out.add(t.id)
    return out


def _is_tensor_annotation(node: ast.AST | None) -> bool:
    return node is not None and dotted(node) in ("torch.Tensor", "Tensor")


def _is_tensor_expr(node: ast.AST, tensor_locals: set[str]) -> bool:
    """The AST can tell ``node`` is a tensor: a ``torch.*`` call, a
    method call or subscript on a tensor, or a tensor local."""
    if isinstance(node, ast.Call):
        if (call_name(node) or "").startswith("torch."):
            return True
        return (isinstance(node.func, ast.Attribute)
                and node.func.attr not in _TENSOR_EXITS
                and _is_tensor_expr(node.func.value, tensor_locals))
    if isinstance(node, ast.Subscript):
        return _is_tensor_expr(node.value, tensor_locals)
    return isinstance(node, ast.Name) and node.id in tensor_locals


def _tensor_locals(fn: ast.AST) -> set[str]:
    """Names this function binds to a provable tensor: parameters and
    locals annotated ``torch.Tensor``, and locals assigned from a
    tensor expression."""
    out: set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if _is_tensor_annotation(a.annotation):
                out.add(a.arg)
    for _ in range(2):  # one extra sweep: tensor-from-tensor assignments
        for node in own_nodes(fn):
            if isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name) and (
                    _is_tensor_annotation(node.annotation)
                    or (node.value is not None
                        and _is_tensor_expr(node.value, out))):
                out.add(node.target.id)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name) and _is_tensor_expr(node.value,
                                                               out):
                    out.add(t.id)
    return out


def _is_tensor_selection(node: ast.Call, tensor_locals: set[str]) -> bool:
    return (
        isinstance(node.func, ast.Attribute)
        and node.func.attr in _TENSOR_SELECTION_METHODS
        and _is_tensor_expr(node.func.value, tensor_locals)
    )


def _is_context_fn(name: str, fn: ast.AST) -> bool:
    short = name.rsplit(".", 1)[-1].lower()
    if any(tok in short for tok in _CONTEXT_NAME_TOKENS):
        return True
    for node in own_nodes(fn):
        if isinstance(node, ast.Call):
            cn = call_name(node) or ""
            if cn == "json.dumps" or cn.startswith("hashlib."):
                return True
    return False


def _iterated_exprs(fn: ast.AST):
    """(node, iterable) pairs whose iteration order becomes output
    order: for loops, comprehension generators, and list/tuple/join
    materializations."""
    for node in own_nodes(fn):
        if isinstance(node, ast.For):
            yield node, node.iter
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                yield node, gen.iter
        elif isinstance(node, ast.Call):
            cn = call_name(node)
            if cn in ("list", "tuple") and node.args:
                yield node, node.args[0]
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"
                and node.args
            ):
                yield node, node.args[0]


class DeterminismPass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        findings: list[Finding] = []
        for m in modules:
            if m.root_kind != "package":
                continue
            self._dt001(m, findings)
            self._dt002(m, findings)
            self._dt003(m, findings)
            self._dt004(m, findings)
        return findings

    def _dt001(self, m: Module, findings: list[Finding]) -> None:
        for qual, fn in walk_functions(m.tree):
            if not _is_context_fn(qual, fn):
                continue
            set_locals = _set_locals(fn)
            for node, it in _iterated_exprs(fn):
                if _is_set_expr(it, set_locals):
                    findings.append(Finding(
                        path=m.repo_rel, line=node.lineno, rule="DT001",
                        symbol=qual,
                        message=(
                            "iteration over a set feeds a fingerprint/"
                            "wire payload — wrap it in sorted(...)"
                        ),
                    ))

    def _dt002(self, m: Module, findings: list[Finding]) -> None:
        in_scope = m.rel.startswith(("serving/", "router/"))
        for qual, fn in walk_functions(m.tree):
            calls_pathsim = any(
                isinstance(n, ast.Call)
                and (call_name(n) or "").startswith("pathsim.score")
                for n in own_nodes(fn)
            )
            tensors = _tensor_locals(fn) if in_scope else set()
            for node in own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                cn = call_name(node) or ""
                if in_scope and (cn in _SELECTION_CALLS
                                 or _is_tensor_selection(node, tensors)):
                    if cn not in _SELECTION_CALLS:
                        cn = f"Tensor.{node.func.attr}"
                    findings.append(Finding(
                        path=m.repo_rel, line=node.lineno, rule="DT002",
                        symbol=qual,
                        message=(
                            f"{cn}() reimplements score selection — use "
                            "the shared ops/pathsim top-k primitives "
                            "(oracle tie order lives there)"
                        ),
                    ))
                elif calls_pathsim and cn in (
                    "np.float32", "jnp.float32", "numpy.float32"
                ):
                    findings.append(Finding(
                        path=m.repo_rel, line=node.lineno, rule="DT002",
                        symbol=qual,
                        message=(
                            "float32 cast inside an f64 scoring path — "
                            "the pathsim primitives are f64 end to end"
                        ),
                    ))

    def _dt003(self, m: Module, findings: list[Finding]) -> None:
        if m.rel in _WALLCLOCK_ALLOWED:
            return
        index = None
        for node in m.nodes:
            if isinstance(node, ast.Call) and call_name(node) == "time.time":
                if index is None:
                    index = qualname_index(m.tree)
                findings.append(Finding(
                    path=m.repo_rel, line=node.lineno, rule="DT003",
                    symbol=symbol_at(index, node.lineno),
                    message=(
                        "time.time() — durations/ordering use "
                        "perf_counter/monotonic; events go through "
                        "utils.logging.timestamps()"
                    ),
                ))

    def _dt004(self, m: Module, findings: list[Finding]) -> None:
        index = None
        for node in m.nodes:
            if not isinstance(node, ast.Call):
                continue
            cn = call_name(node) or ""
            bad = None
            if cn in ("np.random.default_rng", "numpy.random.default_rng"):
                if not node.args and not node.keywords:
                    bad = f"{cn}() without a seed"
            elif cn.startswith(("np.random.", "numpy.random.")):
                if cn.rsplit(".", 1)[-1] in _LEGACY_NP_RANDOM:
                    bad = f"{cn}() uses numpy's global RNG state"
            elif cn.startswith("random."):
                if cn.rsplit(".", 1)[-1] in _GLOBAL_RANDOM_FNS:
                    bad = f"{cn}() uses the module-global RNG"
            if bad is not None:
                if index is None:
                    index = qualname_index(m.tree)
                findings.append(Finding(
                    path=m.repo_rel, line=node.lineno, rule="DT004",
                    symbol=symbol_at(index, node.lineno),
                    message=f"{bad} — pass an explicit seed",
                ))
