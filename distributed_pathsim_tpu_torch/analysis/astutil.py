"""Small shared AST helpers for the analysis passes."""

from __future__ import annotations

import ast


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    """Dotted name of a call's callee, else None."""
    return dotted(node.func)


def self_attr(node: ast.AST) -> str | None:
    """``X`` when ``node`` is exactly ``self.X``, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def is_print_call(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "print"
    )


def print_stream(node: ast.Call) -> str:
    """'stdout' | 'stderr' | 'other' for a print() call's file= target."""
    for kw in node.keywords:
        if kw.arg == "file":
            name = dotted(kw.value)
            if name == "sys.stderr":
                return "stderr"
            if name == "sys.stdout":
                return "stdout"
            return "other"
    return "stdout"


def walk_functions(tree: ast.Module):
    """Yield every (qualname, FunctionDef) in the module, nested defs
    and methods included."""

    def visit(node: ast.AST, prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{prefix}.{child.name}" if prefix else child.name
                yield name, child
                yield from visit(child, name)
            elif isinstance(child, ast.ClassDef):
                name = f"{prefix}.{child.name}" if prefix else child.name
                yield from visit(child, name)
            else:
                yield from visit(child, prefix)

    yield from visit(tree, "")


def own_nodes(fn: ast.AST):
    """Walk a function's OWN body: descendants excluding nested
    function/lambda bodies (each nested def is analyzed in its own
    right by walk_functions, with its own context)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# The port's compile points (utils/compile_counter.KINDS): an nvcc build
# and a library load happen once behind a compile cache, and a CUDA-graph
# capture freezes what it records.
_GRAPH_CONTEXTS = frozenset({"torch.cuda.graph", "cuda.graph"})
_GRAPHED_CALLABLES = frozenset({
    "torch.cuda.make_graphed_callables", "cuda.make_graphed_callables",
    "make_graphed_callables",
})
_CACHE_DECORATORS = frozenset({
    "functools.lru_cache", "lru_cache", "functools.cache", "cache",
})


def cache_decorated(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    """True for a function behind a compile cache: ``@functools.lru_cache``
    (bare or called, ``maxsize=`` or not), ``@lru_cache``,
    ``@functools.cache`` and ``@cache``."""
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if dotted(target) in _CACHE_DECORATORS:
            return True
    return False


def functions_by_name(tree: ast.Module) -> dict[str, list]:
    """Bare name -> every (qualname, FunctionDef) of that name in the
    module, in source order."""
    defs: dict[str, list] = {}
    for qual, fn in walk_functions(tree):
        defs.setdefault(fn.name, []).append((qual, fn))
    return defs


def graph_captures(tree: ast.Module, defs: dict[str, list]):
    """Yield ``(qualname, label, stmts)`` for every region a CUDA graph
    captures in the module: the body of each ``with torch.cuda.graph(...)``
    (``qualname`` is the function holding the ``with``), and the body of
    each function handed to ``torch.cuda.make_graphed_callables`` — found
    by name in ``defs`` (:func:`functions_by_name`). What the region
    calls is the caller's to follow."""

    def visit(node: ast.AST, prefix: str):
        for child in ast.iter_child_nodes(node):
            scope = prefix
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                scope = f"{prefix}.{child.name}" if prefix else child.name
            if isinstance(child, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call)
                and call_name(item.context_expr) in _GRAPH_CONTEXTS
                for item in child.items
            ):
                where = prefix or "<module>"
                yield where, f"the CUDA-graph capture in {where}", child.body
            if (
                isinstance(child, ast.Call)
                and call_name(child) in _GRAPHED_CALLABLES
                and child.args
            ):
                first = child.args[0]
                targets = (
                    first.elts if isinstance(first, (ast.Tuple, ast.List))
                    else [first]
                )
                for t in targets:
                    name = (dotted(t) or "").rsplit(".", 1)[-1]
                    for qual, fn in defs.get(name, ()):
                        yield qual, (
                            f"{fn.name!r}, which make_graphed_callables "
                            "captures"
                        ), fn.body
            yield from visit(child, scope)

    yield from visit(tree, "")
