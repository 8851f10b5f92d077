"""Wire-schema inference + backward-compatibility gate (WC100s).

The JSONL protocol's per-op request/response field contracts live only
in code: ``_dispatch_op`` branches read ``req.get(...)``, handlers
return dict literals, and the routers construct wire dicts. This pass
*infers* that schema by dataflow over the call graph and turns it into
a machine-checked contract:

- the inferred schema is emitted as a checked-in, byte-stable
  ``artifacts/wire_schema_torch.json`` (``dpathsim-torch lint
  --write-wire-schema`` regenerates it; the JAX package's
  ``artifacts/wire_schema.json`` is its own and is never written
  here), covering every op in ``PROTOCOL_OPS``: request fields
  (required vs defaulted, consumer sites, producer sites) and response
  fields (producer sites, plus a ``response_complete`` marker
  for ops whose every return was statically enumerable);
- **WC101 backward-incompatible wire drift**: the checked-in schema
  records the contract old clients were built against — an op dropped,
  a request/response field removed, or an optional field turned
  required fails the build (old peers break);
- **WC102 schema file out of date**: compatible drift (new op, new
  defaulted field, a field relaxed to optional) still needs the file
  regenerated, or the contract record rots;
- **WC103 dead wire field**: a field some producer writes that no
  handler reads (a typo'd key silently ignored at the far end), or —
  for ops the routers themselves produce — a field a handler reads
  that no producer writes.

Inference walks: each op's ``_dispatch_op`` branch; every function the
wire dict is passed to (parameter-position dataflow over resolved call
edges); and — for the ``getattr(service, op)`` trampoline — every
``serving/`` function *named* the op with a ``req`` parameter (the
``PartitionService`` handler convention). ``req.get(key)`` loops over
module-level constant tuples (``_QUERY_KEYS``) resolve to their
elements. The port speaks the JAX package's wire: its inferred schema
has the JAX schema's ops, field sets, ``response_complete`` and
envelope (tests/test_torch_analysis_wireschema.py), and the JAX
package's dynamic cross-check (tests/test_wire_schema.py) replays live
traffic against that schema — the inference-soundness half.
"""

from __future__ import annotations

import ast
import json
import pathlib

from .astutil import call_name
from .callgraph import CallGraph, FuncInfo
from .core import Finding, Module

RULE_DOCS = {
    "WC101": (
        "backward-incompatible wire-schema drift",
        "the checked-in artifacts/wire_schema_torch.json records the "
        "contract "
        "existing peers were built against — removing an op or field, "
        "or turning an optional field required, breaks them; restore "
        "the contract or ship a compatibility path first",
    ),
    "WC102": (
        "wire_schema_torch.json out of date",
        "the code's wire contract grew (new op / new defaulted field / "
        "field relaxed) but the checked-in schema wasn't regenerated — "
        "run `dpathsim-torch lint --write-wire-schema` and commit the "
        "diff so "
        "drift reviews stay real diffs",
    ),
    "WC103": (
        "dead wire field",
        "a request field written by no reader (typo'd key, silently "
        "ignored at the far end) or — on router-produced ops — read by "
        "no writer (dead handler path); fix the mismatch or baseline a "
        "deliberately client-only field with a justification",
    ),
}

# fields every request may carry, handled by handle_request itself —
# not part of any per-op schema
ENVELOPE = ("deadline_ms", "id", "op", "request_id", "trace")

_PROTOCOL_FILE = "serving/protocol.py"
_DISPATCH_FN = "_dispatch_op"
SCHEMA_REL = "artifacts/wire_schema_torch.json"
# where dynamic-dispatch fallbacks may resolve (the service handler
# convention lives in serving/; the trace ring export in obs/)
_HANDLER_PREFIXES = ("serving/", "obs/")


def _frozenset_literal(tree: ast.Module, name: str) -> set[str] | None:
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == name
        ):
            return {
                c.value for c in ast.walk(node.value)
                if isinstance(c, ast.Constant) and isinstance(c.value, str)
            }
    return None


def _const_tuples(tree: ast.Module) -> dict[str, tuple[str, ...]]:
    """Module-level ``NAME = ("a", "b", ...)`` string tuples/lists."""
    out: dict[str, tuple[str, ...]] = {}
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            elts = node.value.elts
            if elts and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in elts
            ):
                out[node.targets[0].id] = tuple(e.value for e in elts)
    return out


class _OpSchema:
    __slots__ = ("request", "response", "response_complete", "producers")

    def __init__(self):
        # field -> {"required": bool, "consumers": set[str]}
        self.request: dict[str, dict] = {}
        # field -> set[str] producer sites
        self.response: dict[str, set] = {}
        self.response_complete = True
        # field -> set[str] request-producer sites
        self.producers: dict[str, set] = {}

    def read(self, field: str, required: bool, site: str) -> None:
        slot = self.request.setdefault(
            field, {"required": False, "consumers": set()}
        )
        slot["required"] = slot["required"] or required
        slot["consumers"].add(site)


class _SchemaBuilder:
    def __init__(self, modules: list[Module]):
        from .callgraph import shared_package_graph

        self.graph = shared_package_graph(modules)
        self.modules = self.graph.modules
        self.by_rel = {m.rel: m for m in self.modules}
        self.consts = {
            m.repo_rel: _const_tuples(m.tree) for m in self.modules
        }
        self.ops: dict[str, _OpSchema] = {}

    # -- entry -------------------------------------------------------------

    def infer(self) -> dict | None:
        proto = self.by_rel.get(_PROTOCOL_FILE)
        if proto is None:
            return None
        registered = _frozenset_literal(proto.tree, "PROTOCOL_OPS")
        if not registered:
            return None
        dispatch = self.graph.by_fid.get(
            f"{proto.repo_rel}:{_DISPATCH_FN}"
        )
        if dispatch is None:
            return None
        for op in sorted(registered):
            self.ops[op] = _OpSchema()
        self._infer_handlers(dispatch, registered)
        self._scan_producers()
        return self._render()

    def _infer_handlers(self, dispatch: FuncInfo, registered) -> None:
        branches = {}
        for stmt in dispatch.node.body:
            if not isinstance(stmt, ast.If):
                continue
            t = stmt.test
            if (
                isinstance(t, ast.Compare)
                and isinstance(t.left, ast.Name)
                and t.left.id == "op"
                and len(t.ops) == 1
                and isinstance(t.ops[0], ast.Eq)
                and isinstance(t.comparators[0], ast.Constant)
                and isinstance(t.comparators[0].value, str)
            ):
                branches[t.comparators[0].value] = stmt.body
        for op in sorted(self.ops):
            schema = self.ops[op]
            visited: set[tuple[str, str]] = set()
            returns: list[tuple[ast.expr, str]] = []
            region = branches.get(op)
            if region is not None:
                self._walk_region(
                    region, dispatch, {"req"}, op, schema, visited,
                    returns,
                )
                self._region_returns(region, dispatch, returns)
            for fn in self._op_fallbacks(op):
                if (fn.fid, "req") not in visited:
                    visited.add((fn.fid, "req"))
                    self._walk_region(
                        fn.node.body, fn, {"req"}, op, schema, visited,
                        returns,
                    )
                self._collect_returns(fn, returns)
            self._infer_response(op, schema, returns)

    def _op_fallbacks(self, op: str) -> list[FuncInfo]:
        """The ``getattr(service, op)(req)`` trampoline targets: every
        serving-tier function named exactly like the op that takes a
        ``req`` parameter."""
        out = []
        for prefix in _HANDLER_PREFIXES:
            for fn in self.graph.functions_named(
                op, rel_prefix=prefix, with_param="req"
            ):
                if fn.module.rel != _PROTOCOL_FILE:
                    out.append(fn)
        return out

    # -- request-field dataflow --------------------------------------------

    def _walk_region(
        self, stmts, fn: FuncInfo, names: set[str], op: str,
        schema: _OpSchema, visited: set, returns: list,
    ) -> None:
        site = f"{fn.module.repo_rel}:{fn.qual}"
        consts = self.consts.get(fn.module.repo_rel, {})
        local_types = self.graph.local_types(fn)

        def const_elems(expr: ast.AST, env: dict) -> tuple[str, ...]:
            if isinstance(expr, ast.Name):
                if expr.id in consts:
                    return consts[expr.id]
                return env.get(expr.id, ())
            if isinstance(expr, (ast.Tuple, ast.List)) and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in expr.elts
            ):
                return tuple(e.value for e in expr.elts)
            return ()

        def guarded(stack: list, field: str) -> bool:
            for anc in stack:
                if not isinstance(anc, (ast.If, ast.IfExp)):
                    continue
                for sub in ast.walk(anc.test):
                    if (
                        isinstance(sub, ast.Compare)
                        and isinstance(sub.left, ast.Constant)
                        and sub.left.value == field
                        and any(isinstance(o, ast.In) for o in sub.ops)
                    ):
                        return True
            return False

        def visit(node: ast.AST, stack: list, env: dict) -> None:
            for child in ast.iter_child_nodes(node):
                child_env = env
                if isinstance(child, (ast.For, ast.comprehension)):
                    target = (
                        child.target if isinstance(child.target, ast.Name)
                        else None
                    )
                    it = child.iter
                    if target is not None:
                        elems = const_elems(it, env)
                        if elems:
                            child_env = dict(env)
                            child_env[target.id] = elems
                if isinstance(child, (ast.DictComp, ast.ListComp,
                                      ast.SetComp, ast.GeneratorExp)):
                    comp_env = dict(env)
                    for gen in child.generators:
                        if isinstance(gen.target, ast.Name):
                            elems = const_elems(gen.iter, comp_env)
                            if elems:
                                comp_env[gen.target.id] = elems
                    child_env = comp_env
                # req["field"] — a required read
                if (
                    isinstance(child, ast.Subscript)
                    and isinstance(child.ctx, ast.Load)
                    and isinstance(child.value, ast.Name)
                    and child.value.id in names
                ):
                    sl = child.slice
                    if isinstance(sl, ast.Constant) and isinstance(
                        sl.value, str
                    ):
                        if sl.value not in ENVELOPE:
                            schema.read(
                                sl.value,
                                required=not guarded(stack, sl.value),
                                site=site,
                            )
                    else:
                        for f in const_elems(sl, child_env):
                            if f not in ENVELOPE:
                                schema.read(f, False, site)
                # req.get("field" ...) — a defaulted read
                if (
                    isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                    and child.func.attr == "get"
                    and isinstance(child.func.value, ast.Name)
                    and child.func.value.id in names
                    and child.args
                ):
                    a0 = child.args[0]
                    if isinstance(a0, ast.Constant) and isinstance(
                        a0.value, str
                    ):
                        if a0.value not in ENVELOPE:
                            schema.read(a0.value, False, site)
                    else:
                        for f in const_elems(a0, child_env):
                            if f not in ENVELOPE:
                                schema.read(f, False, site)
                # "field" in req — a guard read
                if isinstance(child, ast.Compare) and any(
                    isinstance(o, ast.In) for o in child.ops
                ):
                    if (
                        isinstance(child.left, ast.Constant)
                        and isinstance(child.left.value, str)
                        and any(
                            isinstance(c, ast.Name) and c.id in names
                            for c in child.comparators
                        )
                        and child.left.value not in ENVELOPE
                    ):
                        schema.read(child.left.value, False, site)
                # the wire dict passed onward: follow into the callee
                if isinstance(child, ast.Call):
                    self._follow_call(
                        child, fn, names, local_types, op, schema,
                        visited, returns,
                    )
                visit(child, stack + [child], child_env)

        fake_root = ast.Module(body=list(stmts), type_ignores=[])
        visit(fake_root, [], {})

    def _follow_call(
        self, call, fn, names, local_types, op, schema, visited, returns,
    ) -> None:
        passed: list[tuple[int | str, str]] = []
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Name) and a.id in names:
                passed.append((i, a.id))
        for kw in call.keywords:
            if (
                kw.arg is not None
                and isinstance(kw.value, ast.Name)
                and kw.value.id in names
            ):
                passed.append((kw.arg, kw.value.id))
        if not passed:
            return
        callee_fid = self.graph.resolve(fn, call, local_types)
        if callee_fid is None:
            return
        callee = self.graph.by_fid[callee_fid]
        params = callee.params
        offset = 1 if callee.cls is not None and params[:1] == ["self"] \
            else 0
        for pos, _name in passed:
            if isinstance(pos, int):
                idx = pos + offset
                pname = params[idx] if idx < len(params) else None
            else:
                pname = pos if pos in params else None
            if pname is None or (callee_fid, pname) in visited:
                continue
            visited.add((callee_fid, pname))
            self._walk_region(
                callee.node.body, callee, {pname}, op, schema, visited,
                returns,
            )

    # -- response inference ------------------------------------------------

    def _collect_returns(self, fn: FuncInfo, returns: list) -> None:
        self._collect_returns_from(fn.node, fn, returns)

    def _region_returns(self, stmts, fn: FuncInfo, returns: list) -> None:
        fake = ast.Module(body=list(stmts), type_ignores=[])
        self._collect_returns_from(fake, fn, returns)

    def _collect_returns_from(self, root, fn, returns) -> None:
        def visit(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                if isinstance(child, ast.Return) and child.value is not None:
                    returns.append((child.value, fn))
                visit(child)

        visit(root)

    def _infer_response(self, op, schema, returns) -> None:
        seen_fids: set[str] = set()
        work = list(returns)
        depth = 0
        while work and depth < 6:
            depth += 1
            next_work: list = []
            for value, fn in work:
                self._one_return(
                    op, schema, value, fn, next_work, seen_fids
                )
            work = next_work
        if work:
            schema.response_complete = False

    def _one_return(self, op, schema, value, fn, next_work, seen) -> None:
        site = f"{fn.module.repo_rel}:{fn.qual}"
        if isinstance(value, ast.Dict):
            for k in value.keys:
                if k is None:  # **spread: not enumerable
                    schema.response_complete = False
                elif isinstance(k, ast.Constant) and isinstance(
                    k.value, str
                ):
                    schema.response.setdefault(k.value, set()).add(site)
                else:
                    schema.response_complete = False
            return
        if isinstance(value, ast.Call):
            # the `_partition_op(service, "<op>", req)` trampoline:
            # a string-literal argument equal to the op redirects to
            # the named-handler fallbacks
            if any(
                isinstance(a, ast.Constant) and a.value == op
                for a in value.args
            ):
                for target in self._op_fallbacks(op):
                    if target.fid not in seen:
                        seen.add(target.fid)
                        self._queue_returns(target, next_work)
                return
            resolved = self.graph.resolve(
                fn, value, self.graph.local_types(fn)
            )
            targets: list[FuncInfo] = []
            if resolved is not None:
                targets = [self.graph.by_fid[resolved]]
            elif isinstance(value.func, ast.Attribute):
                for prefix in _HANDLER_PREFIXES:
                    targets.extend(self.graph.functions_named(
                        value.func.attr, rel_prefix=prefix
                    ))
            if not targets:
                schema.response_complete = False
                return
            for target in targets:
                if target.fid not in seen:
                    seen.add(target.fid)
                    self._queue_returns(target, next_work)
            return
        schema.response_complete = False

    def _queue_returns(self, fn: FuncInfo, next_work: list) -> None:
        got: list = []
        self._collect_returns(fn, got)
        if not got:
            # a handler that returns nothing enumerable
            next_work.append((ast.Constant(value=None), fn))
        next_work.extend(got)

    # -- producers ---------------------------------------------------------

    def _scan_producers(self) -> None:
        from .core import qualname_index, symbol_at

        for m in self.modules:
            index = None
            for node in m.nodes:
                if not isinstance(node, ast.Dict):
                    continue
                ops_here: list[str] = []
                fields: list[str] = []
                for k, v in zip(node.keys, node.values):
                    if not (
                        isinstance(k, ast.Constant)
                        and isinstance(k.value, str)
                    ):
                        continue
                    if k.value == "op":
                        if isinstance(v, ast.Constant) and isinstance(
                            v.value, str
                        ):
                            ops_here.append(v.value)
                        elif isinstance(v, ast.IfExp):
                            for side in (v.body, v.orelse):
                                if isinstance(
                                    side, ast.Constant
                                ) and isinstance(side.value, str):
                                    ops_here.append(side.value)
                    elif k.value not in ENVELOPE:
                        fields.append(k.value)
                ops_here = [o for o in ops_here if o in self.ops]
                if not ops_here:
                    continue
                if index is None:
                    index = qualname_index(m.tree)
                site = f"{m.repo_rel}:{symbol_at(index, node.lineno)}"
                for o in ops_here:
                    schema = self.ops[o]
                    for f in fields:
                        schema.producers.setdefault(f, set()).add(site)
                    if not fields:
                        schema.producers.setdefault("", set()).add(site)

    # -- rendering ---------------------------------------------------------

    def _render(self) -> dict:
        ops_doc = {}
        for op in sorted(self.ops):
            s = self.ops[op]
            produced_sites = sorted(
                {x for f, sites in s.producers.items() for x in sites}
            )
            ops_doc[op] = {
                "request": {
                    f: {
                        "required": s.request[f]["required"],
                        "consumers": sorted(s.request[f]["consumers"]),
                        "producers": sorted(s.producers.get(f, ())),
                    }
                    for f in sorted(s.request)
                },
                "response": {
                    f: {"producers": sorted(s.response[f])}
                    for f in sorted(s.response)
                },
                "response_complete": s.response_complete,
                "produced_by": produced_sites,
                "extra_produced": sorted(
                    f for f in s.producers
                    if f and f not in s.request
                ),
            }
        return {
            "_doc": [
                "Inferred JSONL wire schema (analysis/wireschema.py, "
                "DESIGN.md §27).",
                "Regenerate with `dpathsim-torch lint --write-wire-schema`. "
                "The lint gate fails on backward-incompatible drift "
                "(WC101) and on a stale file (WC102).",
                "request fields: required=false means defaulted "
                "(yesterday's clients may omit it). consumers/producers "
                "are <path>:<qualname> sites.",
            ],
            "envelope": list(ENVELOPE),
            "ops": ops_doc,
        }


def infer_schema(modules: list[Module]) -> dict | None:
    """The inferred schema document, or None when the analyzed tree has
    no protocol module (fixture corpora for other rules)."""
    return _SchemaBuilder(modules).infer()


def render_schema(schema: dict) -> str:
    return json.dumps(schema, indent=2, sort_keys=True) + "\n"


def schema_path_for(modules: list[Module]) -> pathlib.Path | None:
    """Derive ``<repo>/artifacts/wire_schema_torch.json`` from the analyzed
    protocol module's location (fixture trees carry their own)."""
    for m in modules:
        if m.rel == _PROTOCOL_FILE and m.root_kind == "package":
            parts = pathlib.PurePosixPath(m.repo_rel).parts
            root = m.path.resolve().parents[len(parts) - 1]
            return root / SCHEMA_REL
    return None


class WireSchemaPass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        builder = _SchemaBuilder(modules)
        inferred = builder.infer()
        if inferred is None:
            return []
        findings: list[Finding] = []
        self._dead_fields(builder, findings)
        path = schema_path_for(builder.modules)
        if path is None or not path.exists():
            # no checked-in contract to gate against (the byte-stable
            # regeneration test is what forces the real repo's file to
            # exist and match)
            return sorted(findings)
        try:
            recorded = json.loads(path.read_text(encoding="utf-8"))
        except ValueError:
            findings.append(Finding(
                path=SCHEMA_REL, line=1, rule="WC102",
                symbol="<schema>",
                message=(
                    "wire_schema_torch.json is not valid JSON — "
                    "regenerate"
                ),
            ))
            return sorted(findings)
        self._diff(recorded, inferred, findings)
        return sorted(findings)

    # -- drift -------------------------------------------------------------

    def _diff(self, recorded: dict, inferred: dict, findings) -> None:
        rec_ops = recorded.get("ops") or {}
        inf_ops = inferred.get("ops") or {}

        def incompatible(msg: str) -> None:
            findings.append(Finding(
                path=SCHEMA_REL, line=1, rule="WC101",
                symbol="<schema>", message=msg,
            ))

        def outdated(msg: str) -> None:
            findings.append(Finding(
                path=SCHEMA_REL, line=1, rule="WC102",
                symbol="<schema>", message=msg,
            ))

        for op in sorted(rec_ops):
            if op not in inf_ops:
                incompatible(
                    f"op {op!r} dropped from the protocol — clients "
                    "built against the recorded schema still send it"
                )
                continue
            rec, inf = rec_ops[op], inf_ops[op]
            rec_req = rec.get("request") or {}
            inf_req = inf.get("request") or {}
            for f in sorted(rec_req):
                if f not in inf_req:
                    incompatible(
                        f"request field {op}.{f!r} removed — recorded "
                        "consumers no longer read it; senders that set "
                        "it are now silently ignored"
                    )
                elif (
                    not rec_req[f].get("required")
                    and inf_req[f].get("required")
                ):
                    incompatible(
                        f"request field {op}.{f!r} turned required — "
                        "clients built against the recorded schema may "
                        "omit it and now break"
                    )
                elif (
                    rec_req[f].get("required")
                    and not inf_req[f].get("required")
                ):
                    outdated(
                        f"request field {op}.{f!r} relaxed to optional "
                        "— regenerate the schema file"
                    )
            for f in sorted(inf_req):
                if f not in rec_req:
                    outdated(
                        f"new request field {op}.{f!r} not in the "
                        "schema file — regenerate"
                    )
            if rec.get("response_complete") and inf.get(
                "response_complete"
            ):
                rec_resp = rec.get("response") or {}
                inf_resp = inf.get("response") or {}
                for f in sorted(rec_resp):
                    if f not in inf_resp:
                        incompatible(
                            f"response field {op}.{f!r} removed — "
                            "recorded consumers expect it"
                        )
                for f in sorted(inf_resp):
                    if f not in rec_resp:
                        outdated(
                            f"new response field {op}.{f!r} not in the "
                            "schema file — regenerate"
                        )
        for op in sorted(inf_ops):
            if op not in rec_ops:
                outdated(
                    f"new op {op!r} not in the schema file — regenerate"
                )

    # -- dead fields -------------------------------------------------------

    def _dead_fields(self, builder: _SchemaBuilder, findings) -> None:
        for op in sorted(builder.ops):
            s = builder.ops[op]
            produced = {f for f in s.producers if f}
            consumed = set(s.request)
            for f in sorted(produced - consumed):
                site = sorted(s.producers[f])[0]
                path, qual = site.split(":", 1)
                findings.append(Finding(
                    path=path, line=1, rule="WC103", symbol=qual,
                    message=(
                        f"request field {op}.{f!r} is produced here but "
                        "read by no handler — a typo'd or obsolete key "
                        "the far end silently ignores"
                    ),
                ))
            if not s.producers:
                continue  # nobody in-repo sends this op: client-only
            for f in sorted(consumed - produced):
                site = sorted(s.request[f]["consumers"])[0]
                path, qual = site.split(":", 1)
                findings.append(Finding(
                    path=path, line=1, rule="WC103", symbol=qual,
                    message=(
                        f"request field {op}.{f!r} is read here but "
                        "produced by no in-repo sender — dead handler "
                        "path, or a deliberately client-only field "
                        "(baseline it with the reason)"
                    ),
                ))
