"""The port's static analyzer: the JAX package's invariant checks
(DESIGN.md §25), held against the port.

One framework, one suppression story, for every machine-checkable
contract the port's value rests on. The rules keep the JAX analyzer's
ids and give its findings wherever they mean the same thing; only the
recompile rules are re-keyed, to the port's compile points:

- **recompile-safety** (recompile.py): tuning-knob resolution stays
  outside what a CUDA graph captures, pad/shape decisions in the
  serving tier go through the sanctioned bucket helpers, arguments of
  compile-cached functions stay hashable — the zero-steady-state-
  recompile contract (``utils/compile_counter``: kernel builds, library
  loads, graph captures), checked at the AST instead of only by
  compile-counter smoke tests.
- **lock discipline** (locks.py): for every class owning a
  ``threading.Lock``/``RLock``, attributes written under the lock must
  not be touched on paths that provably don't hold it.
- **determinism** (determinism.py): no unordered set/dict iteration
  into fingerprints/wire payloads, no score selection outside the
  shared ops/pathsim primitives, no wall-clock or unseeded RNG in
  deterministic paths.
- **wire contract** (wire.py): every protocol op registered in
  ``PROTOCOL_OPS``, wire-field reads defaulted (old clients keep
  working), stdout of wire-owning processes print-free.
- **interprocedural lock order** (interlocks.py, on callgraph.py):
  whole-repo held-locks-at-entry fixpoint, the global
  lock-acquisition-order graph (LD101 cycles = potential deadlock),
  blocking calls (LD102) and transport round-trips (LD103) reachable
  while a lock is held — DESIGN.md §27.
- **wire-schema gate** (wireschema.py): the per-op request/response
  field schema inferred by dataflow and checked in as the byte-stable
  ``artifacts/wire_schema_torch.json``; backward-incompatible drift
  fails the build (WC101), stale files flag (WC102), dead fields flag
  (WC103).
- **exception safety** (exceptions.py): bare acquires (EX001), leaked
  handles (EX002), and pending-table registrations whose removal an
  exception can skip (EX003) — exactly-once on every exit path.
- **telemetry** (telemetry.py) and **tuning constants**
  (tuning_constants.py): the JAX package's migrated lint-script rules,
  absorbed so there is ONE analyzer.
- **doorways** (partition.py, metapath_ir.py, compress_rules.py,
  compaction_rules.py, batch_rules.py, learned_rules.py): each
  layout's or engine's internals are reached only through its
  sanctioned surface.

Run it as ``python -m distributed_pathsim_tpu_torch.cli lint``
(``dpathsim-torch lint``; ``--sarif PATH`` also writes a SARIF report).
It is pure AST work: it imports no kernel, builds no backend and never
creates a CUDA context. See core.py for the Finding model, baseline
semantics, and renderers, cache.py for the parse/mtime cache, and
callgraph.py for the interprocedural engine.
"""

from .core import (  # noqa: F401
    Finding,
    Module,
    default_roots,
    load_baseline,
    load_modules,
    render_human,
    render_json,
    run_analysis,
)
from .cache import load_modules_cached  # noqa: F401
from .callgraph import CallGraph, propagate_reachability  # noqa: F401
from .registry import ALL_PASSES, MIGRATED_RULES, RULES  # noqa: F401
from .sarif import render_sarif  # noqa: F401
from .wireschema import infer_schema, render_schema  # noqa: F401
