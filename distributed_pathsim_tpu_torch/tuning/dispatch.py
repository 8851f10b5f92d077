"""Runtime dispatch: the one process-wide tuning-table consultation.

Consumers (the planner, backend builds, serving warmup) call
:func:`choose` with the knob name, their shape context, and their own
heuristic as ``default``. Resolution ladder:

- exact key hit → the tuned choice (``dpathsim_tuning_lookups_total``
  counter, result="hit");
- miss → nearest-bucket interpolation within the same (knob, device,
  dtype) (result="nearest");
- a choice the caller's ``valid`` (or, for a nearest bucket's,
  ``valid_near``) refuses → the caller's heuristic (result="fallback");
- nothing applicable, tuning disabled, or no table installed → the
  caller's heuristic (result="default").

A table that was *requested* but unusable (absent / corrupt /
version-mismatched) degrades to heuristics with a single
``tuning_fallback`` runtime event for the whole process — loud once,
silent after, never a crash.

The device half of every key is :func:`device_kind`: the card's name
(``torch.cuda.get_device_name``) on the card, ``"cpu"`` on the host —
the process's platform, set by the engine (:func:`set_device`) before
any backend is built.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from .registry import KNOBS
from .table import TableError, TuningTable, load_table, make_key

TUNING_TABLE_ENV = "PATHSIM_TUNING_TABLE"


class _State:
    def __init__(self):
        self.enabled = True
        self.table: TuningTable | None = None
        self.source: str | None = None
        self.fallback_emitted = False
        self.lock = threading.Lock()


_state = _State()
_device_kind_cache: str | None = None


def set_device(device) -> None:
    """Key tables on ``device``: the card's name for a CUDA device,
    ``"cpu"`` otherwise. The engine calls this with the run's platform
    before any backend is built, so ``--platform cpu`` on a machine with
    a card keys its lookups on the host."""
    global _device_kind_cache
    import torch

    dev = torch.device(device)
    _device_kind_cache = (
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    )


def device_kind() -> str:
    """The process's device kind (the card's name, or 'cpu'), cached —
    tuning keys are per-device by construction. Without
    :func:`set_device` it is the first card's name when one is present,
    else 'cpu'."""
    global _device_kind_cache
    if _device_kind_cache is None:
        import torch

        _device_kind_cache = (
            torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu"
        )
    return _device_kind_cache


_counter_cells: dict[tuple[str, str], Any] = {}


def _count(knob: str, result: str) -> None:
    # choose() sits on per-batch serving paths (the fused_topk
    # wrapper), so cells are bound once per (knob, result) and the hot
    # path pays one dict hit + one increment — the registry's stated
    # hot-path discipline. reset() zeroes registry cells in place, so
    # cached cells stay live across test resets.
    cell = _counter_cells.get((knob, result))
    if cell is None:
        from ..obs.metrics import get_registry

        cell = get_registry().counter(
            "dpathsim_tuning_lookups_total",
            "tuning-table lookups by knob and resolution",
        ).labels(knob=knob, result=result)
        _counter_cells[(knob, result)] = cell
    cell.inc()


def _emit_fallback(source: str, reason: str) -> None:
    """One structured event per process: operators must see that a run
    they believed tuned is on heuristics, without a crash and without
    per-lookup log spam."""
    from ..utils.logging import runtime_event

    with _state.lock:
        already = _state.fallback_emitted
        _state.fallback_emitted = True
    if not already:
        runtime_event("tuning_fallback", table=source, reason=reason)
    _count("_table", "fallback")


def set_enabled(enabled: bool) -> None:
    """``--no-tuning``: heuristics everywhere, no events, no table."""
    _state.enabled = bool(enabled)


def set_table(table: TuningTable | None, source: str | None = None) -> None:
    """Install an in-memory table (tests, the autotuner's self-check)."""
    _state.table = table
    _state.source = source


def active_table() -> TuningTable | None:
    return _state.table if _state.enabled else None


def reset() -> None:
    """Back to process defaults (tests)."""
    _state.enabled = True
    _state.table = None
    _state.source = None
    _state.fallback_emitted = False


def install_table(path: str | None, required_source: str = "flag") -> bool:
    """Load ``path`` as the process's dispatch table. On any defect:
    heuristics + the single ``tuning_fallback`` event. Returns whether
    a table is now active."""
    if path is None:
        return _state.table is not None
    try:
        table = load_table(path, device_kind())
    except TableError as exc:
        # drop any previously installed table too: the fallback event
        # says this process is on heuristics, and keeping an older
        # table active would make that a lie
        set_table(None)
        _emit_fallback(path, f"{required_source}: {exc}")
        return False
    set_table(table, source=path)
    from ..utils.logging import runtime_event

    runtime_event(
        "tuning_table_loaded",
        echo=False,
        table=path,
        digest=table.digest,
        entries=len(table.entries),
        device=table.device_kind,
    )
    return True


def install_from_env() -> bool:
    """Honor ``PATHSIM_TUNING_TABLE`` when no table was given
    explicitly — the deploy-wide default path."""
    import os

    path = os.environ.get(TUNING_TABLE_ENV)
    if not path or _state.table is not None:
        return _state.table is not None
    return install_table(path, required_source="env")


def choose(
    knob: str,
    *,
    n: int | None = None,
    v: int | None = None,
    nnz: int | None = None,
    dtype: str = "float32",
    default: Any | Callable[[], Any] = None,
    valid: Callable[[Any], bool] | None = None,
    valid_near: Callable[[Any], bool] | None = None,
) -> Any:
    """Resolve one knob for one shape. ``default`` is the caller's own
    heuristic (value or thunk) — returned verbatim on any miss, so an
    untuned process behaves exactly as it did before this subsystem.
    ``valid``: the caller's test of a tuned choice; one it refuses (a JAX
    table's arm that would put a plain version on the card) counts as a
    ``fallback`` lookup and the default is returned. ``valid_near``: a
    further test of a choice taken from the nearest bucket, not this
    shape's own (a choice that only holds at the shape it was measured
    at); one it refuses is a ``fallback`` lookup too."""
    if knob not in KNOBS:
        raise KeyError(f"unknown tuning knob {knob!r}; see tuning.registry")

    def _default():
        return default() if callable(default) else default

    table = active_table()
    if table is None:
        if _state.enabled:
            _count(knob, "default")
        return _default()
    key = make_key(knob, device_kind(), n=n, v=v, nnz=nnz, dtype=str(dtype))
    ent = table.lookup(key)
    if ent is not None:
        choice, result = _decode(ent.choice), "hit"
    else:
        near = table.nearest(key)
        if near is None:
            _count(knob, "default")
            return _default()
        choice, result = _decode(near[0].choice), "nearest"
    if (valid is not None and not valid(choice)) or (
            result == "nearest" and valid_near is not None
            and not valid_near(choice)):
        _count(knob, "fallback")
        return _default()
    _count(knob, result)
    return choice


def _decode(choice: Any) -> Any:
    # JSON has no tuples; tile pairs round-trip as lists.
    if isinstance(choice, list):
        return tuple(choice)
    return choice


def lookup_stats() -> dict[str, int]:
    """Per-result lookup counts from the obs registry (tests and the
    ``stats()`` serving block read this instead of private state)."""
    from ..obs.metrics import get_registry

    counter = get_registry().counter(
        "dpathsim_tuning_lookups_total",
        "tuning-table lookups by knob and resolution",
    )
    out: dict[str, int] = {}
    for labels, cell in counter.cells():
        result = dict(labels).get("result", "?")
        out[result] = out.get(result, 0) + int(cell.get())
    return out
