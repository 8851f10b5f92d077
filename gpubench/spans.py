"""The port's own spans, as the per-layer readers of a ``--trace 1`` run
take them: from the port's tracer, in the process that ran the cell.

``run_cell`` turns the tracer on (with ``device_annotations``, so a span
opened with the card times its stretch of the card's stream: its
``device_s``) before the port's set-up, and clears the tracer's ring when
the window starts. After the run the ring holds the window's spans, and
the tracer's totals by name (which no clear drops) hold set-up's and the
window's: set-up's are the difference. The names come from the port
(``obs/trace.py``'s ``FOLD_SPANS``, ``FACTOR_SPANS``,
``RESULT_PATH_SPANS``), so a rename there reaches these readers.

A program without span totals or these names reads None, and its runs
leave the metrics out.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PortSpans:
    fold: tuple
    factor: tuple
    result_path: tuple
    totals: dict  # name → {"count", "host_s", "device_s"}
    window: list  # the ring: the window's spans


def port_spans() -> PortSpans | None:
    try:
        from distributed_pathsim_tpu_torch.obs import trace

        tracer = trace.get_tracer()
        return PortSpans(trace.FOLD_SPANS, trace.FACTOR_SPANS,
                         trace.RESULT_PATH_SPANS, tracer.totals(),
                         tracer.spans())
    except (ImportError, AttributeError):
        return None


def setup_sum(got: PortSpans, names: tuple, key: str) -> float | None:
    """Set-up's sum of ``key`` (``host_s`` or ``device_s``) over the spans
    named ``names``: the totals less the window's spans. None where
    set-up has no such span, or none with that figure."""
    count = value = 0
    found = False
    for name in names:
        total = got.totals.get(name)
        if total is None:
            continue
        count += total["count"]
        if total[key] is not None:
            found = True
            value += total[key]
    for sp in got.window:
        if sp.name in names:
            count -= 1
            part = sp.duration_s if key == "host_s" else sp.device_s
            value -= part or 0.0
    return value if found and count > 0 else None
