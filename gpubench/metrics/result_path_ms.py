"""``result_path_ms``: a rank-all's milliseconds on the result path, as
the card's stream spends them: the ``device_s`` of the window's
``backend.result_alloc``, ``backend.fetch``, ``backend.drain`` and
``driver.to_f64`` spans, summed and divided by the calls.

A span's ``device_s`` runs from the moment the card's stream reaches
the span's opening to the moment it reaches its closing: the copies the
span enqueued there, and the time the stream stood idle waiting for the
host inside it. Kernels enqueued before the span (a tile in flight while
the host drains the one before) are not counted: the span's opening
event waits for them. The spans do not nest, so the sum is their union
on the stream. Read from the port's tracer (:mod:`gpubench.spans`);
None where no such span has device time."""

from gpubench import spans


def read(run: dict) -> float | None:
    got = spans.port_spans()
    if got is None or run["calls"] <= 0:
        return None
    times = [sp.device_s for sp in got.window
             if sp.name in got.result_path and sp.device_s is not None]
    return 1e3 * sum(times) / run["calls"] if times else None
