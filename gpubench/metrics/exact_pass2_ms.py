"""``exact_pass2_ms``: a rank-all's milliseconds in pass 2 of the exact
K1 (the stable sort of its f64 candidates), as the card's stream spends
them: the ``device_s`` of the window's pass-2 spans (the port's
``obs/trace.py`` ``PASS2_SPAN``), summed and divided by the calls. None
where the program has no such span: a cell that never ranks on the exact
instance, or a program before it."""

from gpubench import spans


def read(run: dict) -> float | None:
    got = spans.port_spans()
    if got is None or run["calls"] <= 0:
        return None
    from distributed_pathsim_tpu_torch.obs import trace

    name = getattr(trace, "PASS2_SPAN", None)
    times = [sp.device_s for sp in got.window
             if sp.name == name and sp.device_s is not None]
    return 1e3 * sum(times) / run["calls"] if times else None
