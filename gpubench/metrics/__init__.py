"""Metric readers, one module each, named as the metric in
``BENCHMARK.json``: the end-to-end metrics (read in a ``--trace 0`` run)
and the per-layer ones (read in a ``--trace 1`` run) alike. Each has
``read(run) -> float | None``: ``run`` is the record that
:func:`gpubench.harness.run_cell` fills (the window's calls and seconds,
the set-up's parts, the traffic generator's ``record()``, the trace's
summary, the card's peaks); None means that the run holds nothing to
read, and the metric is left out of the line."""
