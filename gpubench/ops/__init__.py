"""Traffic generators, one module each, named by a traffic mix's ``op``
(``traffic/<mix>.json``). Each has ``Op(mix, cfg, seed, seconds)``, made
before the port's set-up, with:

- ``bind(backend, driver)``: the one call that the window repeats, back
  to back, on the port's backend and driver;
- ``keep(output)``: after each call, what the comparison needs of its
  output (allocating nothing that lives on where it can);
- ``compare(reference, limits, calls)``: once the window has closed, the
  kept outputs against the configuration's plain reference; returns the
  checks ``{name: {"value", "limit"}}`` and their parts for the log;
- ``record()``: the work of one call and the sizes that the metric
  readers take (``metrics/<metric>.py``), merged into the run's record.
"""
