"""Measured dispatch: the tuning table and its runtime consultation.

- :mod:`.registry` — the knobs that have a decision point in the port
  (planner cost model, streaming tile height and scatter-pad floor,
  factor format, serving bucket geometry), each with the JAX package's
  name, key format and untuned default;
- :mod:`.table` + :mod:`.dispatch` — the versioned on-disk table
  (fingerprint: torch major.minor + the device kind) and
  :func:`choose`: exact hit → tuned choice, miss → nearest bucket,
  unusable table → the built-in heuristics with one
  ``tuning_fallback`` event.

- :mod:`.autotuner` — the offline measurement (``dpathsim-torch
  tune``): interleaved arms, median-of-best (utils/benchrunner.py), one
  racer per knob family, the kernel knobs' arms on the card only;
- :mod:`.sweep` — the bigger offline sweep, the tuned-serving smoke and
  the tuned-vs-default K1 comparison (``python -m
  distributed_pathsim_tpu_torch.tuning.sweep``).

Neither is imported here: the CLI imports the autotuner when ``tune``
runs.

Tuning is bit-invisible: every choice routes between implementations
that share the exact integer-count + f64-normalize scoring primitives.
"""

from .dispatch import (  # noqa: F401
    TUNING_TABLE_ENV,
    active_table,
    choose,
    device_kind,
    install_from_env,
    install_table,
    lookup_stats,
    reset,
    set_device,
    set_enabled,
    set_table,
)
from .registry import KNOBS, resolve_ladder  # noqa: F401
from .table import (  # noqa: F401
    SCHEMA_VERSION,
    TableError,
    TuningTable,
    load_table,
    make_key,
)
