"""Run configuration.

The reference hard-codes everything — dataset path, source author, output
path, engine package pin (``DPathSim_APVPA.py:141-176``). This is the
config the CLI fills in, also constructible programmatically.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RunConfig:
    dataset: str  # GEXF path
    backend: str = "torch"  # see backends.available_backends()
    metapath: str = "APVPA"
    variant: str = "rowsum"  # reference semantics; "diagonal" = Sun et al.
    source: str | None = None  # node label (like the reference) …
    source_id: str | None = None  # … or node id
    output: str | None = None  # reference-grammar log path
    metrics: str | None = None  # JSONL metrics path
    all_pairs: bool = False
    top_k: int = 0
    n_devices: int | None = None  # torch-sharded: shards of the mesh
    loader: str = "auto"  # GEXF loader: auto | python | native
    platform: str = "cuda"  # device of the device backends: cuda | cpu
    tile_rows: int | None = None  # torch-sparse: rows per streaming tile
    approx: bool = False  # device backends: waive the f32 2^24 count guard
    dtype: str | None = None  # carry dtype name; None = the backend's own
    # torch-sparse resident factor layout: None resolves through the
    # tuning registry ("coo", the only layout ported)
    factor_format: str | None = None
    # delta-ingestion capacity reserve (data/delta.with_headroom); the
    # serve CLI sets 0.25, the batch CLI leaves it off
    headroom: float = 0.0
    echo: bool = True
    # Resilience knobs (see resilience/): None = PATHSIM_MAX_RETRIES env
    # default (3 attempts total); degrade=False makes backend-init
    # failures fatal instead of stepping down the chain.
    max_retries: int | None = None
    degrade: bool = True
    # Measured-dispatch knobs (tuning/): path of a tuning table (None =
    # honor PATHSIM_TUNING_TABLE, else built-in heuristics);
    # tuning=False pins every knob to its heuristic.
    tuning_table: str | None = None
    tuning: bool = True
