"""Corpus-scale batch tier: campaigns over every row at once.

The port of the JAX package's ``batch/``. The DP metapath planner and
the packed factor formats were built to answer one request at a time;
this package points the same primitives at the *whole corpus*:
``topk-all`` (top-k for every source row, a blocked GEMM sweep) and ``simjoin`` (every pair scoring ≥ τ, with
provably score-safe block pruning). Campaigns checkpoint per row block
through :class:`~..utils.checkpoint.CheckpointManager` and resume
bit-identically after preemption (DESIGN.md §31).
"""

from .campaign import (  # noqa: F401
    BatchEngine,
    CampaignResult,
    CampaignSpec,
    run_topk_campaign,
)
from .simjoin import run_simjoin_campaign  # noqa: F401
