"""Rule catalog: every pass, every rule id, and the migration map.

``RULES`` is the one authoritative id → doc table (the CLI's
``--list-rules``, the human renderer's "why" lines, and the test
suite's fixture-coverage assertion all read it). ``MIGRATED_RULES``
records which legacy ad-hoc lint rule each unified rule subsumes — the
subsumption test walks it to prove the old scripts' checks all
survived the migration.
"""

from __future__ import annotations

import dataclasses

from .batch_rules import BatchDoorwayPass
from .compaction_rules import CompactionDoorwayPass
from .compress_rules import CompressedLayoutPass
from .determinism import DeterminismPass
from .exceptions import ExceptionSafetyPass
from .interlocks import InterLockPass
from .learned_rules import LearnedDoorwayPass
from .locks import LockDisciplinePass
from .metapath_ir import MetapathIRPass
from .partition import PartitionOwnershipPass
from .recompile import RecompileSafetyPass
from .telemetry import TelemetryPass
from .tuning_constants import TuningConstantsPass
from .wire import WireContractPass
from .wireschema import WireSchemaPass


@dataclasses.dataclass(frozen=True)
class RuleDoc:
    id: str
    title: str
    why: str
    pass_name: str


# rule-family display names for the grouped `--list-rules` catalog
PASS_FAMILIES: dict[str, str] = {
    "RecompileSafetyPass": "recompile-safety (RS)",
    "LockDisciplinePass": "lock discipline, intra-class (LD001+)",
    "InterLockPass": "lock order / blocking-under-lock, "
                     "interprocedural (LD101+)",
    "DeterminismPass": "determinism (DT)",
    "WireContractPass": "wire contract, syntactic (WC001+)",
    "WireSchemaPass": "wire schema inference + compat gate (WC101+)",
    "TelemetryPass": "telemetry (TL)",
    "TuningConstantsPass": "tuning constants (TN)",
    "PartitionOwnershipPass": "partition ownership (PT)",
    "ExceptionSafetyPass": "exception safety / exactly-once (EX)",
    "MetapathIRPass": "metapath planner IR, interprocedural (MP)",
    "CompressedLayoutPass": "compressed factor layouts, "
                            "interprocedural (CF)",
    "CompactionDoorwayPass": "compaction swap doorway (CP)",
    "BatchDoorwayPass": "batch block-sweep doorway (BT)",
    "LearnedDoorwayPass": "learned score doorway (LN)",
}

ALL_PASSES = (
    RecompileSafetyPass(),
    LockDisciplinePass(),
    InterLockPass(),
    DeterminismPass(),
    WireContractPass(),
    WireSchemaPass(),
    TelemetryPass(),
    TuningConstantsPass(),
    PartitionOwnershipPass(),
    ExceptionSafetyPass(),
    MetapathIRPass(),
    CompressedLayoutPass(),
    CompactionDoorwayPass(),
    BatchDoorwayPass(),
    LearnedDoorwayPass(),
)

RULES: dict[str, RuleDoc] = {}
for _p in ALL_PASSES:
    for _rid, (_title, _why) in _p.rules.items():
        RULES[_rid] = RuleDoc(
            id=_rid, title=_title, why=_why,
            pass_name=type(_p).__name__,
        )

# legacy rule (scripts/lint_telemetry.py, scripts/lint_tuning.py) →
# the unified rule that subsumes it
MIGRATED_RULES: dict[str, str] = {
    "wall-clock-duration": "DT003",       # lint_telemetry R1
    "raw-stderr-print": "TL001",          # lint_telemetry R2
    "event-sink-bypass": "TL002",         # lint_telemetry R3
    "raw-stream-write": "WC004",          # lint_telemetry R4
    "router-raw-print": "WC003",          # lint_telemetry R5
    "index-raw-print": "WC003",           # lint_telemetry R6
    "obs-raw-print": "WC003",             # lint_telemetry R7
    "protocol-op-registry": "WC001",      # lint_telemetry R8
    "hardcoded-tuning-constant": "TN001", # lint_tuning
}
