"""Versioned, content-addressed on-disk dispatch table.

One JSON document per (device, torch-version) pair mapping tuning keys —
``knob|device|n{bucket}|v{bucket}|d{bucket}|dtype`` — to the measured
best choice plus its per-arm timings (so a table is auditable: every
choice carries the numbers that picked it).

Integrity ladder (each failure degrades to the built-in heuristics with
a single ``tuning_fallback`` runtime event — never a crash):

- unparsable / missing-field / wrong-digest JSON → ``corrupt``;
- ``schema_version`` ≠ ours → ``schema-mismatch`` (an old reader must
  not guess at a new writer's semantics);
- torch major.minor or device kind ≠ the running process →
  ``fingerprint-mismatch`` (timings from another device/runtime are not
  evidence here). A table the JAX package wrote carries a jax version
  and no torch version: it is a fingerprint mismatch too, never an
  error.

The digest is sha256 over the canonically-serialized entries — the
table's content address. Writes go through a temp file + ``os.replace``
so a crashed writer can never leave a half-written table that then
silently half-loads.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import tempfile
from typing import Any

SCHEMA_VERSION = 1

_ESTIMATOR = "interleaved-arms median-of-best"


class TableError(Exception):
    """A table that must not be used, with the reason ('corrupt',
    'schema-mismatch', 'fingerprint-mismatch', 'absent')."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


def torch_fingerprint() -> str:
    """torch major.minor — the runtime half of the table fingerprint
    (library kernels shift across minor releases; patch releases don't
    invalidate measurements)."""
    import torch

    return ".".join(str(torch.__version__).split("+")[0].split(".")[:2])


def normalize_device(kind: str) -> str:
    return kind.strip().replace(" ", "_").lower() or "unknown"


def n_bucket(n: int | None) -> str:
    """Power-of-two size bucket: the exponent of the next pow-2 ≥ n.
    Shape sensitivity of kernel choice is multiplicative, so pow-2
    buckets give nearest-neighbor lookups a meaningful metric."""
    if n is None or n <= 0:
        return "na"
    return str((int(n) - 1).bit_length())


def density_bucket(n: int | None, v: int | None, nnz: int | None) -> str:
    """Decade bucket of nnz/(n*v) (0 = dense, -3 = one-in-a-thousand).
    'na' when the caller has no sparsity to speak of (dense tiers)."""
    if nnz is None or not n or not v:
        return "na"
    density = max(float(nnz) / (float(n) * float(v)), 1e-12)
    return str(max(-12, min(0, round(math.log10(density)))))


def make_key(
    knob: str,
    device: str,
    n: int | None = None,
    v: int | None = None,
    nnz: int | None = None,
    dtype: str = "float32",
) -> str:
    return "|".join(
        (
            knob,
            normalize_device(device),
            f"n{n_bucket(n)}",
            f"v{n_bucket(v)}",
            f"d{density_bucket(n, v, nnz)}",
            str(dtype),
        )
    )


def _parse_key(key: str) -> tuple[str, str, str, str, str, str] | None:
    parts = key.split("|")
    if len(parts) != 6:
        return None
    return tuple(parts)  # type: ignore[return-value]


def _axis_distance(a: str, b: str) -> int:
    """Distance between two bucket labels on one key axis. 'na' vs a
    number is a real mismatch (worth more than several bucket steps),
    'na' vs 'na' is a match."""
    if a == b:
        return 0
    if a == "na" or b == "na":
        return 8
    return abs(int(a) - int(b))


@dataclasses.dataclass
class Entry:
    choice: Any
    metric_ms: float | None = None
    arms: dict[str, float] | None = None

    def to_json(self) -> dict:
        out: dict[str, Any] = {"choice": self.choice}
        if self.metric_ms is not None:
            out["metric_ms"] = round(float(self.metric_ms), 6)
        if self.arms:
            out["arms"] = {k: round(float(v), 6) for k, v in self.arms.items()}
        return out

    @classmethod
    def from_json(cls, d: dict) -> "Entry":
        return cls(
            choice=d["choice"],
            metric_ms=d.get("metric_ms"),
            arms=d.get("arms"),
        )


def _entries_digest(entries: dict[str, dict]) -> str:
    blob = json.dumps(entries, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


class TuningTable:
    """In-memory dispatch table: exact-key lookup + nearest-bucket
    interpolation within (knob, device, dtype)."""

    def __init__(self, device_kind: str, torch_version: str | None = None):
        self.device_kind = normalize_device(device_kind)
        self.torch_version = torch_version or torch_fingerprint()
        self.entries: dict[str, Entry] = {}

    def put(self, key: str, choice: Any, metric_ms: float | None = None,
            arms: dict[str, float] | None = None) -> None:
        if _parse_key(key) is None:
            raise ValueError(f"malformed tuning key {key!r}")
        self.entries[key] = Entry(choice=choice, metric_ms=metric_ms,
                                  arms=arms)

    def lookup(self, key: str) -> Entry | None:
        return self.entries.get(key)

    def nearest(self, key: str) -> tuple[Entry, str] | None:
        """Closest same-(knob, device, dtype) entry by L1 bucket
        distance over (N, V, density); deterministic tie-break on the
        key string so a lookup never flaps between equidistant
        entries. Returns (entry, its key) or None."""
        want = _parse_key(key)
        if want is None:
            return None
        knob, device, nb, vb, db, dtype = want
        best: tuple[int, str] | None = None
        for cand_key in self.entries:
            got = _parse_key(cand_key)
            if got is None:
                continue
            if (got[0], got[1], got[5]) != (knob, device, dtype):
                continue
            dist = (
                _axis_distance(nb[1:], got[2][1:])
                + _axis_distance(vb[1:], got[3][1:])
                + _axis_distance(db[1:], got[4][1:])
            )
            if best is None or (dist, cand_key) < best:
                best = (dist, cand_key)
        if best is None:
            return None
        return self.entries[best[1]], best[1]

    @property
    def digest(self) -> str:
        return _entries_digest(
            {k: self.entries[k].to_json() for k in sorted(self.entries)}
        )

    def to_json(self) -> dict:
        entries = {k: self.entries[k].to_json() for k in sorted(self.entries)}
        return {
            "schema_version": SCHEMA_VERSION,
            "torch_version": self.torch_version,
            "device_kind": self.device_kind,
            "estimator": _ESTIMATOR,
            "digest": _entries_digest(entries),
            "entries": entries,
        }

    def save(self, path: str) -> str:
        """Atomic write (temp file + rename in the target directory, so
        the rename never crosses filesystems). Returns the digest."""
        doc = self.to_json()
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".tuning_", suffix=".json", dir=d)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return doc["digest"]


def load_table(path: str, device_kind: str) -> TuningTable:
    """Load + verify a table for the CURRENT runtime. Raises
    :class:`TableError` on every defect — callers degrade to heuristics
    (with the one ``tuning_fallback`` event); they never crash."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except FileNotFoundError as exc:
        raise TableError("absent", str(exc)) from exc
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as exc:
        raise TableError("corrupt", str(exc)) from exc
    if not isinstance(doc, dict):
        raise TableError("corrupt", "top-level JSON is not an object")
    try:
        version = doc["schema_version"]
        entries = doc["entries"]
        digest = doc["digest"]
        table_dev = doc["device_kind"]
    except KeyError as exc:
        raise TableError("corrupt", f"missing field {exc}") from exc
    if version != SCHEMA_VERSION:
        raise TableError(
            "schema-mismatch",
            f"table schema {version!r}, reader {SCHEMA_VERSION}",
        )
    if not isinstance(entries, dict):
        raise TableError("corrupt", "entries is not an object")
    if _entries_digest(entries) != digest:
        raise TableError("corrupt", "digest does not match entries")
    table_torch = doc.get("torch_version")
    if table_torch is None:
        if "jax_version" not in doc:
            raise TableError("corrupt", "missing field 'torch_version'")
        raise TableError(
            "fingerprint-mismatch",
            f"table jax {doc['jax_version']}, runtime torch "
            f"{torch_fingerprint()}",
        )
    if table_torch != torch_fingerprint():
        raise TableError(
            "fingerprint-mismatch",
            f"table torch {table_torch}, runtime {torch_fingerprint()}",
        )
    if normalize_device(table_dev) != normalize_device(device_kind):
        raise TableError(
            "fingerprint-mismatch",
            f"table device {table_dev!r}, runtime {device_kind!r}",
        )
    t = TuningTable(table_dev, torch_version=table_torch)
    try:
        for key, ent in entries.items():
            t.entries[key] = Entry.from_json(ent)
    except (KeyError, TypeError, AttributeError) as exc:
        raise TableError("corrupt", f"bad entry: {exc!r}") from exc
    return t
