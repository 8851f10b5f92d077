"""Versioned, fingerprint-keyed tower checkpoints (atomic save/load).

The ``index/mips.py`` persistence contract applied to trained towers:
one ``.npz`` artifact, written atomically (tmp + rename — a crash
mid-save can never corrupt an earlier snapshot), stamped with a schema
version, the feature-map identity, and the training graph's
``(base_fp, delta_seq)`` consistency token. Loading verifies all of
them and raises a NAMED :class:`TowerMismatch` — a stale or foreign
artifact is refused loudly, never a shape error three layers deep.

The keys (``w0..w2``, ``b0..b2``, ``quad_t``, ``quad_w``, ``meta``),
the meta JSON and the messages are the JAX package's: a checkpoint
either package writes loads in the other.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np

from .encoder import FEATURE_FORMAT, InductiveEncoder

_SCHEMA_VERSION = 1


class TowerMismatch(ValueError):
    """A tower artifact that cannot serve this graph/build: wrong
    schema version, wrong base fingerprint, or a feature-map identity
    this build does not produce."""


def save_towers(
    path: str, encoder: InductiveEncoder, token: tuple[str, int]
) -> None:
    """Persist an encoder atomically, keyed to its training graph."""
    payload: dict[str, np.ndarray] = {}
    for i, (kern, bias) in enumerate(encoder.layers):
        payload[f"w{i}"] = kern
        payload[f"b{i}"] = bias
    payload["quad_t"] = encoder.quad_t
    payload["quad_w"] = encoder.quad_w
    payload["meta"] = np.frombuffer(
        json.dumps(
            {
                **encoder.meta,
                "schema_version": _SCHEMA_VERSION,
                "feature_format": FEATURE_FORMAT,
                "base_fp": token[0],
                "delta_seq": int(token[1]),
                "variant": encoder.variant,
                "metapath": encoder.metapath,
                "deg_denom": encoder.deg_denom,
                "target_scale": encoder.target_scale,
                "dim": encoder.dim,
                "hidden": encoder.hidden,
            }
        ).encode(),
        dtype=np.uint8,
    )
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
    os.replace(tmp, path)


def load_towers(
    path: str, expect_base_fp: str | None = None
) -> tuple[InductiveEncoder, tuple[str, int]]:
    """Restore ``(encoder, token)``; every mismatch is a named
    :class:`TowerMismatch` naming what moved and how to fix it.
    A corrupt or truncated artifact (interrupted copy, bad disk) is a
    mismatch too — callers get ONE exception type to catch."""
    try:
        handle = np.load(path)
    except (OSError, ValueError, EOFError, zipfile.BadZipFile) as exc:
        if isinstance(exc, FileNotFoundError):
            raise
        raise TowerMismatch(
            f"{path!r} is not a readable tower artifact ({exc}) — "
            "the file is corrupt or truncated; retrain or re-copy"
        ) from exc
    with handle as z:
        meta = json.loads(z["meta"].tobytes().decode())
        if meta.get("schema_version") != _SCHEMA_VERSION:
            raise TowerMismatch(
                f"{path!r} has tower schema "
                f"{meta.get('schema_version')!r}, this build reads "
                f"{_SCHEMA_VERSION} — retrain with `dpathsim learned "
                "train`"
            )
        if meta.get("feature_format") != FEATURE_FORMAT:
            raise TowerMismatch(
                f"{path!r} was trained on feature map "
                f"{meta.get('feature_format')!r}; this build encodes "
                f"{FEATURE_FORMAT!r} — the tower inputs changed shape "
                "or meaning; retrain"
            )
        base_fp = meta.pop("base_fp", "")
        delta_seq = int(meta.pop("delta_seq", 0))
        if expect_base_fp is not None and base_fp != expect_base_fp:
            raise TowerMismatch(
                f"{path!r} was trained for graph {base_fp!r}, not "
                f"{expect_base_fp!r} — retrain against the served "
                "dataset (and matching --headroom)"
            )
        layers = [
            (
                np.array(z[f"w{i}"], dtype=np.float32),
                np.array(z[f"b{i}"], dtype=np.float32),
            )
            for i in range(3)
        ]
        encoder = InductiveEncoder(
            layers=layers,
            quad_t=np.array(z["quad_t"], dtype=np.float64),
            quad_w=np.array(z["quad_w"], dtype=np.float64),
            deg_denom=float(meta.pop("deg_denom")),
            target_scale=float(meta.pop("target_scale")),
            variant=str(meta.pop("variant")),
            metapath=str(meta.pop("metapath")),
            meta=meta,
        )
    return encoder, (base_fp, delta_seq)
