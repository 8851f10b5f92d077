"""Shape buckets for the serving layer's coalesced dispatch.

Dispatching request batches at their natural sizes (3 requests now, 7
next tick, 12 after that) would give every distinct batch size its own
gather and GEMM shapes: fresh device allocations and a fresh GEMM
configuration per size, paid at serving time. Instead every coalesced
batch is padded UP to the nearest bucket of a small fixed ladder (powers
of two by default): at most ``log2(max_batch)+1`` shapes ever exist, all
of them driven once at startup (``utils.compile_counter.
warm_compile_cache``). Powers of two keep the ladder short (worst-case
pad waste is <2×, and the padded GEMM rows are nearly free next to the
dispatch overhead the batching amortizes) while covering every batch
size the coalescer can form.

Padding is semantically inert by construction: the pad slots repeat the
batch's first row, each row of the batched GEMM is an independent dot
product, and the completion path slices the pad off before anything
downstream sees it — verified by test (padded vs unbatched results are
bit-identical).
"""

from __future__ import annotations

import numpy as np

from ..tuning.registry import resolve_ladder

DEFAULT_BUCKETS: tuple[int, ...] = (1, 2, 4, 8, 16, 32)


def bucket_ladder(max_batch: int) -> tuple[int, ...]:
    """Powers of two 1, 2, 4, … covering ``max_batch`` (the last bucket
    is the smallest power of two ≥ max_batch)."""
    return resolve_ladder("pow2", max_batch)


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket ≥ ``n``. The coalescer caps batches at the
    largest bucket, so a miss is a caller bug — fail loudly."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch of {n} exceeds largest bucket {max(buckets)}")


def pad_rows(rows: np.ndarray, bucket: int) -> np.ndarray:
    """Pad a row-index batch to ``bucket`` by repeating the first row
    (deterministic, always a valid index; pad results are discarded)."""
    rows = np.asarray(rows, dtype=np.int64)
    if rows.shape[0] == bucket:
        return rows
    return np.concatenate(
        [rows, np.full(bucket - rows.shape[0], rows[0], dtype=np.int64)]
    )
