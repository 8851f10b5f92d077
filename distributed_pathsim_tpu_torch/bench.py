"""The port's benchmark: author-pairs/s of the dense rank-all on the card.

    python -m distributed_pathsim_tpu_torch.bench [--authors N]

The metric of the repository's ``bench.py``, measured on the port: a
synthetic DBLP-shaped HIN (32768 authors x 45000 papers x 384 venues,
APVPA, seed 42), every author's top-10 by ``backend.topk(k=10)`` on the
``torch`` backend (K1 + pass 2 at this shape), and

    author-pairs/s = N·(N−1) / (wall time of one topk call, host fetch
                                included)

from the median of 5 timed calls after one warm call (which builds the
kernels, scatter-builds C and splits its limbs), min and max beside it.
Row 7 of the warm call's ranking is checked against host f64 arithmetic
from the graph's edges. Prints ONE JSON line, with the card's name and
power limit (``nvidia-smi``) beside the numbers.

It needs a card: without one it exits 2 and prints no result (a number
from the CPU is not a device number). :func:`run_bench` takes a device
for the tests, which run it on the CPU at a small size.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np

N_AUTHORS, N_PAPERS, N_VENUES, TOP_K, SEED = 32768, 45_000, 384, 10, 42
REPS = 5
CHECK_ROW = 7


def card_state() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def check_row(hin, vals: np.ndarray, idxs: np.ndarray, row: int,
              k: int = TOP_K) -> None:
    """Independent f64 recomputation of one source row in O(nnz) host
    math (every paper has exactly one venue in the generator): the
    ranking's top-k values within 1e-6 of it, as the repository's
    bench.py checks its row."""
    ap = hin.block("author_of")
    pv = hin.block("submit_at")
    n_a, n_p = ap.shape
    n_v = pv.shape[1]
    venue_of = np.zeros(n_p, dtype=np.int64)
    venue_of[pv.rows] = pv.cols
    edge_v = venue_of[ap.cols]
    c_row = np.bincount(edge_v[ap.rows == row], minlength=n_v).astype(
        np.float64)
    colsum = np.bincount(edge_v, minlength=n_v).astype(np.float64)
    d = np.bincount(ap.rows, weights=colsum[edge_v], minlength=n_a)
    m_row = np.bincount(ap.rows, weights=c_row[edge_v], minlength=n_a)
    denom = d[row] + d
    s = np.where(denom > 0, 2 * m_row / np.where(denom > 0, denom, 1), 0.0)
    s[row] = -np.inf
    expect = np.sort(s)[::-1][:k]
    got = np.asarray(vals[row], dtype=np.float64)
    if not np.allclose(got, expect, rtol=0, atol=1e-6):
        raise AssertionError(
            f"row {row}: ranking {got.tolist()} != f64 {expect.tolist()}")
    if not np.allclose(s[np.asarray(idxs[row])], expect, rtol=0, atol=1e-6):
        raise AssertionError(f"row {row}: ranked columns score differently")


def run_bench(n_authors: int = N_AUTHORS, device: str = "cuda",
              reps: int = REPS, n_papers: int = N_PAPERS,
              n_venues: int = N_VENUES) -> dict:
    """Build the graph and the backend, warm once, time ``reps`` topk
    calls; the result record (without the card's state)."""
    import torch

    from .backends.base import create_backend
    from .data.synthetic import synthetic_hin
    from .ops import cuda_kernels
    from .ops.metapath import compile_metapath

    if torch.device(device).type == "cuda":
        cuda_kernels.true_f32()
    hin = synthetic_hin(n_authors, n_papers, n_venues, seed=SEED)
    backend = create_backend("torch", hin,
                             compile_metapath("APVPA", hin.schema),
                             device=device)
    t0 = time.perf_counter()
    vals, idxs = backend.topk(k=TOP_K)
    warm_s = time.perf_counter() - t0
    check_row(hin, vals, idxs, row=min(CHECK_ROW, n_authors - 1))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        vals, idxs = backend.topk(k=TOP_K)  # host arrays: the fetch is in
        times.append(time.perf_counter() - t0)
    median = statistics.median(times)
    pairs = float(n_authors) * (n_authors - 1)
    return {
        "metric": f"author_pairs_per_sec_apvpa_{n_authors}_authors_"
                  f"top{TOP_K}",
        "value": pairs / median,
        "unit": "pairs/sec",
        "seconds_median": median,
        "seconds_min": min(times),
        "seconds_max": max(times),
        "reps": reps,
        "warm_call_s": warm_s,
        "shape": [n_authors, n_papers, n_venues],
        "device": (torch.cuda.get_device_name(torch.device(device))
                   if torch.device(device).type == "cuda" else "cpu"),
    }


def main(argv: list[str] | None = None) -> int:
    import torch

    p = argparse.ArgumentParser(
        prog="python -m distributed_pathsim_tpu_torch.bench",
        description="author-pairs/s of the port's dense rank-all on the card",
    )
    p.add_argument("--authors", type=int, default=N_AUTHORS)
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        from .utils.logging import runtime_event

        runtime_event("bench_refused", reason="no CUDA device available; "
                      "the benchmark measures the card only")
        return 2
    record = run_bench(args.authors, "cuda", args.reps)
    record["card"] = card_state()
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
