#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``distributed_pathsim_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py     # exit 0 only if every phase passes

Phases (each prints its lines; any failure raises, so the exit code is
nonzero and no result line is printed):

1. device and build: the card's name and power limit, the nvcc build of
   every kernel in ``distributed_pathsim_tpu_torch/csrc`` (all sources
   compiled in parallel) and the compiler's registers and spill bytes for
   each kernel instance;
2. every kernel against its plain torch version, zero tolerance
   (``torch.equal`` on values and indices), at small odd shapes, tie-heavy
   rows, zero-degree targets, wide contractions, a factor with 1-, 2- and
   3-limb rows (all four kernels multiply u8 limbs on the int8 tensor
   cores; K2 there also against the correctly rounded exact scores, since
   a 3-limb row's own count is past 2^24), K1 at several stripe widths,
   K4 past the k its lists keep in shared memory, and at the main path's
   shapes; a CUDA factor that is not integer counts must raise;
3. the main path through the port's CLI (``--platform cuda``) on
   synthetic GEXF files written by the port: rank-all at 32768 authors x
   45000 papers x 384 venues (seed 42) with ``--backend torch`` at k = 10
   (K1) and k = 20 (K4) checked bit for bit against the numpy f64
   oracle's counts, the same ranking through ``--backend torch-sparse``
   (K3) byte-identical to the ``torch`` one, single source with its log's
   line count, all-pairs at 8192 authors; then the dense backend's rect
   arm (K3) at the smallest author count past K1's candidate budget;
4. BASELINE config 5 on the card at full size: 1048576 authors x 5242880
   papers x 64 venues (seed 42), ``torch-sparse`` with tile_rows 8192 and
   ``--approx`` semantics, ``PathSimDriver.rank_all(k=10)`` with a
   checkpoint directory: K3 once per row tile, 3 seeded spot rows
   against host f64 arithmetic from the COO factor, K3 against its plain
   version on a 1024-row tile, a resumed rerun returning identical
   arrays, rank-all seconds, author-pairs/s, layer times and busy share,
   how many (row block, column subtile) pairs needed 1, 2, 3, 4, 6 or 9
   limb products, and K3's time at tile 0 (the Zipf head) and at a
   middle tile;
5. times on the card (CUDA events, median of 7 after 2 warm-ups): each
   kernel, its plain version, a library yardstick that the port never
   calls, the least time the card could take (bound), K1 at several
   stripe widths, and the rank-all wall time as author-pairs/s with its
   per-layer breakdown.

The kernels' launch counters are zeroed before each main-path run and
read after it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Nothing here imports JAX.
"""

from __future__ import annotations

import filecmp
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parent

# The rank-all shape of the repository's benchmark (bench.py): APVPA over
# 32768 authors, 45000 papers, 384 venues, top-10, seed 42.
N_AUTHORS, N_PAPERS, N_VENUES, TOP_K, SEED = 32768, 45_000, 384, 10, 42
# All-pairs runs at 8192 authors: the host copy of a 32768² f32 score
# matrix would be 4 GB per copy.
N_AUTHORS_ALL_PAIRS = 8192
# k of the CLI run that takes the single-pass kernel K4 (k > 16).
TOP_K_FOLD = 20
# BASELINE.json config 5 (scripts/scale_config5.py's defaults): APVPA,
# top-10, approx (its counts pass 2^24 by construction), 8192-row tiles.
C5_AUTHORS, C5_PAPERS, C5_VENUES, C5_TILE_ROWS = 1_048_576, 5_242_880, 64, 8192
C5_SPOT_SEED, C5_SPOT_ROWS, C5_ATOL = 7, 3, 1e-6

# Published H100 SXM peaks (NVIDIA data sheet): u8 x u8 on the int8 tensor
# cores (all four kernels multiply exact u8 limbs there; never TF32), f32
# on the CUDA cores (the bound the kernels had before), HBM3 bandwidth.
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

REPS, WARMUP = 7, 2
# K1's stripe widths timed beside the default (column tiles of 128).
STRIPE_SWEEP = (8, 32, 64)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(torch, fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_s(torch, fn, reps: int = 5):
    """Host wall times of ``fn`` (each ending in a synchronize), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def device_busy_share(torch, fn, reps: int = 3):
    """Share of the wall time of ``reps`` calls of ``fn`` in which the
    card ran a kernel (the union of the device events' intervals in a
    torch.profiler trace), or None when the trace holds no device
    event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return busy_us / 1e6 / wall if spans else None


def scores_flops(n: int, v: int) -> float:
    """f32 FLOP the score function needs: S is symmetric, so only the
    n (n + 1) / 2 upper-triangle dot products of 2 v FLOP each. The
    kernels compute every tile, 2 n² v."""
    return float(n) * (n + 1) * v


def bound(ops: float, nbytes: float,
          peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """The least time (ms) for ``ops`` operations at ``peak`` per second
    and ``nbytes`` at the HBM rate, and which of the two bounds it."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def u8_square_ops(counts, v):
    """u8 operations of the symmetric score function on the int8 tensor
    cores: the n (n + 1) / 2 upper-triangle pairs (i, j), each l_i l_j
    limb products of 2 v operations."""
    s1 = float(counts.sum())
    s2 = float((counts * counts).sum())
    return v * (s1 * s1 + s2)


def max_abs_err(torch, got, want) -> float:
    """Largest |got - want| over entries finite in both; inf entries
    must coincide (checked by the caller's torch.equal)."""
    fin = torch.isfinite(got) & torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0
    return float((got[fin].double() - want[fin].double()).abs().max())


# -- phases -----------------------------------------------------------------


def gpu_state() -> str:
    """The card's SM clock, power draw and temperature (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_and_build(torch, ck):
    phase("device and build")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    reports = ck.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(reports) or 'already built'})")
    instances = {kname: kernel_instances(text)
                 for kname, text in reports.items()}
    for kname, insts in instances.items():
        for inst, (regs, spill) in insts.items():
            print(f"  {kname}: {inst}: {regs} registers, {spill} bytes "
                  "spill stores + loads")
    return name, smi, instances


def kernel_instances(report: str) -> dict:
    """Each kernel instance's registers and spill bytes (stores + loads)
    from nvcc's ``-Xptxas -v`` report, keyed by the instance's name with
    its template flags (``topk_fold_kernel<1,0>``)."""
    import re

    out, current, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Function properties for (_Z\w+)", line)
        if m:
            name = re.search(r"pathsim\d+(\w+?)I", m.group(1))
            flags = re.findall(r"Lb([01])E", m.group(1))
            current = (f"{name.group(1) if name else m.group(1)}"
                       f"<{','.join(flags)}>")
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out[current] = (int(m.group(1)), spill)
            current = None
    return out


def check_topk(torch, ck, c, d, k, mask_self, label, stripe_tiles=None,
               limbs=None):
    """K1 (stripe candidates and the final top-k) against the plain
    versions; ``limbs`` the factor split beforehand, as the backend hands
    it over."""
    cv, cc = ck.topk_twopass_candidates(c, d, k, mask_self, limbs=limbs,
                                        stripe_tiles=stripe_tiles)
    pv, pc = ck.topk_twopass_candidates_plain(c, d, k, mask_self,
                                              stripe_tiles=stripe_tiles)
    torch.cuda.synchronize()
    if not (torch.equal(cv, pv) and torch.equal(cc, pc)):
        bad = (cv != pv) | (cc != pc)
        raise AssertionError(
            f"K1 candidates differ from the plain version ({label}, k={k}, "
            f"mask_self={mask_self}, stripe_tiles={stripe_tiles}): "
            f"{int(bad.sum())} entries"
        )
    fv, fc = ck.fused_topk_twopass(c, d, k=k, mask_self=mask_self,
                                   limbs=limbs)
    gv, gc = ck.fused_topk_twopass_plain(c, d, k=k, mask_self=mask_self)
    if not (torch.equal(fv, gv) and torch.equal(fc, gc)):
        raise AssertionError(
            f"K1 top-k differs from the plain version ({label}, k={k}, "
            f"mask_self={mask_self})"
        )
    return max_abs_err(torch, fv, gv)


def check_scores(torch, ck, c, d, label, limbs=None):
    """K2 against the correctly rounded scores of the exact integer
    counts everywhere (f64 sums of integer products are exact below
    2^53), and equal to the plain version wherever the counts are exact
    in f32 (below 2^24: every entry of an exact-count factor)."""
    got = ck.fused_scores(c, d, limbs=limbs)
    want = ck.fused_scores_plain(c, d)
    m = c.double() @ c.double().T
    den = d[:, None] + d[None, :]
    exact = torch.where(den > 0, (2.0 * m.float()) / den, 0.0)
    f32_exact = m < 2**24
    torch.cuda.synchronize()
    if not (torch.equal(got, exact)
            and torch.equal(got[f32_exact], want[f32_exact])):
        diff = (got - exact).abs().max()
        raise AssertionError(
            f"K2 differs from the exact scores or the plain version "
            f"({label}): max |diff| {diff}"
        )
    return max_abs_err(torch, got, want)


def check_rect(torch, ck, c, d, r0, t, k, label, stripe_tiles=None,
               pad_cols=3):
    """K3 (stripe candidates and the final top-k) against the plain
    versions for rows r0 .. r0+t-1 against every column, the last
    ``pad_cols`` columns as padding (n_true_cols = n - pad_cols)."""
    n = c.shape[0]
    n_true = n - pad_cols
    ids = torch.arange(n, dtype=torch.int32, device=c.device)
    args = (c[r0:r0 + t], c, d[r0:r0 + t], d, ids[r0:r0 + t], k)
    cv, cc = ck.topk_rect_candidates(*args, n_true, stripe_tiles)
    pv, pc = ck.topk_rect_candidates_plain(*args, n_true, stripe_tiles)
    torch.cuda.synchronize()
    if not (torch.equal(cv, pv) and torch.equal(cc, pc)):
        bad = (cv != pv) | (cc != pc)
        raise AssertionError(
            f"K3 candidates differ from the plain version ({label}, k={k}, "
            f"stripe_tiles={stripe_tiles}): {int(bad.sum())} entries"
        )
    fv, fc = ck.fused_topk_twopass_rect(*args, n_true_cols=n_true)
    gv, gc = ck.fused_topk_twopass_rect_plain(*args, n_true_cols=n_true)
    if not (torch.equal(fv, gv) and torch.equal(fc, gc)):
        raise AssertionError(
            f"K3 top-k differs from the plain version ({label}, k={k})"
        )
    return max_abs_err(torch, fv, gv)


def check_fold(torch, ck, c, d, k, mask_self, label):
    """K4 against its plain version."""
    fv, fc = ck.fused_topk(c, d, k=k, mask_self=mask_self)
    gv, gc = ck.fused_topk_plain(c, d, k=k, mask_self=mask_self)
    torch.cuda.synchronize()
    if not (torch.equal(fv, gv) and torch.equal(fc, gc)):
        bad = (fv != gv) | (fc != gc)
        raise AssertionError(
            f"K4 differs from the plain version ({label}, k={k}, "
            f"mask_self={mask_self}): {int(bad.sum())} entries"
        )
    return max_abs_err(torch, fv, gv)


def check_k3_k4(torch, ck, c, d, label, masks=(True, False)):
    """K3 at k in {1, 10, 15} (all rows with the default stripes; an odd
    row tile with 4-tile stripes) and K4 at k in {1, 16, 17, 40} and one
    past the k its lists keep in shared memory, with the self mask each
    of ``masks`` ways."""
    n = c.shape[0]
    r0, t = n // 5, n // 3 + 7
    for k in (1, 10, 15):
        check_rect(torch, ck, c, d, 0, n, k, label)
        check_rect(torch, ck, c, d, r0, t, k, label, stripe_tiles=4)
    for k in (1, 16, 17, 40, ck.FOLD_SMEM_K_MAX + 1):
        for mask_self in masks:
            check_fold(torch, ck, c, d, k, mask_self, label)


def multilimb_factor(torch, np, device, n=1500, v=96, seed=5):
    """An integer factor with 1-, 2- and 3-limb rows whose path counts
    between distinct rows stay below 2^24 (so the plain f32 product is
    exact there; a 3-limb row's own count is past it, so the checks mask
    the self pair): random 0..3 entries, and 12 rows with one entry of
    300-850 (2 limbs) or past 65536 (3 limbs), each in its own column,
    where every other row holds at most 1. Some tile pairs are narrow
    (one s32 sum) and some not (the f64 fold): 65536^2 · 96 >= 2^31."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, (n, v)).astype(np.float64)
    c[rng.random((n, v)) < 0.5] = 0
    big_cols = rng.choice(v, 12, replace=False)
    c[:, big_cols] = np.minimum(c[:, big_cols], 1)
    rows = rng.choice(n, 12, replace=False)
    for i, (r, col) in enumerate(zip(rows, big_cols)):
        c[r, col] = (65536 + 17 * i) if i < 4 else (300 + 50 * i)
    d = c @ c.sum(0)
    m = c @ c.T
    np.fill_diagonal(m, 0)
    assert m.max() < 2**24
    return (torch.tensor(c, dtype=torch.float32, device=device),
            torch.tensor(d, dtype=torch.float32, device=device))


def factor(hin, spec, device):
    """Dense f32 half factor and row-sum denominators of ``spec``."""
    import numpy as np

    from distributed_pathsim_tpu_torch.data.encode import factor_from_arrays
    from distributed_pathsim_tpu_torch.ops import planner
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    mp = compile_metapath(spec, hin.schema)
    c = planner.dense_half(hin, mp, dtype=np.float64)
    return factor_from_arrays(c, c @ c.sum(0), device)


def kernel_checks(torch, ck, np, synthetic_hin):
    phase("kernels against plain versions (zero tolerance)")
    dev = torch.device("cuda")
    hin = synthetic_hin(3001, 4500, 64, seed=SEED)
    c, d = factor(hin, "APVPA", dev)
    for k in (1, 10, 16):
        for mask_self in (True, False):
            check_topk(torch, ck, c, d, k, mask_self, "APVPA 3001x64")
    for stripe_tiles in (1, 3):
        check_topk(torch, ck, c, d, 10, True, "APVPA 3001x64", stripe_tiles)
    check_scores(torch, ck, c, d, "APVPA 3001x64")
    print("K1/K2 narrow (APVPA, n=3001, v=64, k in 1/10/16, both masks; K1 "
          "also with stripes of 1 and 3 tiles besides the default "
          f"{ck.twopass_stripe_tiles(c.shape[0])}): equal")
    check_k3_k4(torch, ck, c, d, "APVPA 3001x64")
    print("K3/K4 narrow (APVPA, n=3001, v=64; K3 k in 1/10/15, all rows with "
          "the default stripes and an odd row tile with 4-tile stripes; K4 k "
          "in 1/16/17/40, both masks): equal")

    cm, dm = multilimb_factor(torch, np, dev)
    lim = ck.split_limbs(cm)
    counts = lim.counts.long()
    if not ck._needs_wide(lim, lim):
        raise AssertionError("the multi-limb factor does not take the "
                             "kernels' wide instances")
    for k in (1, 10, 16):
        check_topk(torch, ck, cm, dm, k, True, "multi-limb", limbs=lim)
    check_topk(torch, ck, cm, dm, 10, True, "multi-limb", stripe_tiles=1)
    check_scores(torch, ck, cm, dm, "multi-limb", limbs=lim)
    check_scores(torch, ck, cm, dm, "multi-limb")
    check_k3_k4(torch, ck, cm, dm, "multi-limb", masks=(True,))
    print(f"K1/K2/K3/K4 multi-limb factor, wide instances (n={cm.shape[0]}, "
          f"v={cm.shape[1]}, rows of 1/2/3 limbs: "
          f"{[int((counts == i).sum()) for i in (1, 2, 3)]}; K1 k in "
          "1/10/16 and 1-tile stripes, self masked; K2 also equal to the "
          "correctly rounded exact scores on the diagonal, past 2^24; K4 "
          f"also at k={ck.FOLD_SMEM_K_MAX + 1}, lists in device memory): "
          "equal")
    bad = torch.full((4, 4), 0.5, device=dev)
    one = torch.ones(4, device=dev)
    for label, call in (
            ("K1", lambda: ck.fused_topk_twopass(bad, one, k=2)),
            ("K2", lambda: ck.fused_scores(bad, one)),
            ("K4", lambda: ck.fused_topk(bad, one, k=2))):
        try:
            call()
        except ValueError as exc:
            print(f"{label}: a CUDA factor holding 0.5 raises ValueError: "
                  f"{exc}")
        else:
            raise AssertionError(f"{label} took a factor holding 0.5")

    cw, dw = factor(hin, "APA", dev)  # v = #papers: 282 K steps of 16
    for mask_self in (True, False):
        check_topk(torch, ck, cw, dw, 10, mask_self, "APA wide")
    check_scores(torch, ck, cw, dw, "APA wide")
    print(f"K1/K2 wide (APA, n=3001, v={cw.shape[1]}): equal")
    check_k3_k4(torch, ck, cw, dw, "APA wide")
    print(f"K3/K4 wide (APA, n=3001, v={cw.shape[1]}): equal")

    rng = np.random.default_rng(SEED)
    base = rng.integers(0, 3, size=(40, 24))
    rows = base[rng.integers(0, 40, size=1537)].astype(np.float64)
    rows[rng.integers(0, 1537, size=200)] = 0.0  # zero-degree targets
    ct = torch.tensor(rows, dtype=torch.float32, device=dev)
    dt = ct @ ct.sum(0)
    for k in (1, 10, 16):
        for mask_self in (True, False):
            check_topk(torch, ck, ct, dt, k, mask_self, "ties")
    check_scores(torch, ck, ct, dt, "ties")
    print("K1/K2 tie-heavy rows + zero-degree targets (n=1537): equal")
    check_k3_k4(torch, ck, ct, dt, "ties")
    print("K3/K4 tie-heavy rows + zero-degree targets (n=1537): equal")


def oracle_rows_match(np, got, ids, d, pairwise_row, k, rows, label):
    """Check ranking rows bit for bit: the f32 scores renormalized from
    the f64 oracle's exact integer counts (row sums ``d``,
    ``pairwise_row(r)``), ordered (desc score, asc column), and within
    1e-6 of the f64 scores. ``got`` maps a source id to its [(target id,
    score)] ranking."""
    d32 = d.astype(np.float32)
    for row in rows:
        m = pairwise_row(row)
        den = d32[row] + d32
        s32 = np.where(den > 0, np.float32(2.0) * m.astype(np.float32)
                       / np.where(den > 0, den, np.float32(1.0)),
                       np.float32(0.0))
        s32[row] = -np.inf
        order = np.argsort(-s32, kind="stable")[:k]
        want = [(ids[j], float(s32[j])) for j in order]
        if got[ids[row]] != want:
            raise AssertionError(f"{label}: row {row} differs from the oracle")
        s64 = np.where(d[row] + d > 0,
                       2.0 * m / np.maximum(d[row] + d, 1), 0.0)
        s64[row] = -np.inf
        np.testing.assert_allclose(
            [v for _, v in got[ids[row]]], np.sort(s64)[::-1][:k], atol=1e-6,
        )


def read_ranking(path):
    got: dict[str, list[tuple[str, float]]] = {}
    with open(path, encoding="utf-8") as f:
        next(f)
        for line in f:
            s, _, t, v = line.rstrip("\n").split("\t")
            got.setdefault(s, []).append((t, float(v)))
    return got


def counted(torch, ck, launches, fn, label):
    """Run one main-path step with the launch counters zeroed before it
    and read after it; adds them to ``launches``."""
    ck.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(ck.LAUNCHES)
    for name, cnt in counts.items():
        launches[name] += cnt
    print(f"{label}: {dt:.2f} s, launches {counts}")
    return out, counts, dt


def main_path(torch, ck, np, workdir):
    """The CLI runs of the main path, then the bench-shape backend built
    once more through the engine with a StageTimer (the bootstrap's
    layer times). Returns the graphs, the launches per kernel and that
    backend."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.cli import main as cli_main
    from distributed_pathsim_tpu_torch.config import RunConfig
    from distributed_pathsim_tpu_torch.data.synthetic import (
        synthetic_hin,
        write_gexf,
    )
    from distributed_pathsim_tpu_torch.engine import build_backend
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.utils.profiling import StageTimer

    phase("main path through the CLI")
    launches = {name: 0 for name in ck.LAUNCHES}

    def run_cli(argv, label):
        rc, counts, dt = counted(torch, ck, launches,
                                 lambda: cli_main(argv), label)
        if rc != 0:
            raise AssertionError(f"{label}: CLI exited {rc}")
        return counts, dt

    hin = synthetic_hin(N_AUTHORS, N_PAPERS, N_VENUES, seed=SEED,
                        materialize_ids=True)
    gexf = workdir / "bench.gexf"
    write_gexf(hin, str(gexf))
    ranking = workdir / "ranking.tsv"
    common = ["--dataset", str(gexf), "--platform", "cuda",
              "--backend", "torch", "--quiet"]
    counts, _ = run_cli(
        common + ["--top-k", str(TOP_K), "--ranking-out", str(ranking)],
        f"rank-all {N_AUTHORS}x{N_PAPERS}x{N_VENUES} k={TOP_K}",
    )
    if counts["topk_twopass_candidates"] < 1:
        raise AssertionError("rank-all did not launch K1")

    # Check rows of the TSV bit for bit: f32 scores renormalized from the
    # numpy f64 oracle's exact integer counts, (desc score, asc column).
    oracle = create_backend("numpy", hin, compile_metapath("APVPA", hin.schema))
    got = read_ranking(ranking)
    if len(got) != N_AUTHORS:
        raise AssertionError(f"ranking has {len(got)} sources")
    ids = hin.indices["author"].ids
    d = oracle.global_walks()
    oracle_rows_match(np, got, ids, d, oracle.pairwise_row, TOP_K,
                      (0, 7, 12345, N_AUTHORS - 1), "rank-all k=10")
    print("rank-all rows 0/7/12345/32767: bit-identical to the f32 "
          "renormalization of the f64 oracle's counts")

    sparse_ranking = workdir / "ranking_sparse.tsv"
    counts, _ = run_cli(
        ["--dataset", str(gexf), "--platform", "cuda", "--backend",
         "torch-sparse", "--quiet", "--top-k", str(TOP_K), "--ranking-out",
         str(sparse_ranking)],
        f"rank-all torch-sparse k={TOP_K}",
    )
    tiles = -(-N_AUTHORS // 4096)  # the backend's default tile_rows
    if counts["topk_rect_candidates"] != tiles:
        raise AssertionError(
            f"torch-sparse launched K3 {counts['topk_rect_candidates']} "
            f"times for {tiles} row tiles")
    if not filecmp.cmp(ranking, sparse_ranking, shallow=False):
        raise AssertionError("torch-sparse ranking differs from torch's")
    print("torch-sparse ranking: cmp-identical to the torch ranking")

    ranking20 = workdir / "ranking20.tsv"
    counts, _ = run_cli(
        common + ["--top-k", str(TOP_K_FOLD), "--ranking-out",
                  str(ranking20)],
        f"rank-all k={TOP_K_FOLD}",
    )
    if counts["topk_fold"] < 1:
        raise AssertionError(f"rank-all k={TOP_K_FOLD} did not launch K4")
    oracle_rows_match(np, read_ranking(ranking20), ids, d,
                      oracle.pairwise_row, TOP_K_FOLD,
                      (0, 7, 12345, N_AUTHORS - 1), f"rank-all k={TOP_K_FOLD}")
    print(f"rank-all k={TOP_K_FOLD} rows 0/7/12345/32767: bit-identical to "
          "the f32 renormalization of the f64 oracle's counts")

    log = workdir / "single.log"
    run_cli(common + ["--source", ids[7], "--output", str(log)],
            f"single source {ids[7]}")
    with open(log, encoding="utf-8") as f:
        n_lines = sum(1 for _ in f)
    want_lines = 1 + 5 * (N_AUTHORS - 1) + 1
    if n_lines != want_lines:
        raise AssertionError(f"log has {n_lines} lines, want {want_lines}")
    print(f"single-source log: {n_lines} lines (1 + 5*(N-1) + 1)")

    hin_ap = synthetic_hin(N_AUTHORS_ALL_PAIRS, N_PAPERS, N_VENUES, seed=SEED,
                           materialize_ids=True)
    gexf_ap = workdir / "allpairs.gexf"
    write_gexf(hin_ap, str(gexf_ap))
    counts, _ = run_cli(
        ["--dataset", str(gexf_ap), "--platform", "cuda", "--backend",
         "torch", "--all-pairs"],
        f"all-pairs {N_AUTHORS_ALL_PAIRS} authors",
    )
    if counts["fused_scores"] < 1:
        raise AssertionError("all-pairs did not launch K2")

    timer = StageTimer("cuda")
    _, _, backend = build_backend(
        RunConfig(dataset=str(gexf), platform="cuda"), timer=timer
    )
    with timer.stage("first_topk"):  # includes the scatter-build of C
        backend.topk(k=TOP_K)
    print("bootstrap at the rank-all shape (StageTimer, s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in timer.summary().items()))
    dense_rect_arm(torch, ck, np, launches)
    return hin, hin_ap, launches, backend


def uniform_hin(n_authors, n_papers, n_venues, seed):
    """A DBLP-shaped graph without the Zipf head: each paper has one
    author and one venue, both drawn uniformly, so row sums stay far
    below 2^24 at a few hundred thousand authors (counts stay exact)."""
    import numpy as np

    from distributed_pathsim_tpu_torch.data.encode import (
        encoded_hin_from_arrays,
    )

    rng = np.random.default_rng(seed)
    papers = np.arange(n_papers, dtype=np.int32)
    return encoded_hin_from_arrays({
        "name": f"uniform_a{n_authors}_p{n_papers}_v{n_venues}",
        "node_types": ["author", "paper", "venue"],
        "relations": {"author_of": ("author", "paper"),
                      "submit_at": ("paper", "venue")},
        "types": {"author": {"size": n_authors}, "paper": {"size": n_papers},
                  "venue": {"size": n_venues}},
        "blocks": {
            "author_of": {
                "relationship": "author_of", "src_type": "author",
                "dst_type": "paper",
                "rows": rng.integers(0, n_authors, n_papers), "cols": papers,
                "shape": (n_authors, n_papers),
            },
            "submit_at": {
                "relationship": "submit_at", "src_type": "paper",
                "dst_type": "venue", "rows": papers,
                "cols": rng.integers(0, n_venues, n_papers),
                "shape": (n_papers, n_venues),
            },
        },
    })


def smallest_past_twopass(ck, k, device) -> int:
    """The smallest row count whose K1 candidate buffer exceeds its
    budget on ``device`` (cuda_kernels.candidate_bytes)."""
    lo, hi = 1, 1 << 22
    while lo < hi:
        mid = (lo + hi) // 2
        if ck.twopass_fits(mid, k, device):
            lo = mid + 1
        else:
            hi = mid
    return lo


def dense_rect_arm(torch, ck, np, launches):
    """backend.topk on the dense ``torch`` backend just past K1's
    candidate budget: K3 over row tiles, and K1 not at all."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    phase("dense backend past K1's candidate budget (the rect arm)")
    dev = torch.device("cuda")
    n = smallest_past_twopass(ck, TOP_K, dev)
    hin = uniform_hin(n, 2 * n, 64, SEED)
    mp = compile_metapath("APVPA", hin.schema)
    backend = create_backend("torch", hin, mp)
    (vals, idxs), counts, _ = counted(
        torch, ck, launches, lambda: backend.topk(k=TOP_K),
        f"dense topk at n={n} (candidate buffer "
        f"{ck.candidate_bytes(n, TOP_K)} > budget "
        f"{ck.candidate_budget_bytes(dev)} bytes) k={TOP_K}",
    )
    if counts["topk_rect_candidates"] < 1 or counts["topk_twopass_candidates"]:
        raise AssertionError(f"the rect arm did not run K3 alone: {counts}")
    oracle = create_backend("numpy", hin, mp)
    d = oracle.global_walks()
    if d.max() >= 2**24:
        raise AssertionError("the rect-arm graph's row sums pass 2^24")
    rows = (0, 1, n // 2, n - 1)
    ids = [str(i) for i in range(n)]
    got = {ids[r]: [(ids[int(j)], float(v)) for v, j in zip(vals[r], idxs[r])]
           for r in rows}
    oracle_rows_match(np, got, ids, d, oracle.pairwise_row, TOP_K, rows,
                      "dense rect arm")
    print(f"dense rect arm rows {rows}: bit-identical to the f32 "
          "renormalization of the f64 oracle's counts")


def rect_bounds(rows, cols, t, n, v, k, n_stripes):
    """K3's least times on this tile's data. At the int8 tensor cores'
    rate: 2 v u8 operations for each of the l_i l_j limb products of
    every (row, column) pair (a row tile against every column has no
    symmetry), or the bytes: both factors' limb planes and denominators
    read once, the row ids, the candidates written. Beside it, the f32
    CUDA-core bound of 2 t n v FLOP the kernel had before."""
    ops = 2.0 * v * float(rows.counts.long().sum()) * float(
        cols.counts.long().sum())
    out = 8.0 * t * n_stripes * k
    int8 = bound(ops, rows.planes.numel() + cols.planes.numel()
                 + 4.0 * (2 * t + n) + out, PEAK_INT8_OPS)
    f32 = bound(2.0 * t * n * v,
                4.0 * (t * v + n * v + 2 * t + n) + out)
    return int8, f32


def products_histogram(torch, lim, v_pad):
    """How many (128-row block, 64-column subtile) pairs of a rank-all
    over the factor ``lim`` need 1, 2, 3, 4, 6 or 9 limb products, and
    how many of them fold through f64 (v_pad · largest row entry ·
    largest column entry >= 2^31) rather than one s32 sum."""
    rb = torch.nn.functional.pad(lim.rmax.long(), (0, -lim.rmax.shape[0] % 128))
    rb = rb.view(-1, 128).amax(1)
    sub = lim.sub.long()

    def limbs(m):
        return 1 + (m >= 256).long() + (m >= 65536).long()

    lr, lc = limbs(rb), limbs(sub)
    hist = {}
    for a in (1, 2, 3):
        for b in (1, 2, 3):
            pairs = int((lr == a).sum()) * int((lc == b).sum())
            hist[a * b] = hist.get(a * b, 0) + pairs
    # pairs past the s32 bound: for each row block, the subtiles whose
    # largest entry reaches (2^31 - 1) // (v_pad · its largest) + 1
    cut = torch.div(2**31 - 1, v_pad * rb.clamp(min=1), rounding_mode="floor") + 1
    sub_sorted = torch.sort(sub).values
    wide = int((sub.numel() - torch.searchsorted(sub_sorted, cut)).sum())
    return {p: c for p, c in sorted(hist.items()) if c}, wide


def tiles_device_s(torch, ck, sparse, cc, dc, lim, n, T, tiles):
    """Device seconds of every row tile's K3 and pass 2, launched back to
    back with CUDA events around each (read after one synchronize)."""
    marks = []
    for i in range(tiles):
        i0 = i * T
        ids = torch.arange(i0, i0 + T, dtype=torch.int32, device=cc.device)
        a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        a.record()
        cv, cand = ck.topk_rect_candidates(cc[i0:i0 + T], cc, dc[i0:i0 + T],
                                           dc, ids, TOP_K, n,
                                           limbs=(lim.rows(i0, i0 + T), lim))
        b.record()
        sparse.chunked_row_topk(cv.view(T, -1), cand.view(T, -1), TOP_K)
        c.record()
        marks.append((a, b, c))
    torch.cuda.synchronize()
    return (sum(a.elapsed_time(b) for a, b, _ in marks) / 1e3,
            sum(b.elapsed_time(c) for _, b, c in marks) / 1e3)


def config5(torch, ck, np, launches, workdir, card):
    """BASELINE config 5 through torch-sparse on the card. Returns K3's
    numbers at its row tile (the kernels line)."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
    from distributed_pathsim_tpu_torch.driver import PathSimDriver
    from distributed_pathsim_tpu_torch.ops import sparse
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    phase(f"config 5: {C5_AUTHORS} authors x {C5_PAPERS} papers x "
          f"{C5_VENUES} venues through torch-sparse")
    t0 = time.perf_counter()
    hin = synthetic_hin(C5_AUTHORS, C5_PAPERS, C5_VENUES, seed=SEED)
    graph_s = time.perf_counter() - t0
    mp = compile_metapath("APVPA", hin.schema)

    def make():
        return create_backend("torch-sparse", hin, mp,
                              tile_rows=C5_TILE_ROWS, exact_counts=False)

    t0 = time.perf_counter()
    backend = make()
    init_s = time.perf_counter() - t0
    n, v = backend.n, backend.tiled.v
    tiles = backend._n_live_tiles
    ckdir = str(workdir / "config5_ckpt")
    (vals, idxs), counts, rank_s = counted(
        torch, ck, launches,
        lambda: PathSimDriver(backend).rank_all(k=TOP_K, checkpoint_dir=ckdir),
        f"config 5 rank_all k={TOP_K}",
    )
    if counts["topk_rect_candidates"] != tiles:
        raise AssertionError(
            f"K3 launched {counts['topk_rect_candidates']} times for "
            f"{tiles} row tiles")
    if backend._run_config(TOP_K)["compute_path"] != "rect":
        raise AssertionError("config 5 did not run the rect arm")
    if vals.shape != (n, TOP_K) or not np.isfinite(vals).all():
        raise AssertionError("config 5 result is not [N, k] finite scores")
    pairs = float(n) * (n - 1)
    print(f"config 5 rank-all: {rank_s:.3f} s ({tiles} row tiles of "
          f"{C5_TILE_ROWS}) -> {pairs / rank_s:.4g} author-pairs/s on "
          f"{card}; set-up: synthetic graph {graph_s:.1f} s, backend init "
          f"(host fold + COO tiling) {init_s:.1f} s")

    # Spot rows against host f64 arithmetic from the COO factor.
    coo = backend._c
    c64 = np.zeros(coo.shape, dtype=np.float64)
    np.add.at(c64, (coo.rows, coo.cols), coo.weights)
    d64 = c64 @ c64.sum(0)
    rng = np.random.default_rng(C5_SPOT_SEED)
    spot = [int(r) for r in rng.integers(0, n, size=C5_SPOT_ROWS)]
    for r in spot:
        m = c64 @ c64[r]
        den = d64[r] + d64
        s64 = np.where(den > 0, 2.0 * m / np.where(den > 0, den, 1.0), 0.0)
        s64[r] = -np.inf
        expect = np.sort(s64)[::-1][:TOP_K]
        np.testing.assert_allclose(vals[r], expect, atol=C5_ATOL,
                                   err_msg=f"config 5 spot row {r}")
        np.testing.assert_allclose(s64[idxs[r]], expect, atol=C5_ATOL,
                                   err_msg=f"config 5 spot row {r} columns")
    print(f"config 5 spot rows {spot}: within {C5_ATOL} of host f64 "
          "arithmetic from the COO factor (values and chosen columns)")

    # K3 against its plain version on one 1024-row tile at full N. The
    # counts pass 2^24 here, so sums in another order round differently:
    # values within 1e-6, columns equal where the k-th and (k+1)-th
    # plain values are further apart than that.
    _, cc, dc, lim = backend._rect_factor
    r0 = n // 2
    ids = torch.arange(r0, r0 + 1024, dtype=torch.int32, device=cc.device)
    tile_args = (cc[r0:r0 + 1024], cc, dc[r0:r0 + 1024], dc, ids)
    kv, kc = ck.fused_topk_twopass_rect(*tile_args, k=TOP_K, n_true_cols=n)
    pv, pc = ck.fused_topk_twopass_rect_plain(*tile_args, k=TOP_K + 1,
                                              n_true_cols=n)
    c5_err = float((kv.double() - pv[:, :TOP_K].double()).abs().max())
    clear = (pv[:, TOP_K - 1] - pv[:, TOP_K]) > C5_ATOL
    same = (torch.sort(kc, 1).values
            == torch.sort(pc[:, :TOP_K], 1).values).all(1)
    if c5_err > C5_ATOL or not bool(same[clear].all()):
        raise AssertionError(
            f"K3 vs plain at config 5: max |diff| {c5_err}, "
            f"{int((~same & clear).sum())} rows with other columns")
    print(f"K3 vs plain, 1024-row tile at N={n}: max |diff| {c5_err:.3g}; "
          f"columns equal in all {int(clear.sum())} rows whose k-th and "
          f"(k+1)-th scores differ by more than {C5_ATOL}")

    # A fresh backend on the same checkpoint directory resumes every tile.
    resumed = make()
    done = len(CheckpointManager(ckdir).done_keys())
    (v2, i2), counts, resume_s = counted(
        torch, ck, {name: 0 for name in ck.LAUNCHES},
        lambda: PathSimDriver(resumed).rank_all(k=TOP_K, checkpoint_dir=ckdir),
        "config 5 resumed rank_all",
    )
    if done != tiles or any(counts.values()):
        raise AssertionError(f"resume: {done} of {tiles} units, {counts}")
    if not (np.array_equal(v2, vals) and np.array_equal(i2, idxs)):
        raise AssertionError("the resumed rank-all differs")
    print(f"config 5 resume: all {tiles} row tiles from the checkpoint in "
          f"{resume_s:.2f} s, identical arrays")

    # Layers: row sums, densify, one row tile's K3, pass 2 and fetch (CUDA
    # events), and every tile's K3 + pass 2 back to back (CUDA events
    # around each) against an unprofiled sweep's wall time: the device
    # busy share. (torch.profiler's tracing slows this sweep's kernels,
    # so a profile would overstate it.)
    t0 = time.perf_counter()
    resumed.global_walks()
    rowsum_s = time.perf_counter() - t0
    t = resumed.tiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.dense_device()
    torch.cuda.synchronize()
    densify_s = time.perf_counter() - t0
    t.drop_dense()
    T = C5_TILE_ROWS

    def k3_tile(i0):
        ids = torch.arange(i0, i0 + T, dtype=torch.int32, device=cc.device)
        return ((cc[i0:i0 + T], cc, dc[i0:i0 + T], dc, ids, TOP_K, n),
                (lim.rows(i0, i0 + T), lim))

    # K3 at tile 0 (the Zipf head, where the multi-limb rows lie) and at
    # a middle tile (the tail's tie-heavy rows)
    mid = (tiles // 2) * T
    k3_args0, k3_limbs0 = k3_tile(0)
    k3_args, k3_limbs = k3_tile(mid)
    row_ids = k3_args[4]
    k3_ms0 = time_ms(torch, lambda: ck.topk_rect_candidates(
        *k3_args0, limbs=k3_limbs0))
    k3_ms = time_ms(torch, lambda: ck.topk_rect_candidates(
        *k3_args, limbs=k3_limbs))
    cv, ccand = ck.topk_rect_candidates(*k3_args, limbs=k3_limbs)
    pass2_ms = time_ms(torch, lambda: sparse.chunked_row_topk(
        cv.view(T, -1), ccand.view(T, -1), TOP_K))
    fv, fi = ck.fused_topk_twopass_rect(*k3_args[:5], k=TOP_K, n_true_cols=n,
                                        limbs=k3_limbs)
    hv = torch.empty(fv.shape, dtype=fv.dtype, pin_memory=True)
    hi = torch.empty(fi.shape, dtype=fi.dtype, pin_memory=True)
    fetch_ms = time_ms(torch, lambda: (hv.copy_(fv, non_blocking=True),
                                       hi.copy_(fi, non_blocking=True)))
    state_before = gpu_state()
    k3_s, pass2_s = tiles_device_s(torch, ck, sparse, cc, dc, lim, n, T,
                                   tiles)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed.topk_scores(k=TOP_K)  # row sums cached: the sweep alone
    sweep_s = time.perf_counter() - t0
    print(f"config 5 layers: row sums ({tiles} tile scatters + GEMVs, one "
          f"fetch) {rowsum_s * 1e3:.1f} ms, densify of C "
          f"{densify_s * 1e3:.1f} ms, K3 {k3_s:.3f} s over all {tiles} tiles "
          f"(tile 0 {k3_ms0:.3f} ms, middle tile {k3_ms:.3f} ms), pass 2 "
          f"{pass2_s:.3f} s (middle tile "
          f"{pass2_ms:.3f} ms), fetch {fetch_ms:.4f} ms a tile; sweep "
          f"{sweep_s:.3f} s, device busy share "
          f"{(k3_s + pass2_s) / sweep_s:.3f} (sm clock, power, temperature "
          f"before: {state_before}; after: {gpu_state()})")

    # K3's times at this row tile: kernel, plain version, library.
    k3_plain_ms = time_ms(torch, lambda: ck.fused_topk_twopass_rect_plain(
        *k3_args[:5], k=TOP_K, n_true_cols=n), reps=3, warmup=1)

    def lib_rect():
        # matmul + normalize + torch.topk, 1024 rows at a time (one
        # [8192, 1M] f32 block and its temporaries would not fit)
        cols = torch.arange(n, device=cc.device)
        out = []
        for q in range(mid, mid + T, 1024):
            m = torch.matmul(cc[q:q + 1024], cc[:n].T)
            den = dc[q:q + 1024, None] + dc[None, :n]
            m = torch.where(den > 0, m.mul_(2.0).div_(den), 0.0)
            m.masked_fill_(cols[None, :] == row_ids[q - mid:q - mid + 1024,
                                                    None], float("-inf"))
            out.append(torch.topk(m, TOP_K, dim=1))
        return out

    k3_lib_ms = time_ms(torch, lib_rect, reps=3, warmup=1)
    n_st = cv.shape[1]
    (k3_bound, k3_by), (k3_f32, _) = rect_bounds(
        k3_limbs[0], lim, T, cc.shape[0], v, TOP_K, n_st)
    (k3_bound0, _), _ = rect_bounds(k3_limbs0[0], lim, T, cc.shape[0], v,
                                    TOP_K, n_st)
    hist, wide = products_histogram(torch, lim, lim.planes.shape[2])
    wide_tiles = [i for i in range(tiles)
                  if ck._needs_wide(lim.rows(i * T, (i + 1) * T), lim)]
    print(f"config 5 limb products per (128-row block, 64-column subtile) "
          f"pair of the rank-all: {hist} (products: pairs); {wide} pairs "
          "fold through f64, the rest sum in one s32 accumulator; row "
          f"tiles whose row sums leave M unbounded below 2^31 (K3's "
          f"instance with the f64 fold): {wide_tiles}")
    print(f"K3 topk_rect_candidates {T}x{cc.shape[0]}x{v} k={TOP_K} "
          f"({n_st} stripes): middle tile (rows {mid}..) {k3_ms:.3f} ms, "
          f"tile 0 {k3_ms0:.3f} ms (int8 tensor-core bound {k3_bound:.3f} / "
          f"{k3_bound0:.3f} ms by {k3_by}; f32 CUDA-core bound {k3_f32:.3f} "
          f"ms); K3 + pass 2 per tile {k3_ms + pass2_ms:.3f} ms; plain "
          f"{k3_plain_ms:.3f} ms; library (matmul+normalize+topk, 1024-row "
          f"chunks) {k3_lib_ms:.3f} ms")
    return {"ms": k3_ms, "ms_tile0": k3_ms0, "plain_ms": k3_plain_ms,
            "bound_ms": k3_bound, "bound_by": k3_by, "bound_f32_ms": k3_f32,
            "bound_int8_ms": k3_bound, "library_ms": k3_lib_ms,
            "c5_err": c5_err}


def square_bounds(lim, n, v, out_bytes):
    """A square kernel's least times on this factor: at the int8 tensor
    cores, the limb products of the N(N+1)/2 pairs of the symmetric S (2 v
    u8 operations each) against the limb planes and denominators read once
    and ``out_bytes`` written; beside it, the f32 CUDA-core bound of the
    N(N+1)V FLOP against the f32 factor read once."""
    int8 = bound(u8_square_ops(lim.counts.long(), v),
                 lim.planes.numel() + 4.0 * n + out_bytes, PEAK_INT8_OPS)
    f32 = bound(scores_flops(n, v), 4.0 * (n * v + n) + out_bytes)
    return int8, f32


def timings(torch, ck, hin, hin_ap, launches, backend, card, k3, instances):
    """Phase 2 at the main path's shapes + phase 4 (times)."""
    from distributed_pathsim_tpu_torch.ops import planner
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    phase("kernels at the main path's shapes")
    dev = torch.device("cuda")
    c, d = factor(hin, "APVPA", dev)
    n, v = c.shape
    lim = ck.split_limbs(c)
    err_k1 = check_topk(torch, ck, c, d, TOP_K, True, "rank-all shape",
                        limbs=lim)
    ca, da = factor(hin_ap, "APVPA", dev)
    lim_a = ck.split_limbs(ca)
    err_k2 = check_scores(torch, ck, ca, da, "all-pairs shape", limbs=lim_a)
    err_k3 = check_rect(torch, ck, c, d, 0, 4096, TOP_K, "rank-all shape",
                        pad_cols=0)
    err_k4 = check_fold(torch, ck, c, d, TOP_K_FOLD, True, "rank-all shape")
    print(f"K1 at {n}x{v} k={TOP_K}, K2 at {ca.shape[0]}x{ca.shape[1]}, K3 "
          f"at a 4096-row tile of it, K4 at k={TOP_K_FOLD}: equal to the "
          "plain versions")

    phase("times (CUDA events, median of 7; K3's are in the config 5 "
          "phase)")
    # K1 and K2 on the split factor, as the dense backend calls them (it
    # splits C once per graph)
    k1_ms = time_ms(torch, lambda: ck.topk_twopass_candidates(
        c, d, TOP_K, True, limbs=lim))
    cv, cc = ck.topk_twopass_candidates(c, d, TOP_K, True, limbs=lim)
    n_st = cv.shape[1]
    pass2_ms = time_ms(torch, lambda: ck.sparse.chunked_row_topk(
        cv.view(n, -1), cc.view(n, -1), TOP_K))
    k1_total_ms = time_ms(torch, lambda: ck.fused_topk_twopass(
        c, d, TOP_K, limbs=lim))
    k1_plain_ms = time_ms(torch, lambda: ck.fused_topk_twopass_plain(
        c, d, TOP_K), reps=5)
    sweep = {}
    for tiles in STRIPE_SWEEP:
        sv, sc = ck.topk_twopass_candidates(c, d, TOP_K, True, limbs=lim,
                                            stripe_tiles=tiles)
        sweep[tiles * ck.TILE] = (
            time_ms(torch, lambda: ck.topk_twopass_candidates(
                c, d, TOP_K, True, limbs=lim, stripe_tiles=tiles)),
            time_ms(torch, lambda: ck.sparse.chunked_row_topk(
                sv.view(n, -1), sc.view(n, -1), TOP_K)))

    def lib_topk():
        m = torch.matmul(c, c.T)
        den = d[:, None] + d[None, :]
        s = torch.where(den > 0, (2.0 * m) / den, 0.0)
        s.fill_diagonal_(float("-inf"))
        return torch.topk(s, TOP_K, dim=1)

    k1_lib_ms = time_ms(torch, lib_topk, reps=5)
    k1_cand_bytes = 8.0 * n * n_st * TOP_K
    (k1_bound, k1_by), (k1_f32, _) = square_bounds(lim, n, v, k1_cand_bytes)

    na, va = ca.shape
    k2_ms = time_ms(torch, lambda: ck.fused_scores(ca, da, limbs=lim_a))
    k2_plain_ms = time_ms(torch, lambda: ck.fused_scores_plain(ca, da))

    def lib_scores():
        m = torch.matmul(ca, ca.T)
        den = da[:, None] + da[None, :]
        return torch.where(den > 0, (2.0 * m) / den, 0.0)

    k2_lib_ms = time_ms(torch, lib_scores)
    (k2_bound, k2_by), (k2_f32, _) = square_bounds(lim_a, na, va,
                                                   4.0 * na * na)

    # K4 on the split factor, and with the split made in the call
    k4_ms = time_ms(torch, lambda: ck.fused_topk(c, d, TOP_K_FOLD,
                                                  limbs=lim))
    k4_call_ms = time_ms(torch, lambda: ck.fused_topk(c, d, TOP_K_FOLD))
    k4_plain_ms = time_ms(torch, lambda: ck.fused_topk_plain(
        c, d, TOP_K_FOLD), reps=5)

    def lib_fold():
        m = torch.matmul(c, c.T)
        den = d[:, None] + d[None, :]
        s = torch.where(den > 0, (2.0 * m) / den, 0.0)
        s.fill_diagonal_(float("-inf"))
        return torch.topk(s, TOP_K_FOLD, dim=1)

    k4_lib_ms = time_ms(torch, lib_fold, reps=5)
    (k4_bound, k4_by), (k4_f32, _) = square_bounds(lim, n, v,
                                                   8.0 * n * TOP_K_FOLD)
    spill = {name: {inst: sp for inst, (_, sp) in insts.items()}
             for name, insts in instances.items()}
    print(f"K1 topk_twopass_candidates {n}x{v} k={TOP_K} ({n_st} stripes of "
          f"{ck.twopass_stripe_tiles(n) * ck.TILE} columns): {k1_ms:.3f} ms on "
          f"the split factor (int8 tensor-core bound {k1_bound:.3f} ms by "
          f"{k1_by} with {k1_cand_bytes / 1e6:.1f} MB of candidates; f32 "
          f"CUDA-core bound {k1_f32:.3f} ms); pass 2 {pass2_ms:.3f} ms; "
          f"K1+pass 2 {k1_total_ms:.3f} ms against K4's {k4_ms:.3f} ms at "
          f"k={TOP_K_FOLD}; plain {k1_plain_ms:.3f} ms; library "
          f"(matmul+normalize+topk) {k1_lib_ms:.3f} ms; spill bytes "
          f"{spill.get('topk_twopass_candidates')}")
    print("K1 by stripe width (columns: K1 ms, pass 2 ms): "
          + ", ".join(f"{w}: {a:.3f}, {b:.3f}" for w, (a, b) in sweep.items()))
    print(f"K2 fused_scores {na}x{va}: {k2_ms:.3f} ms on the split factor "
          f"(int8 tensor-core bound {k2_bound:.3f} ms by {k2_by}: "
          f"{4.0 * na * na / 1e6:.0f} MB of scores written; f32 CUDA-core "
          f"bound {k2_f32:.3f} ms); plain {k2_plain_ms:.3f} ms; library "
          f"(matmul+normalize) {k2_lib_ms:.3f} ms; spill bytes "
          f"{spill.get('fused_scores')}")
    print(f"K4 topk_fold {n}x{v} k={TOP_K_FOLD}: {k4_ms:.3f} ms on the "
          f"split factor, {k4_call_ms:.3f} ms with the split (int8 "
          f"tensor-core bound {k4_bound:.3f} ms by {k4_by} for the limb "
          f"products of the N(N+1)/2 pairs; f32 CUDA-core bound "
          f"{k4_f32:.3f} ms; the kernel does every tile, "
          f"{2.0 * n * n * v / k4_ms / 1e12:.1f} TOP/s of one-limb "
          f"products); plain {k4_plain_ms:.3f} ms; library "
          f"(matmul+normalize+topk) {k4_lib_ms:.3f} ms")

    # Rank-all end to end on a built backend (bench.py's measurement:
    # backend.topk including the host fetch), plus its layers.
    mp = compile_metapath("APVPA", hin.schema)
    t0 = time.perf_counter()
    coo = planner.fold_half(hin, mp)
    fold_s = time.perf_counter() - t0
    backend._half_cache = None  # time the scatter-build of C alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cb, rb = backend._half()
    torch.cuda.synchronize()
    scatter_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lb = backend._limbs(cb)
    torch.cuda.synchronize()
    split_ms = (time.perf_counter() - t0) * 1e3
    rank_times = wall_s(torch, lambda: backend.topk(k=TOP_K))
    rank_s = statistics.median(rank_times)
    busy = device_busy_share(torch, lambda: backend.topk(k=TOP_K))
    fv, fi = ck.fused_topk_twopass(cb, rb, TOP_K, limbs=lb)
    fetch_ms = time_ms(torch, lambda: (fv.cpu(), fi.cpu()))
    pairs = float(n) * (n - 1)
    print(f"rank-all backend.topk: {rank_s * 1e3:.3f} ms median of 5 "
          f"(min {min(rank_times) * 1e3:.3f}, max "
          f"{max(rank_times) * 1e3:.3f}) -> {pairs / rank_s:.4g} "
          f"author-pairs/s on {card}; device busy share "
          + ("not measured (no device time in the profile)" if busy is None
             else f"{busy:.3f}"))
    print(f"layers: host fold {fold_s * 1e3:.1f} ms (nnz {coo.rows.size}), "
          f"scatter-build of C {scatter_s * 1e3:.2f} ms, limb split (once "
          f"per graph) {split_ms:.2f} ms, K1 {k1_ms:.3f} ms, pass 2 "
          f"{pass2_ms:.3f} ms, fetch {fetch_ms:.3f} ms")

    def entry(name, source, replaces, pallas, ms, plain, bnd, by, lib, err,
              f32, int8):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "replaces_kernels": pallas,
            "launches": launches[name], "ok": True, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib, "bound_f32_ms": f32, "bound_int8_ms": int8,
            "spill_bytes": spill.get(name),
        }

    return [
        {**entry("topk_twopass_candidates",
                 "distributed_pathsim_tpu_torch/csrc/topk_twopass.cu",
                 "distributed_pathsim_tpu/ops/pallas_kernels.py:545",
                 ["_topk2_kernel", "_topk2_kernel_kt"],
                 k1_ms, k1_plain_ms, k1_bound, k1_by, k1_lib_ms, err_k1,
                 k1_f32, k1_bound),
         "pass2_ms": pass2_ms, "with_pass2_ms": k1_total_ms,
         "ms_by_stripe_columns": {w: a for w, (a, _) in sweep.items()}},
        entry("fused_scores",
              "distributed_pathsim_tpu_torch/csrc/fused_scores.cu",
              "distributed_pathsim_tpu/ops/pallas_kernels.py:119",
              ["_scores_kernel", "_scores_kernel_kt"],
              k2_ms, k2_plain_ms, k2_bound, k2_by, k2_lib_ms, err_k2,
              k2_f32, k2_bound),
        {**entry("topk_rect_candidates",
                 "distributed_pathsim_tpu_torch/csrc/topk_rect.cu",
                 "distributed_pathsim_tpu/ops/pallas_kernels.py:707",
                 ["_topk2_rect_kernel", "_topk2_rect_kernel_kt"],
                 k3["ms"], k3["plain_ms"], k3["bound_ms"], k3["bound_by"],
                 k3["library_ms"], err_k3, k3["bound_f32_ms"],
                 k3["bound_int8_ms"]),
         "ms_tile0": k3["ms_tile0"], "config5_max_abs_err": k3["c5_err"]},
        entry("topk_fold",
              "distributed_pathsim_tpu_torch/csrc/topk_fold.cu",
              "distributed_pathsim_tpu/ops/pallas_kernels.py:192",
              ["_topk_kernel", "_topk_kernel_kt"],
              k4_ms, k4_plain_ms, k4_bound, k4_by, k4_lib_ms, err_k4,
              k4_f32, k4_bound),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import numpy as np

        from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
        from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
    except ImportError as exc:
        print(f"error: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2
    ck.true_f32()

    name, smi, instances = device_and_build(torch, ck)
    kernel_checks(torch, ck, np, synthetic_hin)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        hin, hin_ap, launches, backend = main_path(
            torch, ck, np, pathlib.Path(tmp)
        )
        k3 = config5(torch, ck, np, launches, pathlib.Path(tmp), smi)
    kernels = timings(torch, ck, hin, hin_ap, launches, backend, smi, k3,
                      instances)
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "distributed_pathsim_tpu")]
    if leaked:
        raise AssertionError(f"JAX-side modules imported: {leaked[:5]}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
