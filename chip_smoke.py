#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``distributed_pathsim_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py     # exit 0 only if every phase passes

Phases (each prints its lines; any failure raises, so the exit code is
nonzero and no result line is printed):

1. device and build: the card's name and power limit, the nvcc build of
   every kernel in ``distributed_pathsim_tpu_torch/csrc`` (all sources
   compiled in parallel) and the compiler's register/spill report;
2. every kernel against its plain torch version, zero tolerance
   (``torch.equal`` on values and indices), at small odd shapes, tie-heavy
   rows, zero-degree targets, wide contractions, and at the main path's
   shapes;
3. the main path through the port's CLI (``--platform cuda --backend
   torch``) on synthetic GEXF files written by the port: rank-all at
   32768 authors x 45000 papers x 384 venues (seed 42, k = 10) checked
   bit for bit against the numpy f64 oracle's counts, single source with
   its log's line count, all-pairs at 8192 authors; the kernels' launch
   counters are zeroed before each run and read after it;
4. times on the card (CUDA events, median of 7 after 2 warm-ups): each
   kernel, its plain version, a library yardstick that the port never
   calls, the least time the card could take (bound), and the rank-all
   wall time as author-pairs/s with its per-layer breakdown.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Nothing here imports JAX.
"""

from __future__ import annotations

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

# Published H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores
# (no tensor cores: the kernels must not use TF32) and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

REPS, WARMUP = 7, 2


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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_abs_err(torch, got, want) -> float:
    """Largest |got - want| over entries finite in both; inf entries
    must coincide (checked by the caller's torch.equal)."""
    fin = torch.isfinite(got) & torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0
    return float((got[fin].double() - want[fin].double()).abs().max())


# -- phases -----------------------------------------------------------------


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
    for kname, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {kname}: {line.strip()}")
    return name, smi


def check_topk(torch, ck, c, d, k, mask_self, label):
    """K1 (candidates and final top-k) against the plain versions."""
    cv, cc = ck.topk_twopass_candidates(c, d, k, mask_self)
    pv, pc = ck.topk_twopass_candidates_plain(c, d, k, mask_self)
    torch.cuda.synchronize()
    if not (torch.equal(cv, pv) and torch.equal(cc, pc)):
        bad = (cv != pv) | (cc != pc)
        raise AssertionError(
            f"K1 candidates differ from the plain version ({label}, k={k}, "
            f"mask_self={mask_self}): {int(bad.sum())} entries"
        )
    fv, fc = ck.fused_topk_twopass(c, d, k=k, mask_self=mask_self)
    gv, gc = ck.fused_topk_twopass_plain(c, d, k=k, mask_self=mask_self)
    if not (torch.equal(fv, gv) and torch.equal(fc, gc)):
        raise AssertionError(
            f"K1 top-k differs from the plain version ({label}, k={k}, "
            f"mask_self={mask_self})"
        )
    return max_abs_err(torch, fv, gv)


def check_scores(torch, ck, c, d, label):
    got = ck.fused_scores(c, d)
    want = ck.fused_scores_plain(c, d)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got - want).abs().max()
        raise AssertionError(
            f"K2 differs from the plain version ({label}): max |diff| {diff}"
        )
    return max_abs_err(torch, got, want)


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
    check_scores(torch, ck, c, d, "APVPA 3001x64")
    print("K1/K2 narrow (APVPA, n=3001, v=64, k in 1/10/16, both masks): equal")

    cw, dw = factor(hin, "APA", dev)  # v = #papers: 282 K steps of 16
    for mask_self in (True, False):
        check_topk(torch, ck, cw, dw, 10, mask_self, "APA wide")
    check_scores(torch, ck, cw, dw, "APA wide")
    print(f"K1/K2 wide (APA, n=3001, v={cw.shape[1]}): equal")

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
        ck.reset_launches()
        t0 = time.perf_counter()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(ck.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"{label}: CLI exited {rc}")
        for name, cnt in counts.items():
            launches[name] += cnt
        print(f"{label}: rc 0 in {dt:.2f} s, launches {counts}")
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
    got: dict[str, list[tuple[str, float]]] = {}
    with open(ranking, encoding="utf-8") as f:
        next(f)
        for line in f:
            s, _, t, v = line.rstrip("\n").split("\t")
            got.setdefault(s, []).append((t, float(v)))
    if len(got) != N_AUTHORS:
        raise AssertionError(f"ranking has {len(got)} sources")
    ids = hin.indices["author"].ids
    d = oracle.global_walks()
    d32 = d.astype(np.float32)
    for row in (0, 7, 12345, N_AUTHORS - 1):
        m = oracle.pairwise_row(row)
        den = d32[row] + d32
        s32 = np.where(den > 0, np.float32(2.0) * m.astype(np.float32)
                       / np.where(den > 0, den, np.float32(1.0)),
                       np.float32(0.0))
        s32[row] = -np.inf
        order = np.argsort(-s32, kind="stable")[:TOP_K]
        want = [(ids[j], float(s32[j])) for j in order]
        if got[ids[row]] != want:
            raise AssertionError(f"ranking row {row} differs from the oracle")
        s64 = np.where(d[row] + d > 0, 2.0 * m / np.maximum(d[row] + d, 1), 0.0)
        s64[row] = -np.inf
        np.testing.assert_allclose(
            [v for _, v in got[ids[row]]], np.sort(s64)[::-1][:TOP_K],
            atol=1e-6,
        )
    print("rank-all rows 0/7/12345/32767: bit-identical to the f32 "
          "renormalization of the f64 oracle's counts")

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
    return hin, hin_ap, launches, backend


def timings(torch, ck, hin, hin_ap, launches, backend, card):
    """Phase 2 at the main path's shapes + phase 4 (times)."""
    from distributed_pathsim_tpu_torch.ops import planner
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    phase("kernels at the main path's shapes")
    dev = torch.device("cuda")
    c, d = factor(hin, "APVPA", dev)
    n, v = c.shape
    err_k1 = check_topk(torch, ck, c, d, TOP_K, True, "rank-all shape")
    ca, da = factor(hin_ap, "APVPA", dev)
    err_k2 = check_scores(torch, ck, ca, da, "all-pairs shape")
    print(f"K1 at {n}x{v} k={TOP_K} and K2 at {ca.shape[0]}x{ca.shape[1]}: "
          "equal to the plain versions")

    phase("times (CUDA events, median of 7)")
    k1_ms = time_ms(torch, lambda: ck.topk_twopass_candidates(c, d, TOP_K, True))
    cv, cc = ck.topk_twopass_candidates(c, d, TOP_K, True)
    pass2_ms = time_ms(torch, lambda: ck.sparse.chunked_row_topk(
        cv.view(n, -1), cc.view(n, -1), TOP_K))
    k1_total_ms = time_ms(torch, lambda: ck.fused_topk_twopass(c, d, TOP_K))
    k1_plain_ms = time_ms(torch, lambda: ck.fused_topk_twopass_plain(
        c, d, TOP_K), reps=5)

    def lib_topk():
        m = torch.matmul(c, c.T)
        den = d[:, None] + d[None, :]
        s = torch.where(den > 0, (2.0 * m) / den, 0.0)
        s.fill_diagonal_(float("-inf"))
        return torch.topk(s, TOP_K, dim=1)

    k1_lib_ms = time_ms(torch, lib_topk, reps=5)
    n_ct = -(-n // ck.TILE)
    k1_bound, k1_by = bound(scores_flops(n, v),
                            4.0 * (n * v + n) + 8.0 * n * n_ct * TOP_K)

    na, va = ca.shape
    k2_ms = time_ms(torch, lambda: ck.fused_scores(ca, da))
    k2_plain_ms = time_ms(torch, lambda: ck.fused_scores_plain(ca, da))

    def lib_scores():
        m = torch.matmul(ca, ca.T)
        den = da[:, None] + da[None, :]
        return torch.where(den > 0, (2.0 * m) / den, 0.0)

    k2_lib_ms = time_ms(torch, lib_scores)
    k2_bound, k2_by = bound(scores_flops(na, va),
                            4.0 * (na * va + na) + 4.0 * na * na)
    print(f"K1 topk_twopass_candidates {n}x{v} k={TOP_K}: {k1_ms:.3f} ms "
          f"(bound {k1_bound:.3f} ms by {k1_by} at N(N+1)V FLOP; the "
          f"kernel does 2N^2V FLOP at "
          f"{2.0 * n * n * v / k1_ms / 1e9:.1f} TFLOP/s); pass 2 "
          f"{pass2_ms:.3f} ms; K1+pass 2 {k1_total_ms:.3f} ms; plain "
          f"{k1_plain_ms:.3f} ms; library (matmul+normalize+topk) "
          f"{k1_lib_ms:.3f} ms")
    print(f"K2 fused_scores {na}x{va}: {k2_ms:.3f} ms (bound {k2_bound:.3f} "
          f"ms by {k2_by} at N(N+1)V FLOP); plain {k2_plain_ms:.3f} ms; library "
          f"(matmul+normalize) {k2_lib_ms:.3f} ms")

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
    rank_times = wall_s(torch, lambda: backend.topk(k=TOP_K))
    rank_s = statistics.median(rank_times)
    busy = device_busy_share(torch, lambda: backend.topk(k=TOP_K))
    fv, fi = ck.fused_topk_twopass(cb, rb, TOP_K)
    fetch_ms = time_ms(torch, lambda: (fv.cpu(), fi.cpu()))
    pairs = float(n) * (n - 1)
    print(f"rank-all backend.topk: {rank_s * 1e3:.3f} ms median of 5 "
          f"(min {min(rank_times) * 1e3:.3f}, max "
          f"{max(rank_times) * 1e3:.3f}) -> {pairs / rank_s:.4g} "
          f"author-pairs/s on {card}; device busy share "
          + ("not measured (no device time in the profile)" if busy is None
             else f"{busy:.3f}"))
    print(f"layers: host fold {fold_s * 1e3:.1f} ms (nnz {coo.rows.size}), "
          f"scatter-build of C {scatter_s * 1e3:.2f} ms, K1 {k1_ms:.3f} ms, "
          f"pass 2 {pass2_ms:.3f} ms, fetch {fetch_ms:.3f} ms")

    def entry(name, source, replaces, pallas, ms, plain, bnd, by, lib, err):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "replaces_kernels": pallas,
            "launches": launches[name], "ok": True, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib,
        }

    return [
        entry("topk_twopass_candidates",
              "distributed_pathsim_tpu_torch/csrc/topk_twopass.cu",
              "distributed_pathsim_tpu/ops/pallas_kernels.py:545",
              ["_topk2_kernel", "_topk2_kernel_kt"],
              k1_ms, k1_plain_ms, k1_bound, k1_by, k1_lib_ms, err_k1),
        entry("fused_scores",
              "distributed_pathsim_tpu_torch/csrc/fused_scores.cu",
              "distributed_pathsim_tpu/ops/pallas_kernels.py:119",
              ["_scores_kernel", "_scores_kernel_kt"],
              k2_ms, k2_plain_ms, k2_bound, k2_by, k2_lib_ms, err_k2),
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

    name, smi = device_and_build(torch, ck)
    kernel_checks(torch, ck, np, synthetic_hin)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        hin, hin_ap, launches, backend = main_path(
            torch, ck, np, pathlib.Path(tmp)
        )
    kernels = timings(torch, ck, hin, hin_ap, launches, backend, smi)
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
