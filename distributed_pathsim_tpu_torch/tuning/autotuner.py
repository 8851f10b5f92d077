"""Offline autotuner: measure every registered knob per shape key.

``dpathsim-torch tune`` (and the bigger sweep in :mod:`.sweep`)
micro-benchmarks each knob's candidate arms per key ``(device_kind,
N-bucket, V-bucket, density-bucket, dtype)`` and writes the winning
choices as a versioned, content-addressed dispatch table
(:mod:`~distributed_pathsim_tpu_torch.tuning.table`) that
``--tuning-table`` / ``PATHSIM_TUNING_TABLE`` read. The JAX package's
autotuner (``distributed_pathsim_tpu/tuning/autotuner.py``) is the
reference: the same racers, arm names, ``{knob: (choice, arms)}``
contract, per-arm audit fields and recall gates.

Timing discipline is the shared estimator (utils/benchrunner.py):
candidate arms are **interleaved** per round and compared by
**median-of-best**, so drift of a shared host hits every arm alike.
Every table entry records all arms' summaries, so a choice is auditable
from the table alone. Every arm that launches work on the card finishes
it before it returns (``torch.cuda.synchronize`` or a fetch to the
host): an arm that returned at launch would time the launch.

Platform honesty: an arm that cannot run for real on the current device
is *not* measured. The kernels' plain versions are references, not
arms: timing one would tune the card by a torch program it never runs.
So the kernel knobs (``twopass_stripe_tiles`` for K1,
``rect_target_units`` for K3) and ``ring_kernel`` (whose one arm is K3)
record nothing on the CPU, and every arm on the card goes through the
kernels. The JAX package's Pallas racers ``bench_scores``,
``bench_topk_rowtile`` and ``bench_k_tile`` have no counterpart here:
their knobs have no port arm (tuning/registry.py — K2's and K4's tiles
are compile-time wgmma shapes, and an "xla" arm would be a plain
version on the card).

Each racer's factor is made of integer counts, like the real half-chain
factor (the kernels take nothing else), in a few distinct buffers made
from one seed each, so repeated timed calls never see identical inputs;
each buffer's u8 limbs are split once, outside every timed call, as the
backends cache them. K1's racer times the APVPA half chain of a
synthetic DBLP-shaped graph (``_hin_factor``): K1's selection work, and
with it its best stripe width, follows the factor's data (its row
degrees and limb mix), not only its shape, and a uniform random factor
ranks the widths differently from a real graph's.

Dtype hygiene: every arm computes in float32 (the kernels' input type),
so entries are keyed ``float32``; a lookup with another dtype misses to
its heuristic, visible as ``dpathsim_tuning_lookups_total
{result="default"}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools

import numpy as np

from ..utils import benchrunner as br
from ..utils.logging import runtime_event
from . import dispatch
from .registry import KNOBS, resolve_ladder
from .table import TuningTable, make_key


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One shape key to tune: dense when nnz is None."""

    n: int
    v: int
    nnz: int | None = None

    @classmethod
    def parse(cls, spec: str) -> "SweepPoint":
        parts = [int(p) for p in spec.lower().split("x")]
        if len(parts) == 2:
            return cls(parts[0], parts[1])
        if len(parts) == 3:
            return cls(parts[0], parts[1], parts[2])
        raise ValueError(f"bad shape spec {spec!r}; want NxV or NxVxNNZ")


def _dense_factor(n: int, v: int, device, seed: int = 0, variants: int = 3):
    """``variants`` distinct integer factors C [n, v] (counts 0..2, one
    seed each), each with its denominators and its u8 limbs split once
    (``cuda_kernels.kernel_limbs``; None on the CPU): a list of
    (c, d, limbs)."""
    import torch

    from ..ops import cuda_kernels as ck

    out = []
    for i in range(max(variants, 1)):
        rng = np.random.default_rng(seed + i)
        c = torch.as_tensor(
            rng.integers(0, 3, size=(n, v)).astype(np.float32), device=device)
        d = torch.clamp(c.sum(dim=1), min=1.0)
        out.append((c, d, ck.kernel_limbs(c)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


# Papers per author of the bench graph (32,768 authors, 45,000 papers,
# 384 venues: chip_smoke.py's N_AUTHORS / N_PAPERS / N_VENUES).
_PAPERS_PER_AUTHOR = 45_000 / 32_768


def _hin_factor(n: int, v: int, device, seed: int = 0, variants: int = 3):
    """``variants`` APVPA half-chain factors C [n, v] of synthetic
    DBLP-shaped graphs (``data.synthetic.synthetic_hin``: n authors with
    a Zipf head, the bench graph's papers per author, v venues; one seed
    each), each with its PathSim denominators (global walks) and its u8
    limbs split once (``cuda_kernels.kernel_limbs``): a list of
    (c, d, limbs), the dense rank-all's operands for such a graph."""
    from ..data.encode import factor_from_arrays
    from ..data.synthetic import synthetic_hin
    from ..ops import cuda_kernels as ck
    from ..ops import planner
    from ..ops.metapath import compile_metapath

    out = []
    for i in range(max(variants, 1)):
        hin = synthetic_hin(n, max(1, round(n * _PAPERS_PER_AUTHOR)), v,
                            seed=seed + i)
        c = planner.dense_half(hin, compile_metapath("APVPA", hin.schema),
                               dtype=np.float64)
        c, d = factor_from_arrays(c, c @ c.sum(0), device)
        out.append((c, d, ck.kernel_limbs(c)))
    _finish(device)
    return out


def _cycled(fn, buffers):
    counter = itertools.count()

    def run():
        fn(buffers[next(counter) % len(buffers)])

    return run


def _sparse_coo(n: int, v: int, nnz: int, seed: int = 0):
    from ..ops import sparse as sp

    rng = np.random.default_rng(seed)
    return sp.COOMatrix(
        rows=rng.integers(0, n, size=nnz).astype(np.int64),
        cols=rng.integers(0, v, size=nnz).astype(np.int64),
        weights=np.ones(nnz, dtype=np.float64),
        shape=(n, v),
    )


def _finish(device):
    """Wait for the card: every arm ends here, so it times its kernels,
    not their launches."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _tiled_rect_factor(t, device):
    """A :class:`~..ops.sparse.TiledHalfChain`'s dense C and its row-sum
    denominators (rows padded to whole tiles) as K3 takes them, made
    once (``cuda_kernels.rect_pad_factor``), as torch-sparse's rect path
    caches them."""
    import torch

    from ..ops import cuda_kernels as ck

    d_pad = torch.zeros(t.n_tiles * t.tile_rows, dtype=torch.float32,
                        device=device)
    d_pad[: t.n] = torch.as_tensor(t.rowsums(), dtype=torch.float32,
                                   device=device)
    cc, dc, limbs = ck.rect_pad_factor(t.dense_device(), d_pad)
    t.drop_dense()
    ids = torch.arange(cc.shape[0], dtype=torch.int32, device=device)
    return cc, dc, limbs, ids


def _rect_sweep(prep, n: int, tile_rows: int, k: int,
                stripe_tiles: int | None = None) -> None:
    """torch-sparse's rect rank-all (``_topk_row_tile``): K3 + pass 2
    for every live row tile against the whole column range."""
    from ..ops import cuda_kernels as ck

    cc, dc, limbs, ids = prep
    for i0 in range(0, n, tile_rows):
        ck.fused_topk_twopass_rect(
            cc[i0:i0 + tile_rows], cc, dc[i0:i0 + tile_rows], dc,
            ids[i0:i0 + tile_rows], k=k, n_true_cols=n,
            limbs=None if limbs is None else (
                limbs.rows(i0, i0 + tile_rows), limbs),
            stripe_tiles=stripe_tiles,
        )


# ---------------------------------------------------------------------------
# Per-knob benches. Each returns {knob: (choice, results_by_arm)} for one
# sweep point; the driver turns those into table entries.
# ---------------------------------------------------------------------------


def bench_twopass_stripe(point: SweepPoint, reps: int, device,
                         k: int = 10) -> dict:
    """``twopass_stripe_tiles``: K1 + pass 2 (``fused_topk_twopass``,
    the dense rank-all) at each candidate stripe width over synthetic
    graphs' half chains (``_hin_factor``), on the card only (on the CPU
    the plain version would run: no real arm)."""
    from ..ops import cuda_kernels as ck

    if device.type != "cuda":
        return {}
    ctx = {"n": point.n, "v": point.v, "k": k,
           "budget_bytes": ck.candidate_budget_bytes(device)}
    widths = KNOBS["twopass_stripe_tiles"].candidates(ctx)
    if not widths:
        return {}
    bufs = _hin_factor(point.n, point.v, device)

    def arm(width: int):
        def fn(buf):
            c, d, lim = buf
            ck.fused_topk_twopass(c, d, k=k, limbs=lim, stripe_tiles=width)
            _finish(device)

        return _cycled(fn, bufs)

    res = br.time_interleaved({f"stripe{w}": arm(w) for w in widths}, reps)
    return {"twopass_stripe_tiles": (
        int(br.best_arm(res).removeprefix("stripe")), res)}


def bench_rect_units(point: SweepPoint, reps: int, device,
                     k: int = 10) -> dict:
    """``rect_target_units``: a full K3 row-tile sweep (torch-sparse's
    rect path at its untuned tile height) over a synthetic COO factor,
    per candidate target, on the card only. Targets that give the same
    stripe width run the same launches, so only the first of each width
    is measured; targets whose candidate buffer passes the budget are
    skipped, as the runtime would refuse them."""
    from ..ops import cuda_kernels as ck
    from ..ops import sparse as sp

    if device.type != "cuda" or not ck.rect_supported(point.v, k):
        return {}
    nnz = point.nnz or 8 * point.n
    tile_rows = min(4096, point.n)  # torch-sparse's untuned tile height
    t = sp.TiledHalfChain(_sparse_coo(point.n, point.v, nnz),
                          tile_rows=tile_rows, device=device)
    n_cols = t.n_tiles * t.tile_rows
    budget = ck.candidate_budget_bytes(device)
    widths: dict[int, int] = {}
    for units in KNOBS["rect_target_units"].candidates(
            {"n": point.n, "v": point.v}):
        w = ck._stripe_tiles_for_units(tile_rows, n_cols, units)
        fits = tile_rows * ck._rect_n_stripes(n_cols, w) * k * 8 <= budget
        if fits and w not in widths.values():
            widths[units] = w
    if not widths:
        return {}
    prep = _tiled_rect_factor(t, device)

    def arm(width: int):
        def run():
            _rect_sweep(prep, point.n, tile_rows, k, stripe_tiles=width)
            _finish(device)

        return run

    res = br.time_interleaved(
        {f"units{u}": arm(w) for u, w in widths.items()}, reps)
    return {"rect_target_units": (
        int(br.best_arm(res).removeprefix("units")), res)}


def bench_sparse_tiles(point: SweepPoint, reps: int, device,
                       k: int = 10) -> dict:
    """torch-sparse streaming tile width: a full streaming top-k pass
    per candidate width over the same synthetic COO factor, by the arm
    the backend takes (``_compute_path``): K3 + pass 2 per row tile on
    the card, the scanned torch fold on the CPU. On the card a width
    whose K3 candidate buffer would pass the budget is skipped (the
    backend would run the torch fold there, a plain version: no real
    arm), as ``bench_rect_units`` skips such targets."""
    from ..ops import cuda_kernels as ck
    from ..ops import sparse as sp

    on_card = device.type == "cuda"
    if on_card and not ck.rect_supported(point.v, k):
        return {}
    nnz = point.nnz or 8 * point.n
    coo = _sparse_coo(point.n, point.v, nnz)
    ctx = {"n": point.n, "v": point.v}
    # clamp candidates to N and dedupe BEFORE measuring: the recorded
    # choice must be the tile width that actually ran, not a nominal
    # candidate silently clamped inside the bench
    widths = sorted({
        min(int(cand), point.n)
        for cand in KNOBS["sparse_tile_rows"].candidates(ctx)
    })
    arms = {}
    for cand in widths:
        t = sp.TiledHalfChain(coo, tile_rows=cand, device=device)
        if on_card:
            if not ck.rect_fits(t.n_tiles * t.tile_rows, t.tile_rows, k,
                                device, point.v):
                continue
            prep = _tiled_rect_factor(t, device)

            def run(prep=prep, tr=t.tile_rows):
                _rect_sweep(prep, point.n, tr, k)
                _finish(device)
        else:
            import torch

            c_all = t.dense_device()
            d_pad = torch.zeros(t.n_tiles * t.tile_rows, dtype=t.dtype,
                                device=device)
            d_pad[: t.n] = torch.as_tensor(t.rowsums(), dtype=t.dtype,
                                           device=device)

            def run(t=t, c_all=c_all, d_pad=d_pad):
                for i in range(t.n_tiles):
                    sp.stream_row_tile_topk(
                        c_all, d_pad, i * t.tile_rows, k=k, n_true=point.n,
                        tile_rows=t.tile_rows,
                    )

        arms[f"tile{cand}"] = run
    if not arms:
        return {}
    res = br.time_interleaved(arms, reps)
    return {"sparse_tile_rows": (int(br.best_arm(res)[4:]), res)}


def bench_sparse_nnz_floor(point: SweepPoint, reps: int, device,
                           drift_steps: int = 6) -> dict:
    """Scatter-pad bucket floor under delta drift: each round walks a
    FRESH drifting-nnz sequence and rebuilds + densifies the tile; a
    low floor re-crosses pow-2 pad boundaries (a new scatter shape, new
    device buffers), a high floor pays pad-scatter waste — the
    production trade of torch-sparse's ``nnz_bucket_floor``."""
    from ..ops import sparse as sp

    nnz = point.nnz or 8 * point.n

    def arm(floor: int):
        # per-ARM call counter: time_interleaved calls every arm once
        # per round, so call r of each arm shares the same base nnz —
        # every floor walks the identical drift sequence in a round
        round_no = itertools.count()

        def run():
            base = nnz + 977 * next(round_no)
            for s in range(drift_steps):
                coo = _sparse_coo(point.n, point.v, base + 61 * s, seed=s)
                t = sp.TiledHalfChain(
                    coo, tile_rows=min(2048, point.n),
                    nnz_bucket_floor=floor, device=device,
                )
                t.tile(0)
            _finish(device)

        return run

    arms = {
        f"floor{f}": arm(f)
        for f in KNOBS["sparse_nnz_floor"].candidates(
            {"n": point.n, "v": point.v}
        )
    }
    res = br.time_interleaved(arms, reps, warmup=0)
    return {"sparse_nnz_floor": (int(br.best_arm(res)[5:]), res)}


def bench_planner(point: SweepPoint, reps: int) -> dict:
    """plan_density_cutover + plan_memo_budget_mb — real arms over a
    synthetic HIN at the sweep point's scale (host folds, any device).

    Cutover arms: plan a 4-factor asymmetric COO chain (APVPT) under
    each density threshold and time the plan-ordered sparse fold — the
    threshold decides where the DP switches from the join-size estimate
    to the dense model, which flips the association order it picks.
    Memo arms: a rotating mixed APVPA/APA/APTPA fold workload over
    several graph variants per budget — a small budget thrashes the
    LRU, a large one keeps every shared sub-chain resident."""
    from ..data.synthetic import synthetic_hin
    from ..ops import planner
    from ..ops import sparse as _sp
    from ..ops.metapath import compile_metapath

    n = point.n
    hin = synthetic_hin(
        n, 2 * n, max(point.v // 4, 4), n_topics=max(point.v // 8, 8),
        seed=3,
    )
    mp = compile_metapath("APVPT", hin.schema)
    blocks = []
    for st in mp.steps:
        b = _sp.coo_from_block(hin.block(st.relationship))
        if st.reverse:
            b = _sp.COOMatrix(
                rows=b.cols, cols=b.rows, weights=b.weights,
                shape=(b.shape[1], b.shape[0]),
            )
        blocks.append(b.summed())
    arms = {}
    for cut in KNOBS["plan_density_cutover"].candidates(
        {"n": n, "v": len(mp.steps)}
    ):

        def fn(cut=cut):
            out = planner.fold_blocks(blocks, dense_cutover=float(cut))
            return int(out.rows.shape[0])

        arms[f"cut{cut}"] = fn
    res = br.time_interleaved(arms, reps)
    out = {
        "plan_density_cutover": (
            float(br.best_arm(res).removeprefix("cut")), res
        ),
    }

    variants = [
        synthetic_hin(
            n, 2 * n, max(point.v // 4, 4),
            n_topics=max(point.v // 8, 8), seed=11 + s,
        )
        for s in range(4)
    ]
    paths = [
        compile_metapath(spec, variants[0].schema)
        for spec in ("APVPA", "APA", "APTPA")
    ]

    def memo_arm(mb: float):
        memo = planner.SubchainCache(int(mb * (1 << 20)))

        def run():
            for h in variants:
                for p in paths:
                    planner.fold_half(h, p, memo=memo)

        return run

    memo_arms = {
        f"mb{mb}": memo_arm(mb)
        for mb in KNOBS["plan_memo_budget_mb"].candidates({"n": n})
    }
    memo_res = br.time_interleaved(memo_arms, reps)
    out["plan_memo_budget_mb"] = (
        float(br.best_arm(memo_res).removeprefix("mb")), memo_res
    )
    return out


def bench_factor_format(point: SweepPoint, reps: int, device,
                        k: int = 10) -> dict:
    """``factor_format`` — real arms: one torch-sparse backend per
    resident layout over the same graph, raced on the batched serving
    primitive (``topk_rows`` over a rotating row workload, fetched to
    the host — the path where a packed layout pays its decode cost).
    Fewer bytes is structurally never faster, so racing on time alone
    could never pick a packed layout: any arm within the measured noise
    of the fastest competes, and among those the smallest resident
    factor wins. Measured bytes ride along per arm."""
    from ..backends.base import create_backend
    from ..data.synthetic import synthetic_hin
    from ..ops.metapath import compile_metapath

    n = point.n
    hin = synthetic_hin(n, 2 * n, max(point.v // 4, 8), seed=0)
    mp = compile_metapath("APVPA", hin.schema)
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, n, size=16) for _ in range(6)]
    backends = {}
    bytes_by: dict[str, int] = {}
    for fmt in KNOBS["factor_format"].candidates({"n": n}):
        b = create_backend("torch-sparse", hin, mp, factor_format=fmt,
                           device=device)
        b.topk_rows(rows[0], k=k)  # device buffers outside the timed region
        backends[fmt] = b
        bytes_by[fmt] = int(b.factor_info()["bytes"])

    def arm(fmt: str):
        b = backends[fmt]
        return _cycled(lambda r: b.topk_rows(r, k=k), rows)

    res = br.time_interleaved({f: arm(f) for f in backends}, reps)
    for fmt in backends:
        res[fmt]["factor_bytes"] = bytes_by[fmt]
    noise = br.noise_bound(res)
    floor_ms = res[br.best_arm(res)]["median_of_best_ms"] * (1.0 + noise)
    winner = min(
        (f for f in backends
         if res[f]["median_of_best_ms"] <= floor_ms),
        key=lambda f: (bytes_by[f], f),
    )
    return {"factor_format": (winner, res)}


def bench_compaction(point: SweepPoint, reps: int, k: int = 10) -> dict:
    """``compact_chain_len`` + ``compact_headroom`` — real arms: a warm
    service absorbing a sustained delta stream (edge adds plus periodic
    node appends, interleaved with affected-row queries) under each
    trigger setting, end to end. The numpy backend keeps the race about
    the knob's own trade — host-side re-encode/replay work vs per-delta
    bookkeeping; compaction itself is bit-invisible (token, fingerprints,
    caches preserved), so every arm serves identical answers."""
    from ..backends.base import create_backend
    from ..data import delta as dl
    from ..data.synthetic import synthetic_hin
    from ..ops.metapath import compile_metapath
    from ..serving import PathSimService, ServeConfig

    n = min(point.n, 2048)
    n_deltas = 96

    def workload(chain_len: int, headroom: float):
        hin = dl.with_headroom(
            synthetic_hin(n, 2 * n, max(point.v // 8, 8), seed=0), 0.25
        )
        mp = compile_metapath("APVPA", hin.schema)
        svc = PathSimService(
            create_backend("numpy", hin, mp),
            config=ServeConfig(
                max_batch=8, max_wait_ms=0.2, warm=False,
                compact_auto=True, compact_chain_len=chain_len,
                compact_headroom=headroom, compact_cooldown_s=0.0,
            ),
        )
        rng = np.random.default_rng(0)
        ap = hin.blocks["author_of"]
        existing = set(zip(ap.rows.tolist(), ap.cols.tolist()))
        append_seq = itertools.count()

        def run():
            for i in range(n_deltas):
                adds = []
                while len(adds) < 2:
                    e = (int(rng.integers(0, n)),
                         int(rng.integers(0, 2 * n)))
                    if e not in existing:
                        existing.add(e)
                        adds.append(e)
                nodes = ()
                if i % 6 == 5:
                    nodes = (
                        dl.NodeAppend(node_type="venue", count=1)
                        if hin.indices["venue"].size_override is not None
                        else dl.NodeAppend(
                            node_type="venue",
                            ids=(f"v_extra_{next(append_seq)}",),
                        ),
                    )
                svc.update(dl.DeltaBatch(
                    edges=(dl.edge_delta("author_of", add=adds),),
                    nodes=nodes,
                ))
                svc.topk_index(int(adds[0][0]), k=k)
            # fold any in-flight build into the measurement: the arm's
            # cost includes the re-encodes it scheduled
            svc._compactor._done.wait(60.0)

        return svc, run

    out: dict = {}
    for knob, arms_of in (
        ("compact_chain_len",
         lambda c: workload(int(c), 0.25)),
        ("compact_headroom",
         lambda c: workload(8, float(c))),
    ):
        services, arms = [], {}
        for cand in KNOBS[knob].candidates({"n": n}):
            svc, run = arms_of(cand)
            services.append(svc)
            arms[f"arm{cand}"] = run
        res = br.time_interleaved(arms, reps, warmup=0)
        win = br.best_arm(res)
        choice = win.removeprefix("arm")
        out[knob] = (
            int(choice) if knob == "compact_chain_len"
            else float(choice),
            res,
        )
        for svc in services:
            svc.close()
    return out


def bench_ring(point: SweepPoint, reps: int, device, k: int = 10) -> dict:
    """Ring-step fold choice on a 1-shard mesh: the ring a real mesh
    runs per step, minus the hop. Its one arm is ``rect-cuda`` (K3), on
    the card only: the torch fold is a plain version, never an arm, so
    on the CPU nothing is recorded."""
    import torch

    from ..ops import cuda_kernels as ck
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import shard_first_block_rows, sharded_topk

    if device.type != "cuda" or not ck.rect_supported(point.v, k):
        return {}
    mesh = make_mesh(1, devices=[device])
    firsts = []
    for c, _, _ in _dense_factor(point.n, point.v, device):
        first = shard_first_block_rows(c, mesh)
        firsts.append((first, [ck.kernel_limbs(b.to(torch.float32)
                                               .contiguous())
                               for b in first]))

    def fn(buf):
        first, limbs = buf
        sharded_topk(first, (), mesh=mesh, k=k, n_true=point.n,
                     use_kernel=True, limbs=limbs)
        _finish(device)

    res = br.time_interleaved({"rect-cuda": _cycled(fn, firsts)}, reps)
    return {"ring_kernel": (br.best_arm(res), res)}


def bench_serve_buckets(n_authors: int, max_batch: int, reps: int, device,
                        k: int = 10, seed: int = 0) -> dict:
    """Bucket-ladder geometry: steady-state batched dispatch
    (``topk_rows``, fetched to the host) over a mixed batch-size
    workload, per candidate ladder, on one backend warmed for every
    ladder first, so the timed phase is the serving steady state. The
    warm cost — the other half of the trade — is recorded per arm: each
    ladder's first dispatch of every bucket from a fresh backend
    (``utils/compile_counter.warm_compile_cache``, with its compiles
    counted by a ``CompileCounter``). The port has no jit cache to clear
    between geometries (the JAX package clears XLA's): a fresh backend
    owns no device buffers, and the process-wide one-time costs (CUDA
    context, kernel libraries, library handles) are paid by the shared
    backend's warmup before any geometry is measured, so the numbers
    stay order-independent."""
    import time as _time

    from ..backends.base import create_backend
    from ..data.synthetic import synthetic_hin
    from ..ops.metapath import compile_metapath
    from ..serving import buckets as bk
    from ..utils.compile_counter import CompileCounter, warm_compile_cache

    hin = synthetic_hin(n_authors, 2 * n_authors, 24, seed=seed)
    mp = compile_metapath("APVPA", hin.schema)
    backend = create_backend("torch", hin, mp, device=device)
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, max_batch + 1, size=24)
    rows = rng.integers(0, n_authors, size=(24, max_batch))

    geometries = KNOBS["serve_buckets"].candidates({"n": n_authors})
    ladders = {g: resolve_ladder(g, max_batch) for g in geometries}
    for g in geometries:
        warm_compile_cache(backend, ladders[g], k=k)
    warm_s: dict[str, float] = {}
    warm_compiles: dict[str, int] = {}
    for g in geometries:
        fresh = create_backend("torch", hin, mp, device=device)
        with CompileCounter() as cc:
            t0 = _time.perf_counter()
            warm_compile_cache(fresh, ladders[g], k=k)
            _finish(device)
            warm_s[g] = _time.perf_counter() - t0
        warm_compiles[g] = cc.count
        del fresh

    def arm(g: str):
        ladder = ladders[g]

        def run():
            for i, bs in enumerate(sizes):
                bucket = bk.bucket_for(int(bs), ladder)
                padded = bk.pad_rows(rows[i, :bs], bucket)
                backend.topk_rows(padded, k=k)

        return run

    res = br.time_interleaved({g: arm(g) for g in geometries}, reps)
    for g in geometries:
        res[g]["warm_ms"] = warm_s[g] * 1e3
        res[g]["warm_compiles"] = warm_compiles[g]
        res[g]["ladder"] = list(ladders[g])
    # the knob's trade is steady-state pad waste vs warm cost, and a
    # denser ladder's steady state is structurally never worse — so any
    # geometry within the measured noise of the fastest competes, and
    # among those the cheapest warm wins
    noise = br.noise_bound(res)
    floor_ms = res[br.best_arm(res)]["median_of_best_ms"] * (1.0 + noise)
    winner = min(
        (g for g in geometries
         if res[g]["median_of_best_ms"] <= floor_ms),
        key=lambda g: (res[g]["warm_ms"], g),
    )
    return {"serve_buckets": (winner, res)}


def bench_ann(point: SweepPoint, reps: int, device, k: int = 10,
              recall_floor: float = 0.99) -> dict:
    """ANN index knobs (index/ subsystem), measured with a RECALL GATE:
    an arm that misses the recall floor is excluded from the race
    outright, not merely slower — a tuned index that forgot how to find
    the true top-k is wrong, not fast. Probe (torch ops on the index's
    device) + exact host rerank wall time per query batch is the metric;
    measured recall rides along in every arm record.

    Geometry knobs (``ann_centroids``, ``ann_cluster_cap``) each build a
    real index per arm; probe knobs (``ann_nprobe``, ``ann_cand_mult``)
    share one default-geometry index. Every arm is real on either
    device."""
    from ..data.synthetic import synthetic_hin
    from ..index.build import (
        build_index, default_centroids, half_chain_and_denominators,
    )
    from ..ops import pathsim
    from ..ops.metapath import compile_metapath

    n = point.n
    hin = synthetic_hin(n, 2 * n, 24, seed=0)
    mp = compile_metapath("APVPA", hin.schema)
    c, d = half_chain_and_denominators(hin, mp)
    rng = np.random.default_rng(0)
    # sample only ANN-eligible rows: the serving layer answers degenerate
    # rows (d <= 0, all-zero score ties) through the exact path
    eligible = np.flatnonzero(d > 0)
    if eligible.size < 2:
        return {}
    sample = np.sort(rng.choice(
        eligible, size=min(64, eligible.size), replace=False
    ))
    oracle_kth: dict[int, float] = {}
    for row in sample:
        scores = pathsim.score_row(c @ c[row], d[row], d)
        scores[int(row)] = -np.inf
        vals, _ = pathsim.topk_from_score_rows(scores[None, :], k)
        oracle_kth[int(row)] = float(vals[0][-1])
    qrows = rng.choice(eligible, size=(8, 32))
    # the cache value keeps the INDEX alive too: keyed by id() alone, a
    # garbage-collected index could recycle its address
    blocks_cache: dict[int, tuple] = {}

    def blocks_of(index) -> np.ndarray:
        hit = blocks_cache.get(id(index))
        if hit is not None and hit[0] is index:
            return hit[1]
        safe = np.maximum(index.members, 0)
        bl = c[safe.reshape(-1)].reshape(
            *index.members.shape, c.shape[1]
        )
        bl[index.members < 0] = 0.0
        blocks_cache[id(index)] = (index, bl)
        return bl

    def answer(index, batch, nprobe: int, cand_mult: int, variant: str):
        """Serve one probe batch the way the serving layer would, per
        variant; yields (row, vals)."""
        if variant == "rerank-all":
            mem, top_c = index.route_batch(batch, nprobe)
            blocks = blocks_of(index)
            for b, row in enumerate(batch):
                blk = blocks[top_c[b]]
                counts = blk.reshape(-1, blk.shape[-1]) @ c[row]
                cols = mem[b].astype(np.int64)
                dc = d[np.maximum(cols, 0)]
                sc = pathsim.score_candidates(
                    counts[None, :], np.asarray([d[row]]), dc[None, :]
                )
                vals, _ = pathsim.topk_from_candidate_scores(
                    sc, cols[None, :], k
                )
                yield int(row), vals[0]
        else:
            sims, mem = index.probe_batch(batch, nprobe)
            for b, row in enumerate(batch):
                cand = index.select_candidates(
                    sims[b], mem[b], cand_mult * k
                )
                counts = c[cand] @ c[row]
                sc = pathsim.score_candidates(
                    counts[None, :], np.asarray([d[row]]),
                    d[cand][None, :],
                )
                vals, _ = pathsim.topk_from_candidate_scores(
                    sc, cand[None, :], k
                )
                yield int(row), vals[0]

    def recall_of(index, nprobe: int, cand_mult: int,
                  variant: str) -> float:
        """Score recall@k (ties at the k boundary count — the serving
        shadow gate's metric, serving/ann.py)."""
        hits = tot = 0
        for row, vals in answer(index, sample.astype(np.int64),
                                nprobe, cand_mult, variant):
            kth = oracle_kth[row]
            got = vals[np.isfinite(vals)]
            hits += min(int((got >= kth).sum()), k)
            tot += k
        return hits / max(tot, 1)

    def timing_arm(index, nprobe: int, cand_mult: int, variant: str):
        def run():
            for batch in qrows:
                for _ in answer(index, batch, nprobe, cand_mult,
                                variant):
                    pass

        return run

    def race(names) -> tuple | None:
        """Measure the feasible arms of one knob; None when no arm meets
        the recall floor (the knob keeps its heuristic)."""
        arms, recalls = {}, {}
        for name, (index, nprobe, mult, variant) in names.items():
            r = recall_of(index, nprobe, mult, variant)
            recalls[name] = r
            if r >= recall_floor:
                arms[name] = timing_arm(index, nprobe, mult, variant)
        if not arms:
            return None
        res = br.time_interleaved(arms, reps)
        for name in res:
            res[name]["recall"] = round(recalls[name], 4)
        return br.best_arm(res), res

    def build(**kw):
        return build_index(c=c, d=d, metapath=mp, device=device, **kw)

    out: dict = {}
    idx0 = build(n_centroids=default_centroids(n, 1.0))
    nprobe_w = min(max(16, idx0.n_centroids // 3), 96)
    mult_w = 16
    var_w = "rerank-all"

    raced = race({
        f"var-{v_}": (idx0, nprobe_w, mult_w, v_)
        for v_ in KNOBS["ann_probe_variant"].candidates({"n": n})
    })
    if raced is not None:
        win, res = raced
        var_w = win.removeprefix("var-")
        out["ann_probe_variant"] = (var_w, res)

    raced = race({
        f"nprobe{p}": (idx0, p, mult_w, var_w)
        for p in KNOBS["ann_nprobe"].candidates({"n": n})
        if p <= idx0.n_centroids
    })
    if raced is not None:
        win, res = raced
        nprobe_w = int(win.removeprefix("nprobe"))
        out["ann_nprobe"] = (nprobe_w, res)

    raced = race({
        f"mult{m}": (idx0, nprobe_w, m, "shortlist")
        for m in KNOBS["ann_cand_mult"].candidates({"n": n})
    })
    if raced is not None:
        win, res = raced
        mult_w = int(win.removeprefix("mult"))
        out["ann_cand_mult"] = (mult_w, res)

    raced = race({
        f"cmult{cm}": (
            build(n_centroids=default_centroids(n, float(cm))),
            nprobe_w, mult_w, var_w,
        )
        for cm in KNOBS["ann_centroids"].candidates({"n": n})
    })
    if raced is not None:
        win, res = raced
        out["ann_centroids"] = (float(win.removeprefix("cmult")), res)

    raced = race({
        f"cap{cap}": (
            build(n_centroids=default_centroids(n, 1.0), cluster_cap=cap),
            nprobe_w, mult_w, var_w,
        )
        for cap in KNOBS["ann_cluster_cap"].candidates({"n": n})
    })
    if raced is not None:
        win, res = raced
        out["ann_cluster_cap"] = (int(win.removeprefix("cap")), res)
    return out


_ANN_KNOBS = ("ann_nprobe", "ann_cand_mult", "ann_centroids",
              "ann_cluster_cap", "ann_probe_variant")


def bench_learned(point: SweepPoint, reps: int, device, k: int = 10,
                  recall_floor: float = 0.95) -> dict:
    """Learned-tier knobs (learned/ subsystem), measured with the same
    RECALL GATE discipline as :func:`bench_ann`: an arm whose tower
    shortlist misses the floor is excluded outright. Tower arms
    (``learned_dim``, ``learned_neg_ratio``) each distill a real tower
    per arm on ``device`` (tiny step budget — the race is about
    geometry, not final loss); ``learned_cand_mult`` re-serves one
    tower at different shortlist widths. ``learned_conf_floor`` picks
    the tightest floor the measured recall actually clears, and
    ``learned_refresh_deltas`` races a sustained delta+query stream end
    to end per cadence (fold cost vs degraded-query cost, measured, not
    modeled)."""
    from ..data.synthetic import synthetic_hin
    from ..index.build import half_chain_and_denominators
    from ..learned.serving import LearnedState
    from ..learned.trainer import train_towers
    from ..ops import pathsim
    from ..ops.metapath import compile_metapath

    # cap the training graph: tower geometry trades are visible at 2k
    # rows, and per-arm distillation cost must stay offline-tolerable
    n = min(point.n, 2048)
    hin = synthetic_hin(n, 2 * n, 24, seed=0)
    mp = compile_metapath("APVPA", hin.schema)
    c, d = half_chain_and_denominators(hin, mp)
    rng = np.random.default_rng(0)
    eligible = np.flatnonzero(d > 0)
    if eligible.size < 2:
        return {}
    sample = np.sort(rng.choice(
        eligible, size=min(64, eligible.size), replace=False
    ))
    oracle_kth: dict[int, float] = {}
    for row in sample:
        scores = pathsim.score_row(c @ c[row], d[row], d)
        scores[int(row)] = -np.inf
        vals, _ = pathsim.topk_from_score_rows(scores[None, :], k)
        oracle_kth[int(row)] = float(vals[0][-1])
    qrows = rng.choice(eligible, size=(8, 32))

    encoders: dict[tuple, object] = {}

    def encoder_for(dim: int, neg_ratio: float):
        key = (dim, neg_ratio)
        if key not in encoders:
            enc, _ = train_towers(
                hin, "APVPA", dim=dim, hidden=64, steps=80, seed=0,
                hard_frac=1.0 - neg_ratio,
                hard_sources=min(n, 256), hard_k=2 * k, device=device,
            )
            encoders[key] = enc
        return encoders[key]

    states: list = []

    def state_for(dim: int, neg_ratio: float, cand_mult: int):
        st = LearnedState(
            encoder_for(dim, neg_ratio), c, d,
            cand_mult=cand_mult, shadow_every=0, device=device,
        )
        states.append(st)
        return st

    def recall_of(st) -> float:
        hits = tot = 0
        handle = st.probe_batch(sample.astype(np.int64), k)
        for b, row in enumerate(sample):
            vals, _ = st.answer_from_handle(handle, b, int(row), k)
            kth = oracle_kth[int(row)]
            got = vals[np.isfinite(vals)]
            hits += min(int((got >= kth).sum()), k)
            tot += k
        return hits / max(tot, 1)

    def timing_arm(st):
        def run():
            for batch in qrows:
                handle = st.probe_batch(batch, k)
                for b, row in enumerate(batch):
                    st.answer_from_handle(handle, b, int(row), k)

        return run

    def race(named_states: dict) -> tuple | None:
        arms, recalls = {}, {}
        for name, st in named_states.items():
            r = recall_of(st)
            recalls[name] = r
            if r >= recall_floor:
                arms[name] = timing_arm(st)
        if not arms:
            return None
        res = br.time_interleaved(arms, reps)
        for name in res:
            res[name]["recall"] = round(recalls[name], 4)
        return br.best_arm(res), res

    out: dict = {}
    try:
        dim_w, neg_w, mult_w = 32, 0.5, 16
        raced = race({
            f"dim{dm}": state_for(dm, neg_w, mult_w)
            for dm in KNOBS["learned_dim"].candidates({"n": n})
        })
        if raced is not None:
            win, res = raced
            dim_w = int(win.removeprefix("dim"))
            out["learned_dim"] = (dim_w, res)

        raced = race({
            f"neg{nr}": state_for(dim_w, nr, mult_w)
            for nr in KNOBS["learned_neg_ratio"].candidates({"n": n})
        })
        if raced is not None:
            win, res = raced
            neg_w = float(win.removeprefix("neg"))
            out["learned_neg_ratio"] = (neg_w, res)

        raced = race({
            f"mult{m}": state_for(dim_w, neg_w, m)
            for m in KNOBS["learned_cand_mult"].candidates({"n": n})
        })
        if raced is not None:
            win, res = raced
            mult_w = int(win.removeprefix("mult"))
            out["learned_cand_mult"] = (mult_w, res)

        # confidence floor: the tightest (highest) candidate floor the
        # measured recall of the SHIPPED configuration clears
        final = state_for(dim_w, neg_w, mult_w)
        r_final = recall_of(final)
        floors = KNOBS["learned_conf_floor"].candidates({"n": n})
        feasible = [f for f in floors if f <= r_final]
        if feasible:
            ms = br.time_interleaved(
                {"final": timing_arm(final)}, reps
            )["final"]["median_of_best_ms"]
            res = {
                f"floor{f}": {
                    "median_of_best_ms": ms,
                    "recall": round(r_final, 4),
                }
                for f in floors
                if f <= r_final
            }
            out["learned_conf_floor"] = (max(feasible), res)

        # refresh cadence: a sustained delta+query stream, end to end
        # per arm — each "delta" stales a row block (those queries
        # answer through the exact path, the serving fallback), every
        # cadence-th landing pays the real half-chain fold + absorb
        enc_final = encoder_for(dim_w, neg_w)
        stale_blocks = rng.choice(
            eligible, size=(8, 32)).astype(np.int64)

        def cadence_arm(every: int):
            def run():
                st = LearnedState(
                    enc_final, c, d, cand_mult=mult_w, shadow_every=0,
                    device=device,
                )
                states.append(st)
                since = 0
                for i, block in enumerate(stale_blocks):
                    st.mark_stale(block)
                    since += 1
                    for b, row in enumerate(qrows[i % len(qrows)]):
                        row = int(row)
                        if st.peek(row) is not None:
                            scores = pathsim.score_row(
                                c @ c[row], d[row], d
                            )
                            scores[row] = -np.inf
                            pathsim.topk_from_score_rows(
                                scores[None, :], k
                            )
                        else:
                            h = st.probe_batch(
                                np.asarray([row], dtype=np.int64), k
                            )
                            st.answer_from_handle(h, 0, row, k)
                    if since >= every:
                        c2, d2 = half_chain_and_denominators(hin, mp)
                        st.absorb(c2, d2, ("", i + 1))
                        since = 0

            return run

        res = br.time_interleaved(
            {
                f"every{e}": cadence_arm(e)
                for e in KNOBS["learned_refresh_deltas"]
                .candidates({"n": n})
            },
            reps,
        )
        win = br.best_arm(res)
        out["learned_refresh_deltas"] = (
            int(win.removeprefix("every")), res
        )
    finally:
        for st in states:
            st.close()
    return out


_LEARNED_KNOBS = ("learned_dim", "learned_neg_ratio",
                  "learned_cand_mult", "learned_conf_floor",
                  "learned_refresh_deltas")


# ---------------------------------------------------------------------------
# Sweep driver
# ---------------------------------------------------------------------------

def tune(
    points: list[SweepPoint],
    knobs: list[str] | None = None,
    reps: int = 3,
    max_batch: int = 32,
    out: str | None = None,
    device=None,
) -> TuningTable:
    """Measure ``knobs`` (default: every knob with a real arm here)
    over ``points`` on ``device`` (None: the card) and return (and
    optionally save) the table, keyed on :func:`dispatch.device_kind`.
    Unknown knobs raise ValueError."""
    from ..utils.device import resolve_device

    want = set(knobs) if knobs else set(KNOBS)
    unknown = want - set(KNOBS)
    if unknown:
        raise ValueError(f"unknown knob(s) {sorted(unknown)}")
    device = resolve_device(device)
    table = TuningTable(dispatch.device_kind())

    def record(point: SweepPoint | None, results: dict,
               nnz: int | None = None) -> None:
        for knob, (choice, arms) in results.items():
            if knob not in want:
                continue
            key = make_key(
                knob, dispatch.device_kind(),
                n=point.n if point else None,
                v=point.v if point else None,
                # K3's lookups (ops/cuda_kernels.rect_stripe_tiles) are
                # keyed on (N, V) alone, whatever point measured them
                nnz=None if knob == "rect_target_units" else nnz,
            )
            arms_out: dict[str, float] = {}
            for name, a in arms.items():
                arms_out[name] = a["median_of_best_ms"]
                if "warm_ms" in a:
                    # serve_buckets picks within the steady-state noise
                    # band by warm cost — persist the deciding number
                    arms_out[f"{name}_warm"] = a["warm_ms"]
                if "recall" in a:
                    # ann / learned knobs gate on measured recall before
                    # racing on time — persist it per arm
                    arms_out[f"{name}_recall"] = a["recall"]
                if "factor_bytes" in a:
                    # factor_format picks within the noise band by
                    # resident bytes — persist the deciding number
                    arms_out[f"{name}_bytes"] = float(a["factor_bytes"])
            table.put(
                key, choice,
                metric_ms=min(
                    a["median_of_best_ms"] for a in arms.values()
                ),
                arms=arms_out,
            )
            runtime_event(
                "tuning_measured", echo=False, knob=knob, key=key,
                choice=choice, arms=len(arms),
            )

    for point in points:
        if point.nnz is None:
            if "twopass_stripe_tiles" in want:
                record(point, bench_twopass_stripe(point, reps, device))
            if "ring_kernel" in want:
                record(point, bench_ring(point, reps, device))
            if want & set(_ANN_KNOBS):
                record(point, bench_ann(point, reps, device))
            if want & set(_LEARNED_KNOBS):
                record(point, bench_learned(point, reps, device))
            if want & {"plan_density_cutover", "plan_memo_budget_mb"}:
                record(point, bench_planner(point, reps))
            if "factor_format" in want:
                record(point, bench_factor_format(point, reps, device))
            if want & {"compact_chain_len", "compact_headroom"}:
                record(point, bench_compaction(point, reps))
        else:
            if "sparse_tile_rows" in want:
                record(point, bench_sparse_tiles(point, reps, device),
                       nnz=point.nnz)
            if "sparse_nnz_floor" in want:
                record(point, bench_sparse_nnz_floor(point, reps, device),
                       nnz=point.nnz)
            if "rect_target_units" in want:
                record(point, bench_rect_units(point, reps, device),
                       nnz=point.nnz)
    if "serve_buckets" in want:
        # keyed on (n_authors, max_batch): the ladder trade depends on
        # the batch ceiling, so it rides the V axis of the key (the knob
        # has no contraction width of its own)
        n_serve = min(512, max(p.n for p in points) if points else 512)
        res = bench_serve_buckets(
            n_authors=n_serve, max_batch=max_batch, reps=reps,
            device=device,
        )
        record(SweepPoint(n=n_serve, v=max_batch), res)
    if out:
        digest = table.save(out)
        runtime_event(
            "tuning_table_written", table=out, digest=digest,
            entries=len(table.entries),
        )
    return table


_QUICK_POINTS = [SweepPoint(1024, 384), SweepPoint(2048, 64, nnz=16384)]
# The JAX package's default set, plus the bench shape (K1's stripe
# width tuned where rank-all runs) and a sparse point of config 5's width
# whose K3 sweep spans 32 row tiles (rect_target_units at a launch count
# the streaming tier sees).
_DEFAULT_POINTS = [
    SweepPoint(2048, 384),
    SweepPoint(8192, 384),
    SweepPoint(32768, 384),
    SweepPoint(4096, 64, nnz=32768),
    SweepPoint(131072, 64, nnz=655360),
]


def tune_main(argv: list[str] | None = None) -> int:
    """``dpathsim-torch tune`` — measure this device, write the table."""
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser(
        prog="dpathsim-torch tune",
        description="autotune kernel/tile/bucket knobs on THIS device "
        "and write the dispatch table consulted by --tuning-table",
    )
    p.add_argument("--out", required=True, help="table JSON path")
    p.add_argument(
        "--shapes", default=None,
        help="comma-separated NxV (dense) / NxVxNNZ (sparse) sweep "
        "points; default a small dense+sparse set",
    )
    p.add_argument(
        "--knobs", default=None,
        help="comma-separated knob subset (default: all measurable here)",
    )
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--max-batch", type=int, default=32,
                   help="serving bucket ceiling for the serve_buckets knob")
    p.add_argument("--quick", action="store_true",
                   help="smallest sweep (seconds, CPU-safe)")
    p.add_argument(
        "--platform", default="cuda", choices=("cuda", "cpu"),
        help="device measured: 'cuda' (default) fails when no card is "
        "present; 'cpu' measures the host arms (the kernel knobs record "
        "nothing there)",
    )
    args = p.parse_args(argv)

    device = resolve_device(args.platform)
    if device.type == "cuda":
        from ..ops import cuda_kernels

        cuda_kernels.true_f32()
    dispatch.set_device(device)
    if args.shapes:
        points = [SweepPoint.parse(s) for s in args.shapes.split(",") if s]
    else:
        points = _QUICK_POINTS if args.quick else _DEFAULT_POINTS
    knobs = (
        [k.strip() for k in args.knobs.split(",") if k.strip()]
        if args.knobs else None
    )
    table = tune(
        points, knobs=knobs, reps=args.reps, max_batch=args.max_batch,
        out=args.out, device=device,
    )
    runtime_event(
        "tuning_done",
        table=args.out,
        entries=len(table.entries),
        device=table.device_kind,
        digest=table.digest,
    )
    return 0
