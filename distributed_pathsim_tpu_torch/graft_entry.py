"""The graft entry on the card: a single-card forward check and a
multi-shard dry run.

    python -m distributed_pathsim_tpu_torch.graft_entry [--platform cuda|cpu]

The port's twin of the repository's ``__graft_entry__.py``:

- :func:`entry` gives ``(fn, example_args)``: the flagship forward step,
  the APVPA PathSim all-pairs scores from the half-chain blocks, in true
  f32. ``fn`` makes no host sync, so one ``torch.cuda.CUDAGraph``
  captures it; the capture and its replay (:func:`graph_replay`) stand
  where ``jax.jit`` stood.
- :func:`dryrun_multichip` runs every parallel path of the port once on
  a mesh of ``n_devices`` shards at tiny shapes and checks each: the
  row-sharded chain under both all-pairs strategies, the ring's top-k
  (on the card K3 at every ring step, held bit for bit against the torch
  fold on host copies of the shards), its checkpointed stepwise form
  preempted and resumed, 2-D tiling, the sharded ensemble, a meshed
  NeuralPathSim step, the multi-process assembly path and the
  ``torch-sharded`` backend.

Not ported: the JAX file's provisioning of virtual XLA host devices
(``_device_flags_value``, ``_try_ensure_devices`` and the subprocess
fallback for an interpreter whose backends were already initialised). A
port :class:`~.parallel.mesh.Mesh` repeats a device, so D shards need
nothing provisioned: the mesh spreads them over every visible card, and
on one card it puts all D there. What that provisioning guarded becomes
this: with ``platform="cpu"`` the dry run never touches the card, and
``torch.cuda.is_initialized()`` stays False.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import unittest.mock as mock

import numpy as np
import torch

from .ops import cuda_kernels as ck
from .utils.device import resolve_device

# K3's launch counter (ops/cuda_kernels.LAUNCHES): the ring's per-step
# kernel.
RING_KERNEL = "topk_rect_candidates"


def _small_blocks(dtype, n_authors=64, n_papers=96, n_venues=12, seed=0):
    from .data.synthetic import synthetic_hin
    from .ops import chain
    from .ops.metapath import compile_metapath

    hin = synthetic_hin(n_authors, n_papers, n_venues, seed=seed)
    mp = compile_metapath("APVPA", hin.schema)
    return chain.oriented_dense_blocks(hin, mp.half(), dtype=dtype)


def forward(a_ap: torch.Tensor, a_pv: torch.Tensor) -> torch.Tensor:
    """S = 2M / (dᵢ + dⱼ) with C = A_AP·A_PV, M = C·Cᵀ, d = C·colsum(C);
    0 where the denominator is 0. Integer counts below 2²⁴ make every
    product exact in f32, and the division is correctly rounded."""
    c = a_ap @ a_pv
    m = c @ c.T
    rowsums = c @ c.sum(0)
    denom = rowsums[:, None] + rowsums[None, :]
    pos = denom > 0
    return torch.where(pos, 2.0 * m / torch.where(pos, denom, 1.0), 0.0)


def entry(device=None):
    """(fn, example_args): the forward step and its half-chain blocks
    (f32), on the card unless ``device="cpu"``. On the card TF32 must be
    off (``cuda_kernels.true_f32()``); a caller that left it on gets a
    ValueError, never TF32 products."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        ck.check_true_f32()
    blocks = _small_blocks(np.float32)
    return forward, tuple(torch.from_numpy(np.ascontiguousarray(b)).to(dev)
                          for b in blocks)


def graph_replay(fn, args) -> torch.Tensor:
    """``fn(*args)`` captured once in a CUDA graph and replayed: one warm
    call on a side stream (the capture's prerequisite), the capture, one
    replay. Returns the graph's output after the replay."""
    from .utils.compile_counter import record

    static = [a.clone() for a in args]
    side = torch.cuda.Stream(device=static[0].device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*static)
    record("cuda_graph", "graft_entry_forward")
    graph.replay()
    torch.cuda.synchronize()
    return out


def _host_topk(m: np.ndarray, d: np.ndarray, k: int) -> np.ndarray:
    """The top-k values of 2M/(dᵢ + dⱼ) per row, self pairs out, in f64."""
    with np.errstate(invalid="ignore"):
        denom = d[:, None] + d[None, :]
        s = np.where(denom > 0, 2 * m / np.where(denom > 0, denom, 1), 0)
    np.fill_diagonal(s, -np.inf)
    return np.sort(s, axis=1)[:, ::-1][:, :k]


def dryrun_multichip(n_devices: int, platform: str = "cuda") -> dict:
    """Run the port's sharded programs once over an ``n_devices``-shard
    mesh on ``platform`` at tiny shapes, each checked (AssertionError on
    a mismatch). Covers every parallel path the port ships:

    1. 1-D row sharding of the chain: the psum'd column totals, the
       all-gather all-pairs and the ring (equal), the ring's top-k
       against host f64, the ring forced onto its kernel (K3 on the
       card, exactly D² launches, bit-identical to the torch fold on
       host copies), the diagonal variant, and the checkpointed stepwise
       ring preempted after step 0 and resumed in D − 1 steps;
    2. 2-D (dp, tp) block tiling, and the dp-sharded multi-metapath
       ensemble against its host top-k;
    3. the meshed NeuralPathSim training step;
    4. the multi-process assembly path (hybrid mesh, first block from
       process-local rows) and the ``torch-sharded`` backend.

    Returns ``{"launches_1c", "launches", "resume_steps", "arrays"}``:
    the kernel launches of item 1c and of the whole run, the steps the
    resume ran, and each item's host arrays (M, row sums, the ring's
    top-k, forced, diagonal; the 2-D scores and top-k; the ensemble's
    top-k; the backend's M)."""
    from .backends.base import create_backend
    from .data.synthetic import synthetic_hin
    from .models.multipath import MultiMetapathScorer
    from .models.neural import NeuralPathSim
    from .ops.metapath import compile_metapath
    from .parallel import sharded as sh
    from .parallel.mesh import gather_rows, make_mesh, make_mesh_2d
    from .parallel.multihost import distributed_first_block, make_hybrid_mesh
    from .parallel.tiling import (
        assemble_2d,
        place_2d,
        tiled_scores_2d,
        tiled_topk_2d,
    )
    from .utils.checkpoint import CheckpointManager

    device = resolve_device(platform)
    platform = device.type
    if platform == "cuda":
        ck.check_true_f32()
    launches0 = dict(ck.LAUNCHES)
    n_authors = 8 * n_devices
    blocks = _small_blocks(np.float32, n_authors=n_authors, n_papers=64)
    mesh = make_mesh(n_devices, platform=platform)
    first = sh.shard_first_block_rows(blocks[0], mesh)
    rest = tuple(sh.replicate(b, mesh) for b in blocks[1:])

    # 1. 1-D row-sharded chain, both all-pairs strategies
    m_ag, rs_ag = sh.sharded_chain_outputs(
        first, rest, mesh=mesh, allpairs_strategy="allgather")
    m_ring, rs_ring = sh.sharded_chain_outputs(
        first, rest, mesh=mesh, allpairs_strategy="ring")
    m_ag, rs_ag = gather_rows(m_ag, mesh), gather_rows(rs_ag, mesh)
    np.testing.assert_array_equal(gather_rows(m_ring, mesh), m_ag)
    np.testing.assert_array_equal(gather_rows(rs_ring, mesh), rs_ag)

    # 1b. the ring-streamed distributed top-k against M + a host sort
    def ring_topk(f, r, on, **kw):
        v, i = sh.sharded_topk(f, r, mesh=on, k=3, n_true=n_authors, **kw)
        return gather_rows(v, on), gather_rows(i, on)

    tv, ti = ring_topk(first, rest, mesh)
    np.testing.assert_allclose(
        tv.astype(np.float64)[:n_authors],
        _host_topk(m_ag.astype(np.float64), rs_ag.astype(np.float64), 3),
        atol=1e-6)

    # 1c. the ring with its kernel forced at every step: on the card K3,
    # D² launches and no other kernel's, bit-identical to the torch fold
    # on host copies of the shards; then the textbook denominator
    # (local Σ C², no collective)
    before = dict(ck.LAUNCHES)
    kv, ki = ring_topk(first, rest, mesh, use_kernel=True)
    launches_1c = {n: ck.LAUNCHES[n] - before[n] for n in before}
    if platform == "cuda":
        want = {n: (n_devices * n_devices if n == RING_KERNEL else 0)
                for n in launches_1c}
        assert launches_1c == want, (launches_1c, want)
    fv, fi = ring_topk([f.cpu() for f in first],
                       [[b.cpu() for b in blk] for blk in rest],
                       make_mesh(n_devices, platform="cpu"), use_kernel=False)
    np.testing.assert_array_equal(kv, fv)
    np.testing.assert_array_equal(ki, fi)
    tvd, _ = ring_topk(first, rest, mesh, variant="diagonal")
    m64 = m_ag.astype(np.float64)
    np.testing.assert_allclose(tvd.astype(np.float64)[:n_authors],
                               _host_topk(m64, np.diag(m64).copy(), 3),
                               atol=1e-6)

    # 1d. the checkpointed stepwise ring: one step, a preemption, the
    # resume — bit-identical to 1b, and it runs only the D − 1 steps
    # left (with one shard the first run finishes and the resume runs 0)
    ck_dir = tempfile.mkdtemp(prefix="graft_ring_ck_")
    try:
        ck_cfg = {"n": n_authors, "k": 3, "n_devices": n_devices,
                  "format": "dryrun-ring-v1"}
        real_step = sh.sharded_ring_step
        calls: list[int] = []

        def dying_step(*a, **kw):
            if calls:
                raise KeyboardInterrupt("dryrun preemption after step 0")
            calls.append(1)
            return real_step(*a, **kw)

        with mock.patch.object(sh, "sharded_ring_step", dying_step):
            try:
                sh.sharded_topk_stepwise(
                    first, rest, mesh=mesh, k=3, n_true=n_authors,
                    ckpt=CheckpointManager(ck_dir, config=ck_cfg))
                if n_devices > 1:
                    raise AssertionError("dryrun preemption never fired")
            except KeyboardInterrupt:
                pass
        resumed: list[int] = []

        def counting_step(*a, **kw):
            resumed.append(1)
            return real_step(*a, **kw)

        with mock.patch.object(sh, "sharded_ring_step", counting_step):
            rv, ri = sh.sharded_topk_stepwise(
                first, rest, mesh=mesh, k=3, n_true=n_authors,
                ckpt=CheckpointManager(ck_dir, config=ck_cfg))
        assert len(resumed) == n_devices - 1, (
            f"resume ran {len(resumed)} steps, wanted {n_devices - 1}")
        np.testing.assert_array_equal(gather_rows(rv, mesh), tv)
        np.testing.assert_array_equal(gather_rows(ri, mesh), ti)
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)

    # 2. 2-D (dp, tp) tiled scores + distributed top-k
    shape = (n_devices // 2, 2) if n_devices % 2 == 0 else (n_devices, 1)
    mesh2 = make_mesh_2d(shape, platform=platform)
    c = np.asarray(blocks[0] @ blocks[1], dtype=np.float32)
    d = np.asarray(c @ c.sum(axis=0), dtype=np.float32)
    args = place_2d(c, d, mesh2)
    scores = assemble_2d(tiled_scores_2d(*args, mesh=mesh2), mesh2)
    vals, idxs = tiled_topk_2d(*args, mesh=mesh2, k=3, n_true=c.shape[0])

    # 2b. batched multi-metapath ensemble, dp-sharded (config 4 × 3)
    hin_mp = synthetic_hin(n_authors, 64, 12, seed=0)
    scorer = MultiMetapathScorer(hin_mp, ["APVPA", "APA"], device=platform)
    mv, mi = scorer.topk_sharded(k=3, n_devices=n_devices)
    hv, _ = scorer.topk(k=3)
    np.testing.assert_allclose(mv, hv, atol=1e-6)

    # 3. the meshed neural training step
    hin = synthetic_hin(n_authors, 64, 12, seed=0)
    model = NeuralPathSim(hin, "APVPA", dim=8, hidden=16, mesh=mesh)
    losses = model.train(steps=1, batch_size=8 * n_devices)
    assert np.isfinite(losses[0]), losses

    # 4. the multi-process assembly path (hybrid mesh, first block from
    # process-local rows); a different mesh gives other local GEMM
    # shapes, so M is held to a tight tolerance, not bit for bit
    tp4 = 2 if n_devices % 2 == 0 else 1
    mesh_h = make_hybrid_mesh(tp=tp4, platform=platform, n_local=n_devices)
    ap = np.asarray(blocks[0], dtype=np.float32)
    first_h = distributed_first_block(
        lambda a, b: ap[a:b], ap.shape[0], ap.shape[1], mesh_h)
    rest_h = tuple(sh.replicate(np.asarray(b), mesh_h) for b in blocks[1:])
    m_h, _ = sh.sharded_chain_outputs(first_h, rest_h, mesh=mesh_h)
    np.testing.assert_allclose(gather_rows(m_h, mesh_h)[: m_ag.shape[0]],
                               m_ag, rtol=1e-6)

    # 4b. the product path: the torch-sharded backend on the graph
    # _small_blocks built, against item 1's M
    hin4 = synthetic_hin(n_authors, 64, 12, seed=0)
    mp = compile_metapath("APVPA", hin4.schema)
    backend = create_backend("torch-sharded", hin4, mp, n_devices=n_devices,
                             device=platform)
    m_backend = backend.commuting_matrix()
    np.testing.assert_allclose(
        m_backend[:n_authors, :n_authors],
        m_ag.astype(np.float64)[:n_authors, :n_authors], rtol=1e-6)
    return {"launches_1c": launches_1c,
            "launches": {n: ck.LAUNCHES[n] - launches0[n] for n in launches0},
            "resume_steps": len(resumed),
            "arrays": {"m": m_ag, "rowsums": rs_ag, "topk": (tv, ti),
                       "topk_kernel": (kv, ki), "topk_diagonal": tvd,
                       "scores_2d": scores, "topk_2d": (vals, idxs),
                       "ensemble": (mv, mi), "backend_m": m_backend}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    platform = resolve_device(args.platform).type
    if platform == "cuda":
        ck.true_f32()
    fn, example = entry(device=platform)
    out = graph_replay(fn, example) if platform == "cuda" else fn(*example)
    print("entry:", tuple(out.shape))
    dryrun_multichip(4, platform=platform)
    print("dryrun_multichip(4): ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
