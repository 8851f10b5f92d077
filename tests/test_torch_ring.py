"""The port's mesh, ring and 2-D tiling (``parallel/``) against the JAX
package's ``parallel/`` on the CPU: D virtual shards of the host against
D of the 8 virtual XLA devices (tests/conftest.py), N not a multiple of
D. The JAX ring runs its Pallas step in interpret mode
(``use_pallas=True``) against the port's K3 step (its plain version on
the host), and its jnp fold against the port's torch fold. Tolerance 0:
exact counts, IEEE division, the (descending score, ascending column)
order."""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu.parallel import mesh as jmesh
from distributed_pathsim_tpu.parallel import sharded as jsh
from distributed_pathsim_tpu.parallel import tiling as jtil
from distributed_pathsim_tpu_torch.ops import planner
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.parallel import mesh as tmesh
from distributed_pathsim_tpu_torch.parallel import sharded as tsh
from distributed_pathsim_tpu_torch.parallel import tiling as ttil
from torch_port_util import backend_graphs


@pytest.fixture(scope="module")
def factor():
    """APVPA's dense half factor C (f32, integer counts) and N."""
    thin = backend_graphs()[1]
    c = planner.dense_half(thin, compile_metapath("APVPA", thin.schema),
                           dtype=np.float64).astype(np.float32)
    return c[:203], 203  # 203 rows: a multiple of no D but 1


def _port_rows(parts, n):
    return torch.cat([p.cpu() for p in parts])[:n].numpy()


def test_mesh_placement_and_collectives():
    mesh = tmesh.make_mesh(3, platform="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.shape == {"dp": 3} and mesh.size == 3
    assert tmesh.spread(["a", "b"], 4) == ("a", "a", "b", "b")
    assert tmesh.pad_to_multiple(203, 8) == jmesh.pad_to_multiple(203, 8)
    m2 = tmesh.make_mesh_2d((2, 4), platform="cpu")
    assert m2.shape == {"dp": 2, "tp": 4}
    with pytest.raises(ValueError):
        tmesh.make_mesh(0, platform="cpu")
    parts = [torch.full((2, 3), float(i)) for i in range(3)]
    assert all(torch.equal(p, torch.full((2, 3), 3.0))
               for p in tmesh.psum(parts, mesh))
    assert all(torch.equal(g, torch.cat(parts))
               for g in tmesh.all_gather(parts, mesh))
    rolled = tmesh.ppermute(parts, mesh)
    assert [int(p[0, 0]) for p in rolled] == [2, 0, 1]
    assert [int(p[0, 0]) for p in tsh._roll_rows(parts, 2, mesh)] == [1, 2, 0]
    # the padded rows are zero and land in the last shard
    first = tsh.shard_first_block_rows(np.ones((7, 2), np.float32), mesh)
    assert [p.shape[0] for p in first] == [3, 3, 3]
    assert float(first[-1].sum()) == 2.0
    np.testing.assert_array_equal(tmesh.gather_rows(first, mesh)[:7], 1.0)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_ring_topk_matches_jax(factor, n_dev):
    """Both ring steps (K3 / Pallas interpret, torch fold / jnp fold), both
    variants, with and without the self mask: values and global columns
    equal to the JAX ring on the same D."""
    c, n = factor
    jm = jmesh.make_mesh(n_dev)
    tm = tmesh.make_mesh(n_dev, platform="cpu")
    jfirst = jsh.shard_first_block_rows(c, jm)
    tfirst = tsh.shard_first_block_rows(c, tm)
    for variant in ("rowsum", "diagonal"):
        for kernel in (True, False):
            for mask in ((True, False) if kernel else (True,)):
                jv, ji = jsh.sharded_topk(
                    jfirst, (), mesh=jm, k=7, n_true=n, variant=variant,
                    mask_self=mask, use_pallas=kernel)
                tv, ti = tsh.sharded_topk(
                    tfirst, (), mesh=tm, k=7, n_true=n, variant=variant,
                    mask_self=mask, use_kernel=kernel)
                np.testing.assert_array_equal(_port_rows(tv, n),
                                              np.asarray(jv)[:n])
                np.testing.assert_array_equal(_port_rows(ti, n),
                                              np.asarray(ji)[:n])


@pytest.mark.parametrize("strategy", ["allgather", "ring"])
def test_chain_outputs_match_jax(factor, strategy):
    """M row blocks and row sums through both all-pairs strategies, with
    a replicated rest block (the chain folded on the shards)."""
    c, n = factor
    a, b = c[:, :9], np.eye(9, c.shape[1], dtype=np.float32)
    for n_dev in (3, 8):
        jm = jmesh.make_mesh(n_dev)
        tm = tmesh.make_mesh(n_dev, platform="cpu")
        jm_, jr = jsh.sharded_chain_outputs(
            jsh.shard_first_block_rows(a, jm), (jsh.replicate(b, jm),),
            mesh=jm, allpairs_strategy=strategy)
        tm_, tr = tsh.sharded_chain_outputs(
            tsh.shard_first_block_rows(a, tm), (tsh.replicate(b, tm),),
            mesh=tm, allpairs_strategy=strategy)
        np.testing.assert_array_equal(_port_rows(tr, n), np.asarray(jr)[:n])
        np.testing.assert_array_equal(tmesh.gather_rows(tm_, tm),
                                      np.asarray(jm_))


def test_ties_straddling_owners_keep_the_column_order():
    """Duplicate rows spread over every shard: equal scores in several
    owners' blocks rank by ascending global column, whatever the shard
    count, as a stable sort of the full score matrix does."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 3, size=(6, 5)).astype(np.float32)
    c = base[rng.integers(0, 6, size=61)]
    n = c.shape[0]
    d = c @ c.sum(0)
    m = c.astype(np.float64) @ c.T
    s = np.where(d[:, None] + d[None, :] > 0,
                 (2.0 * m.astype(np.float32)) / (d[:, None] + d[None, :]),
                 0.0).astype(np.float32)
    np.fill_diagonal(s, -np.inf)
    want_i = np.argsort(-s, axis=1, kind="stable")[:, :9]
    want_v = np.take_along_axis(s, want_i, 1)
    for n_dev in (1, 3, 8):
        tm = tmesh.make_mesh(n_dev, platform="cpu")
        first = tsh.shard_first_block_rows(c, tm)
        for kernel in (True, False):
            tv, ti = tsh.sharded_topk(first, (), mesh=tm, k=9, n_true=n,
                                      use_kernel=kernel)
            np.testing.assert_array_equal(_port_rows(tv, n), want_v)
            np.testing.assert_array_equal(_port_rows(ti, n), want_i)


def test_tiled_2d_matches_jax(factor):
    c, n = factor
    d = c @ c.sum(0)
    for shape in ((4, 2), (2, 4), (8, 1), (1, 8)):
        jm = jmesh.make_mesh_2d(shape)
        tm = tmesh.make_mesh_2d(shape, platform="cpu")
        jp = jtil.place_2d(c, d, jm)
        tp = ttil.place_2d(c, d, tm)
        np.testing.assert_array_equal(
            ttil.assemble_2d(ttil.tiled_scores_2d(*tp, tm), tm),
            np.asarray(jtil.tiled_scores_2d(*jp, jm)))
        jv, ji = jtil.tiled_topk_2d(*jp, jm, k=6, n_true=n)
        tv, ti = ttil.tiled_topk_2d(*tp, tm, k=6, n_true=n)
        np.testing.assert_array_equal(tv, np.asarray(jv))
        np.testing.assert_array_equal(ti, np.asarray(ji))
    # k past the merged candidate width pads with -inf, as the JAX one
    small = c[:5]
    ds = small @ small.sum(0)
    jm, tm = jmesh.make_mesh_2d((1, 4)), tmesh.make_mesh_2d((1, 4),
                                                             platform="cpu")
    jv, ji = jtil.tiled_topk_2d(*jtil.place_2d(small, ds, jm), jm, k=9,
                                n_true=5)
    tv, ti = ttil.tiled_topk_2d(*ttil.place_2d(small, ds, tm), tm, k=9,
                                n_true=5)
    np.testing.assert_array_equal(tv, np.asarray(jv))
    np.testing.assert_array_equal(ti, np.asarray(ji))


def test_wide_v_and_the_k16_fold_match_jax():
    """A factor wider than one Pallas V block takes the K-tiled JAX step
    in interpret mode; k = 16 (past K3's gate) takes both folds."""
    rng = np.random.default_rng(53)
    c = (rng.random((130, 600)) < 0.05).astype(np.float32)
    jm = jmesh.make_mesh(4)
    tm = tmesh.make_mesh(4, platform="cpu")
    jfirst = jsh.shard_first_block_rows(c, jm)
    tfirst = tsh.shard_first_block_rows(c, tm)
    for k, kernel in ((5, True), (16, False)):
        jv, ji = jsh.sharded_topk(jfirst, (), mesh=jm, k=k, n_true=130,
                                  use_pallas=kernel)
        tv, ti = tsh.sharded_topk(tfirst, (), mesh=tm, k=k, n_true=130,
                                  use_kernel=kernel)
        np.testing.assert_array_equal(_port_rows(tv, 130),
                                      np.asarray(jv)[:130])
        np.testing.assert_array_equal(_port_rows(ti, 130),
                                      np.asarray(ji)[:130])
    # the resolver: K3 only on the card and only where it takes the shape
    assert not tsh.resolve_ring_kernel(130, 600, 5, "cpu")
    assert not tsh.resolve_ring_kernel(130, 600, 16, "cuda")
    assert tsh.choose_allpairs_strategy(1000, 64, 4) == "allgather"
    assert tsh.choose_allpairs_strategy(1 << 22, 1024, 4) == "ring"
