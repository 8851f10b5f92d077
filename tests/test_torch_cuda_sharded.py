"""torch-sharded and partition mode on the card: the ring's K3 steps
against K1 and the fold, D shards on one card and, with two or more
cards, one shard per card; the multi-process ring is tested on the CPU
(tests/test_torch_multihost.py). These tests need a CUDA card (marker
``cuda``) and skip without one; they import only the port, so they run
on a machine with no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_sharded.py
"""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.parallel.mesh import make_mesh
from distributed_pathsim_tpu_torch.parallel.sharded import (
    shard_first_block_rows,
    sharded_topk,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.true_f32()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graph(card):
    hin = synthetic_hin(1501, 2250, 48, seed=13)
    mp = compile_metapath("APVPA", hin.schema)
    dense = create_backend("torch", hin, mp)
    return hin, mp, dense


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_ring_on_one_card_equals_k1(graph, n_dev):
    """D shards on one card: K3 at every step (D² launches, no fold),
    values and indices equal to K1's on both variants."""
    hin, mp, dense = graph
    b = create_backend("torch-sharded", hin, mp, n_devices=n_dev)
    for variant in ("rowsum", "diagonal"):
        ck.reset_launches()
        got = b.topk(k=10, variant=variant)
        assert ck.LAUNCHES["topk_rect_candidates"] == n_dev * n_dev
        want = dense.topk(k=10, variant=variant)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


def test_k3_steps_equal_the_fold(graph):
    """The same ring with K3 and with the torch fold (forced) on the card:
    bit-identical, ties included; k = 16 (K3 refuses it) takes the fold."""
    hin, mp, _ = graph
    b = create_backend("torch-sharded", hin, mp, n_devices=4)
    common = dict(mesh=b.mesh, k=10, n_true=b.n)
    kv, ki = sharded_topk(b._first, (), use_kernel=True, **common)
    fv, fi = sharded_topk(b._first, (), use_kernel=False, **common)
    for a, f in zip(kv + ki, fv + fi):
        assert torch.equal(a, f)
    ck.reset_launches()
    v16, i16 = b.topk(k=16)
    assert ck.LAUNCHES["topk_rect_candidates"] == 0
    want = create_backend("torch", hin, mp, device="cpu").topk(k=16)
    assert np.array_equal(v16, want[0]) and np.array_equal(i16, want[1])


def test_mid_ring_resume_on_the_card(graph, tmp_path):
    """A stepwise ring killed after step 1 resumes from its snapshot with
    the same arrays as the fused ring."""
    from distributed_pathsim_tpu_torch.resilience import inject

    hin, mp, _ = graph
    b = create_backend("torch-sharded", hin, mp, n_devices=4)
    want = b.topk(k=10)
    inject.install_plan("tile_execute:crash:1@2")
    try:
        with pytest.raises(inject.InjectedCrash):
            b.topk_scores(k=10, checkpoint_dir=str(tmp_path))
    finally:
        inject.reset()
    got = b.topk_scores(k=10, checkpoint_dir=str(tmp_path))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_ring_across_cards(graph):
    """One shard per card when the machine has two or more: the rotation
    copies blocks and limbs between cards, ordered against K3 on the
    destination's stream."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    hin, mp, dense = graph
    n = torch.cuda.device_count()
    mesh = make_mesh(n, platform="cuda")
    assert len(set(mesh.devices)) == n
    c = torch.as_tensor(dense._half()[0].cpu().numpy())
    first = shard_first_block_rows(c, mesh)
    vals, idxs = sharded_topk(first, (), mesh=mesh, k=10, n_true=dense.n_sources)
    got_v = torch.cat([v.cpu() for v in vals])[: dense.n_sources].double()
    got_i = torch.cat([i.cpu() for i in idxs])[: dense.n_sources]
    want = dense.topk(k=10)
    assert np.array_equal(got_v.numpy(), want[0])
    assert np.array_equal(got_i.numpy(), want[1])


def test_partition_window_counts_on_the_card(graph):
    """A partition worker on the card scores its windows with the card's
    f64 GEMM, bit-identical to the host arm."""
    from distributed_pathsim_tpu_torch.backends.partition_factors import (
        range_colsums,
    )
    from distributed_pathsim_tpu_torch.serving.partition import (
        PartitionConfig,
        PartitionService,
    )

    hin, mp, _ = graph
    host = [PartitionService(hin, mp, i, 3, 1,
                             config=PartitionConfig(device="cpu"))
            for i in range(3)]
    on_card = PartitionService(hin, mp, 0, 3, 1,
                               config=PartitionConfig(device="cuda"))
    g = np.zeros(host[0].fs.v)
    for svc in host:  # the router's colsum: one contribution per range
        for payload in range_colsums(svc.fs, svc.held).values():
            g[payload["cols"]] += payload["vals"]
    nz = np.flatnonzero(g)
    for svc in (host[0], on_card):
        svc.set_colsum({"mode": "init", "cols": nz.tolist(),
                        "vals": g[nz].tolist()})
    req = {"range": 0, "row": 5, "k": 10, **host[0].tile_pull({"row": 5})}
    assert on_card.partial_topk(req)["cands"] == host[0].partial_topk(
        req)["cands"]
    a, b = on_card.partial_scores(req), host[0].partial_scores(req)
    assert a["counts"] == b["counts"] and a["denoms"] == b["denoms"]
