"""NeuralPathSim's training on the card against the same training on the
CPU: equal initial weights (drawn on the CPU, moved), mining whose lists
equal the CPU's bit for bit, 5 train steps from the same pool and batches
within ``rtol=1e-4`` (losses) and ``atol=1e-5`` (embeddings), a 2-shard
mesh on the one card equal to the single-device step, and two card runs
of 200 steps from one seed bit-identical. These tests need a CUDA card
(marker ``cuda``) and skip without one; they import only the port:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_neural.py
"""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.models.neural import NeuralPathSim
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.true_f32()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def hin():
    return synthetic_hin(800, 1200, 24, seed=11)


def _models(hin, **kw):
    kw = {"dim": 32, "hidden": 64, "seed": 5, **kw}
    return (NeuralPathSim(hin, "APVPA", device="cpu", **kw),
            NeuralPathSim(hin, "APVPA", device="cuda", **kw))


def test_mining_on_the_card_equals_the_cpu(card, hin):
    cpu, gpu = _models(hin)
    for kw in ({"n_sources": 300, "k": 32, "seed": 0},
               {"n_sources": 50, "k": 16, "seed": 3, "chunk": 16}):
        for a, b in zip(gpu.mine_hard_candidates(**kw),
                        cpu.mine_hard_candidates(**kw)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_steps_on_the_card_match_the_cpu(card, hin):
    cpu, gpu = _models(hin)
    for (_, a), (_, b) in zip(cpu.model.named_parameters(),
                              gpu.model.named_parameters()):
        assert torch.equal(a, b.cpu())
    src, cand = cpu.mine_hard_candidates(128, k=16, seed=1)
    for m in (cpu, gpu):
        m.set_hard_pool(src, cand)
    lc = cpu.train(steps=5, batch_size=256, seed=7)
    lg = gpu.train(steps=5, batch_size=256, seed=7)
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    np.testing.assert_allclose(gpu.embeddings(), cpu.embeddings(),
                               atol=1e-5)


def test_two_shards_on_the_card_match_one(card, hin):
    single = NeuralPathSim(hin, "APVPA", dim=16, hidden=32, seed=3,
                           device="cuda")
    sharded = NeuralPathSim(hin, "APVPA", dim=16, hidden=32, seed=3,
                            mesh=make_mesh(2, devices=[card]))
    l1 = single.train(steps=5, batch_size=256, seed=7)
    l2 = sharded.train(steps=5, batch_size=256, seed=7)
    np.testing.assert_allclose(l1, l2, rtol=1e-4)
    np.testing.assert_allclose(single.embeddings(), sharded.embeddings(),
                               atol=1e-5)


def test_card_training_is_deterministic(card, hin):
    runs = []
    for _ in range(2):
        model = NeuralPathSim(hin, "APVPA", dim=32, hidden=64, seed=0,
                              device="cuda")
        model.set_hard_pool(*model.mine_hard_candidates(64, k=16, seed=0))
        runs.append((model.train(steps=200, batch_size=512, seed=0),
                     model.embeddings()))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert runs[0][0][-1] < runs[0][0][0]
