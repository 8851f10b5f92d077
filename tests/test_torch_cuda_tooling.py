"""The port's tooling twins on the card: the graft entry's forward
step eager and replayed from a CUDA graph, each equal bit for bit to the
CPU's; the dry run at D = 2 and 4 shards on the card (the ring's K3 at
every step, D² launches, equal to the torch fold on host copies) and on
the host without touching the card; the neural bench at a tiny size
with struct figures equal to the CPU run's. These tests need a CUDA card
(marker ``cuda``) and skip without one; they import only the port:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_tooling.py
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from distributed_pathsim_tpu_torch import graft_entry, neural_bench
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = ["--authors", "2000", "--papers", "6000", "--venues", "24",
        "--steps", "20", "--batch", "512", "--dim", "16", "--hidden", "32",
        "--eval-sources", "20"]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.true_f32()
    return torch.device("cuda")


def test_entry_eager_and_graph_replayed_equal_the_cpu(card):
    fn, args = graft_entry.entry()
    assert all(a.device.type == "cuda" for a in args)
    want = fn(*(a.cpu() for a in args))
    assert torch.equal(fn(*args).cpu(), want)
    assert torch.equal(graft_entry.graph_replay(fn, args).cpu(), want)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_on_the_card(card, n):
    report = graft_entry.dryrun_multichip(n)
    assert report["launches_1c"][graft_entry.RING_KERNEL] == n * n
    assert sum(report["launches_1c"].values()) == n * n
    assert report["resume_steps"] == n - 1


def test_dryrun_on_the_host_leaves_the_card_alone(card):
    code = ("import torch; from distributed_pathsim_tpu_torch import "
            "graft_entry; graft_entry.dryrun_multichip(2, platform='cpu'); "
            "print(torch.cuda.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"]


def test_neural_bench_struct_figures_equal_the_cpu(card):
    got = neural_bench.main(TINY)
    want = neural_bench.main(TINY + ["--platform", "cpu"])
    assert got["config"]["platform"] == "cuda"
    for key in ("struct_recall_at_k",
                "struct_rerank_recall_at_k_top100_prefilter", "struct_dim",
                "eval_sources"):
        assert got[key] == want[key], key
    assert json.dumps(list(got)) == json.dumps(list(want))
