"""The CUDA backend's device handling on the card: it refuses to start
with TF32 on, and a kernel launches on its factor's own card. These
tests need a CUDA card (marker ``cuda``) and skip without one; they
import only the port, so they run on a machine with no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_devices.py
"""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data.encode import factor_from_arrays
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops import planner
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.true_f32()
    return torch.device("cuda")


def test_backend_refuses_tf32(card, monkeypatch):
    hin = synthetic_hin(64, 96, 8, seed=9)
    mp = compile_metapath("APVPA", hin.schema)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(ValueError, match="TF32"):
        create_backend("torch", hin, mp)


def test_launch_on_a_second_card(card):
    """A factor on cuda:1 launches on cuda:1's stream while cuda:0 is
    the current device."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    hin = synthetic_hin(301, 451, 24, seed=4)
    c = planner.dense_half(hin, compile_metapath("APVPA", hin.schema),
                           dtype=np.float64)
    c, d = factor_from_arrays(c, c @ c.sum(0), torch.device("cuda:1"))
    with torch.cuda.device(0):
        got = ck.fused_topk_twopass(c, d, k=5)
    want = ck.fused_topk_twopass_plain(c, d, k=5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
