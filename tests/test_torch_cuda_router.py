"""The router fleet on the card: two ``dpathsim-torch worker`` processes
with ``--platform cuda`` behind one port Router answer every row as one
port service on the same card does, before and after a broadcast
``update`` that both replicas apply on the delta path. Needs a CUDA card
(marker ``cuda``) and skips without one; it imports only the port:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_router.py
"""

import sys

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.router import (
    Router,
    RouterConfig,
    SubprocessTransport,
)
from distributed_pathsim_tpu_torch.router.cli import build_worker_hin
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from distributed_pathsim_tpu_torch.serving.protocol import handle_request

pytestmark = pytest.mark.cuda

SPEC = "synthetic:authors=1500,papers=2250,venues=40,seed=5"


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.true_f32()
    return torch.device("cuda")


def _routed(router, rows, k=10):
    """Every row through the router, 128 requests in flight at a time
    (under every queue bound, so nothing is shed)."""
    out = []
    for i in range(0, len(rows), 128):
        futs = [router.submit({"id": int(r), "op": "topk", "row": int(r),
                               "k": k}) for r in rows[i:i + 128]]
        for f in futs:
            resp = f.result(timeout=120)
            assert resp["ok"], resp
            out.append(resp["result"])
    return out


def _served(svc, rows, k=10):
    return [{"row": int(r), "topk": [
        {"id": i, "label": lab, "score": s}
        for i, lab, s in svc.topk(row=int(r), k=k)]} for r in rows]


def test_two_workers_on_the_card_answer_as_one_service(card):
    argv = [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli",
            "worker", "--dataset", SPEC, "--backend", "torch",
            "--platform", "cuda"]
    transports = {f"w{i}": SubprocessTransport(
        f"w{i}", argv + ["--worker-id", f"w{i}"]) for i in range(2)}
    router = Router(transports, RouterConfig())
    hin = build_worker_hin(SPEC, 0.25)
    svc = PathSimService(
        create_backend("torch", hin, compile_metapath("APVPA", hin.schema),
                       device=card),
        config=ServeConfig(warm=False))
    try:
        router.start(ready_timeout=300)
        rows = np.arange(svc.n)
        assert _routed(router, rows) == _served(svc, rows)
        upd = {"op": "update", "add_edges": [
            {"rel": "author_of", "src_row": 3, "dst_row": 17},
            {"rel": "author_of", "src_row": 900, "dst_row": 5}]}
        resp = router.request(dict(upd), timeout=120)
        assert resp["ok"] and resp["result"]["applied"] == ["w0", "w1"]
        assert resp["result"]["mode"] == "delta"
        assert handle_request(svc, dict(upd))["result"]["mode"] == "delta"
        assert _routed(router, rows) == _served(svc, rows)
        for wid in transports:
            health = router.worker_health(wid)
            assert health["delta_seq"] == 1 and health["backend"] == "torch"
    finally:
        router.close()
        svc.close()
