"""The batch CLI's new flags with ``--platform cuda``: ``--dtype
float64`` on the f32 kernels (and its 2^24 guard), the multi-metapath
ensemble on the card against the host's, the observability flags (the
profiler trace names K1's kernel), the card's degradation chain and the
tuning table keyed on the card's name. These tests need a CUDA card
(marker ``cuda``) and skip without one; they import only the port:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_batch_cli.py
"""

import json

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch import tuning
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.cli import main as cli_main
from distributed_pathsim_tpu_torch.data.synthetic import (
    synthetic_hin,
    write_gexf,
)
from distributed_pathsim_tpu_torch.driver import PathSimDriver
from distributed_pathsim_tpu_torch.models.multipath import MultiMetapathScorer
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.resilience import inject

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.true_f32()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def gexf(card, tmp_path_factory):
    path = tmp_path_factory.mktemp("cuda_cli") / "g.gexf"
    write_gexf(synthetic_hin(3001, 4500, 40, seed=5, materialize_ids=True),
               str(path))
    return str(path)


def _rank(gexf, out, *extra):
    ck.reset_launches()
    rc = cli_main(["--dataset", gexf, "--platform", "cuda", "--quiet",
                   "--top-k", "10", "--ranking-out", str(out), *extra])
    assert rc == 0
    return dict(ck.LAUNCHES)


def test_float64_ranks_on_the_kernels_and_guards_the_cast(card, gexf,
                                                          tmp_path):
    launches = _rank(gexf, tmp_path / "f64.tsv", "--dtype", "float64")
    assert launches["topk_twopass_candidates"] == 1
    _rank(gexf, tmp_path / "f32.tsv")
    assert (tmp_path / "f64.tsv").read_bytes() == \
        (tmp_path / "f32.tsv").read_bytes()
    big = synthetic_hin(1500, 40_000, 3, seed=1)
    b = create_backend("torch", big, compile_metapath("APVPA", big.schema),
                       dtype=torch.float64, device=card)
    with pytest.raises(OverflowError, match="--approx"):
        b.all_pairs_scores()
    host = create_backend("numpy", big, compile_metapath("APVPA", big.schema))
    np.testing.assert_array_equal(b.pairwise_row(3), host.pairwise_row(3))
    # past 2^24 rank-all takes the exact instances: the f64 oracle's
    for got, want in zip(PathSimDriver(b).rank_all(5),
                         PathSimDriver(host).rank_all(5)):
        np.testing.assert_array_equal(got, want)
    approx = create_backend("torch", big,
                            compile_metapath("APVPA", big.schema),
                            dtype=torch.float64, device=card,
                            exact_counts=False)
    assert approx.topk(k=5)[0].shape == (1500, 5)


def test_ensemble_on_the_card_equals_the_host(card, gexf):
    hin = synthetic_hin(3001, 4500, 40, seed=5)
    names, w = ["APVPA", "APA"], [0.7, 0.3]
    dev = MultiMetapathScorer(hin, names, device=card)
    host = MultiMetapathScorer(hin, names, device="cpu")
    np.testing.assert_array_equal(dev.combined_scores(w),
                                  host.combined_scores(w))
    dv, di = dev.topk(k=10, weights=w)
    hv, hi = host.topk(k=10, weights=w)
    np.testing.assert_array_equal(dv, hv)
    np.testing.assert_array_equal(di, hi)
    assert cli_main(["--dataset", gexf, "--platform", "cuda", "--metapath",
                     "APVPA,APA", "--weights", "0.7,0.3", "--top-k", "5",
                     "--all-pairs"]) == 0


def test_observability_flags_on_the_card(card, gexf, tmp_path):
    rc = cli_main(["--dataset", gexf, "--platform", "cuda", "--quiet",
                   "--top-k", "10", "--metrics", str(tmp_path / "m.jsonl"),
                   "--trace-out", str(tmp_path / "t.json"), "--metrics-file",
                   str(tmp_path / "m.prom"), "--profile-dir",
                   str(tmp_path / "prof")])
    assert rc == 0
    events = [json.loads(line)["event"]
              for line in (tmp_path / "m.jsonl").open()]
    assert "stage_time" in events
    assert "dpathsim_stage_seconds" in (tmp_path / "m.prom").read_text()
    prof = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("topk_twopass_kernel" in str(e.get("name", ""))
               for e in prof["traceEvents"])


def test_degradation_stays_on_the_card(card, gexf, tmp_path, monkeypatch):
    _rank(gexf, tmp_path / "want.tsv")
    monkeypatch.setenv("PATHSIM_RETRY_BASE_DELAY", "0")
    monkeypatch.setenv(inject.ENV_VAR, "backend_init:error:3")
    inject.reset()
    try:
        _rank(gexf, tmp_path / "got.tsv", "--backend", "torch-sparse",
              "--metrics", str(tmp_path / "m.jsonl"))
        steps = [(e["from_"], e["to"], e["platform"])
                 for e in map(json.loads, (tmp_path / "m.jsonl").open())
                 if e["event"] == "degrade"]
        assert steps == [("torch-sparse", "torch", "cuda")]
        assert (tmp_path / "got.tsv").read_bytes() == \
            (tmp_path / "want.tsv").read_bytes()
        monkeypatch.setenv(inject.ENV_VAR, "backend_init:error:100")
        inject.reset()
        with pytest.raises(inject.InjectedFault):
            _rank(gexf, tmp_path / "never.tsv")
    finally:
        inject.reset()


def test_tuning_table_keys_on_the_card(card, gexf, tmp_path):
    from distributed_pathsim_tpu_torch.engine import install_tuning
    from distributed_pathsim_tpu_torch.config import RunConfig

    name = torch.cuda.get_device_name(card)
    t = tuning.TuningTable(name)
    t.put(tuning.make_key("sparse_tile_rows", name, n=3001, v=40), 1024)
    t.save(str(tmp_path / "t.json"))
    try:
        install_tuning(RunConfig(dataset=gexf, platform="cuda",
                                 tuning_table=str(tmp_path / "t.json")))
        assert tuning.device_kind() == name
        assert tuning.active_table() is not None
        launches = _rank(gexf, tmp_path / "tuned.tsv", "--backend",
                         "torch-sparse", "--tuning-table",
                         str(tmp_path / "t.json"))
        assert launches["topk_rect_candidates"] == 3  # 3001 rows / 1024
    finally:
        tuning.reset()
