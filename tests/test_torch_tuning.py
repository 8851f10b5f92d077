"""The port's tuning dispatch (``distributed_pathsim_tpu_torch.tuning``)
against the JAX package's: the same keys and untuned defaults for every
ported knob, the table's round trip and integrity ladder, a table the
JAX package wrote degrading to heuristics with one ``tuning_fallback``
event, and ``--no-tuning`` ignoring ``PATHSIM_TUNING_TABLE``."""

import json

import numpy as np
import pytest

from distributed_pathsim_tpu import tuning as jtuning
from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.ops import planner as jplanner
from distributed_pathsim_tpu_torch import tuning
from distributed_pathsim_tpu_torch.backends.base import create_backend as tcreate
from distributed_pathsim_tpu_torch.cli import main as torch_main
from distributed_pathsim_tpu_torch.ops import planner as tplanner
from torch_port_util import backend_graphs, metapaths, write_cli_gexf

PORTED = ("plan_density_cutover", "plan_dp_max_len", "sparse_tile_rows",
          "sparse_nnz_floor", "serve_buckets", "factor_format")


@pytest.fixture(autouse=True)
def fresh_tuning(monkeypatch):
    monkeypatch.delenv(tuning.TUNING_TABLE_ENV, raising=False)
    tuning.reset()
    jtuning.reset()
    yield
    tuning.reset()
    jtuning.reset()


@pytest.mark.parametrize("knob", PORTED)
def test_keys_and_untuned_choices_equal_jax(knob):
    assert knob in jtuning.KNOBS and knob in tuning.KNOBS
    for n, v, nnz, dtype in ((None, None, None, "float32"),
                             (350, 14, 1200, "float32"),
                             (1 << 20, 64, 5 << 20, "float64")):
        assert tuning.make_key(knob, "NVIDIA H100 80GB HBM3", n=n, v=v,
                               nnz=nnz, dtype=dtype) == jtuning.make_key(
            knob, "NVIDIA H100 80GB HBM3", n=n, v=v, nnz=nnz, dtype=dtype)
        assert tuning.choose(knob, n=n, v=v, nnz=nnz, default=7) == \
            jtuning.choose(knob, n=n, v=v, nnz=nnz, default=7) == 7


def test_sites_resolve_the_jax_defaults_untuned():
    """The port's decision points, untuned, land where the JAX
    package's land: planner knobs, the streaming tile height and pad
    floor, the factor format, the serving ladder."""
    assert tplanner._plan_knobs(350, 2, 1200) == \
        jplanner._plan_knobs(350, 2, 1200) == (0.25, 16)
    graphs = backend_graphs()
    jmp, tmp = metapaths(graphs)
    jb = jcreate("jax-sparse", graphs[0], jmp)
    tb = tcreate("torch-sparse", graphs[1], tmp, device="cpu")
    assert tb._tile_rows_req == jb._tile_rows_req == 4096
    assert tb._nnz_floor_req == jb._nnz_floor_req == 1
    assert tb._factor_format == "coo"
    # the packed layouts' arms and the batch tier's block height: the JAX
    # package's keys and candidates
    for knob in ("factor_format", "batch_block_rows"):
        assert tuning.KNOBS[knob].candidates({}) == \
            jtuning.KNOBS[knob].candidates({})
        assert tuning.make_key(knob, "cpu", n=130) == jtuning.make_key(
            knob, "cpu", n=130)
    assert tuning.resolve_ladder("pow2", 32) == jtuning.resolve_ladder(
        "pow2", 32)
    assert tuning.resolve_ladder("coarse", 40) == jtuning.resolve_ladder(
        "coarse", 40)
    # the Pallas tile/variant knobs have no port arm
    for knob in ("scores_variant", "scores_tile", "topk_rowtile", "k_tile"):
        assert knob not in tuning.KNOBS
        with pytest.raises(KeyError):
            tuning.choose(knob, default=1)
    # ring_kernel keeps the JAX key; its one arm is K3, so a table's fold
    # arm on a K3-feasible shape counts as a fallback and K3 runs
    from distributed_pathsim_tpu_torch.parallel.sharded import (
        resolve_ring_kernel,
    )

    assert tuning.KNOBS["ring_kernel"].candidates({}) == ["rect-cuda"]
    assert tuning.make_key("ring_kernel", "cpu", n=130, v=16) == \
        jtuning.make_key("ring_kernel", "cpu", n=130, v=16)
    table = tuning.TuningTable("cpu")
    table.put(tuning.make_key("ring_kernel", "cpu", n=130, v=16),
              "jnp-fold")
    tuning.set_table(table, "test")
    before = tuning.lookup_stats().get("fallback", 0)
    assert tuning.choose("ring_kernel", n=130, v=16, default="rect-cuda",
                         valid=lambda arm: arm == "rect-cuda") == "rect-cuda"
    assert tuning.lookup_stats()["fallback"] == before + 1
    assert not resolve_ring_kernel(130, 16, 10, "cpu")  # the host folds
    assert not resolve_ring_kernel(130, 16, 16, "cuda")  # K3 refuses k=16


def test_table_round_trip_hits_and_nearest(tmp_path):
    t = tuning.TuningTable("cpu")
    key = tuning.make_key("sparse_tile_rows", "cpu", n=400, v=16, nnz=900)
    t.put(key, 1024, metric_ms=1.5, arms={"1024": 1.5, "4096": 2.0})
    path = str(tmp_path / "t.json")
    digest = t.save(path)
    doc = json.loads(open(path).read())
    assert doc["torch_version"] == tuning.table.torch_fingerprint()
    assert "jax_version" not in doc and doc["digest"] == digest
    loaded = tuning.load_table(path, "cpu")
    assert loaded.lookup(key).choice == 1024 and loaded.digest == digest
    before = tuning.lookup_stats()
    assert tuning.install_table(path)
    assert tuning.choose("sparse_tile_rows", n=400, v=16, nnz=900,
                         default=4096) == 1024
    assert tuning.choose("sparse_tile_rows", n=3000, v=16, nnz=900,
                         default=4096) == 1024  # nearest bucket
    assert tuning.choose("plan_dp_max_len", default=16) == 16  # miss
    after = tuning.lookup_stats()
    for result in ("hit", "nearest", "default"):
        assert after.get(result, 0) == before.get(result, 0) + 1, result
    # tampering breaks the digest; another device is a fingerprint miss
    doc["entries"][key]["choice"] = 2048
    (tmp_path / "bad.json").write_text(json.dumps(doc))
    with pytest.raises(tuning.TableError) as exc:
        tuning.load_table(str(tmp_path / "bad.json"), "cpu")
    assert exc.value.reason == "corrupt"
    with pytest.raises(tuning.TableError) as exc:
        tuning.load_table(path, "NVIDIA H100 80GB HBM3")
    assert exc.value.reason == "fingerprint-mismatch"


def test_jax_written_table_falls_back_once(tmp_path, capsys):
    jt = jtuning.TuningTable("cpu")
    jt.put(jtuning.make_key("sparse_tile_rows", "cpu", n=400), 1024)
    path = str(tmp_path / "jax_table.json")
    jt.save(path)
    with pytest.raises(tuning.TableError) as exc:
        tuning.load_table(path, "cpu")
    assert exc.value.reason == "fingerprint-mismatch"
    assert "table jax" in str(exc.value)
    capsys.readouterr()
    assert not tuning.install_table(path)
    assert not tuning.install_table(path)  # a second try stays quiet
    err = capsys.readouterr().err
    assert err.count("tuning_fallback") == 1
    assert "fingerprint-mismatch" in err
    assert tuning.active_table() is None
    assert tuning.choose("sparse_tile_rows", n=400, default=4096) == 4096


def _ckpt_tile_rows(ckpt_dir) -> int:
    manifest = json.loads((ckpt_dir / "manifest.json").read_text())
    return next(v for v in manifest.values()
                if isinstance(v, dict) and "tile_rows" in v)["tile_rows"]


def test_env_table_drives_the_cli_and_no_tuning_ignores_it(
        tmp_path, monkeypatch, capsys):
    """A port table in PATHSIM_TUNING_TABLE sets torch-sparse's tile
    height (a hit at the folded factor's key); ``--no-tuning`` ignores
    it; both rankings are identical (tuning is bit-invisible)."""
    gexf = write_cli_gexf(tmp_path / "g.gexf")
    t = tuning.TuningTable("cpu")
    t.put(tuning.make_key("sparse_tile_rows", "cpu", n=350, v=14,
                          nnz=None), 128)
    table = str(tmp_path / "t.json")
    t.save(table)
    monkeypatch.setenv(tuning.TUNING_TABLE_ENV, table)
    base = ["--dataset", gexf, "--platform", "cpu", "--backend",
            "torch-sparse", "--top-k", "4", "--quiet"]
    tsv = {}
    for name, extra in (("tuned", []), ("untuned", ["--no-tuning"])):
        tuning.reset()
        ckpt = tmp_path / name
        assert torch_main(base + extra + [
            "--checkpoint-dir", str(ckpt),
            "--ranking-out", str(tmp_path / f"{name}.tsv")]) == 0
        tsv[name] = (tmp_path / f"{name}.tsv").read_bytes()
        want = 128 if name == "tuned" else 350  # untuned: 4096, capped at N
        assert _ckpt_tile_rows(ckpt) == want, name
    assert tsv["tuned"] == tsv["untuned"]
    assert "tuning_fallback" not in capsys.readouterr().err
    np.testing.assert_equal(tuning.active_table(), None)  # --no-tuning
