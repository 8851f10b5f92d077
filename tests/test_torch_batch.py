"""Port parity: the batch tier's campaigns (``batch/``) against the JAX
package's, zero tolerance, on the CPU (the host arm; the card's f64 GEMM
arm is held against it in tests/test_torch_cuda_batch.py).

- ``run_topk_campaign``: values, indices and ``export_pairs`` bytes equal
  to the JAX package's on the same graph, for the COO and a packed
  layout (and the pairs loader, split and negative sampling of
  ``batch/pairs.py`` on that export); the manifest identity config equal to the JAX package's as a
  dict; ``block_rows`` invisible in the result;
- SIGTERM mid-campaign resumes byte-identically (shard files and
  arrays); a manifest of another campaign is refused;
- ``run_simjoin_campaign``: equal to the JAX package's, and its block
  prune never drops a pair (against brute force over random graphs and
  taus) in every grouping; a preempted join resumes to the same pairs;
- ``dpathsim-torch batch`` writes the same ``--out`` and ``--emit-pairs``
  bytes as ``dpathsim batch``."""

import hashlib
import json
import os
import pathlib
import signal

import numpy as np
import pytest

from distributed_pathsim_tpu.batch import BatchEngine as JEngine
from distributed_pathsim_tpu.batch import campaign as jcampaign
from distributed_pathsim_tpu.batch import run_simjoin_campaign as jsimjoin
from distributed_pathsim_tpu.batch import run_topk_campaign as jtopk
from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.batch import (
    BatchEngine,
    run_simjoin_campaign,
    run_topk_campaign,
)
from distributed_pathsim_tpu_torch.batch import campaign as tcampaign
from distributed_pathsim_tpu_torch.resilience import (
    Preempted,
    preemption_handler,
)
from torch_port_util import metapaths, port_hin


@pytest.fixture(scope="module")
def graphs():
    jhin = jsyn.synthetic_hin(130, 240, 8, seed=5)
    return jhin, port_hin(jhin)


def _engines(graphs, **kw):
    jmp, tmp = metapaths(graphs)
    return (JEngine(graphs[0], jmp, **kw),
            BatchEngine(graphs[1], tmp, device="cpu", **kw))


@pytest.fixture
def preemption():
    yield preemption_handler
    preemption_handler.uninstall()
    preemption_handler.reset()


def _shard_hashes(ckdir) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in pathlib.Path(ckdir).glob("*.npy")}


@pytest.mark.parametrize("fmt", ["coo", "bitpacked"])
def test_topk_campaign_and_export_equal_jax(graphs, fmt, tmp_path):
    je, te = _engines(graphs, block_rows=32, factor_format=fmt)
    assert te.backend_mode == "numpy" and te.block_rows == je.block_rows
    ja = jtopk(je, 7, emit_pairs=str(tmp_path / "j.jsonl"))
    ta = run_topk_campaign(te, 7, emit_pairs=str(tmp_path / "t.jsonl"))
    np.testing.assert_array_equal(ta.vals, ja.vals)
    np.testing.assert_array_equal(ta.idxs, ja.idxs)
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    # the --emit-pairs loader and its split / negative sampling
    from distributed_pathsim_tpu.batch import pairs as jpairs
    from distributed_pathsim_tpu_torch.batch import pairs as tpairs

    got = tpairs.load_pairs(str(tmp_path / "t.jsonl"))
    for a, b in zip(got, jpairs.load_pairs(str(tmp_path / "j.jsonl"))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tpairs.split_pairs(got[0], 0.2, seed=3),
                    jpairs.split_pairs(got[0], 0.2, seed=3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tpairs.sample_negatives(got[0], got[1], te.n, seed=4),
                    jpairs.sample_negatives(got[0], got[1], te.n, seed=4)):
        np.testing.assert_array_equal(a, b)
    assert (te.spec("topk", k=7).manifest_config()
            == je.spec("topk", k=7).manifest_config())
    assert (te.spec("simjoin", tau=0.3, grouping="degree").manifest_config()
            == je.spec("simjoin", tau=0.3,
                       grouping="degree").manifest_config())
    assert tcampaign.block_ranges(130, 32) == jcampaign.block_ranges(130, 32)
    # the serving oracle's rows, bit for bit
    b = create_backend("torch", graphs[1], metapaths(graphs)[1],
                       device="cpu")
    sample = np.array([0, 1, 31, 32, 63, 64, 100, te.n - 1])
    vals, idxs = b.topk_rows(sample, 7, variant="rowsum")
    np.testing.assert_array_equal(ta.vals[sample], vals)
    np.testing.assert_array_equal(ta.idxs[sample], idxs)


def test_block_rows_invisible_and_diagonal_variant(graphs):
    ref = run_topk_campaign(_engines(graphs, block_rows=32)[1], 5)
    for br in (8, 100, 128):  # 100 snaps to the pow-2 ladder
        eng = _engines(graphs, block_rows=br)[1]
        assert eng.block_rows & (eng.block_rows - 1) == 0
        res = run_topk_campaign(eng, 5)
        np.testing.assert_array_equal(res.vals, ref.vals)
        np.testing.assert_array_equal(res.idxs, ref.idxs)
    je, te = _engines(graphs, block_rows=64, variant="diagonal")
    a, b = jtopk(je, 4), run_topk_campaign(te, 4)
    np.testing.assert_array_equal(a.vals, b.vals)
    np.testing.assert_array_equal(a.idxs, b.idxs)


def test_sigterm_resume_byte_identical(graphs, tmp_path, preemption):
    """A real SIGTERM mid-campaign: the in-flight block's shard is
    durable, the resume skips the completed blocks, and the shard files
    and arrays equal an uninterrupted run's."""
    eng = _engines(graphs, block_rows=32)[1]
    ck_ref, ck_cut = tmp_path / "ref", tmp_path / "cut"
    ref = run_topk_campaign(eng, 7, checkpoint_dir=str(ck_ref))
    assert preemption.install()

    def on_block(done, total):
        if done == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(Preempted) as exc_info:
        run_topk_campaign(eng, 7, checkpoint_dir=str(ck_cut),
                          on_block=on_block)
    assert exc_info.value.resumable
    preemption.reset()
    assert len(_shard_hashes(ck_cut)) == 4  # two blocks: vals + idxs
    res = run_topk_campaign(_engines(graphs, block_rows=32)[1], 7,
                            checkpoint_dir=str(ck_cut))
    assert res.blocks_resumed == 2
    np.testing.assert_array_equal(res.vals, ref.vals)
    np.testing.assert_array_equal(res.idxs, ref.idxs)
    assert _shard_hashes(ck_cut) == _shard_hashes(ck_ref)


def test_stale_manifest_refused(graphs, tmp_path):
    ck = str(tmp_path / "ck")
    run_topk_campaign(_engines(graphs, block_rows=32)[1], 5,
                      checkpoint_dir=ck)
    with pytest.raises(ValueError, match="different run"):
        run_topk_campaign(_engines(graphs, block_rows=32)[1], 6,
                          checkpoint_dir=ck)
    jhin2 = jsyn.synthetic_hin(130, 240, 8, seed=6)
    other = _engines((jhin2, port_hin(jhin2)), block_rows=32)[1]
    with pytest.raises(ValueError, match="different run"):
        run_topk_campaign(other, 5, checkpoint_dir=ck)
    # a campaign of another layout is another campaign too
    with pytest.raises(ValueError, match="different run"):
        run_topk_campaign(_engines(graphs, block_rows=32,
                                   factor_format="blocked")[1], 5,
                          checkpoint_dir=ck)


@pytest.mark.parametrize("grouping", ["natural", "degree", "centroid"])
def test_simjoin_equals_jax_and_prune_never_drops_a_pair(grouping):
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        jhin = jsyn.synthetic_hin(
            int(rng.integers(40, 90)), int(rng.integers(80, 160)),
            int(rng.integers(3, 9)), seed=seed + 100)
        graphs = (jhin, port_hin(jhin))
        je, te = _engines(graphs, block_rows=16)
        scores = create_backend("numpy", graphs[1],
                                metapaths(graphs)[1]).scores_rows(
            np.arange(te.n), variant="rowsum")
        iu = np.arange(te.n)
        for tau in (0.02, float(rng.uniform(0.03, 0.4)), 0.9):
            res = run_simjoin_campaign(te, tau, grouping=grouping)
            ref = jsimjoin(je, tau, grouping=grouping)
            np.testing.assert_array_equal(res.rows, ref.rows)
            np.testing.assert_array_equal(res.cols, ref.cols)
            np.testing.assert_array_equal(res.scores, ref.scores)
            assert res.block_pairs_pruned == ref.block_pairs_pruned
            ii, jj = np.nonzero((scores >= tau) & (iu[:, None] < iu[None, :]))
            assert set(zip(res.rows.tolist(), res.cols.tolist())) == \
                set(zip(ii.tolist(), jj.tolist())), (seed, tau)
            assert (res.scores == scores[res.rows, res.cols]).all()
    with pytest.raises(ValueError, match="rowsum"):
        run_simjoin_campaign(_engines(graphs, block_rows=16,
                                      variant="diagonal")[1], 0.5)
    with pytest.raises(ValueError, match="tau > 0"):
        run_simjoin_campaign(te, 0.0)


def test_simjoin_resume_matches_straight_run(graphs, tmp_path, preemption):
    eng = _engines(graphs, block_rows=32)[1]
    ref = run_simjoin_campaign(eng, 0.05, grouping="degree")
    assert ref.block_pairs_pruned > 0  # the certificates fire
    ck = str(tmp_path / "sj")

    def on_block(done, total):
        if done == 1:
            preemption.request("test")

    with pytest.raises(Preempted):
        run_simjoin_campaign(eng, 0.05, grouping="degree",
                             checkpoint_dir=ck, on_block=on_block)
    preemption.reset()
    res = run_simjoin_campaign(eng, 0.05, grouping="degree",
                               checkpoint_dir=ck)
    assert res.blocks_resumed == 1
    np.testing.assert_array_equal(res.rows, ref.rows)
    np.testing.assert_array_equal(res.cols, ref.cols)
    np.testing.assert_array_equal(res.scores, ref.scores)


def test_batch_cli_bytes_equal_jax_cli(tmp_path, capsys):
    """``dpathsim-torch batch topk-all|simjoin|resume --platform cpu``
    against ``dpathsim batch ... --no-jax`` on one synthetic spec: the
    same --out and --emit-pairs bytes, the same summary lines but the
    backend's name."""
    from distributed_pathsim_tpu.batch.cli import batch_main as jmain
    from distributed_pathsim_tpu_torch.cli import main as tmain

    spec = "synthetic:authors=90,papers=150,venues=6,seed=3"
    runs = []
    for side in ("j", "t"):
        d = tmp_path / side
        d.mkdir()
        base = ["--dataset", spec, "--block-rows", "32"]
        plat = ["--no-jax"] if side == "j" else ["--platform", "cpu"]
        argvs = [
            ["topk-all", *base, *plat, "--k", "4", "--checkpoint-dir",
             str(d / "ck"), "--out", str(d / "a.npz"), "--emit-pairs",
             str(d / "a.jsonl")],
            ["resume", "--dataset", spec, *plat, "--checkpoint-dir",
             str(d / "ck"), "--out", str(d / "r.npz")],
            ["simjoin", *base, *plat, "--tau", "0.05", "--out",
             str(d / "s.jsonl")],
        ]
        outs = []
        for argv in argvs:
            capsys.readouterr()
            rc = jmain(argv) if side == "j" else tmain(["batch", *argv])
            assert rc == 0, (side, argv)
            line = json.loads(capsys.readouterr().out.splitlines()[-1])
            line.pop("backend")
            line.pop("rows_per_s", None)
            outs.append(line)
        runs.append((d, outs))
    (jd, jout), (td, tout) = runs
    assert tout == jout
    for name in ("a.npz", "a.jsonl", "r.npz", "s.jsonl"):
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name
    assert (td / "r.npz").read_bytes() == (td / "a.npz").read_bytes()
