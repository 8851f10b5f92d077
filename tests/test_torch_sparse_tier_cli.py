"""The streaming tier through the port's CLI (``--platform cpu``):
``--backend torch-sparse`` rankings byte-identical to ``--backend torch``
and to the JAX package's ``--backend jax-sparse``, checkpointed reruns,
``--top-k 20`` (the single-pass K4 arm) against the JAX package's CLI,
and the flag-validation messages with the port's backend names."""

import filecmp

import pytest

from distributed_pathsim_tpu.cli import main as jax_main
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.cli import main as torch_main
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from torch_port_util import write_cli_gexf


@pytest.fixture(scope="module")
def gexf(tmp_path_factory):
    return write_cli_gexf(tmp_path_factory.mktemp("sparse_cli") / "g.gexf")


def _rank(main, gexf, out, *extra, jax=False):
    argv = ["--dataset", gexf, "--platform", "cpu", "--quiet",
            "--ranking-out", str(out), *extra]
    if jax:
        argv += ["--loader", "python"]
    assert main(argv) == 0
    return out


def test_sparse_ranking_identical_to_torch_and_jax_sparse(gexf, tmp_path):
    dense = _rank(torch_main, gexf, tmp_path / "t.tsv", "--backend", "torch",
                  "--top-k", "10")
    sparse = _rank(torch_main, gexf, tmp_path / "s.tsv", "--backend",
                   "torch-sparse", "--tile-rows", "128", "--top-k", "10")
    jsparse = _rank(jax_main, gexf, tmp_path / "j.tsv", "--backend",
                    "jax-sparse", "--tile-rows", "128", "--top-k", "10",
                    jax=True)
    assert filecmp.cmp(sparse, dense, shallow=False)
    assert filecmp.cmp(sparse, jsparse, shallow=False)


def test_checkpointed_rerun_identical(gexf, tmp_path):
    ck_dir = str(tmp_path / "ck")
    args = ("--backend", "torch-sparse", "--tile-rows", "100", "--top-k",
            "6", "--checkpoint-dir", ck_dir)
    first = _rank(torch_main, gexf, tmp_path / "a.tsv", *args)
    again = _rank(torch_main, gexf, tmp_path / "b.tsv", *args)
    assert filecmp.cmp(first, again, shallow=False)
    assert len(list((tmp_path / "ck").glob("topk6_rowtile_*.vals.npy"))) == 4


def test_top_k_20_identical_to_jax(gexf, tmp_path):
    """k > 16 takes K4 in the port and fused_topk's arm in the JAX
    package: the same rankings."""
    port = _rank(torch_main, gexf, tmp_path / "t.tsv", "--backend", "torch",
                 "--top-k", "20")
    ref = _rank(jax_main, gexf, tmp_path / "j.tsv", "--backend", "jax",
                "--top-k", "20", jax=True)
    assert filecmp.cmp(port, ref, shallow=False)


@pytest.mark.parametrize(
    "extra,message",
    [(["--backend", "torch", "--tile-rows", "64", "--top-k", "3"],
      "--tile-rows tunes the streaming tiled path and requires --backend "
      "torch-sparse"),
     (["--backend", "numpy", "--approx", "--top-k", "3"],
      "--approx waives the f32 exact-count guard of the device backends "
      "(torch, torch-sparse); the numpy oracle is f64-exact"),
     (["--backend", "torch-sparse", "--checkpoint-dir", "CK", "--top-k",
       "3", "--source", "author_1"],
      "--ranking-out/--checkpoint-dir rank ALL sources and cannot be "
      "combined with --source/--source-id"),
     (["--backend", "torch-sparse", "--checkpoint-dir", "CK"],
      "--ranking-out/--checkpoint-dir requires --top-k (the all-sources "
      "ranking mode)"),
     (["--backend", "torch", "--checkpoint-dir", "CK", "--top-k", "3"],
      "checkpointed ranking requires a streaming backend (torch-sparse)")],
)
def test_flag_validation_messages(gexf, tmp_path, capsys, extra, message):
    """The JAX CLI's checks and wording, with the port's backend names;
    the JAX CLI refuses the counterpart flags too."""
    extra = [str(tmp_path / "ck") if a == "CK" else a for a in extra]
    capsys.readouterr()
    assert torch_main(["--dataset", gexf, "--platform", "cpu", "--quiet",
                       *extra]) == 1
    assert capsys.readouterr().err.splitlines()[-1] == f"error: {message}"
    jextra = ["jax-sparse" if a == "torch-sparse" else
              "jax" if a == "torch" else a for a in extra]
    assert jax_main(["--dataset", gexf, "--platform", "cpu", "--quiet",
                     "--loader", "python", *jextra]) == 1


def test_packed_formats_build_and_bad_formats_or_chains_are_refused():
    """The packed layouts build (tests/test_torch_packed_sparse.py holds
    them against the JAX package); a format name neither package knows
    is refused, and so is an asymmetric metapath."""
    hin = synthetic_hin(40, 60, 4, seed=2)
    mp = compile_metapath("APVPA", hin.schema)
    b = create_backend("torch-sparse", hin, mp, device="cpu",
                       factor_format="bitpacked")
    assert b.factor_info()["format"] == "bitpacked"
    with pytest.raises(ValueError, match="unknown factor_format"):
        create_backend("torch-sparse", hin, mp, device="cpu",
                       factor_format="csr")
    with pytest.raises(ValueError, match="symmetric"):
        create_backend("torch-sparse", hin,
                       compile_metapath("APV", hin.schema), device="cpu")
