"""Port parity end to end, rank-all and all-pairs: the port's CLI with
``--platform cpu`` against the JAX package's CLI (``--backend jax
--platform cpu``) on the same synthetic GEXF — cmp-identical ranking
TSVs and equal all-pairs summaries; and the port's two backends agree
through the CLI."""

import pytest

from distributed_pathsim_tpu_torch.cli import main as torch_main
from torch_port_util import run_both_clis, write_cli_gexf


@pytest.fixture(scope="module")
def gexf(tmp_path_factory):
    return write_cli_gexf(tmp_path_factory.mktemp("cli") / "g.gexf")


@pytest.mark.parametrize(
    "extra",
    [["--top-k", "10"], ["--top-k", "16", "--variant", "diagonal"],
     ["--top-k", "1", "--metapath", "APTPA"]],
)
def test_ranking_tsv_identical(gexf, tmp_path, capsys, extra):
    j_tsv, t_tsv = tmp_path / "j.tsv", tmp_path / "t.tsv"
    (rc_j, _, _), (rc_t, _, _) = run_both_clis(
        gexf, [*extra, "--quiet"], capsys,
        out_j=["--ranking-out", str(j_tsv)],
        out_t=["--ranking-out", str(t_tsv)],
    )
    assert rc_j == rc_t == 0
    assert t_tsv.read_bytes() == j_tsv.read_bytes()


@pytest.mark.parametrize("extra", [[], ["--variant", "diagonal"],
                                   ["--metapath", "APA"]])
def test_all_pairs_summary_identical(gexf, capsys, extra):
    (rc_j, out_j, _), (rc_t, out_t, _) = run_both_clis(
        gexf, ["--all-pairs", *extra], capsys
    )
    assert rc_j == rc_t == 0

    def summary(out):
        return [ln for ln in out.splitlines() if ln.startswith("All-pairs")]

    assert summary(out_t) == summary(out_j)
    assert len(summary(out_t)) == 1


def test_numpy_backend_ranking_matches_torch(gexf, tmp_path, capsys):
    """The port's two backends agree through the CLI as well (the numpy
    oracle ranks from the f64 score matrix, the torch backend from the
    f32 two-pass top-k: the order and ids agree on this graph)."""
    outs = {}
    for backend in ("numpy", "torch"):
        path = tmp_path / f"{backend}.tsv"
        assert torch_main(["--dataset", gexf, "--platform", "cpu",
                           "--backend", backend, "--top-k", "5", "--quiet",
                           "--ranking-out", str(path)]) == 0
        outs[backend] = [ln.split("\t")[:3] for ln in
                         path.read_text().splitlines()]
    assert outs["numpy"] == outs["torch"]
