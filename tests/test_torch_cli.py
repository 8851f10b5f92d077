"""Port parity end to end: the port's CLI with ``--platform cpu``
against ``python -m distributed_pathsim_tpu.cli --backend jax
--platform cpu`` on the same synthetic GEXF — byte-identical run logs
apart from the ``***`` timing lines, the same top-k listing and equal
error messages. The ranking TSVs and all-pairs summaries are in
test_torch_cli_ranking.py."""

import pytest

from distributed_pathsim_tpu_torch.cli import main as torch_main
from torch_port_util import run_both_clis, write_cli_gexf


@pytest.fixture(scope="module")
def gexf(tmp_path_factory):
    return write_cli_gexf(tmp_path_factory.mktemp("cli") / "g.gexf")


def _grammar(path):
    with open(path, encoding="utf-8") as f:
        return [line for line in f if not line.startswith("***")]


@pytest.mark.parametrize(
    "source",
    [["--source", "author_3"], ["--source-id", "author_120"],
     ["--source", "author_7", "--variant", "diagonal"],
     ["--source", "author_9", "--metapath", "APA"]],
)
def test_single_source_log_identical(gexf, tmp_path, capsys, source):
    j_log, t_log = str(tmp_path / "j.log"), str(tmp_path / "t.log")
    (rc_j, _, _), (rc_t, _, _) = run_both_clis(
        gexf, [*source, "--quiet"], capsys,
        out_j=["--output", j_log], out_t=["--output", t_log],
    )
    assert rc_j == rc_t == 0
    want = _grammar(j_log)
    assert len(want) == 1 + 4 * 349
    assert _grammar(t_log) == want


def test_top_k_listing_identical(gexf, capsys):
    (rc_j, out_j, _), (rc_t, out_t, _) = run_both_clis(
        gexf, ["--source", "author_4", "--top-k", "8", "--quiet"], capsys
    )
    assert rc_j == rc_t == 0
    assert out_t == out_j
    assert "Top-8 similar to author_4:" in out_t


@pytest.mark.parametrize(
    "extra",
    [["--source", "nobody at all"], ["--source", "author_1",
                                     "--metapath", "APXPA"]],
)
def test_error_probes_identical(gexf, capsys, extra):
    (rc_j, _, err_j), (rc_t, _, err_t) = run_both_clis(gexf, extra, capsys)
    assert rc_j == rc_t == 1
    assert err_t.splitlines()[-1] == err_j.splitlines()[-1]
    assert err_t.splitlines()[-1].startswith("error: ")


def test_ranking_out_needs_all_sources_mode(gexf, tmp_path, capsys):
    assert torch_main(["--dataset", gexf, "--platform", "cpu",
                       "--ranking-out", str(tmp_path / "r.tsv")]) == 1
    assert "requires --top-k" in capsys.readouterr().err
    assert torch_main(["--dataset", gexf, "--platform", "cpu", "--top-k",
                       "3", "--source", "author_1", "--ranking-out",
                       str(tmp_path / "r.tsv")]) == 1
    assert "ALL sources" in capsys.readouterr().err
    # the packed layouts need the streaming backend
    assert torch_main(["--dataset", gexf, "--platform", "cpu", "--backend",
                       "torch", "--factor-format", "blocked",
                       "--top-k", "3"]) == 1
    assert "requires --backend torch-sparse" in capsys.readouterr().err
