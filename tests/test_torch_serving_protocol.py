"""Port parity: the JSONL protocol. One script through both packages'
``serve_loop`` (same graph, CPU): every response equal apart from timing
fields and the backend's name, and each validated against the checked-in
wire contract ``artifacts/wire_schema.json`` — per-request metapaths,
the ``compact`` op and ``batch_blocks`` included. The learned lane's
requests on a replica without towers answer as the JAX service's do
(exactly, through the counted fallback). Then the ``dpathsim-torch
serve`` subprocess on the CPU, and its refusals: no card without
``--platform cpu``, and the flags of training towers in the service by
name."""

import io
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.ops import metapath as jmeta
from distributed_pathsim_tpu.serving import PathSimService as JService
from distributed_pathsim_tpu.serving import ServeConfig as JConfig
from distributed_pathsim_tpu.serving.protocol import serve_loop as jloop
from distributed_pathsim_tpu.tuning import dispatch as jtuning
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.cli import main as torch_main
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from distributed_pathsim_tpu_torch.serving.protocol import serve_loop
from torch_port_util import delta_graphs, write_cli_gexf

REPO = pathlib.Path(__file__).resolve().parents[1]
SCHEMA = json.loads((REPO / "artifacts" / "wire_schema.json").read_text())
# the response envelope of handle_request / serve_loop
ENVELOPE = {"id", "ok", "result", "latency_ms", "error", "request_id",
            "deadline_exceeded"}
LOOP_OPS = ("shutdown", "drain")


def _script(hin):
    blk = hin.blocks["author_of"]
    ids = hin.indices["author"].ids
    return [
        {"id": 1, "op": "ping"},
        {"id": 2, "op": "topk", "row": 5, "k": 4},
        {"id": 3, "op": "topk", "source_id": ids[9]},
        {"id": 4, "op": "topk", "source": hin.indices["author"].labels[12],
         "k": 3, "request_id": "r-4", "deadline_ms": 60000.0},
        {"id": 5, "op": "topk", "row": 5, "k": 4},
        {"id": 6, "op": "scores", "row": 7},
        {"id": 7, "op": "topk", "row": 5, "k": 2, "mode": "exact",
         "metapath": "APVPA"},
        {"id": 8, "op": "update",
         "add_nodes": [{"type": "author", "id": "a_new", "label": "A. New"}],
         "add_edges": [{"rel": "author_of", "src": "a_new",
                        "dst": hin.indices["paper"].ids[3]},
                       {"rel": "author_of", "src_row": 2, "dst_row": 149}],
         "remove_edges": [{"rel": "author_of", "src_row": int(blk.rows[0]),
                           "dst_row": int(blk.cols[0])}],
         "want_rows": True},
        {"id": 9, "op": "topk", "source_id": "a_new", "k": 5},
        {"id": 10, "op": "topk", "row": 5, "k": 4},
        {"id": 22, "op": "topk", "row": 5, "k": 4, "metapath": "APA"},
        {"id": 23, "op": "scores", "row": 1, "metapath": "APA"},
        {"id": 24, "op": "topk", "row": 1, "metapath": "APTPA"},
        {"id": 25, "op": "scores", "row": 1, "metapath": "APV"},
        {"id": 26, "op": "compact"},
        {"id": 27, "op": "topk", "row": 5, "k": 4},
        {"id": 28, "op": "topk", "row": 5, "k": 4, "metapath": "APA"},
        {"id": 29, "op": "batch_blocks", "lo": 0, "hi": 4, "k": 3},
        {"id": 30, "op": "batch_blocks", "lo": 2, "hi": 9, "mode": "simjoin",
         "tau": 0.05},
        {"id": 11, "op": "health"},
        {"id": 12, "op": "stats"},
        {"id": 13, "op": "metrics"},
        {"id": 14, "op": "invalidate"},
        {"id": 15, "op": "topk", "row": 5, "k": 4},
        {"id": 16, "op": "topk"},
        {"id": 17, "op": "topk", "row": 10_000},
        {"id": 18, "op": "topk", "row": 1, "deadline_ms": 0},
        {"id": 19, "op": "no_such_op"},
        {"id": 20, "op": "trace", "limit": 10},
        {"id": 21, "op": "shutdown"},
    ]


# the learned lane's requests, sent to a replica without towers
LEARNED_NO_TOWERS = [
    {"id": 102, "op": "topk", "row": 1, "mode": "learned"},
    {"id": 106, "op": "refresh_towers"},
]


def _run(loop, svc, reqs):
    lines = [json.dumps(r) for r in reqs]
    lines.insert(1, "{not json")
    out = io.StringIO()
    assert loop(svc, io.StringIO("\n".join(lines) + "\n"), out) == 0
    return [json.loads(line) for line in out.getvalue().splitlines()]


def _validate(req, resp):
    """The response (and its request) against the wire contract."""
    assert set(resp) <= ENVELOPE, resp
    op = req.get("op", "topk")
    if op in LOOP_OPS:
        return
    if op not in SCHEMA["ops"]:  # an op outside the contract: an error
        assert not resp["ok"] and "unknown op" in resp["error"]
        return
    schema = SCHEMA["ops"][op]
    fields = set(req) - set(SCHEMA["envelope"])
    assert fields <= set(schema["request"]), (op, fields)
    if resp["ok"] and schema["response_complete"]:
        assert set(resp["result"]) <= set(schema["response"]), op
    if "request_id" in req:
        assert resp["request_id"] == req["request_id"]


def _comparable(op, result):
    """What must match between the packages for one op's result."""
    if op == "update":
        return {k: v for k, v in result.items() if k != "ms"}
    if op == "compact":
        # XLA compiles for a new padded shape; the port has no jit
        return {k: v for k, v in result.items()
                if k not in ("build_ms", "pause_ms", "total_ms",
                             "compiles")}
    if op == "health":
        return {k: result[k] for k in ("ok", "n", "queue_depth", "inflight",
                                       "shed", "base_fp", "delta_seq",
                                       "fingerprint", "compaction")} | {
            "exact": result["modes"]["exact"]}
    if op == "stats":
        comp = result["compaction"]
        return {k: result[k] for k in ("n", "metapath", "variant",
                                       "fingerprint", "topk_mode",
                                       "result_cache", "tile_cache")} | {
            "delta": {k: result["delta"][k] for k in (
                "seq", "base_fingerprint", "headroom", "deltas",
                "rebuilds", "purged_rows")},
            "plan": {"memo": result["plan"]["memo"], "engines": {
                name: {k: v for k, v in eng.items() if k != "backend"}
                for name, eng in result["plan"]["engines"].items()}},
            "compaction": {k: v for k, v in comp.items() if k != "last"},
            "buckets": result["obs"]["tuning"]["buckets"]}
    if op == "metrics":
        return result["caches"]
    if op == "trace":
        return sorted(result)
    return result


def test_protocol_script_matches_jax_and_wire_schema():
    jhin, thin = delta_graphs(headroom=0.25)
    prev = jtuning._state.enabled
    jtuning.set_enabled(False)
    cfg = dict(max_batch=4, max_wait_ms=1.0, warm=False)
    js = JService(jcreate("jax", jhin, jmeta.compile_metapath(
        "APVPA", jhin.schema)), config=JConfig(compact_auto=False, **cfg))
    ts = PathSimService(create_backend("torch", thin, compile_metapath(
        "APVPA", thin.schema), device="cpu"),
        config=ServeConfig(compact_auto=False, **cfg))
    try:
        reqs = _script(thin)
        jr, tr = _run(jloop, js, reqs), _run(serve_loop, ts, reqs)
        assert len(jr) == len(tr) == len(reqs) + 1
        assert tr[1] == jr[1] and not tr[1]["ok"]  # the bad JSON line
        del jr[1], tr[1]
        for req, a, b in zip(reqs, jr, tr):
            _validate(req, b)
            op = req.get("op", "topk")
            assert (b["id"], b["ok"]) == (a["id"], a["ok"]), req
            assert b.get("error") == a.get("error"), req
            assert b.get("deadline_exceeded") == a.get("deadline_exceeded")
            if b["ok"]:
                assert _comparable(op, b["result"]) == _comparable(
                    op, a["result"]), req
        by_id = {r["id"]: r for r in tr}
        assert by_id[8]["result"]["mode"] == "delta"
        assert by_id[9]["result"]["topk"]
        assert by_id[18]["deadline_exceeded"]
        assert by_id[22]["ok"] and by_id[22]["result"]["topk"]
        assert not by_id[24]["ok"] and not by_id[25]["ok"]
        assert by_id[26]["result"]["swapped"]
        # the swap kept the answers: the same topk after it is a hit
        assert by_id[27]["result"] == by_id[10]["result"]
        assert by_id[28]["result"] == by_id[22]["result"]
        # the learned lane on a replica without towers: a learned topk
        # answers exactly (counted no_towers), refresh_towers reports no
        # towers — the JAX service's answers
        script = LEARNED_NO_TOWERS + [{"id": 199, "op": "ping"}]
        out, out_j = _run(serve_loop, ts, script), _run(jloop, js, script)
        del out[1], out_j[1]
        for req, resp, want in zip(LEARNED_NO_TOWERS, out, out_j):
            _validate(req, resp)
            assert resp["ok"] and want["ok"], resp
            assert resp["result"] == want["result"], req
        assert out[0]["result"]["topk"]
        assert out[1]["result"] == {"learned": False, "refreshed": 0}
        assert out[-1]["ok"]  # the process keeps serving
        # the partition-exchange ops belong to partition workers: a
        # replica refuses them per request, as the JAX service does
        part = [{"id": 109, "op": "partial_topk"}]
        out_t = _run(serve_loop, ts, part)
        out_j = _run(jloop, js, part)
        assert not out_t[0]["ok"] and not out_j[0]["ok"]
        assert "requires a partition worker" in out_t[0]["error"]
        assert "requires a partition worker" in out_j[0]["error"]
    finally:
        js.close()
        ts.close()
        jtuning.set_enabled(prev)


def test_serve_subprocess_on_the_cpu(tmp_path):
    gexf = write_cli_gexf(tmp_path / "g.gexf")
    script = [
        {"id": 1, "op": "topk", "source_id": "author_3", "k": 5},
        {"id": 2, "op": "topk", "source_id": "author_3", "k": 5},
        {"id": 3, "op": "update",
         "add_edges": [{"rel": "author_of", "src": "author_3",
                        "dst": "paper_511"}]},
        {"id": 4, "op": "metrics"},
        {"id": 5, "op": "health"},
        {"id": 6, "op": "shutdown"},
    ]
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", "serve",
         "--dataset", gexf, "--platform", "cpu", "--backend", "torch",
         "--max-batch", "4", "--metrics", str(tmp_path / "events.jsonl")],
        input="\n".join(json.dumps(r) for r in script) + "\n",
        capture_output=True, text=True, timeout=240, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    resps = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["id"] for r in resps] == [1, 2, 3, 4, 5, 6]
    assert all(r["ok"] for r in resps), resps
    assert resps[0]["result"] == resps[1]["result"]
    assert resps[2]["result"]["mode"] == "delta"
    assert resps[3]["result"]["caches"]["result"]["hits"] >= 1
    assert resps[4]["result"]["delta_seq"] == 1
    events = [json.loads(line)["event"] for line in
              (tmp_path / "events.jsonl").read_text().splitlines()]
    assert "serve_ready" in events and "serve_update" in events


def test_serve_refuses_without_a_card_and_unported_flags(
        tmp_path, monkeypatch, capsys):
    gexf = write_cli_gexf(tmp_path / "g.gexf")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capsys.readouterr()
    assert torch_main(["serve", "--dataset", gexf]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device is available" in err and "--platform cpu" in err
    # training towers in the service is ported: its flags parse into the
    # config, and learned mode without a usable checkpoint distills towers
    # at startup (the JAX service's behaviour) and answers learned topk
    from distributed_pathsim_tpu_torch.serving.cli import (
        parse_serve_args,
        serve_config,
    )

    for flag, want in ((["--learned-steps=5"], ("learned_steps", 5)),
                       (["--learned-dim", "16"], ("learned_dim", 16)),
                       (["--learned-neg-ratio", "0.5"],
                        ("learned_neg_ratio", 0.5))):
        cfg = serve_config(parse_serve_args(["--dataset", gexf, *flag]))
        assert getattr(cfg, want[0]) == want[1], flag
    for flag in (["--topk-mode", "learned"],
                 ["--topk-mode", "learned", "--learned-checkpoint",
                  str(tmp_path / "missing.npz")]):
        script = [{"id": 1, "op": "topk", "source_id": "author_3", "k": 5,
                   "mode": "learned"},
                  {"id": 2, "op": "topk", "source_id": "author_3", "k": 5,
                   "mode": "exact"},
                  {"id": 3, "op": "stats"}, {"id": 4, "op": "shutdown"}]
        monkeypatch.setattr(sys, "stdin", io.StringIO(
            "\n".join(json.dumps(r) for r in script) + "\n"))
        assert torch_main(["serve", "--dataset", gexf, "--platform", "cpu",
                           "--learned-steps", "5", "--learned-cand-mult",
                           "256", *flag]) == 0, flag
        resps = [json.loads(line) for line in
                 capsys.readouterr().out.splitlines()]
        assert [r["id"] for r in resps] == [1, 2, 3, 4], flag
        assert resps[0]["result"]["topk"] == resps[1]["result"]["topk"]
        assert resps[2]["result"]["learned"]["enabled"], flag
    # the learned lane's serving flags are ported
    cfg = serve_config(parse_serve_args([
        "--dataset", gexf, "--topk-mode", "learned", "--learned-checkpoint",
        "t.npz", "--learned-cand-mult", "8", "--learned-shadow-every", "0",
        "--learned-recall-floor", "0.9", "--no-learned-refresh"]))
    assert (cfg.topk_mode, cfg.learned_checkpoint, cfg.learned_cand_mult,
            cfg.learned_shadow_every, cfg.learned_recall_floor,
            cfg.learned_auto_refresh) == ("learned", "t.npz", 8, 0, 0.9,
                                          False)
    # the packed layouts are served by torch-sparse only
    assert torch_main(["serve", "--dataset", gexf, "--platform", "cpu",
                       "--factor-format", "blocked"]) == 1
    assert "requires --backend torch-sparse" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        torch_main(["serve", "--dataset", gexf, "--bogus-flag"])
