"""The port's neural bench (``distributed_pathsim_tpu_torch.neural_bench``)
against the repository's ``scripts/neural_bench.py`` on the CPU: the same
record keys in the same order, equal struct figures, ``struct_dim``,
``eval_sources`` and ``config`` but for ``platform``, at a tiny size (the
script in a subprocess, so that its compile-cache setting leaves this
process's JAX config alone); and the port's evaluation function, on
towers that carry the JAX model's parameters, equal to the script's loop
on the JAX model, arm for arm.

Run as a program, it prints the JAX package's struct figures at the
script's defaults (the figures ``chip_smoke.py`` holds the card's run
to)::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_neural_bench.py
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = ["--authors", "300", "--papers", "900", "--venues", "12",
        "--steps", "12", "--batch", "256", "--dim", "8", "--hidden", "16",
        "--eval-sources", "12", "--top-k", "5", "--platform", "cpu"]


def script_loop(model, sources, k, arms=("learned", "learned_rerank",
                                         "struct", "struct_rerank")):
    """scripts/neural_bench.py's evaluation loop on ``model``, its
    arithmetic as written there; the per-source recall lists by arm."""
    c64 = model._c64
    d = model._d
    out = {arm: [] for arm in arms}
    for s in sources:
        num = 2.0 * (c64 @ c64[int(s)])
        denom = d + d[int(s)]
        exact = np.where(denom > 0, num / np.where(denom > 0, denom, 1), 0.0)
        exact[int(s)] = -np.inf
        kth = np.sort(exact)[::-1][k - 1]
        got = {
            "learned": lambda: model.topk(int(s), k=k),
            "learned_rerank": lambda: model.topk_rerank(
                int(s), k=k, candidates=100, index="learned"),
            "struct": lambda: model.topk_struct(int(s), k=k),
            "struct_rerank": lambda: model.topk_rerank(
                int(s), k=k, candidates=100, index="struct"),
        }
        for arm in arms:
            hits = {t for t, _ in got[arm]()}
            out[arm].append(sum(exact[t] >= kth for t in hits) / k)
    return out


def _jax_record(tmp_path, argv) -> dict:
    out = tmp_path / "jax.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_ENABLE_COMPILATION_CACHE="false")
    proc = subprocess.run(
        [sys.executable, "scripts/neural_bench.py", *argv, "--out",
         str(out)],
        capture_output=True, text=True, timeout=600, cwd=str(REPO), env=env,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(out.read_text())


@pytest.mark.parametrize("mine", [[], ["--mine", "16", "--mine-k", "8"]])
def test_record_matches_the_jax_script(tmp_path, mine):
    from distributed_pathsim_tpu_torch import neural_bench

    want = _jax_record(tmp_path, TINY + mine)
    got = neural_bench.main(TINY + mine + ["--out", str(tmp_path / "t.json")])
    assert json.loads((tmp_path / "t.json").read_text()) == got
    assert list(got) == list(want)
    assert {k: v for k, v in got["config"].items() if k != "platform"} == {
        k: v for k, v in want["config"].items() if k != "platform"}
    assert got["config"]["platform"] == want["config"]["platform"] == "cpu"
    for key in ("struct_recall_at_k",
                "struct_rerank_recall_at_k_top100_prefilter", "struct_dim",
                "eval_sources", "mined_sources", "mine_k", "metric", "unit",
                "vs_baseline"):
        assert got[key] == want[key], key
    assert got["struct_dim"] == 12 * 12
    losses = (got["loss_first10_mean"], got["loss_last10_mean"])
    assert all(np.isfinite(losses))


def test_evaluate_equals_the_script_loop_on_shared_towers():
    import jax

    from distributed_pathsim_tpu.data.synthetic import synthetic_hin as jsyn
    from distributed_pathsim_tpu.models.neural import NeuralPathSim as JNeural
    from distributed_pathsim_tpu_torch.models.neural import (
        NeuralPathSim,
        params_from_flax,
    )
    from distributed_pathsim_tpu_torch.neural_bench import ARMS, evaluate
    from torch_port_util import port_hin

    jhin = jsyn(400, 1200, 16, seed=42)
    j = JNeural(jhin, "APVPA", dim=8, hidden=16)
    j.train(steps=30, batch_size=256, seed=0)
    t = NeuralPathSim(port_hin(jhin), "APVPA", dim=8, hidden=16,
                      device="cpu")
    params_from_flax(jax.tree_util.tree_map(np.asarray, j.state.params),
                     t.model)
    sources = np.random.default_rng(123).integers(0, 400, size=40)
    want = script_loop(j, sources, 10)
    got = evaluate(t, sources, 10)
    assert list(got) == list(ARMS) == list(want)
    for arm in ARMS:
        assert got[arm] == want[arm], arm
    # the towers learned something the arms tell apart
    assert 0 < np.mean(got["learned"]) < np.mean(got["learned_rerank"]) <= 1


def jax_struct_figures(argv=()) -> dict:
    """The JAX package's struct figures at the script's arguments (its
    defaults unless ``argv`` says otherwise): the model constructed, no
    training (the struct index does not depend on it), the script's
    loop over its evaluation draw."""
    import argparse

    from distributed_pathsim_tpu.data.synthetic import synthetic_hin as jsyn
    from distributed_pathsim_tpu.models.neural import NeuralPathSim as JNeural

    p = argparse.ArgumentParser()
    for flag, default in (("--authors", 65536), ("--papers", 327680),
                          ("--venues", 64), ("--dim", 64), ("--hidden", 128),
                          ("--eval-sources", 50), ("--top-k", 10)):
        p.add_argument(flag, type=int, default=default)
    args = p.parse_args(list(argv))
    model = JNeural(jsyn(args.authors, args.papers, args.venues, seed=42),
                    "APVPA", dim=args.dim, hidden=args.hidden)
    sources = np.random.default_rng(123).integers(
        0, args.authors, size=args.eval_sources)
    r = script_loop(model, sources, args.top_k,
                    arms=("struct", "struct_rerank"))
    return {"struct_recall_at_k": float(np.mean(r["struct"])),
            "struct_rerank_recall_at_k_top100_prefilter": float(
                np.mean(r["struct_rerank"])),
            "struct_dim": int(model.QUAD_M * model.v)}


if __name__ == "__main__":
    print(json.dumps(jax_struct_figures(sys.argv[1:])))
