"""The port's analyzer, interprocedural lock order and blocking under a
lock (LD101–LD103), and the call graph they run on.

On every LD1 corpus of ``tests/fixtures/analysis/`` the port's analyzer
gives the JAX analyzer's findings (tests/torch_analysis_util.py)."""

from __future__ import annotations

import pytest

from torch_analysis_util import assert_parity, corpora


@pytest.mark.parametrize("case", corpora("ld1"), ids=lambda p: p.name)
def test_corpus_gives_the_jax_findings(case, tmp_path):
    assert_parity(case, tmp_path)


def test_callgraph_over_the_port_is_deterministic():
    """Resolved edges, reachability chains and SCCs are identical across
    two builds over the port's package (witness chains land in finding
    messages, so they must be byte-stable), absolute imports of the port
    resolve, and the service's warm path reaches the native build — the
    port baseline's LD102 reason, checked by machine."""
    from distributed_pathsim_tpu_torch.analysis import load_modules
    from distributed_pathsim_tpu_torch.analysis.callgraph import (
        CallGraph,
        propagate_reachability,
        strongly_connected,
    )
    from distributed_pathsim_tpu_torch.analysis.core import (
        Module,
        default_roots,
    )

    roots = default_roots()
    modules = load_modules({"package": roots["package"]})
    g1, g2 = CallGraph(modules), CallGraph(modules)
    assert sorted(g1.by_fid) == sorted(g2.by_fid)
    seeds = {fid: "seed" for fid in sorted(g1.by_fid)
             if fid.endswith("native/build.py:shared_lib")}
    assert seeds, "native.build.shared_lib should be indexed"
    r1 = propagate_reachability(g1, seeds)
    assert r1 == propagate_reachability(g2, seeds)
    assert any("serving/service.py" in fid for fid in r1)
    # `from distributed_pathsim_tpu_torch.x import y` resolves into the
    # package (the port's tests import it absolutely)
    import ast

    src = ("from distributed_pathsim_tpu_torch.native.build import "
           "shared_lib\n\n\ndef go():\n    return shared_lib('x')\n")
    probe = Module(path=roots["package"] / "probe.py", rel="probe.py",
                   repo_rel="probe.py", root_kind="package", text=src,
                   tree=ast.parse(src))
    g3 = CallGraph(modules + [probe])
    edges = [s.callee for s in g3.call_sites()
             if s.caller == "probe.py:go"]
    assert edges == [next(iter(seeds))]
    assert strongly_connected(
        {"a": {"b"}, "b": {"a"}, "c": {"c"}, "d": {"a"}}
    ) == [["a", "b"], ["c"]]
