"""The port's serving load generator keeps the repository harness's
smoke checks, and on the card serves from the card.

- For each of the twelve regimes, the keys of the twin's check builder
  equal the keys of the repository harness's checks (``bench_serving.py``:
  the ``checks`` dict of a ``run_*_smoke``, the result's ``"checks"``
  entry of ``run_metapath_bench``, the ``checks[...]`` assignments of
  ``run_batch_bench``), both read by AST, so no smoke runs twice.
- At the default ``platform="cuda"`` every service and in-process fleet
  the twin builds (the load and update regimes', the fleet-obs fleet, the
  firehose's coalescing fleet and autoscale fleet, the batch fleet) is a
  ``torch`` backend on the card, and every worker it spawns is a
  ``distributed_pathsim_tpu_torch.cli worker`` with ``--backend torch
  --platform cuda``; numpy serves only as the oracle.
"""

import ast
import pathlib

import pytest

from distributed_pathsim_tpu_torch import bench_serving as bs
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.router.cli import _worker_argv

REPO = pathlib.Path(__file__).resolve().parents[1]
# regime -> (the repository harness's smoke, the twin's check builder)
REGIMES = {
    "load": ("run_smoke", "load_checks"),
    "update": ("run_update_smoke", "update_checks"),
    "obs": ("run_obs_smoke", "obs_checks"),
    "router": ("run_router_smoke", "router_checks"),
    "fleet-obs": ("run_fleet_obs_smoke", "fleet_obs_checks"),
    "partition": ("run_partition_smoke", "partition_checks"),
    "ann": ("run_ann_smoke", "ann_checks"),
    "learned": ("run_learned_smoke", "learned_checks"),
    "firehose": ("run_firehose_smoke", "firehose_checks"),
    "metapath": ("run_metapath_bench", "metapath_checks"),
    "compress": ("run_compress_smoke", "compress_checks"),
    "batch": ("run_batch_bench", "batch_checks"),
}


def _check_keys(path: pathlib.Path, fn_name: str) -> set:
    """The string keys of the checks built in ``fn_name``: the dict
    assigned to ``checks``, the dict under a ``"checks"`` key of a dict
    literal, or, in a check builder, the dict returned; else the keys of
    its ``checks[...] = ...`` assignments."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    subscripts = set()
    for node in ast.walk(fn):
        value = None
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "checks"
                for t in node.targets):
            value = node.value
        elif isinstance(node, ast.Return):
            value = node.value
        elif isinstance(node, ast.Dict):
            value = next((v for k, v in zip(node.keys, node.values)
                          if isinstance(k, ast.Constant)
                          and k.value == "checks"), None)
        if isinstance(node, ast.Assign):
            subscripts |= {
                t.slice.value for t in node.targets
                if isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Name) and t.value.id == "checks"
                and isinstance(t.slice, ast.Constant)}
        if isinstance(value, ast.Dict):
            return {k.value for k in value.keys}
    if subscripts:
        return subscripts
    raise AssertionError(f"no checks dict in {fn_name}")


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_smoke_check_keys_match_the_jax_harness(regime):
    jax_fn, twin_fn = REGIMES[regime]
    want = _check_keys(REPO / "bench_serving.py", jax_fn)
    got = _check_keys(pathlib.Path(bs.__file__), twin_fn)
    assert got == want
    assert set(bs.CLOCK_CHECKS.get(regime, ())) <= got
    assert set(bs.CARD_EXEMPT_CHECKS.get(regime, ())) <= got


def _flag(argv, name):
    return argv[argv.index(name) + 1]


def test_on_the_card_every_service_and_worker_serves_from_torch(
        monkeypatch, tmp_path):
    spec = "synthetic:authors=64,papers=96,venues=4,seed=0"
    argvs = [
        bs._router_worker_argv(spec, "torch", "w0", 8, 1.0, 5),
        bs._partition_worker_argv(spec, 0, 3, 2, 5),
        _worker_argv(bs._fleet_obs_router_args(str(tmp_path)), 0),
    ]
    for argv in argvs:
        assert argv[1:4] == ["-m", "distributed_pathsim_tpu_torch.cli",
                             "worker"], argv
        assert _flag(argv, "--backend") == "torch", argv
        assert _flag(argv, "--platform") == "cuda", argv

    built = []
    real = bs._create_backend

    def record(name, hin, mp, platform, **options):
        built.append((name, platform))
        return real(name, hin, mp, "cpu", **options)  # this box has no card

    monkeypatch.setattr(bs, "_create_backend", record)
    tiny = dict(n_authors=128, n_papers=200, n_venues=8)
    bs.run_bench(**tiny, clients=2, queries_per_client=4, max_batch=4)
    bs.run_update_bench(**tiny, reps=1)
    hin = synthetic_hin(64, 96, 4, seed=0)
    mp = compile_metapath("APVPA", hin.schema)
    router, transports = bs._inproc_fleet(hin, mp, 2)
    bs._close_inproc_fleet(router, transports)
    fleet = bs._firehose_fleet_phase(64, 96, 4, updates=4, k=3)
    assert fleet["oracle_checked"]["mismatches"] == 0
    auto = bs._firehose_autoscale_phase(64, 96, 4, k=3)
    assert auto["spawn_tick"] is not None  # the spawned worker: torch too
    services, sched = bs._batch_fleet(hin, mp, workers=2)
    sched.close()
    for svc in services:
        svc.close()
    served = [b for b in built if b[0] != "numpy"]
    assert served and set(served) == {("torch", "cuda")}, built
    # numpy only as the firehose fleet's oracle
    assert [b[0] for b in built if b[0] == "numpy"] == ["numpy"], built
