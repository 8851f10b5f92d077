"""Port hygiene: the PyTorch port imports neither JAX (nor flax, optax
or msgpack) nor the JAX package, and it never carries on quietly on the
host — without a CUDA device its entry points raise unless the CPU is
asked for. The compaction hot-swap is reached only through the
service's doorway, the packed layout only through its sanctioned
factory, the batch sweeps only through the campaign runners, a
partition's factor slice only through the partition exchange, and the
learned tier's raw tower similarities never outside learned/."""

import json
import pkgutil
import subprocess
import sys

import pytest
import torch

import distributed_pathsim_tpu_torch as port
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.cli import main as torch_main
from distributed_pathsim_tpu_torch.data.synthetic import (
    synthetic_hin,
    write_gexf,
)
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.utils.device import (
    DeviceUnavailable,
    resolve_device,
)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")
    )


def test_port_never_names_or_spawns_the_jax_package():
    """No port module and no line of chip_smoke.py names a module of the
    JAX package (``distributed_pathsim_tpu.cli`` above all) or spawns one
    with ``-m``: a port fleet whose router started JAX workers would pass
    every parity test for the wrong reason."""
    import pathlib
    import re

    from distributed_pathsim_tpu_torch.router.cli import (
        _worker_argv,
        parse_router_args,
    )

    root = pathlib.Path(port.__file__).parent
    named = re.compile(r"\bdistributed_pathsim_tpu\.\w")
    spawned = re.compile(
        r"""["']-m["']\s*,\s*["']distributed_pathsim_tpu["'.]""")
    sources = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    assert len(sources) > 50
    for path in sources:
        text = path.read_text()
        assert not named.search(text), path
        assert not spawned.search(text), path
    args = parse_router_args(["--dataset", "g.gexf"])
    argv = _worker_argv(args, 3)
    assert argv[1:6] == ["-m", "distributed_pathsim_tpu_torch.cli",
                         "worker", "--worker-id", "w3"]
    assert argv[argv.index("--platform") + 1] == "cuda"


def test_compaction_swap_only_through_the_service_doorway():
    """The swap internals named in ``COMPACTION_SURFACE`` keep the token,
    the fingerprint and both cache tiers only inside
    ``PathSimService._apply_compaction`` under the swap lock: no port
    module but ``serving/service.py`` and its one sanctioned caller,
    ``serving/compact.py``, names them."""
    import ast
    import pathlib

    from distributed_pathsim_tpu_torch.serving.service import (
        COMPACTION_SURFACE,
    )

    root = pathlib.Path(port.__file__).parent
    allowed = {root / "serving" / "service.py",
               root / "serving" / "compact.py"}
    reached = {}
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Attribute)
                    and node.attr in COMPACTION_SURFACE):
                reached.setdefault(path, []).append(node.lineno)
    assert set(reached) <= allowed, reached
    assert root / "serving" / "compact.py" in reached


def test_packed_layout_and_batch_sweeps_stay_behind_their_doorways():
    """The packed layout's private coordinate system (``PACKED_SURFACE``
    attributes, the chunk codec) is named only in ``ops/packed.py``, and
    every other module calls only the ``SANCTIONED_FACTORY`` functions of
    it — a module reading ``.chunks`` would take permuted-space ids for
    graph columns. The block-sweep primitives of ``BATCH_SURFACE`` are
    named only by the campaign runners (batch/campaign.py,
    batch/simjoin.py): anywhere else their results would belong to no
    manifest. A partition's ``FACTOR_SURFACE`` is named only by
    backends/partition_factors.py and serving/partition.py. (The JAX
    package's analyzer checks these as CF001, BT001 and PT001.)"""
    import ast
    import pathlib

    from distributed_pathsim_tpu_torch.batch.campaign import BATCH_SURFACE
    from distributed_pathsim_tpu_torch.ops.packed import (
        PACKED_SURFACE,
        SANCTIONED_FACTORY,
    )

    root = pathlib.Path(port.__file__).parent
    packed_py = root / "ops" / "packed.py"
    runners = {root / "batch" / "campaign.py", root / "batch" / "simjoin.py"}
    private = {"_Chunk", "_pack_chunk", "_decode_chunk", "PackedFactor",
               "_pack_bit_blocks", "_unpack_bit_blocks"}
    public = SANCTIONED_FACTORY | {"FACTOR_FORMATS", "PACKED_SURFACE"}
    packed_users, batch_users = set(), set()
    for path in sorted(root.rglob("*.py")):
        aliases = set()
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and (
                    node.module is None or node.module.endswith("ops")):
                aliases |= {a.asname or a.name for a in node.names
                            if a.name == "packed"}
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.endswith("packed"):
                bad = {a.name for a in node.names} - public
                assert path == packed_py or not bad, (path, bad)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute):
                continue
            if node.attr in BATCH_SURFACE:
                batch_users.add(path)
            if path == packed_py:
                continue
            assert node.attr not in PACKED_SURFACE | private, (
                path, node.lineno, node.attr)
            if isinstance(node.value, ast.Name) and node.value.id in aliases:
                packed_users.add(path)
                assert node.attr in public, (path, node.lineno, node.attr)
    assert {root / "backends" / "torch_sparse.py", root / "ops" / "sparse.py",
            root / "batch" / "campaign.py"} <= packed_users
    assert batch_users <= runners and root / "batch" / "simjoin.py" in \
        batch_users, batch_users
    # a partition worker's raw held-row state (FACTOR_SURFACE, the JAX
    # analyzer's PT001) is named only by the slice's module and the
    # partition exchange layer
    from distributed_pathsim_tpu_torch.backends.partition_factors import (
        FACTOR_SURFACE,
    )

    slice_users = {path for path in sorted(root.rglob("*.py"))
                   for node in ast.walk(ast.parse(path.read_text()))
                   if isinstance(node, ast.Attribute)
                   and node.attr in FACTOR_SURFACE}
    assert slice_users == {root / "backends" / "partition_factors.py",
                           root / "serving" / "partition.py"}, slice_users
    # the learned tier's raw tower similarities (LEARNED_SURFACE, the JAX
    # analyzer's LN001) are named only inside learned/: everyone else
    # gets exact-reranked answers through answer_from_handle
    from distributed_pathsim_tpu_torch.learned import LEARNED_SURFACE

    raw_users = {path for path in sorted(root.rglob("*.py"))
                 + [root.parent / "chip_smoke.py"]
                 for node in ast.walk(ast.parse(path.read_text()))
                 if isinstance(node, ast.Attribute)
                 and node.attr in LEARNED_SURFACE}
    assert raw_users and all(root / "learned" in path.parents
                             for path in raw_users), raw_users


def test_port_imports_no_jax_and_no_jax_package():
    names = _port_modules()
    for mod in ("ops.cuda_kernels", "native.build", "native.gexf_native",
                "native.coo_native", "tuning.dispatch", "tuning.registry",
                "tuning.table", "models.multipath", "bench",
                "resilience.degrade", "ops.packed", "data.compress",
                "batch.campaign", "batch.simjoin", "batch.pairs", "batch.cli",
                "router.batch", "index.mips", "index.build", "index.cli",
                "serving.ann", "models.neural", "parallel.mesh",
                "parallel.ring", "parallel.sharded", "parallel.tiling",
                "parallel.multihost", "backends.torch_sharded",
                "backends.partition_factors", "serving.partition",
                "router.partition", "learned.encoder", "learned.checkpoint",
                "learned.serving", "learned.cli", "learned.trainer",
                "models.flax_msgpack", "neural_cli", "graft_entry",
                "neural_bench", "chaos_suite"):
        assert f"distributed_pathsim_tpu_torch.{mod}" in names, mod
    code = (
        "import importlib, json, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'flax', 'optax', 'msgpack') or m.startswith(('jax.', 'jaxlib.', "
        "'flax.', 'optax.', 'msgpack.')) or m == 'distributed_pathsim_tpu' "
        "or m.startswith('distributed_pathsim_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, timeout=120,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def gexf(tmp_path_factory):
    path = tmp_path_factory.mktemp("hygiene") / "g.gexf"
    write_gexf(synthetic_hin(40, 60, 4, seed=2, materialize_ids=True),
               str(path))
    return str(path)


def test_device_defaults_to_cuda_and_refuses_without_it(no_cuda):
    with pytest.raises(DeviceUnavailable, match="--platform cpu"):
        resolve_device(None)
    with pytest.raises(DeviceUnavailable):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_backend_refuses_without_cuda_unless_cpu(no_cuda):
    hin = synthetic_hin(30, 45, 3, seed=1)
    mp = compile_metapath("APVPA", hin.schema)
    with pytest.raises(DeviceUnavailable):
        create_backend("torch", hin, mp)
    b = create_backend("torch", hin, mp, device="cpu")
    assert b.device == torch.device("cpu")
    assert b.topk(k=3)[0].shape == (30, 3)
    # the sharded backend and a partition worker refuse the same way
    from distributed_pathsim_tpu_torch.serving.partition import (
        PartitionConfig,
        PartitionService,
    )

    with pytest.raises(DeviceUnavailable):
        create_backend("torch-sharded", hin, mp, n_devices=2)
    with pytest.raises(DeviceUnavailable):
        PartitionService(hin, mp, 0, 2)
    sb = create_backend("torch-sharded", hin, mp, n_devices=2, device="cpu")
    assert sb.mesh.devices == (torch.device("cpu"),) * 2
    assert PartitionService(hin, mp, 0, 2, config=PartitionConfig(
        device="cpu")).backend.name == "partition[cpu]"


def test_cli_refuses_without_cuda_unless_cpu(no_cuda, gexf, capsys):
    assert torch_main(["--dataset", gexf, "--top-k", "3", "--quiet"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert torch_main(["--dataset", gexf, "--top-k", "3", "--quiet",
                       "--platform", "cpu"]) == 0
    sharded = ["--dataset", gexf, "--top-k", "3", "--quiet", "--backend",
               "torch-sharded", "--n-devices", "2"]
    assert torch_main(sharded) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert torch_main(sharded + ["--platform", "cpu"]) == 0


def test_kernel_builds_key_on_every_header(tmp_path, monkeypatch):
    """Every header a kernel source includes exists in csrc/, and a
    kernel library's path changes when a header is edited, added or
    removed: a stale build is never loaded."""
    import re
    import shutil

    from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck

    for src in ck.CSRC.iterdir():
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (ck.CSRC / inc).exists(), (src.name, inc)
    csrc = tmp_path / "csrc"
    shutil.copytree(ck.CSRC, csrc)
    monkeypatch.setattr(ck, "CSRC", csrc)
    before = {name: ck._lib_path(name) for name in ck.KERNELS}
    (csrc / "extra.cuh").write_text("#pragma once\n")
    added = {name: ck._lib_path(name) for name in ck.KERNELS}
    (csrc / "extra.cuh").unlink()
    assert {name: ck._lib_path(name) for name in ck.KERNELS} == before
    header = csrc / "u8_tile.cuh"
    header.write_text(header.read_text() + "\n")
    edited = {name: ck._lib_path(name) for name in ck.KERNELS}
    (csrc / "topk_list.cuh").unlink()
    gone = {name: ck._lib_path(name) for name in ck.KERNELS}
    for name in ck.KERNELS:
        paths = {before[name], added[name], edited[name], gone[name]}
        assert len(paths) == 4, name


def test_native_copies_build_only_into_the_build_dir():
    """The C++ copies of native/ compile only into the package's
    ``_build/`` (gitignored): the build never writes beside the source,
    as the JAX package's does, and the library name carries the
    source's digest."""
    import pathlib

    from distributed_pathsim_tpu_torch.native import build, coo_native
    from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck

    root = pathlib.Path(port.__file__).parent
    assert build.BUILD_DIR == ck.BUILD_DIR == root / "_build"
    sources = sorted(p.name for p in (root / "native").glob("*.cpp"))
    assert sources == ["coo_fast.cpp", "gexf_fast.cpp"]
    for src in sources:
        name = src[:-4]
        assert build.lib_path(name).parent == build.BUILD_DIR
        assert build.lib_path(name).name.startswith(f"lib{name}-")
    assert coo_native.available()
    built = [p for p in root.rglob("*.so")
             if build.BUILD_DIR not in p.parents]
    assert built == []
    gitignore = (root.parent / ".gitignore").read_text().splitlines()
    assert "distributed_pathsim_tpu_torch/_build/" in gitignore


def test_bench_needs_a_card(no_cuda, capsys):
    """``python -m distributed_pathsim_tpu_torch.bench`` measures the card
    only: without one it exits 2 and prints no result. Its measurement
    path runs on the CPU at a small size (the row check included) and
    names the device it ran on."""
    from distributed_pathsim_tpu_torch import bench

    assert bench.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    record = bench.run_bench(600, "cpu", reps=2, n_papers=900, n_venues=24)
    assert record["device"] == "cpu" and record["reps"] == 2
    assert record["seconds_min"] <= record["seconds_median"] <= \
        record["seconds_max"]
    assert record["value"] == 600 * 599 / record["seconds_median"]
