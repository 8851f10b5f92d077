"""Port hygiene: the PyTorch port imports neither JAX nor the JAX
package, and it never carries on quietly on the host — without a CUDA
device its entry points raise unless the CPU is asked for."""

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


def test_port_imports_no_jax_and_no_jax_package():
    names = _port_modules()
    assert "distributed_pathsim_tpu_torch.ops.cuda_kernels" in names
    code = (
        "import importlib, json, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib') or "
        "m.startswith(('jax.', 'jaxlib.')) or m == 'distributed_pathsim_tpu' "
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


def test_cli_refuses_without_cuda_unless_cpu(no_cuda, gexf, capsys):
    assert torch_main(["--dataset", gexf, "--top-k", "3", "--quiet"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert torch_main(["--dataset", gexf, "--top-k", "3", "--quiet",
                       "--platform", "cpu"]) == 0


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
