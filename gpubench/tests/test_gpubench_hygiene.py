"""No process of the benchmark holds JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference loads nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys

from gpubench.harness import BANNED, PORT
from gpubench.tests._tiny import REPO

RUN = """
import json, pathlib, sys, tempfile
sys.path.insert(0, {repo!r})
from gpubench import harness
from gpubench.tests._tiny import make_root
root = make_root(pathlib.Path(tempfile.mkdtemp()))
harness.run_cell(root, "tinydense.rank-all.k10", 7, 0.2, True, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import importlib.util, json, sys
import numpy as np
spec = importlib.util.spec_from_file_location(
    "ref", {path!r})
ref = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ref)
r = ref.PathSimF64(np.array([0, 1]), np.array([0, 0]), np.array([0]),
                   np.array([0]), 3, 1, 1)
r.topk(np.array([0, 1, 2]), 2)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _top_level(RUN.format(repo=str(REPO)))
    assert PORT in loaded  # the run did load the port
    assert not loaded & set(BANNED)


def test_the_reference_loads_nothing_of_the_port():
    path = str(REPO / "gpubench/reference/pathsim_f64.py")
    loaded = _top_level(REFERENCE.format(path=path))
    assert not loaded & {PORT, "torch", *BANNED}
