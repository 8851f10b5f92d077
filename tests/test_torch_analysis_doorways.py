"""The port's analyzer, the batch, compressed-layout and compaction
doorways (BT001, CF001, CP001) and tuning constants (TN001).

On every BT, CF, CP and TN corpus of ``tests/fixtures/analysis/`` the
port's analyzer gives the JAX analyzer's findings
(tests/torch_analysis_util.py)."""

from __future__ import annotations

import pytest

from torch_analysis_util import assert_parity, corpora


@pytest.mark.parametrize("case", corpora("bt", "cf", "cp", "tn"),
                         ids=lambda p: p.name)
def test_corpus_gives_the_jax_findings(case, tmp_path):
    assert_parity(case, tmp_path)


def test_tn001_reads_the_port_registry_and_its_knob_defaults(monkeypatch):
    """TN001 reads the port's ``tuning/registry.py``: K3's unit target,
    which K1's untuned width follows too, stands as the registry's
    default (``KNOB_DEFAULTS``), naming a registered knob and a constant
    its file defines; kernel layout stands sanctioned. A default whose
    knob the registry stops registering is no longer let stand: a
    tile-like one is a stray constant again."""
    from distributed_pathsim_tpu_torch.analysis import load_modules
    from distributed_pathsim_tpu_torch.analysis.core import default_roots
    from distributed_pathsim_tpu_torch.analysis.tuning_constants import (
        _const_assignments,
        _sanctioned,
        scan_modules,
    )
    from distributed_pathsim_tpu_torch.tuning import registry

    assert registry.KNOB_DEFAULTS["ops/cuda_kernels.py"] == {
        "RECT_TARGET_UNITS": "rect_target_units",
    }
    pkg = default_roots()["package"]
    modules = load_modules({"package": pkg})
    by_rel = {m.rel: m for m in modules}
    for rel, names in [*registry.KNOB_DEFAULTS.items(),
                       *registry.SANCTIONED_CONSTANTS.items()]:
        defined = {name for name, _ in _const_assignments(by_rel[rel].tree)}
        assert set(names) <= defined, (rel, set(names) - defined)
    for knob in registry.KNOB_DEFAULTS["ops/cuda_kernels.py"].values():
        assert knob in registry.KNOBS
    assert "TILE" in registry.SANCTIONED_CONSTANTS["ops/cuda_kernels.py"]
    kernels = [by_rel["ops/cuda_kernels.py"], by_rel["backends/torch_dense.py"]]
    assert scan_modules(kernels) == []
    monkeypatch.setattr(registry, "KNOB_DEFAULTS", {
        "ops/cuda_kernels.py": {"RECT_TARGET_UNITS": "no_such_knob"},
    })
    assert "RECT_TARGET_UNITS" not in _sanctioned()["ops/cuda_kernels.py"]
    # end to end: a tile-like constant let stand only as a knob's default
    # is a finding once the registry drops that knob
    monkeypatch.setattr(registry, "SANCTIONED_CONSTANTS", {
        **registry.SANCTIONED_CONSTANTS,
        "ops/cuda_kernels.py":
            registry.SANCTIONED_CONSTANTS["ops/cuda_kernels.py"] - {"TILE"},
    })
    monkeypatch.setattr(registry, "KNOB_DEFAULTS", {
        "ops/cuda_kernels.py": {"RECT_TARGET_UNITS": "rect_target_units",
                                "TILE": "twopass_stripe_tiles"},
    })
    assert scan_modules(kernels) == []
    monkeypatch.setattr(registry, "KNOB_DEFAULTS", {
        "ops/cuda_kernels.py": {"RECT_TARGET_UNITS": "rect_target_units",
                                "TILE": "no_such_knob"},
    })
    assert [(f.rule, f.symbol) for f in scan_modules(kernels)] == [
        ("TN001", "TILE")]
