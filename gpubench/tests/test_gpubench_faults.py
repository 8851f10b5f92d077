"""The comparison fails a run whose timed path is broken underneath: the
top-k kernels' wrappers (K1, K4, K3) patched to give wrong answers, the
rest of the run as it is. One card holds the cell, so there is no
exchange between cards to leave out."""

from __future__ import annotations

import pytest
import torch

from gpubench import harness
from gpubench.tests._tiny import make_root

KERNELS = ("fused_topk_twopass", "fused_topk", "fused_topk_twopass_rect")


def _broken(fn, fault):
    def wrapped(*args, **kwargs):
        vals, idxs = fn(*args, **kwargs)
        if fault == "unchanged":  # the output as it was before the step
            return torch.full_like(vals, float("-inf")), torch.zeros_like(
                idxs)
        vals, idxs = vals.clone(), idxs.clone()
        if fault == "half_left_out":  # half of the rows never computed
            h = vals.shape[0] // 2
            vals[h:], idxs[h:] = float("-inf"), 0
        else:  # an answer altered where it is produced
            idxs[:, -1] += 1
        return vals, idxs
    return wrapped


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered"])
@pytest.mark.parametrize("cell", ["tinydense.rank-all.k10",
                                  "tinydense.rank-all.k20",
                                  "tinysparse.rank-all.k10"])
def test_broken_kernels_read_not_correct(tmp_path, monkeypatch, cell, fault):
    from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck

    for name in KERNELS:
        monkeypatch.setattr(ck, name, _broken(getattr(ck, name), fault))
    root = make_root(tmp_path, mixes=("rank-all.k10", "rank-all.k20"))
    rec = harness.run_cell(root, cell, 2**32 + 5, 0.2, False, "cpu")
    assert rec["correct"] is False
    assert rec["checks"]["rank_gap"]["value"] > rec["checks"]["rank_gap"][
        "limit"]
