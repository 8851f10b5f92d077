"""``rank_all_exact``: ``rank_all``'s calls, window, buffers and record,
held to one check more than ``rank_all``'s ``rank_gap``:

- ``column_mismatch``: the (call, row, rank) entries of the sampled rows
  whose column differs from the reference's. Under an exact guarantee a
  tie broken the wrong way across rank k leaves every value right, so
  ``rank_gap`` reads 0 where this check does not.
"""

from __future__ import annotations

import numpy as np

from gpubench import check
from gpubench.ops import rank_all


class _TopkOnce:
    """The reference with the sampled rows' top-k worked out once, for
    both checks."""

    def __init__(self, reference, rows: np.ndarray, k: int):
        self.n = reference.n
        self.top = reference.topk(rows, k)
        self.scores = reference.scores

    def topk(self, rows, k):
        return self.top


class Op(rank_all.Op):
    def __init__(self, mix: dict, cfg: dict, seed: int, seconds: float):
        super().__init__(mix, cfg, seed, seconds)
        self.calls_of = []  # the calls each kept output stands for

    def keep(self, output) -> None:
        kept = len(self.outputs)
        super().keep(output)
        if len(self.outputs) > kept:
            self.calls_of.append(1)
        else:
            self.calls_of[-1] += 1

    def compare(self, reference, limits: dict, calls: int):
        ref = _TopkOnce(reference, self.rows, self.k)
        checks, parts = check.compare(self.outputs, self.rows, ref, self.k,
                                      limits, calls)
        ref_i = ref.top[1]
        mismatch = 0
        for (_, idxs), n_calls in zip(self.outputs, self.calls_of):
            idxs = np.asarray(idxs)
            wrong = (ref_i.size if idxs.shape != ref_i.shape
                     else int((idxs != ref_i).sum()))
            mismatch += n_calls * wrong
        checks["column_mismatch"] = {"value": mismatch,
                                     "limit": limits["column_mismatch"]}
        parts["column_mismatch"] = mismatch
        return checks, parts
