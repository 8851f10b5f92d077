"""The plain reference against brute force on small graphs."""

from __future__ import annotations

import numpy as np
import pytest

from gpubench import graph
from gpubench.reference.pathsim_f64 import PathSimF64


def brute_topk(a_ap, a_pv, rows, k):
    c = a_ap @ a_pv
    m = c @ c.T
    d = m.sum(1)
    out_v, out_i = [], []
    for r in rows:
        den = d[r] + d
        s = np.array([2 * m[r, j] / den[j] if den[j] > 0 else 0.0
                      for j in range(len(d))])
        s[r] = -np.inf
        order = sorted(range(len(d)), key=lambda j: (-s[j], j))[:k]
        out_v.append(s[order])
        out_i.append(order)
    return np.array(out_v), np.array(out_i)


@pytest.mark.parametrize("seed,k", [(1, 3), (2, 10), (2**33 + 7, 20)])
def test_reference_equals_brute_force_with_ties(seed, k):
    g = graph.synthetic_coo({"authors": 60, "papers": 40, "venues": 5},
                            seed)
    a_ap = np.zeros((60, 40))
    np.add.at(a_ap, (g["ap_rows"], g["ap_cols"]), 1)
    a_pv = np.zeros((40, 5))
    np.add.at(a_pv, (g["pv_rows"], g["pv_cols"]), 1)
    ref = PathSimF64(g["ap_rows"], g["ap_cols"], g["pv_rows"], g["pv_cols"],
                     60, 40, 5)
    rows = np.arange(60)
    v, i = ref.topk(rows, k)
    bv, bi = brute_topk(a_ap, a_pv, rows, k)
    assert np.array_equal(i, bi) and np.array_equal(v, bv)
    # this graph has rows of only ties (authors with no paper) and ties
    # inside rows, so the column order is tested
    assert (v == 0).all(axis=1).any() and (v[:, :-1] == v[:, 1:]).any()
    assert np.array_equal(ref.scores(rows[:, None].repeat(k, 1), bi), bv)


def test_factor_counts_papers_with_several_venues():
    ap_r, ap_c = np.array([0, 0, 1, 2]), np.array([0, 1, 1, 2])
    pv_r, pv_c = np.array([1, 0, 1, 2, 2]), np.array([2, 0, 0, 1, 2])
    ref = PathSimF64(ap_r, ap_c, pv_r, pv_c, 3, 3, 3)
    a_ap = np.zeros((3, 3))
    a_ap[ap_r, ap_c] = 1
    a_pv = np.zeros((3, 3))
    a_pv[pv_r, pv_c] = 1
    c = a_ap @ a_pv
    assert np.array_equal(ref.c, c)
    assert np.array_equal(ref.d, (c @ c.T).sum(1))
