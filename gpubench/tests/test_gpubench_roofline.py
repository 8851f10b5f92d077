"""The roofline's arithmetic: the work of one rank-all and the reader."""

from __future__ import annotations

import pytest

from gpubench.harness import Bench, peaks_for
from gpubench.tests._tiny import REPO

H100 = peaks_for(REPO, "NVIDIA H100 80GB HBM3")
reader = Bench(REPO).reader("topk_roofline")


def test_dense_bench_shape_is_bound_by_operations():
    # 32768² × 384 int8 operations at 1,979 TOP/s
    assert reader.least_time_s(32768, 384, 10, H100) == pytest.approx(
        0.208e-3, abs=0.5e-6)
    # config 5: 1,048,576² × 64
    assert reader.least_time_s(1 << 20, 64, 10, H100) == pytest.approx(
        35.558e-3, abs=0.001e-3)


def test_narrow_factor_is_bound_by_bytes():
    n, v, k = 4096, 1, 10
    nbytes = 4 * n * v + 4 * n + 8 * n * k
    assert reader.least_time_s(n, v, k, H100) == pytest.approx(
        nbytes / 3.35e12)


def test_reader_reads_nothing_without_a_trace():
    run = {"n": 32768, "v": 384, "k": 10, "calls": 100, "peaks": H100}
    assert reader.read({**run, "trace": None}) is None
    trace = {"kernel_s": 100 * 4.16e-3, "busy_s": 0.5, "window_s": 1.0}
    assert reader.read({**run, "trace": trace}) == pytest.approx(5.0,
                                                                 rel=1e-2)
    assert peaks_for(REPO, "cpu") is None
