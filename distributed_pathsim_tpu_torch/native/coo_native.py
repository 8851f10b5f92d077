"""ctypes bridge to the C++ COO SpGEMM (coo_fast.cpp).

Drop-in for ``ops.sparse.coo_matmul(a, b).summed()`` — identical output
(coalesced, row-major sorted; integer-weight accumulation is exact in
f64 regardless of order). Falls back cleanly (available() → False) when
the toolchain is missing.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .build import shared_lib

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = shared_lib("coo_fast")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:  # built for another host's C++ runtime
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.coo_spgemm.restype = ctypes.c_void_p
    lib.coo_spgemm.argtypes = [
        i64p, i64p, f64p, ctypes.c_int64,
        i64p, i64p, f64p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.coo_error.restype = ctypes.c_char_p
    lib.coo_error.argtypes = [ctypes.c_void_p]
    lib.coo_result_nnz.restype = ctypes.c_int64
    lib.coo_result_nnz.argtypes = [ctypes.c_void_p]
    lib.coo_result_fill.restype = None
    lib.coo_result_fill.argtypes = [ctypes.c_void_p, i64p, i64p, f64p]
    lib.coo_free.restype = None
    lib.coo_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _as_i64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _as_f64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def coo_matmul_summed(a, b):
    """(a @ b) coalesced, as a new COOMatrix. a: (M,K), b: (K,N)."""
    from ..ops.sparse import COOMatrix

    if a.shape[1] != b.shape[0]:  # same guard as the numpy coo_matmul
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    lib = _load()
    if lib is None:
        raise RuntimeError("native coo library unavailable")
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    ar, ac, aw = _as_i64(a.rows), _as_i64(a.cols), _as_f64(a.weights)
    br, bc, bw = _as_i64(b.rows), _as_i64(b.cols), _as_f64(b.weights)
    h = lib.coo_spgemm(
        ar.ctypes.data_as(i64p), ac.ctypes.data_as(i64p),
        aw.ctypes.data_as(f64p), len(ar),
        br.ctypes.data_as(i64p), bc.ctypes.data_as(i64p),
        bw.ctypes.data_as(f64p), len(br),
        b.shape[0], b.shape[1],
    )
    try:
        err = lib.coo_error(h)
        if err:
            raise ValueError(err.decode())
        nnz = lib.coo_result_nnz(h)
        rows = np.empty(nnz, dtype=np.int64)
        cols = np.empty(nnz, dtype=np.int64)
        weights = np.empty(nnz, dtype=np.float64)
        if nnz:
            lib.coo_result_fill(
                h,
                rows.ctypes.data_as(i64p),
                cols.ctypes.data_as(i64p),
                weights.ctypes.data_as(f64p),
            )
    finally:
        lib.coo_free(h)
    return COOMatrix(
        rows=rows, cols=cols, weights=weights, shape=(a.shape[0], b.shape[1])
    )
