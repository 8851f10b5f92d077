"""The hand-written CUDA kernels of the PathSim hot path, their plain
PyTorch versions, and the build/launch wrappers.

The FLOPs live in ``M = C @ Cᵀ`` followed by the elementwise
normalization ``S = 2M / (d_i + d_j)`` (reference semantics, SURVEY.md
§3.3). Four kernels (sources in ``csrc/``, CUDA C++ for ``sm_90a``)
compute tiles of S in registers so M never reaches device memory:

- **K1** ``topk_twopass_candidates`` (``csrc/topk_twopass.cu``) replaces
  the Pallas ``_topk2_kernel`` / ``_topk2_kernel_kt``: each score tile's
  per-row top-k goes to a candidate buffer ``[N, n_col_tiles, k]``, and
  :func:`fused_topk_twopass` reduces it with
  :func:`..ops.sparse.chunked_row_topk` (pass 2, torch ops).
- **K2** ``fused_scores`` (``csrc/fused_scores.cu``) replaces
  ``_scores_kernel`` / ``_scores_kernel_kt``: the whole score matrix.
- **K3** ``topk_rect_candidates`` (``csrc/topk_rect.cu``) replaces
  ``_topk2_rect_kernel`` / ``_topk2_rect_kernel_kt``: one row tile
  against every column, self pairs masked in the kernel, each row's
  top-k per stripe of columns (:func:`rect_stripe_tiles`) to a candidate
  buffer ``[T, n_stripes, k]``; :func:`fused_topk_twopass_rect` reduces
  it with ``chunked_row_topk``. The streaming tier's hot op.
- **K4** ``topk_fold`` (``csrc/topk_fold.cu``) replaces ``_topk_kernel``
  / ``_topk_kernel_kt``: the single-pass top-k for any k, each row's
  running best merged tile by tile (:func:`fused_topk`).

Exactness contract — zero tolerance against the plain versions: path
counts are integers below 2²⁴, so every f32 sum is exact in any order,
and the one division is correctly rounded (the kernels are built without
fast math and with ``-prec-div=true``). TF32 would truncate counts above
2048, so the kernels use CUDA-core FMAs, the entry points call
:func:`true_f32` to turn TF32 off for every torch matmul on the card, and
the backend refuses to run with it on (:func:`check_true_f32`).

Dispatch rule: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. Nothing falls back.

The kernels are compiled at first use with ``nvcc`` into ``_build/``
(listed in ``.gitignore``), one shared library per source with a plain C
interface, loaded with ``ctypes``. Nothing here touches the GPU or the
compiler at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from . import sparse

# Tile edge of every kernel (csrc/tile_gemm.cuh BM = BN).
TILE = 128
# Two-pass top-k bound: k rounds of extraction per tile (K1), one list
# slot per lane of a half-warp (K3). k > CAND_MAX is the single-pass fold
# kernel's job (K4).
CAND_MAX = 16
# Grid rows are blockIdx.y (at most 65535 row tiles).
_MAX_ROWS = 65535 * TILE
# Blocks K3's grid aims for when it sets its stripe width: about four
# waves of an H100's 132 SMs (rect_stripe_tiles).
RECT_TARGET_BLOCKS = 512
# Rows of one score block in the plain rect version (it never holds more
# than about 2^27 scores at once).
_PLAIN_BLOCK_SCORES = 1 << 27

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-prec-div=true", "-Xptxas", "-v",
)
# Kernel name → (source, C entry point, ctypes argtypes).
_P = ctypes.c_void_p
_I = ctypes.c_int
KERNELS = {
    "topk_twopass_candidates": (
        "topk_twopass.cu", "pathsim_topk_candidates",
        [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    ),
    "fused_scores": (
        "fused_scores.cu", "pathsim_fused_scores",
        [_P, _P, _I, _I, _P, _P],
    ),
    "topk_rect_candidates": (
        "topk_rect.cu", "pathsim_topk_rect",
        [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    ),
    "topk_fold": (
        "topk_fold.cu", "pathsim_topk_fold",
        [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    ),
}

# Launches per kernel wrapper: incremented where the kernel is launched
# and nowhere else, so a run can show that its main path went through
# the kernels. Read and reset by the caller.
LAUNCHES = {name: 0 for name in KERNELS}

_LIBS: dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def true_f32() -> None:
    """Turn TF32 off for torch's matmuls and convolutions on the card:
    path counts above 2048 would not survive TF32's 10-bit mantissa.
    The flags are process-wide, so only entry points (the CLI,
    ``chip_smoke.py``) call this; the backend checks it with
    :func:`check_true_f32`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_true_f32() -> None:
    """Refuse to compute on the card while torch's matmuls may use TF32
    (it would truncate path counts above 2048)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise ValueError(
            "TF32 matmuls are on; exact path counts need true f32 "
            "(call cuda_kernels.true_f32() first)"
        )


# -- build ---------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> pathlib.Path:
    """The library's path, keyed by a digest of its source, every header
    in ``csrc/`` and the flags: an edited source or header never loads a
    stale build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (CSRC / KERNELS[name][0], *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every named kernel library that is not built yet, all
    nvcc processes started together. Returns each compiled kernel's
    compiler report (``-Xptxas -v``: registers, shared memory, spills);
    raises RuntimeError with the compiler's output if a build fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / KERNELS[name][0])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out,
        )
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


def _entry(name: str):
    """The kernel's C entry point, building and loading its library at
    first use."""
    with _LIBS_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(path))
    _, symbol, argtypes = KERNELS[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch on ``device``'s current stream, with ``device`` current
    for the C side's kernel launch."""
    fn = _entry(name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {rc} "
            "(an sm_90a build runs only on a Hopper card)"
        )
    LAUNCHES[name] += 1


# -- input checks ----------------------------------------------------------


def _check_factor(c: torch.Tensor, d: torch.Tensor) -> None:
    if c.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(
            f"kernels take float32 factors, got {c.dtype} / {d.dtype}"
        )
    if c.dim() != 2 or d.shape != (c.shape[0],):
        raise ValueError(
            f"factor shapes {tuple(c.shape)} / {tuple(d.shape)} do not match"
        )
    if c.device != d.device:
        raise ValueError(f"factor on {c.device}, denominators on {d.device}")


def _device_kind(c: torch.Tensor) -> str:
    kind = c.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {c.device}")
    return kind


def _check_kernel_input(c: torch.Tensor, d: torch.Tensor) -> None:
    if c.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {c.device}")
    if not (c.is_contiguous() and d.is_contiguous()):
        raise ValueError("the CUDA kernels take contiguous tensors")
    n, v = c.shape
    if n > _MAX_ROWS or v >= 2**31:
        raise ValueError(f"factor {n}x{v} exceeds the kernels' grid limits")


# -- plain versions ---------------------------------------------------------


def _scores_plain(c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    m = c @ c.T
    denom = d[:, None] + d[None, :]
    return torch.where(denom > 0, (2.0 * m) / denom, 0.0)


def fused_scores_plain(c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """K2's function in plain torch: S [N, N] f32."""
    _check_factor(c, d)
    return _scores_plain(c, d)


def fused_topk_twopass_plain(c: torch.Tensor, d: torch.Tensor, k: int = 10,
                             mask_self: bool = True):
    """K1 + pass 2's function in plain torch: per-row top-k (values f32
    [N, k], columns int64 [N, k]) ordered (descending score, ascending
    column), self pairs at -inf when ``mask_self``."""
    _check_factor(c, d)
    s = _scores_plain(c, d)
    if mask_self:
        s.fill_diagonal_(float("-inf"))
    v, p = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k], p[:, :k]


def topk_twopass_candidates_plain(c: torch.Tensor, d: torch.Tensor, k: int,
                                  mask_self: bool):
    """K1's own output in plain torch: each row's top-k inside every
    TILE-wide column tile (columns past N at -inf; ties to the lowest
    column), values f32 and global columns int32, [N, n_col_tiles, k]."""
    _check_factor(c, d)
    n = c.shape[0]
    n_ct = -(-n // TILE)
    s = _scores_plain(c, d)
    if mask_self:
        s.fill_diagonal_(float("-inf"))
    s = torch.nn.functional.pad(s, (0, n_ct * TILE - n), value=float("-inf"))
    v, p = torch.sort(s.view(n, n_ct, TILE), dim=2, descending=True,
                      stable=True)
    base = torch.arange(n_ct, device=c.device).view(1, n_ct, 1) * TILE
    return v[..., :k].contiguous(), (p[..., :k] + base).to(torch.int32)


def _sorted_topk(s: torch.Tensor, k: int):
    """Each row's top-k of ``s`` in (descending value, ascending column)
    order, the row padded with -inf columns to at least k (a stable
    descending sort keeps equal values in column order). Returns copies,
    not views: a view would keep the whole sorted block alive."""
    if s.shape[1] < k:
        s = torch.nn.functional.pad(s, (0, k - s.shape[1]),
                                    value=float("-inf"))
    v, p = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k].contiguous(), p[:, :k].contiguous()


def fused_topk_plain(c: torch.Tensor, d: torch.Tensor, k: int = 10,
                     mask_self: bool = True):
    """K4's function in plain torch: per-row top-k (values f32 [N, k],
    columns int64 [N, k]) ordered (descending score, ascending column),
    self pairs at -inf when ``mask_self``; a row with fewer than k
    finite scores gets distinct ascending -inf columns (padding columns
    N, N+1, … past the real ones)."""
    _check_factor(c, d)
    if k < 1:
        raise ValueError("fused_topk needs k >= 1")
    s = _scores_plain(c, d)
    if mask_self:
        s.fill_diagonal_(float("-inf"))
    return _sorted_topk(s, k)


def _rect_n_stripes(n: int, stripe_tiles: int) -> int:
    return -(-(-(-n // TILE)) // stripe_tiles)


def _check_rect(c_rows, c_cols, d_rows, d_cols, row_ids) -> None:
    _check_factor(c_rows, d_rows)
    _check_factor(c_cols, d_cols)
    if c_rows.shape[1] != c_cols.shape[1]:
        raise ValueError(
            f"row factor {tuple(c_rows.shape)} and column factor "
            f"{tuple(c_cols.shape)} differ in width"
        )
    if row_ids.shape != (c_rows.shape[0],):
        raise ValueError(
            f"row_ids {tuple(row_ids.shape)} do not match {c_rows.shape[0]} rows"
        )
    if len({c_rows.device, c_cols.device, row_ids.device}) != 1:
        raise ValueError("rect factors and row ids lie on different devices")


def _rect_scores_masked(c_rows, c_cols, d_rows, d_cols, row_ids,
                        n_true_cols: int) -> torch.Tensor:
    """The [T, N] score block with columns >= ``n_true_cols`` and self
    pairs (column == row id) at -inf."""
    m = c_rows @ c_cols.T
    denom = d_rows[:, None] + d_cols[None, :]
    s = torch.where(denom > 0, (2.0 * m) / denom, 0.0)
    cols = torch.arange(c_cols.shape[0], device=s.device)
    drop = (cols[None, :] >= n_true_cols) | (cols[None, :] == row_ids[:, None])
    return s.masked_fill_(drop, float("-inf"))


def topk_rect_candidates_plain(c_rows, c_cols, d_rows, d_cols, row_ids,
                               k: int, n_true_cols: int | None = None,
                               stripe_tiles: int | None = None):
    """K3's own output in plain torch: each row's top-k inside every
    stripe of ``stripe_tiles * TILE`` columns (default
    :func:`rect_stripe_tiles`; columns past N at -inf; ties to the lowest
    column), values f32 and global columns int32, [T, n_stripes, k]."""
    _check_rect(c_rows, c_cols, d_rows, d_cols, row_ids)
    t, n = c_rows.shape[0], c_cols.shape[0]
    n_true = n if n_true_cols is None else int(n_true_cols)
    if stripe_tiles is None:
        stripe_tiles = rect_stripe_tiles(t, n)
    width = stripe_tiles * TILE
    n_st = _rect_n_stripes(n, stripe_tiles)
    s = _rect_scores_masked(c_rows, c_cols, d_rows, d_cols, row_ids, n_true)
    s = torch.nn.functional.pad(s, (0, n_st * width - n), value=float("-inf"))
    v, p = torch.sort(s.view(t, n_st, width), dim=2, descending=True,
                      stable=True)
    base = torch.arange(n_st, device=s.device).view(1, n_st, 1) * width
    return v[..., :k].contiguous(), (p[..., :k] + base).to(torch.int32)


def fused_topk_twopass_rect_plain(c_rows, c_cols, d_rows, d_cols, row_ids,
                                  k: int = 10, n_true_cols: int | None = None):
    """K3 + pass 2's function in plain torch: the per-row top-k (values
    f32 [T, k], columns int64 [T, k]) of the [T, N] score block
    ``2·(c_rows @ c_colsᵀ) / (d_rows ⊕ d_cols)`` with columns >=
    ``n_true_cols`` and self pairs (column == ``row_ids[r]``) at -inf,
    ordered (descending score, ascending column). Scores blocks of at
    most about 2^27 entries at a time."""
    _check_rect(c_rows, c_cols, d_rows, d_cols, row_ids)
    t, n = c_rows.shape[0], c_cols.shape[0]
    n_true = n if n_true_cols is None else int(n_true_cols)
    step = max(1, _PLAIN_BLOCK_SCORES // max(n, 1))
    outs = [
        _sorted_topk(_rect_scores_masked(
            c_rows[r0:r0 + step], c_cols, d_rows[r0:r0 + step], d_cols,
            row_ids[r0:r0 + step], n_true), k)
        for r0 in range(0, t, step)
    ]
    if not outs:
        return (torch.empty((0, k), dtype=torch.float32, device=c_rows.device),
                torch.empty((0, k), dtype=torch.int64, device=c_rows.device))
    return torch.cat([v for v, _ in outs]), torch.cat([p for _, p in outs])


# -- kernel wrappers ----------------------------------------------------------


def topk_twopass_candidates(c: torch.Tensor, d: torch.Tensor, k: int,
                            mask_self: bool):
    """Launch K1: per-row, per-column-tile top-k candidates, values f32
    and global columns int32, each [N, ceil(N / TILE), k]."""
    _check_factor(c, d)
    _check_kernel_input(c, d)
    if not 1 <= k <= CAND_MAX:
        raise ValueError(f"topk_twopass_candidates needs 1 <= k <= {CAND_MAX}")
    n, v = c.shape
    n_ct = -(-n // TILE)
    vals = torch.empty((n, n_ct, k), dtype=torch.float32, device=c.device)
    cols = torch.empty((n, n_ct, k), dtype=torch.int32, device=c.device)
    if n:
        _launch(
            "topk_twopass_candidates", c.device, c.data_ptr(), d.data_ptr(),
            n, v, k,
            int(mask_self), vals.data_ptr(), cols.data_ptr(),
        )
    return vals, cols


def fused_topk_twopass(c: torch.Tensor, d: torch.Tensor, k: int = 10,
                       mask_self: bool = True):
    """Exact per-row top-k of the score matrix, never materialized on
    the card: K1 writes tile candidates, pass 2 (stable sorts) reduces
    them. Returns (values f32 [N, k], columns int64 [N, k])."""
    _check_factor(c, d)
    if k > CAND_MAX:
        raise ValueError(f"fused_topk_twopass supports k <= {CAND_MAX}")
    if _device_kind(c) == "cpu":
        return fused_topk_twopass_plain(c, d, k=k, mask_self=mask_self)
    vals, cols = topk_twopass_candidates(c, d, k, mask_self)
    n = c.shape[0]
    fv, fc = sparse.chunked_row_topk(vals.view(n, -1), cols.view(n, -1), k)
    return fv, fc.long()


def fused_scores(c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """All-pairs scores S [N, N] f32 (K2 on the card)."""
    _check_factor(c, d)
    if _device_kind(c) == "cpu":
        return fused_scores_plain(c, d)
    _check_kernel_input(c, d)
    n, v = c.shape
    out = torch.empty((n, n), dtype=torch.float32, device=c.device)
    if n:
        _launch("fused_scores", c.device, c.data_ptr(), d.data_ptr(), n, v,
                out.data_ptr())
    return out


def topk_rect_candidates(c_rows, c_cols, d_rows, d_cols, row_ids, k: int,
                         n_true_cols: int | None = None,
                         stripe_tiles: int | None = None):
    """Launch K3: each row's top-k per stripe of ``stripe_tiles * TILE``
    columns (default :func:`rect_stripe_tiles`), values f32 and global
    columns int32, [T, n_stripes, k]. ``row_ids`` is int32 [T] on the
    card."""
    _check_rect(c_rows, c_cols, d_rows, d_cols, row_ids)
    _check_kernel_input(c_rows, d_rows)
    _check_kernel_input(c_cols, d_cols)
    if row_ids.dtype != torch.int32 or not row_ids.is_contiguous():
        raise ValueError("K3 takes contiguous int32 row ids")
    if not 1 <= k <= CAND_MAX:
        raise ValueError(f"topk_rect_candidates needs 1 <= k <= {CAND_MAX}")
    t, v = c_rows.shape
    n = c_cols.shape[0]
    if stripe_tiles is None:
        stripe_tiles = rect_stripe_tiles(t, n)
    if stripe_tiles < 1:
        raise ValueError("stripe_tiles must be >= 1")
    n_true = n if n_true_cols is None else int(n_true_cols)
    if not 0 <= n_true <= n:
        raise ValueError(f"n_true_cols {n_true} outside [0, {n}]")
    n_st = _rect_n_stripes(n, stripe_tiles)
    vals = torch.empty((t, n_st, k), dtype=torch.float32, device=c_rows.device)
    cols = torch.empty((t, n_st, k), dtype=torch.int32, device=c_rows.device)
    if t and n:
        _launch(
            "topk_rect_candidates", c_rows.device, c_rows.data_ptr(),
            d_rows.data_ptr(), row_ids.data_ptr(), t, c_cols.data_ptr(),
            d_cols.data_ptr(), n, n_true, v, k, stripe_tiles,
            vals.data_ptr(), cols.data_ptr(),
        )
    return vals, cols


def fused_topk_twopass_rect(c_rows, c_cols, d_rows, d_cols, row_ids,
                            k: int = 10, n_true_cols: int | None = None):
    """Exact per-row top-k of the [T, N] score block of a row tile
    against every column, self pairs and columns >= ``n_true_cols``
    excluded, never materialized on the card: K3 writes stripe
    candidates, pass 2 (stable sorts) reduces them. Returns (values f32
    [T, k], columns int64 [T, k])."""
    _check_rect(c_rows, c_cols, d_rows, d_cols, row_ids)
    if not rect_supported(c_rows.shape[1], k):
        raise ValueError(f"fused_topk_twopass_rect requires k<{CAND_MAX}")
    if _device_kind(c_rows) == "cpu":
        return fused_topk_twopass_rect_plain(
            c_rows, c_cols, d_rows, d_cols, row_ids, k=k,
            n_true_cols=n_true_cols,
        )
    vals, cols = topk_rect_candidates(c_rows, c_cols, d_rows, d_cols,
                                      row_ids, k, n_true_cols)
    t = c_rows.shape[0]
    fv, fc = sparse.chunked_row_topk(vals.view(t, -1), cols.view(t, -1), k)
    return fv, fc.long()


def fused_topk(c: torch.Tensor, d: torch.Tensor, k: int = 10,
               mask_self: bool = True):
    """Single-pass per-row top-k for any k (K4 on the card): values f32
    [N, k], columns int64 [N, k], ordered (descending score, ascending
    column); a row with fewer than k finite scores gets distinct
    ascending -inf columns."""
    _check_factor(c, d)
    if k < 1:
        raise ValueError("fused_topk needs k >= 1")
    if _device_kind(c) == "cpu":
        return fused_topk_plain(c, d, k=k, mask_self=mask_self)
    _check_kernel_input(c, d)
    n, v = c.shape
    if max(n, k) >= 2**31 - TILE:
        raise ValueError(f"fused_topk with n={n}, k={k} exceeds the "
                         "kernel's int32 column range")
    vals = torch.empty((n, k), dtype=torch.float32, device=c.device)
    idxs = torch.empty((n, k), dtype=torch.int32, device=c.device)
    if n:
        _launch("topk_fold", c.device, c.data_ptr(), d.data_ptr(), n, v, k,
                int(mask_self), vals.data_ptr(), idxs.data_ptr())
    return vals, idxs.long()


# -- budgets ----------------------------------------------------------------


def candidate_bytes(n: int, k: int) -> int:
    """K1's candidate buffer: N · ceil(N / TILE) · k · (4 + 4) bytes."""
    return n * (-(-n // TILE)) * k * 8


def candidate_budget_bytes(device) -> int:
    """How much of the card the candidate buffer may take: an eighth of
    its memory (pass 2's sorts need about twice the buffer again)."""
    return torch.cuda.get_device_properties(device).total_memory // 8


def twopass_fits(n: int, k: int, device) -> bool:
    """Whether K1's candidate buffer fits the budget on ``device`` (the
    port's counterpart of the TPU gate of the same name). Only the
    kernel has a candidate buffer: on the CPU the plain version runs,
    so every shape passes there."""
    if torch.device(device).type != "cuda":
        return True
    return candidate_bytes(n, k) <= candidate_budget_bytes(device)


# -- K3's gates (the port's counterparts of the TPU gates of the same names)


def rect_supported(v: int, k: int) -> bool:
    """K3 takes any factor width (the V loop is inside the block); the
    one gate is the JAX package's k < 16, kept so both packages route
    the same k to the same arm."""
    return 1 <= k < CAND_MAX


def rect_stripe_tiles(t: int, n: int) -> int:
    """Column tiles per K3 stripe for a [t, n] block. A row's list
    restarts at every stripe, and its insertions grow only with the log
    of the stripe's width, so stripes are made as wide as still gives
    the grid :data:`RECT_TARGET_BLOCKS` blocks: 1024 tiles (131072
    columns) at t = 8192, n = 1M, where that measured fastest; 8 sets of
    k candidates a row for pass 2."""
    n_ct = max(1, -(-n // TILE))
    row_blocks = max(1, -(-t // TILE))
    n_stripes = min(n_ct, -(-RECT_TARGET_BLOCKS // row_blocks))
    return -(-n_ct // n_stripes)


def rect_candidate_bytes(n_cols: int, tile_rows: int, k: int) -> int:
    """K3's candidate buffer for one row tile: T · n_stripes · k ·
    (4 + 4) bytes. 5.2 MB at T = 8192, N = 1M, k = 10."""
    n_st = _rect_n_stripes(n_cols, rect_stripe_tiles(tile_rows, n_cols))
    return tile_rows * n_st * k * 8


def rect_fits(n_cols: int, tile_rows: int, k: int, device) -> bool:
    """Whether one row tile's K3 candidate buffer fits the same budget
    as K1's (an eighth of the card: pass 2's sorts need about twice the
    buffer again). Only the kernel has a candidate buffer: on the CPU
    every shape passes."""
    if torch.device(device).type != "cuda":
        return True
    return (rect_candidate_bytes(n_cols, tile_rows, k)
            <= candidate_budget_bytes(device))


def rect_pad_factor(c: torch.Tensor, d: torch.Tensor):
    """The factor and denominators as K3 takes them, made once per pass
    so that no row-tile launch copies them again: contiguous float32.
    Unlike the TPU kernel's, K3 masks its ragged edges itself, so
    nothing is padded."""
    return (c.to(torch.float32).contiguous(),
            d.to(torch.float32).contiguous())
