"""The hand-written CUDA kernels of the PathSim hot path, their plain
PyTorch versions, and the build/launch wrappers.

The FLOPs live in ``M = C @ Cᵀ`` followed by the elementwise
normalization ``S = 2M / (d_i + d_j)`` (reference semantics, SURVEY.md
§3.3). Two kernels (sources in ``csrc/``, CUDA C++ for ``sm_90a``)
compute tiles of S in registers so M never reaches device memory:

- **K1** ``topk_twopass_candidates`` (``csrc/topk_twopass.cu``) replaces
  the Pallas ``_topk2_kernel`` / ``_topk2_kernel_kt``: each score tile's
  per-row top-k goes to a candidate buffer ``[N, n_col_tiles, k]``, and
  :func:`fused_topk_twopass` reduces it with
  :func:`..ops.sparse.chunked_row_topk` (pass 2, torch ops).
- **K2** ``fused_scores`` (``csrc/fused_scores.cu``) replaces
  ``_scores_kernel`` / ``_scores_kernel_kt``: the whole score matrix.

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

# Tile edge of both kernels (csrc/tile_gemm.cuh BM = BN).
TILE = 128
# Two-pass top-k bound: k rounds of extraction per tile. k > CAND_MAX is
# the single-pass fold kernel's job (Pallas fused_topk, not ported yet).
CAND_MAX = 16
# Grid rows are blockIdx.y (at most 65535 row tiles).
_MAX_ROWS = 65535 * TILE

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
    """The library's path, keyed by a digest of its sources and flags:
    an edited source never loads a stale build."""
    source = KERNELS[name][0]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (source, "tile_gemm.cuh"):
        h.update((CSRC / f).read_bytes())
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
