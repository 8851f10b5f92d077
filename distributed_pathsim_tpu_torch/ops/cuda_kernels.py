"""The hand-written CUDA kernels of the PathSim hot path, their plain
PyTorch versions, and the build/launch wrappers.

The FLOPs live in ``M = C @ Cᵀ`` followed by the elementwise
normalization ``S = 2M / (d_i + d_j)`` (reference semantics, SURVEY.md
§3.3). Four kernels (sources in ``csrc/``, CUDA C++ for ``sm_90a``)
compute tiles of S in registers so M never reaches device memory:

- **K1** ``topk_twopass_candidates`` (``csrc/topk_twopass.cu``) replaces
  the Pallas ``_topk2_kernel`` / ``_topk2_kernel_kt``: each row's top-k
  per stripe of columns (:func:`twopass_stripe_tiles`) goes to a
  candidate buffer ``[N, n_stripes, k]``, and :func:`fused_topk_twopass`
  reduces it with :func:`..ops.sparse.chunked_row_topk` (pass 2, torch
  ops).
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

K1 and K4 have exact instances too (``topk_twopass_exact`` and
``topk_fold_exact`` in :data:`KERNELS`, :func:`fused_topk_twopass_exact`,
:func:`fused_topk_exact`), for exact counts past
2²⁴: f64 scores ``2·M / (d_i + d_j)`` of the exact M (never rounded to
f32) and exact f64 denominators, behind an f32 prefilter that keeps the
f64 division off every element that provably stays out of a row's list
(``csrc/topk_list.cuh``).

Exactness contract — zero tolerance against the plain versions: path
counts are integers below 2²⁴, so every f32 sum is exact in any order,
and the one division is correctly rounded (the kernels are built without
fast math and with ``-prec-div=true``). All four kernels compute M on
the integer tensor cores, exact by construction (past 2²⁴, with
``--approx``, M is the correctly rounded exact count): :func:`split_limbs`
splits the factor into u8
limbs (raising for anything but integers in ``[0, 2²⁴)``), the u8 × u8
products and their s32 sums are integer arithmetic, folded into f64
before they could overflow, and M is converted to f32 once, correctly
rounded (``csrc/u8_tile.cuh`` has the argument; :func:`limb_product_plain`
repeats it in torch). Still no TF32: it would truncate counts above 2048,
so the entry points call :func:`true_f32` to turn it off for every torch
matmul on the card, and the backend refuses to run with it on
(:func:`check_true_f32`).

Dispatch rule: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. Nothing falls back.

float64: the plain versions compute in float64 (a float64 backend on the
CPU gives the JAX package's x64 results). The kernels stay f32-input: a
float64 factor on the card is cast to f32 at the wrapper's entry
(:func:`kernel_operands`), as the JAX package's Pallas wrappers cast on
a TPU — after the f32 exact-count guard, which raises ``OverflowError``
past 2²⁴ where the JAX package casts silently.

The kernels are compiled at first use with ``nvcc`` into ``_build/``
(listed in ``.gitignore``), one shared library per source with a plain C
interface, loaded with ``ctypes``; each build and each load is recorded
with :func:`utils.compile_counter.record`. Nothing here touches the GPU
or the compiler at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import NamedTuple

import numpy as np
import torch

from . import sparse
from ..obs.trace import PASS2_SPAN, get_tracer
from ..utils import compile_counter

# Rows of the kernels' row blocks (csrc/u8_tile.cuh BM), and the unit of
# K1's and K3's column stripes.
TILE = 128
# Columns of the kernels' subtiles (csrc/u8_tile.cuh BN, wgmma's N).
SUBTILE = 64
# The limb planes' width is padded to a multiple of this many bytes
# (wgmma's u8 depth).
LIMB_ALIGN = 32
# Bytes of V summed in one s32 accumulator before the f64 fold
# (csrc/u8_tile.cuh FOLD_CHUNKS * CHUNK): 255² · 8192 · 3 < 2³¹.
FOLD_V = 8192
# Largest k whose lists K4 keeps in shared memory (csrc/topk_fold.cu
# SMEM_K_MAX); past it they live in the output.
FOLD_SMEM_K_MAX = 137
# Two-pass top-k bound: a row's list has at most this many slots in
# shared memory (K1, K3; csrc/topk_list.cuh CAND_K_MAX). k > CAND_MAX is
# the single-pass fold kernel's job (K4).
CAND_MAX = 16
# (row block, stripe) units a two-pass grid aims for when it sets its
# stripe width: K3's (rect_stripe_tiles; the untuned default of the
# ``rect_target_units`` knob) and K1's untuned width
# (default_twopass_stripe_tiles). About two per block slot of an H100
# (132 SMs, two blocks each), which the card's in-order block dispatch
# still balances, with stripes as wide as that allows: a row's list
# restarts per stripe, and a stripe's first subtile is scored in full
# while the list fills. So from 512 row blocks (65,536 rows) on, a K1
# row block is one unit with one list over all columns, and K1's
# candidate buffer, pass 2's input, is N · k entries.
RECT_TARGET_UNITS = 512
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
# Kernel name → (source, C entry point, ctypes argtypes). One library a
# source: the exact instances of K1 and K4 (exact counts past 2^24) are
# entry points of their f32 twins' libraries.
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNELS = {
    "topk_twopass_candidates": (
        "topk_twopass.cu", "pathsim_topk_twopass",
        [_P, _I, _L, _I, _P, _I, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P,
         _P, _P, _P, _P],
    ),
    "fused_scores": (
        "fused_scores.cu", "pathsim_fused_scores",
        [_P, _I, _L, _I, _P, _I, _I, _P, _P, _P, _I, _P, _P],
    ),
    "topk_rect_candidates": (
        "topk_rect.cu", "pathsim_topk_rect",
        [_P, _I, _L, _P, _P, _I, _P, _I, _L, _P, _I, _I, _I, _I, _I,
         _P, _P, _P, _P, _I, _P, _P, _P],
    ),
    "topk_fold": (
        "topk_fold.cu", "pathsim_topk_fold",
        [_P, _I, _L, _I, _P, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P, _P,
         _P, _P, _P],
    ),
    "topk_twopass_exact": (
        "topk_twopass.cu", "pathsim_topk_twopass_exact",
        [_P, _I, _L, _I, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _I, _P,
         _P, _P, _P, _P, _P, _P],
    ),
    "topk_fold_exact": (
        "topk_fold.cu", "pathsim_topk_fold_exact",
        [_P, _I, _L, _I, _P, _P, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P,
         _P, _P, _P, _P],
    ),
}

# Launches per kernel wrapper: incremented where the kernel is launched
# and nowhere else, so a run can show that its main path went through
# the kernels. Read and reset by the caller.
LAUNCHES = {name: 0 for name in KERNELS}
# Row blocks each wrapper launched on its kernel's instance with the f64
# fold (csrc/u8_tile.cuh), summed over launches: how often the slow
# instance still engages. Reset with LAUNCHES.
WIDE_ROW_BLOCKS = {name: 0 for name in KERNELS}
# Column stripes of each K1 launch (approx and exact instances), summed
# over launches: a row's list restarts once a stripe. Reset with
# LAUNCHES.
TWOPASS_STRIPES = {name: 0 for name in ("topk_twopass_candidates",
                                        "topk_twopass_exact")}

_LIBS: dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()
# Per card: the stream K1 and K4 run their wide row blocks on beside the
# narrow launch (_launch_square).
_SIDE_STREAMS: dict[int, torch.cuda.Stream] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        WIDE_ROW_BLOCKS[name] = 0
    for name in TWOPASS_STRIPES:
        TWOPASS_STRIPES[name] = 0


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
    """The path of the kernel's library (one a source), keyed by a digest
    of its source, every header in ``csrc/`` and the flags: an edited
    source or header never loads a stale build."""
    src = CSRC / KERNELS[name][0]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (src, *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile the library of every named kernel that is not built yet,
    all nvcc processes started together. Returns each compiled kernel's
    compiler report (``-Xptxas -v``: registers, shared memory, spills;
    kernels of one library share it); raises RuntimeError with the
    compiler's output if a build fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}  # library → (nvcc, its temporary output, its kernels)
    for name in names:
        out = _lib_path(name)
        if out in procs:
            procs[out][2].append(name)
            continue
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / KERNELS[name][0])]
        procs[out] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, [name],
        )
    reports = {}
    failed = []
    for out, (proc, tmp, built) in procs.items():
        text, _ = proc.communicate()
        reports.update(dict.fromkeys(built, text))
        if proc.returncode != 0:
            failed.append(f"{out.name} (rc {proc.returncode}):\n{text}")
        else:
            os.replace(tmp, out)
            compile_counter.record("nvcc", built[0])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


def _entry(name: str):
    """The kernel's C entry point, building and loading its library at
    first use."""
    source, symbol, argtypes = KERNELS[name]
    with _LIBS_LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build([name])
            lib = _LIBS[source] = ctypes.CDLL(str(path))
            compile_counter.record("load", name)
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


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The card's stream for a square kernel's wide row blocks, made once.
    Its priority is above the default, so the card starts the wide
    blocks' units ahead of the narrow launch's pending ones."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    with _LIBS_LOCK:
        side = _SIDE_STREAMS.get(index)
        if side is None:
            side = _SIDE_STREAMS[index] = torch.cuda.Stream(index, priority=-1)
    return side


def _launch_square(name: str, device: torch.device, lim: "Limbs", head,
                   tail) -> None:
    """One launch of a square kernel (K1, K4) whose C entry takes ``head``,
    then the factor's wide and narrow row blocks (:class:`Limbs`), then
    ``tail``: the instance with the f64 fold over the wide blocks, the
    other over the rest. With both kinds present, the wide blocks run on
    :func:`_side_stream`, forked from the current stream and joined back
    to it, beside the narrow launch and not after it: every buffer
    either touches is ordered before the current stream goes on."""
    n_wide, n_narrow = lim.wide_order.shape[0], lim.narrow_order.shape[0]
    both = bool(n_wide and n_narrow)
    cur = torch.cuda.current_stream(device)
    side = _side_stream(device) if both else cur
    if both:
        side.wait_stream(cur)
    try:
        _launch(name, device, *head, lim.wide_order.data_ptr(), n_wide,
                lim.narrow_order.data_ptr(), n_narrow, *tail,
                side.cuda_stream)
    finally:
        if both:
            cur.wait_stream(side)
    WIDE_ROW_BLOCKS[name] += n_wide


# -- input checks ----------------------------------------------------------


_FACTOR_DTYPES = (torch.float32, torch.float64)


def _check_factor(c: torch.Tensor, d: torch.Tensor) -> None:
    if c.dtype not in _FACTOR_DTYPES or d.dtype != c.dtype:
        raise TypeError(
            "kernels take float32 (or float64) factors with denominators "
            f"of the same dtype, got {c.dtype} / {d.dtype}"
        )
    if c.dim() != 2 or d.shape != (c.shape[0],):
        raise ValueError(
            f"factor shapes {tuple(c.shape)} / {tuple(d.shape)} do not match"
        )
    if c.device != d.device:
        raise ValueError(f"factor on {c.device}, denominators on {d.device}")


def kernel_operands(c: torch.Tensor, d: torch.Tensor,
                    exact_counts: bool = True):
    """``(c, d)`` as a kernel launch takes them: unchanged on the CPU
    (the plain versions compute in the input's dtype) and for f32; a
    float64 pair on the card is cast to f32, as the JAX package's Pallas
    wrappers cast at their entry on a TPU (pallas_kernels.py:163-164,
    598-599, 806-807). The cast keeps every count exact only below 2²⁴,
    so with ``exact_counts`` it is guarded first: ``max(d)`` bounds every
    entry of M under both score variants (row sums directly, the diagonal
    by Cauchy–Schwarz). This is stricter than the JAX package on a TPU,
    which casts silently."""
    if c.device.type != "cuda" or c.dtype == torch.float32:
        return c, d
    if exact_counts and d.numel() and float(d.max()) >= 2.0**24:
        raise OverflowError(
            "path counts exceed the f32 exact-integer range (2^24): on the "
            "card all-pairs (K2) and K3 run on the f32 kernels even for a "
            "float64 backend; pass --approx (exact_counts=False) for "
            "correctly rounded counts. The dense backend's rank-all needs "
            "neither: past 2^24 it ranks on the exact instances of K1 and "
            "K4 (f64 scores of the exact counts)"
        )
    return c.to(torch.float32), d.to(torch.float32)


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
    if n >= 2**31 - TILE or v >= 2**31:
        raise ValueError(f"factor {n}x{v} exceeds the kernels' grid limits")


# -- u8 limbs --------------------------------------------------------------


class Limbs(NamedTuple):
    """A factor split into u8 limbs, c = l0 + 256·l1 + 65536·l2, as the
    kernels read it: ``planes`` u8 [L, n, v_pad] (L the most limbs any entry
    needs, v_pad a multiple of :data:`LIMB_ALIGN`, zero padded; a slice
    of rows may leave the planes apart by more than n · v_pad),
    ``counts`` u8 [n] (the limbs each row needs, at least 1), ``rmax``
    int32 [n] (each row's largest entry), ``sub`` int32 [ceil(n /
    SUBTILE)] (the largest entry of each 64-row tile: the kernels'
    column subtiles), ``blocks`` and ``order`` int32 [ceil(n / TILE)]
    (each row block's largest entry, and the blocks' launch order, most
    limbs first: :func:`_row_blocks`), and on the host ``host_rsum`` /
    ``host_rmax`` (each row's sum and largest entry, int64 numpy) to pick
    a launch's kernel instance without waiting for the card
    (:func:`_needs_wide`). For the square kernels (K1, K4), which pick it
    per row block: ``host_wide`` (bool numpy [ceil(n / TILE)], each
    block's rows against the whole factor's columns, the test K3 makes
    per tile), and ``order`` split into ``wide_order`` and
    ``narrow_order`` (int32, each in launch order). Everything a launch
    reads besides the planes is made here, once, so a call on a split
    factor launches at once."""

    planes: torch.Tensor
    counts: torch.Tensor
    rmax: torch.Tensor
    sub: torch.Tensor
    blocks: torch.Tensor
    order: torch.Tensor
    wide_order: torch.Tensor
    narrow_order: torch.Tensor
    host_wide: np.ndarray
    host_rsum: np.ndarray
    host_rmax: np.ndarray

    @classmethod
    def of(cls, planes, counts, rmax, host_rsum, host_rmax) -> "Limbs":
        blocks, order, wide_order, narrow_order, host_wide = _row_blocks(
            host_rsum, host_rmax, rmax.device)
        return cls(planes, counts, rmax, _tile_max(rmax, SUBTILE), blocks,
                   order, wide_order, narrow_order, host_wide, host_rsum,
                   host_rmax)

    def rows(self, r0: int, r1: int) -> "Limbs":
        """The limbs of rows r0 .. r1-1, sharing the planes' memory."""
        return Limbs.of(self.planes[:, r0:r1], self.counts[r0:r1],
                        self.rmax[r0:r1], self.host_rsum[r0:r1],
                        self.host_rmax[r0:r1])


def _tile_max(values: torch.Tensor, rows: int) -> torch.Tensor:
    """The largest of each ``rows``-row tile of ``values``, int32."""
    n = values.shape[0]
    pad = torch.nn.functional.pad(values.to(torch.int32), (0, -n % rows))
    return pad.view(-1, rows).amax(1).contiguous()


def split_limbs(c: torch.Tensor) -> Limbs:
    """Split a factor of integer path counts into the u8 limb planes the
    kernels multiply on the tensor cores (:class:`Limbs`). Raises
    ValueError unless every entry is an integer in [0, 2²⁴): NaN, ±inf,
    negatives, fractions and anything from 2²⁴ up (an f32 holds every
    integer below it, and three limbs do)."""
    if c.dim() != 2:
        raise ValueError(f"split_limbs takes a 2-D factor, got {tuple(c.shape)}")
    bad = ~torch.isfinite(c) | (c < 0) | (c >= 2**24) | (c != torch.floor(c))
    if bool(bad.any()):
        raise ValueError(
            "the tensor-core kernels take integer path counts in [0, 2^24); "
            f"{int(bad.sum())} entries are not"
        )
    n, v = c.shape
    ci = c.to(torch.int32)
    row_max = (ci.amax(1) if v else torch.zeros(n, dtype=torch.int32,
                                                 device=c.device))
    counts = (1 + (row_max >= 256).int() + (row_max >= 65536).int()).to(
        torch.uint8)
    n_planes = int(counts.max()) if n else 1
    v_pad = max(LIMB_ALIGN, -(-v // LIMB_ALIGN) * LIMB_ALIGN)
    planes = torch.zeros((n_planes, n, v_pad), dtype=torch.uint8,
                         device=c.device)
    for p in range(n_planes):
        planes[p, :, :v] = ((ci >> (8 * p)) & 255).to(torch.uint8)
    return Limbs.of(planes, counts, row_max,
                    ci.sum(1, dtype=torch.int64).cpu().numpy(),
                    row_max.long().cpu().numpy())


def limb_product_plain(rows: Limbs, cols: Limbs) -> torch.Tensor:
    """M = A Bᵀ in f32 by the kernels' arithmetic, in torch: the u8 limb
    products that share a shift 8·(p+q), summed in (emulated) s32 over at
    most :data:`FOLD_V` bytes of V, folded into an f64 sum, then one
    correctly rounded conversion to f32. For the tests: it shows the
    integer path is exact, and equals the plain f32 product wherever M
    stays below 2²⁴."""
    a, b = rows.planes.long(), cols.planes.long()
    n_r, n_c, v_pad = a.shape[0], b.shape[0], a.shape[2]
    wide = torch.zeros((a.shape[1], b.shape[1]), dtype=torch.float64,
                       device=a.device)
    for s in range(n_r + n_c - 1):
        for g0 in range(0, v_pad, FOLD_V):
            acc = sum(a[p, :, g0:g0 + FOLD_V] @ b[s - p, :, g0:g0 + FOLD_V].T
                      for p in range(max(0, s - n_c + 1), min(s, n_r - 1) + 1))
            if bool((acc >= 2**31).any()):
                raise OverflowError("an s32 accumulator would overflow")
            wide += acc.double() * float(1 << (8 * s))
    return wide.to(torch.float32)


def _needs_wide(rows: Limbs, cols: Limbs) -> bool:
    """Whether some M of rows × cols may reach 2³¹, so the launch takes the
    kernel instance with the f64 fold (``csrc/u8_tile.cuh``). M_ij is at
    most (row sum of row i) · (largest entry of column row j), and the
    other way round; the largest of either bound below 2³¹ clears every
    pair for one s32 accumulator. Host arithmetic only: no wait for the
    card."""
    if not (len(rows.host_rsum) and len(cols.host_rsum)):
        return False
    a = int(rows.host_rsum.max()) * int(cols.host_rmax.max())
    b = int(cols.host_rsum.max()) * int(rows.host_rmax.max())
    return min(a, b) >= 2**31


def _row_blocks(host_rsum: np.ndarray, host_rmax: np.ndarray, device):
    """Per TILE-row block of a factor whose rows' sums and largest entries
    are ``host_rsum`` / ``host_rmax``: its largest entry, the blocks'
    launch order (those with the most limbs first, stable), that order
    split into the wide blocks and the rest, each in launch order, and
    each block's wide flag (host bool). A block is wide when
    :func:`_needs_wide` holds for its rows against every row of the
    factor. Host arithmetic, then one upload to ``device`` that does not
    wait for the card."""
    n = len(host_rmax)
    nb = -(-n // TILE)
    pad = (0, nb * TILE - n)
    bmax = np.pad(host_rmax, pad).reshape(nb, TILE).max(1, initial=0)
    bsum = np.pad(host_rsum, pad).reshape(nb, TILE).max(1, initial=0)
    order = np.argsort(-((bmax >= 256).astype(np.int64) + (bmax >= 65536)),
                       kind="stable")
    # _needs_wide's two bounds in f64: a product below 2^53 is exact, and
    # one past it lies far past 2^31, so the test is exact
    host_wide = np.minimum(bsum * float(bmax.max(initial=0)),
                           float(bsum.max(initial=0)) * bmax) >= 2.0**31
    n_wide = int(host_wide.sum())
    buf = torch.from_numpy(np.concatenate(
        [bmax, order, order[host_wide[order]], order[~host_wide[order]]]
    ).astype(np.int32))
    if torch.device(device).type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    blocks, order, wide_order, narrow_order = buf.split(
        [nb, nb, n_wide, nb - n_wide])
    return blocks, order, wide_order, narrow_order, host_wide


def _subtile_min(d: torch.Tensor, n_sub: int) -> torch.Tensor:
    """The least denominator of each of the n_sub SUBTILE-column
    subtiles a kernel walks, 0 where a subtile reaches past d (the
    kernels' coarse prefilter bound, csrc/topk_list.cuh)."""
    pad = torch.nn.functional.pad(d, (0, n_sub * SUBTILE - d.shape[0]))
    return pad.view(n_sub, SUBTILE).amin(1).contiguous()


def _check_limbs(limbs: Limbs, n: int, v: int, device) -> None:
    planes = limbs.planes
    if planes.dtype != torch.uint8 or planes.dim() != 3:
        raise ValueError("limb planes must be u8 [L, n, v_pad]")
    l, rows, v_pad = planes.shape
    if (rows != n or v_pad < v or v_pad % LIMB_ALIGN or not 1 <= l <= 3
            or planes.stride(2) != 1 or planes.stride(1) != v_pad
            or limbs.counts.shape != (n,) or limbs.rmax.shape != (n,)
            or len(limbs.host_rsum) != n or len(limbs.host_rmax) != n
            or limbs.sub.shape != (-(-n // SUBTILE),)
            or limbs.sub.dtype != torch.int32
            or limbs.blocks.shape != (-(-n // TILE),)
            or limbs.order.shape != (-(-n // TILE),)
            or limbs.host_wide.shape != (-(-n // TILE),)
            or limbs.wide_order.shape != (int(limbs.host_wide.sum()),)
            or limbs.narrow_order.shape != (int((~limbs.host_wide).sum()),)):
        raise ValueError(
            f"limbs {tuple(planes.shape)} do not match a {n}x{v} factor"
        )
    if planes.device != device or limbs.sub.device != device:
        raise ValueError(f"limbs on {planes.device}, factor on {device}")


# -- plain versions ---------------------------------------------------------


def _scores_plain(c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    m = c @ c.T
    denom = d[:, None] + d[None, :]
    return torch.where(denom > 0, (2.0 * m) / denom, 0.0)


def fused_scores_plain(c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """K2's function in plain torch: S [N, N] in the factor's dtype."""
    _check_factor(c, d)
    return _scores_plain(c, d)


def fused_topk_twopass_plain(c: torch.Tensor, d: torch.Tensor, k: int = 10,
                             mask_self: bool = True):
    """K1 + pass 2's function in plain torch: per-row top-k (values
    [N, k] in the factor's dtype, columns int64 [N, k]) ordered
    (descending score, ascending column), self pairs at -inf when
    ``mask_self``."""
    _check_factor(c, d)
    s = _scores_plain(c, d)
    if mask_self:
        s.fill_diagonal_(float("-inf"))
    v, p = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k], p[:, :k]


def _stripe_topk(s: torch.Tensor, k: int, stripe_tiles: int):
    """Each row's top-k of ``s`` [T, N] inside every stripe of
    ``stripe_tiles * TILE`` columns (columns past N at -inf, each with its
    own id; ties to the lowest column): values f32 and global columns
    int32, [T, n_stripes, k]. The two-pass kernels' candidate layout."""
    t, n = s.shape
    width = stripe_tiles * TILE
    n_st = _rect_n_stripes(n, stripe_tiles)
    s = torch.nn.functional.pad(s, (0, n_st * width - n), value=float("-inf"))
    v, p = torch.sort(s.view(t, n_st, width), dim=2, descending=True,
                      stable=True)
    base = torch.arange(n_st, device=s.device).view(1, n_st, 1) * width
    return v[..., :k].contiguous(), (p[..., :k] + base).to(torch.int32)


def topk_twopass_candidates_plain(c: torch.Tensor, d: torch.Tensor, k: int,
                                  mask_self: bool,
                                  stripe_tiles: int | None = None):
    """K1's own output in plain torch: each row's top-k inside every
    stripe of ``stripe_tiles * TILE`` columns (default
    :func:`twopass_stripe_tiles`; self pairs at -inf when ``mask_self``),
    [N, n_stripes, k] (:func:`_stripe_topk`)."""
    _check_factor(c, d)
    s = _scores_plain(c, d)
    if mask_self:
        s.fill_diagonal_(float("-inf"))
    n, v = c.shape
    return _stripe_topk(s, k, stripe_tiles
                        or twopass_stripe_tiles(n, v, k, c.device))


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
    """K4's function in plain torch: per-row top-k (values [N, k] in
    the factor's dtype, columns int64 [N, k]) ordered (descending score,
    ascending column), self pairs at -inf when ``mask_self``; a row with
    fewer than k finite scores gets distinct ascending -inf columns
    (padding columns N, N+1, … past the real ones)."""
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
    (t, v), n = c_rows.shape, c_cols.shape[0]
    n_true = n if n_true_cols is None else int(n_true_cols)
    if stripe_tiles is None:
        stripe_tiles = rect_stripe_tiles(t, n, v, k, c_rows.device)
    s = _rect_scores_masked(c_rows, c_cols, d_rows, d_cols, row_ids, n_true)
    return _stripe_topk(s, k, stripe_tiles)


def fused_topk_twopass_rect_plain(c_rows, c_cols, d_rows, d_cols, row_ids,
                                  k: int = 10, n_true_cols: int | None = None):
    """K3 + pass 2's function in plain torch: the per-row top-k (values
    [T, k] in the factor's dtype, columns int64 [T, k]) of the [T, N]
    score block ``2·(c_rows @ c_colsᵀ) / (d_rows ⊕ d_cols)`` with columns >=
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
        return (torch.empty((0, k), dtype=c_rows.dtype, device=c_rows.device),
                torch.empty((0, k), dtype=torch.int64, device=c_rows.device))
    return torch.cat([v for v, _ in outs]), torch.cat([p for _, p in outs])


# -- kernel wrappers ----------------------------------------------------------


def _square_limbs(c: torch.Tensor, limbs: Limbs | None) -> Limbs:
    """What a square kernel (K1, K2, K4) launches with: the factor's limbs
    (``limbs``, else split here, raising ValueError for entries that are
    not integers in [0, 2²⁴)). K1 and K4 pick the instance with the f64
    fold per row block (``Limbs.wide_order``, :func:`_launch_square`), K2
    for the whole factor (:func:`_needs_wide`)."""
    lim = split_limbs(c) if limbs is None else limbs
    _check_limbs(lim, c.shape[0], c.shape[1], c.device)
    return lim


def topk_twopass_candidates(c: torch.Tensor, d: torch.Tensor, k: int,
                            mask_self: bool, limbs: Limbs | None = None,
                            stripe_tiles: int | None = None):
    """Launch K1: each row's top-k per stripe of ``stripe_tiles * TILE``
    columns (default :func:`twopass_stripe_tiles`), values f32 and global
    columns int32, each [N, n_stripes, k]. ``limbs``: the factor already
    split (:func:`split_limbs`); otherwise it is split here, raising
    ValueError for entries that are not integers in [0, 2²⁴)."""
    _check_factor(c, d)
    _check_kernel_input(c, d)
    c, d = kernel_operands(c, d)
    if not 1 <= k <= CAND_MAX:
        raise ValueError(f"topk_twopass_candidates needs 1 <= k <= {CAND_MAX}")
    n = c.shape[0]
    if stripe_tiles is None:
        stripe_tiles = twopass_stripe_tiles(n, c.shape[1], k, c.device)
    if stripe_tiles < 1:
        raise ValueError("stripe_tiles must be >= 1")
    n_st = _rect_n_stripes(n, stripe_tiles)
    vals = torch.empty((n, n_st, k), dtype=torch.float32, device=c.device)
    cols = torch.empty((n, n_st, k), dtype=torch.int32, device=c.device)
    if n:
        lim = _square_limbs(c, limbs)
        d_min = _subtile_min(d, 2 * -(-n // TILE))
        _launch_square(
            "topk_twopass_candidates", c.device, lim,
            (lim.planes.data_ptr(), lim.planes.shape[0],
             lim.planes.stride(0), lim.planes.shape[2], d.data_ptr(), n, k,
             int(mask_self), stripe_tiles, lim.blocks.data_ptr()),
            (lim.sub.data_ptr(), d_min.data_ptr(), vals.data_ptr(),
             cols.data_ptr()))
        TWOPASS_STRIPES["topk_twopass_candidates"] += n_st
    return vals, cols


def fused_topk_twopass(c: torch.Tensor, d: torch.Tensor, k: int = 10,
                       mask_self: bool = True, limbs: Limbs | None = None,
                       stripe_tiles: int | None = None):
    """Exact per-row top-k of the score matrix, never materialized on
    the card: K1 writes stripe candidates, pass 2 (stable sorts) reduces
    them. Returns (values f32 [N, k], columns int64 [N, k]).
    ``limbs`` and ``stripe_tiles``: as for
    :func:`topk_twopass_candidates` (unused on the CPU; the autotuner
    races ``stripe_tiles``)."""
    _check_factor(c, d)
    if k > CAND_MAX:
        raise ValueError(f"fused_topk_twopass supports k <= {CAND_MAX}")
    if _device_kind(c) == "cpu":
        return fused_topk_twopass_plain(c, d, k=k, mask_self=mask_self)
    c, d = kernel_operands(c, d)
    vals, cols = topk_twopass_candidates(c, d, k, mask_self, limbs=limbs,
                                         stripe_tiles=stripe_tiles)
    n = c.shape[0]
    fv, fc = sparse.chunked_row_topk(vals.view(n, -1), cols.view(n, -1), k)
    return fv, fc.long()


def fused_scores(c: torch.Tensor, d: torch.Tensor,
                 limbs: Limbs | None = None) -> torch.Tensor:
    """All-pairs scores S [N, N] f32 (K2 on the card). ``limbs``: the
    factor already split (:func:`split_limbs`); otherwise it is split
    here, raising ValueError for entries that are not integers in
    [0, 2²⁴). Unused on the CPU."""
    _check_factor(c, d)
    if _device_kind(c) == "cpu":
        return fused_scores_plain(c, d)
    c, d = kernel_operands(c, d)
    _check_kernel_input(c, d)
    n = c.shape[0]
    out = torch.empty((n, n), dtype=torch.float32, device=c.device)
    if n:
        lim = _square_limbs(c, limbs)
        wide = _needs_wide(lim, lim)
        _launch("fused_scores", c.device, lim.planes.data_ptr(),
                lim.planes.shape[0], lim.planes.stride(0),
                lim.planes.shape[2], d.data_ptr(), n,
                _stripe_tiles_for_units(n, n, RECT_TARGET_UNITS),
                lim.blocks.data_ptr(),
                lim.order.data_ptr(),
                lim.sub.data_ptr(), int(wide), out.data_ptr())
        WIDE_ROW_BLOCKS["fused_scores"] += wide * lim.order.shape[0]
    return out


def topk_rect_candidates(c_rows, c_cols, d_rows, d_cols, row_ids, k: int,
                         n_true_cols: int | None = None,
                         stripe_tiles: int | None = None,
                         limbs: tuple[Limbs, Limbs] | None = None):
    """Launch K3: each row's top-k per stripe of ``stripe_tiles * TILE``
    columns (default :func:`rect_stripe_tiles`), values f32 and global
    columns int32, [T, n_stripes, k]. ``row_ids`` is int32 [T] on the
    card. ``limbs`` is (row limbs, column limbs) of the two factors when
    the caller has split them already (:func:`rect_pad_factor`);
    otherwise both are split here, raising ValueError for entries that
    are not integers in [0, 2²⁴)."""
    _check_rect(c_rows, c_cols, d_rows, d_cols, row_ids)
    _check_kernel_input(c_rows, d_rows)
    _check_kernel_input(c_cols, d_cols)
    c_rows, d_rows = kernel_operands(c_rows, d_rows)
    c_cols, d_cols = kernel_operands(c_cols, d_cols)
    if row_ids.dtype != torch.int32 or not row_ids.is_contiguous():
        raise ValueError("K3 takes contiguous int32 row ids")
    if not 1 <= k <= CAND_MAX:
        raise ValueError(f"topk_rect_candidates needs 1 <= k <= {CAND_MAX}")
    t, v = c_rows.shape
    n = c_cols.shape[0]
    if stripe_tiles is None:
        stripe_tiles = rect_stripe_tiles(t, n, v, k, c_rows.device)
    if stripe_tiles < 1:
        raise ValueError("stripe_tiles must be >= 1")
    n_true = n if n_true_cols is None else int(n_true_cols)
    if not 0 <= n_true <= n:
        raise ValueError(f"n_true_cols {n_true} outside [0, {n}]")
    n_st = _rect_n_stripes(n, stripe_tiles)
    vals = torch.empty((t, n_st, k), dtype=torch.float32, device=c_rows.device)
    cols = torch.empty((t, n_st, k), dtype=torch.int32, device=c_rows.device)
    if t and n:
        lr, lc = limbs if limbs is not None else (split_limbs(c_rows),
                                                  split_limbs(c_cols))
        _check_limbs(lr, t, v, c_rows.device)
        _check_limbs(lc, n, v, c_rows.device)
        if lr.planes.shape[2] != lc.planes.shape[2]:
            raise ValueError("row and column limbs differ in width")
        d_min = _subtile_min(d_cols, 2 * -(-n // TILE))
        wide = _needs_wide(lr, lc)
        _launch(
            "topk_rect_candidates", c_rows.device,
            lr.planes.data_ptr(), lr.planes.shape[0], lr.planes.stride(0),
            d_rows.data_ptr(), row_ids.data_ptr(), t,
            lc.planes.data_ptr(), lc.planes.shape[0], lc.planes.stride(0),
            d_cols.data_ptr(), n, n_true, lr.planes.shape[2], k,
            stripe_tiles, lr.blocks.data_ptr(), lr.order.data_ptr(),
            lc.sub.data_ptr(), d_min.data_ptr(), int(wide),
            vals.data_ptr(), cols.data_ptr(),
        )
        WIDE_ROW_BLOCKS["topk_rect_candidates"] += wide * lr.order.shape[0]
    return vals, cols


def fused_topk_twopass_rect(c_rows, c_cols, d_rows, d_cols, row_ids,
                            k: int = 10, n_true_cols: int | None = None,
                            limbs: tuple[Limbs, Limbs] | None = None,
                            stripe_tiles: int | None = None):
    """Exact per-row top-k of the [T, N] score block of a row tile
    against every column, self pairs and columns >= ``n_true_cols``
    excluded, never materialized on the card: K3 writes stripe
    candidates, pass 2 (stable sorts) reduces them. Returns (values f32
    [T, k], columns int64 [T, k]). ``limbs`` and ``stripe_tiles``: as
    for :func:`topk_rect_candidates` (unused on the CPU; the autotuner
    races ``stripe_tiles``)."""
    _check_rect(c_rows, c_cols, d_rows, d_cols, row_ids)
    if not rect_supported(c_rows.shape[1], k):
        raise ValueError(f"fused_topk_twopass_rect requires k<{CAND_MAX}")
    if _device_kind(c_rows) == "cpu":
        return fused_topk_twopass_rect_plain(
            c_rows, c_cols, d_rows, d_cols, row_ids, k=k,
            n_true_cols=n_true_cols,
        )
    c_rows, d_rows = kernel_operands(c_rows, d_rows)
    c_cols, d_cols = kernel_operands(c_cols, d_cols)
    vals, cols = topk_rect_candidates(c_rows, c_cols, d_rows, d_cols,
                                      row_ids, k, n_true_cols,
                                      stripe_tiles=stripe_tiles, limbs=limbs)
    t = c_rows.shape[0]
    fv, fc = sparse.chunked_row_topk(vals.view(t, -1), cols.view(t, -1), k)
    return fv, fc.long()


def fused_topk(c: torch.Tensor, d: torch.Tensor, k: int = 10,
               mask_self: bool = True, limbs: Limbs | None = None):
    """Single-pass per-row top-k for any k (K4 on the card): values f32
    [N, k], columns int64 [N, k], ordered (descending score, ascending
    column); a row with fewer than k finite scores gets distinct
    ascending -inf columns. ``limbs``: the factor already split
    (:func:`split_limbs`); otherwise it is split here, raising
    ValueError for entries that are not integers in [0, 2²⁴)."""
    _check_factor(c, d)
    if k < 1:
        raise ValueError("fused_topk needs k >= 1")
    if _device_kind(c) == "cpu":
        return fused_topk_plain(c, d, k=k, mask_self=mask_self)
    c, d = kernel_operands(c, d)
    _check_kernel_input(c, d)
    n = c.shape[0]
    if max(n, k) >= 2**31 - TILE or n * k >= 2**31:
        raise ValueError(f"fused_topk with n={n}, k={k} exceeds the "
                         "kernel's int32 column range")
    # one buffer: K4 finds a row's columns n * k slots after its values
    buf = torch.empty(2 * n * k, dtype=torch.int32, device=c.device)
    vals = buf[:n * k].view(torch.float32).view(n, k)
    idxs = buf[n * k:].view(n, k)
    if n:
        lim = _square_limbs(c, limbs)
        d_min = _subtile_min(d, 2 * -(-max(n, k) // TILE))
        _launch_square(
            "topk_fold", c.device, lim,
            (lim.planes.data_ptr(), lim.planes.shape[0],
             lim.planes.stride(0), lim.planes.shape[2], d.data_ptr(), n, k,
             int(mask_self), lim.blocks.data_ptr()),
            (lim.sub.data_ptr(), d_min.data_ptr(), vals.data_ptr(),
             idxs.data_ptr()))
    return vals, idxs.long()


# -- the exact instances of K1 and K4 ------------------------------------------


def _check_exact_factor(c: torch.Tensor, d: torch.Tensor) -> None:
    if c.dtype not in _FACTOR_DTYPES or d.dtype != torch.float64:
        raise TypeError(
            "the exact instances take a float32 or float64 factor and "
            f"float64 denominators, got {c.dtype} / {d.dtype}"
        )
    if c.dim() != 2 or d.shape != (c.shape[0],):
        raise ValueError(
            f"factor shapes {tuple(c.shape)} / {tuple(d.shape)} do not match"
        )
    if c.device != d.device:
        raise ValueError(f"factor on {c.device}, denominators on {d.device}")


def _exact_operands(c: torch.Tensor, d: torch.Tensor, limbs: Limbs | None,
                    width: int):
    """What an exact launch reads besides its outputs: the factor's
    limbs, d's f32 roundings (the prefilter's) and their least value per
    subtile, for the subtiles of ``width`` columns padded to whole
    tiles."""
    lim = _square_limbs(c, limbs)
    d32 = d.to(torch.float32)
    return lim, d32, _subtile_min(d32, 2 * -(-width // TILE))


def topk_twopass_candidates_exact(c: torch.Tensor, d: torch.Tensor, k: int,
                                  mask_self: bool, limbs: Limbs | None = None,
                                  stripe_tiles: int | None = None,
                                  scored: torch.Tensor | None = None):
    """Launch K1's exact instance: each row's top-k per stripe of
    ``stripe_tiles * TILE`` columns (default :func:`twopass_stripe_tiles`
    at 12-byte candidates) of the scores ``2·M / (d_i + d_j)`` correctly
    rounded in f64, M the exact counts of ``c``'s limbs and ``d`` the
    exact denominators (float64 integers below 2⁵²: the caller's
    guarantee). Values float64 and global columns int32, each [N,
    n_stripes, k]. ``scored``: an int64 device tensor the launch adds the
    count of elements it scored in f64 to (None: not counted)."""
    _check_exact_factor(c, d)
    _check_kernel_input(c, d)
    if not 1 <= k <= CAND_MAX:
        raise ValueError(f"topk_twopass_candidates needs 1 <= k <= {CAND_MAX}")
    n = c.shape[0]
    if stripe_tiles is None:
        stripe_tiles = twopass_stripe_tiles(n, c.shape[1], k, c.device,
                                            exact=True)
    if stripe_tiles < 1:
        raise ValueError("stripe_tiles must be >= 1")
    n_st = _rect_n_stripes(n, stripe_tiles)
    vals = torch.empty((n, n_st, k), dtype=torch.float64, device=c.device)
    cols = torch.empty((n, n_st, k), dtype=torch.int32, device=c.device)
    if n:
        lim, d32, d_min = _exact_operands(c, d, limbs, n)
        _launch_square(
            "topk_twopass_exact", c.device, lim,
            (lim.planes.data_ptr(), lim.planes.shape[0],
             lim.planes.stride(0), lim.planes.shape[2], d.data_ptr(),
             d32.data_ptr(), n, k, int(mask_self), stripe_tiles,
             lim.blocks.data_ptr()),
            (lim.sub.data_ptr(), d_min.data_ptr(), vals.data_ptr(),
             cols.data_ptr(), None if scored is None else scored.data_ptr()))
        TWOPASS_STRIPES["topk_twopass_exact"] += n_st
    return vals, cols


def fused_topk_twopass_exact(c: torch.Tensor, d: torch.Tensor, k: int = 10,
                             mask_self: bool = True,
                             limbs: Limbs | None = None,
                             stripe_tiles: int | None = None):
    """Exact per-row top-k of the scores ``2·M / (d_i + d_j)`` of the
    exact counts M (``c`` holds integer counts) and exact denominators
    ``d`` (float64), each correctly rounded in f64 (0 where d_i + d_j is
    0), ordered (descending score, ascending column): K1's exact instance,
    then pass 2 on f64 keys in a ``backend.pass2`` span, which carries
    the count of elements K1 scored in f64 (``f64_scores``). On the CPU
    the plain version in float64. Returns (values float64 [N, k],
    columns int64 [N, k])."""
    _check_exact_factor(c, d)
    if k > CAND_MAX:
        raise ValueError(f"fused_topk_twopass_exact supports k <= {CAND_MAX}")
    if _device_kind(c) == "cpu":
        return fused_topk_twopass_plain(c.double(), d, k=k,
                                        mask_self=mask_self)
    scored = torch.zeros(1, dtype=torch.int64, device=c.device)
    vals, cols = topk_twopass_candidates_exact(
        c, d, k, mask_self, limbs=limbs, stripe_tiles=stripe_tiles,
        scored=scored)
    n, w = c.shape[0], vals.shape[1] * k
    tracer = get_tracer()
    with tracer.span(PASS2_SPAN, device=c.device) as span:
        tracer.defer_arg(span, "f64_scores", scored)
        # one stable sort a row: its n_stripes * k candidates are few
        fv, fc = sparse.chunked_row_topk(vals.view(n, w), cols.view(n, w),
                                         k, chunk=w)
    return fv, fc.long()


def fused_topk_exact(c: torch.Tensor, d: torch.Tensor, k: int = 10,
                     mask_self: bool = True, limbs: Limbs | None = None):
    """:func:`fused_topk_twopass_exact`'s function for any k: K4's exact
    instance on the card, the plain version in float64 on the CPU.
    Values float64 [N, k], columns int64 [N, k]; a row with fewer than k
    finite scores gets distinct ascending -inf columns."""
    _check_exact_factor(c, d)
    if k < 1:
        raise ValueError("fused_topk needs k >= 1")
    if _device_kind(c) == "cpu":
        return fused_topk_plain(c.double(), d, k=k, mask_self=mask_self)
    _check_kernel_input(c, d)
    n = c.shape[0]
    if max(n, k) >= 2**31 - TILE or 2 * n * k >= 2**31:
        raise ValueError(f"fused_topk_exact with n={n}, k={k} exceeds the "
                         "kernel's int32 column range")
    # one buffer: K4 finds a row's columns 2 * n * k 4-byte slots after
    # its values
    buf = torch.empty(3 * n * k, dtype=torch.int32, device=c.device)
    vals = buf[:2 * n * k].view(torch.float64).view(n, k)
    idxs = buf[2 * n * k:].view(n, k)
    if n:
        lim, d32, d_min = _exact_operands(c, d, limbs, max(n, k))
        _launch_square(
            "topk_fold_exact", c.device, lim,
            (lim.planes.data_ptr(), lim.planes.shape[0],
             lim.planes.stride(0), lim.planes.shape[2], d.data_ptr(),
             d32.data_ptr(), n, k, int(mask_self), lim.blocks.data_ptr()),
            (lim.sub.data_ptr(), d_min.data_ptr(), vals.data_ptr(),
             idxs.data_ptr()))
    return vals, idxs.long()


# -- budgets ----------------------------------------------------------------


def _usable_tuned(value, most: int | None, buffer_bytes, device) -> bool:
    """Whether a tuned stripe width or unit target can run: an int of at
    least 1 (and at most ``most``: the factor's column tiles, for a
    width) whose candidate buffer (``buffer_bytes(value)``) fits the
    budget when ``device`` is a card (on the CPU no kernel and no buffer
    runs)."""
    if isinstance(value, bool) or not isinstance(value, int):
        return False
    if value < 1 or (most is not None and value > most):
        return False
    if torch.device(device).type != "cuda":
        return True
    return buffer_bytes(value) <= candidate_budget_bytes(device)


def default_twopass_stripe_tiles(n: int) -> int:
    """The untuned K1 stripe width for N rows: K3's rule, stripes only as
    narrow as gives about :data:`RECT_TARGET_UNITS` (row block, stripe)
    units to fill the card. 8 tiles at 8,192 rows, 128 (2 stripes) at
    32,768, and from 512 row blocks (65,536 rows) on the whole width: one
    list a row over all columns, so a row's list never restarts."""
    return _stripe_tiles_for_units(n, n, RECT_TARGET_UNITS)


def _slot_bytes(exact: bool) -> int:
    """Bytes of one K1 candidate: an f32 (f64 for the exact instance)
    value and an int32 column."""
    return 12 if exact else 8


def twopass_stripe_tiles(n: int, v: int, k: int, device,
                         exact: bool = False) -> int:
    """Column tiles per K1 stripe for an [N, V] factor at top-``k`` on
    ``device`` (``exact``: for the exact instance's 12-byte candidates):
    the ``twopass_stripe_tiles`` knob of the tuning table, keyed on (N,
    V), else :func:`default_twopass_stripe_tiles`. A tuned width below 1,
    wider than the factor or, on a card, whose candidate buffer passes
    the budget, is a ``fallback`` lookup and the heuristic runs; so is a
    width narrower than the default taken from another (N, V) bucket
    (the width that fills the card follows N, so only a width measured
    at this bucket may restart a row's list more often than the default
    does). The one decision point:
    :func:`candidate_bytes`, :func:`twopass_fits` and K1's launch all
    take their width here, so a gate never sees another width than the
    kernel runs."""
    from .. import tuning

    n_ct = max(1, -(-n // TILE))
    default = default_twopass_stripe_tiles(n)
    return tuning.choose(
        "twopass_stripe_tiles", n=n, v=v,
        default=default,
        valid=lambda w: _usable_tuned(
            w, n_ct,
            lambda w: n * _rect_n_stripes(n, w) * k * _slot_bytes(exact),
            device),
        valid_near=lambda w: w >= default,
    )


def candidate_bytes(n: int, k: int, v: int, device,
                    exact: bool = False) -> int:
    """K1's candidate buffer: N · n_stripes · k · (4 + 4) bytes (8 + 4
    for the exact instance), stripes of :func:`twopass_stripe_tiles`
    column tiles: N · k · 8 (12) bytes from 65,536 rows on, where the
    default runs one stripe."""
    return n * _rect_n_stripes(
        n, twopass_stripe_tiles(n, v, k, device, exact)) * k \
        * _slot_bytes(exact)


def candidate_budget_bytes(device) -> int:
    """How much of the card the candidate buffer may take: an eighth of
    its memory (pass 2's sorts need about twice the buffer again)."""
    return torch.cuda.get_device_properties(device).total_memory // 8


def twopass_fits(n: int, k: int, device, v: int, exact: bool = False) -> bool:
    """Whether K1's candidate buffer (its exact instance's with
    ``exact``) fits the budget on ``device`` (the port's counterpart of
    the TPU gate of the same name), at the width K1 would run an [N, V]
    factor with. At the default width's one stripe the buffer is N · k
    slots, so every N whose dense factor the card holds passes, and the
    dense rank-all stays on K1 (its rect arm takes only a buffer over the
    budget). Only the kernel has a candidate buffer: on the CPU the
    plain version runs, so every shape passes there."""
    if torch.device(device).type != "cuda":
        return True
    return (candidate_bytes(n, k, v, device, exact)
            <= candidate_budget_bytes(device))


# -- K3's gates (the port's counterparts of the TPU gates of the same names)


def rect_supported(v: int, k: int) -> bool:
    """K3 takes any factor width (the V loop is inside the block); the
    one gate is the JAX package's k < 16, kept so both packages route
    the same k to the same arm."""
    return 1 <= k < CAND_MAX


def _stripe_tiles_for_units(t: int, n: int, units: int) -> int:
    """Column tiles per stripe of a [t, n] block that give about
    ``units`` (128-row block, stripe) units."""
    n_ct = max(1, -(-n // TILE))
    row_blocks = max(1, -(-t // TILE))
    n_stripes = min(n_ct, -(-units // row_blocks))
    return -(-n_ct // n_stripes)


def rect_stripe_tiles(t: int, n: int, v: int, k: int, device) -> int:
    """Column tiles per K3 stripe for a [t, n] block of width V at
    top-``k`` on ``device``: one K3
    block owns one (128-row block, stripe) unit, and stripes are made as
    narrow as gives about ``rect_target_units`` units — the tuning
    table's knob, keyed on (N, V), else :data:`RECT_TARGET_UNITS`. Many
    units let the card balance them (the multi-limb row blocks are
    launched first); a row's list restarts per stripe, at a cost growing
    only with the log of the stripe's width, and pass 2 reduces one set
    of k candidates per stripe. At t = 8192, n = 1M: 8 stripes of 1024
    tiles (131072 columns). A tuned target below 1 or, on a card, whose
    candidate buffer passes the budget, is a ``fallback`` lookup and the
    default runs. The one decision point, as
    :func:`twopass_stripe_tiles` is K1's: :func:`rect_candidate_bytes`,
    :func:`rect_fits` and K3's launch all take their width here."""
    from .. import tuning

    units = tuning.choose(
        "rect_target_units", n=n, v=v, default=RECT_TARGET_UNITS,
        valid=lambda u: _usable_tuned(
            u, None,
            lambda u: t * _rect_n_stripes(
                n, _stripe_tiles_for_units(t, n, u)) * k * 8,
            device),
    )
    return _stripe_tiles_for_units(t, n, units)


def rect_candidate_bytes(n_cols: int, tile_rows: int, k: int, v: int,
                         device) -> int:
    """K3's candidate buffer for one row tile: T · n_stripes · k ·
    (4 + 4) bytes. 5.2 MB at T = 8192, N = 1M, k = 10."""
    n_st = _rect_n_stripes(
        n_cols, rect_stripe_tiles(tile_rows, n_cols, v, k, device))
    return tile_rows * n_st * k * 8


def rect_fits(n_cols: int, tile_rows: int, k: int, device,
              v: int) -> bool:
    """Whether one row tile's K3 candidate buffer fits the same budget
    as K1's (an eighth of the card: pass 2's sorts need about twice the
    buffer again), at the width K3 would run a [tile_rows, V] tile
    against ``n_cols`` columns with. Only the kernel has a candidate
    buffer: on the CPU every shape passes."""
    if torch.device(device).type != "cuda":
        return True
    return (rect_candidate_bytes(n_cols, tile_rows, k, v, device)
            <= candidate_budget_bytes(device))


def kernel_limbs(c: torch.Tensor) -> Limbs | None:
    """The factor's limbs where a kernel will read them: split once
    (:func:`split_limbs`) for a CUDA factor, None on the CPU, where the
    plain versions take any f32. A backend keeps them beside its factor
    and hands them to every launch, so no call pays the split."""
    if c.device.type != "cuda":
        return None
    with get_tracer().span("backend.limbs", device=c.device) as span:
        limbs = split_limbs(c)
        if span is not None:
            span.args["bytes"] = sum(part.nbytes for part in limbs)
    return limbs


def rect_pad_factor(c: torch.Tensor, d: torch.Tensor,
                    limbs: Limbs | None = None):
    """The factor and denominators as K3 takes them, made once per pass
    so that no row-tile launch splits them again: contiguous float32,
    and the factor's limbs (``limbs`` when the caller has split the
    factor already, else :func:`kernel_limbs`; a row tile's are
    ``limbs.rows(i0, i1)``). Unlike the TPU kernel's, K3 masks its
    ragged edges itself, so nothing is padded."""
    with get_tracer().span("backend.factor", device=c.device) as span:
        cc = c.to(torch.float32).contiguous()
        dc = d.to(torch.float32).contiguous()
        if span is not None:  # the bytes of the copies made (none of f32)
            span.args["bytes"] = sum(new.nbytes for new, old in
                                     ((cc, c), (dc, d)) if new is not old)
    if limbs is None:
        limbs = kernel_limbs(cc)
    return cc, dc, limbs
