"""Neural PathSim: a factorized analytic index + learned compact embeddings.

Exact PathSim ranks with O(N·V) work per query and cannot score nodes
added after encoding. This module provides two inner-product indexes
over the half-chain factor C (built sparsely — the dense N×P
intermediate of the naive chain product never exists):

1. **Structural (Cauchy-quadrature) index** — the rowsum-variant score
   2·(C_i·C_j)/(d_i+d_j) looks non-factorizable because the denominator
   couples i and j additively, but the Cauchy kernel identity
   1/(d_i+d_j) = ∫₀^∞ e^(-t·d_i) · e^(-t·d_j) dt turns it into an inner
   product: with log-spaced quadrature nodes t_k and weights w_k,
   φ(j) = vec_k( sqrt(2·w_k) · e^(-d_j·t_k) · C_j ) ∈ R^(m·V)
   satisfies φ(i)·φ(j) ≈ score(i,j) to a few percent relative error.
   No training; inductive (new nodes embed analytically from their C
   row). The ANN index (index/build.py) embeds every node with that map.

2. **Learned compact index** — a two-tower MLP compresses the same
   information into d≪m·V dims for O(d) queries, trained with a
   listwise ranking loss (per-source KL against the exact-score
   distribution over a candidate slate) plus a Huber calibration term
   that keeps raw inner products in score units for ``predict_pairs``.

This is the port of the JAX package's ``models/neural.py``. The host
numpy parts (the factor, features, quadrature, target scale, the CSR/CSC
pools, slate sampling, the struct index and the exact rerank) are copies
that give bit-identical arrays; the tower is a ``torch.nn.Module`` with
flax's parameter layout (``Dense_i.kernel`` [in, out], ``Dense_i.bias``)
and flax's default initialisation, trained by torch autograd with
optax's ``clip_by_global_norm(1.0)`` + ``adam(lr)`` written out in torch
ops, on the card unless the caller asks for the CPU. Checkpoints are the
JAX package's ``.npz`` with flax-msgpack blobs (``flax_msgpack.py``), so
either package loads the other's.

Under a :class:`~..parallel.mesh.Mesh` the source axis of a slate batch
is split into contiguous per-shard blocks, each shard computes its
block's share of the global mean loss on its own device, and the
gradients are summed with ``mesh.psum`` before the clip: the
single-device step up to reduction order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..data.encode import EncodedHIN
from ..ops.metapath import MetaPath, compile_metapath

# Quadrature width of the structural index: m log-spaced nodes cover the
# full observed range of 2·d with ~3% max relative error (m=12, margin=2
# measured 7.1%-max/1.5%-mean on 9 decades in the JAX package).
QUAD_M = 12


def cauchy_quadrature(
    d: np.ndarray, m: int = 12, margin: float = 2.0
) -> tuple[np.ndarray, np.ndarray]:
    """Log-spaced quadrature (nodes t, weights w) for the Cauchy kernel
    identity 1/(d_i+d_j) = ∫₀^∞ e^(-t·d_i)·e^(-t·d_j) dt over the
    observed denominator range: s = d_i + d_j ∈ [2·min d⁺, 2·max d],
    extended by ``margin`` on each side in u = log t (the trapezoid
    rule needs tail room for uniform relative accuracy). Shared by the
    trainer's feature gates and the index's analytic embedding map."""
    d = np.asarray(d, dtype=np.float64)
    dpos = d[d > 0]
    if not dpos.size:  # degenerate graph: every denominator is zero
        return np.zeros(m), np.zeros(m)
    s_lo = max(2.0 * float(dpos.min()), 1e-12)
    s_hi = max(2.0 * float(dpos.max()), s_lo * (1.0 + 1e-9))
    u = np.linspace(
        np.log(1.0 / s_hi) - margin, np.log(1.0 / s_lo) + margin, m
    )
    h = float(u[1] - u[0]) if m > 1 else 1.0
    t = np.exp(u)
    return t, h * t


def quadrature_gates(d: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Denominator gates E[j,k] = e^(-d_j·t_k) ∈ [0,1] (f32): the
    complete quadrature picture of 1/(d_j + ·)."""
    return np.exp(
        -np.clip(
            np.asarray(d, np.float64)[:, None] * np.asarray(t)[None, :],
            0.0, 700.0,
        )
    ).astype(np.float32)


# -- the tower -------------------------------------------------------------

# flax's lecun_normal: a normal truncated to [-2, 2] standard deviations,
# rescaled by the truncated distribution's standard deviation so the
# kernel's variance is 1/fan_in (jax.nn.initializers.variance_scaling).
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], f32 on the CPU, drawn as
    ``jax.random.truncated_normal`` draws: a uniform between Φ(-2) and
    Φ(2), mapped through √2·erfinv, clipped inside the bounds."""
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32)
    lo, hi = torch.erf(torch.tensor([-2.0, 2.0]) / sqrt2)
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    out = sqrt2 * torch.erfinv(lo + (hi - lo) * u)
    bound = torch.nextafter(torch.tensor(2.0), torch.tensor(0.0))
    return out.clamp(-bound, bound)


class Dense(nn.Module):
    """flax ``nn.Dense``'s parameters: y = x @ kernel + bias, kernel
    [in, out] (applied by :func:`tower_apply`)."""

    def __init__(self, features_in: int, features_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features_in, features_out))
        self.bias = nn.Parameter(torch.zeros(features_out))


def tower_apply(params: Sequence[torch.Tensor], x: torch.Tensor):
    """The tower's forward over explicit ``(kernel, bias) × 3``: three
    dense layers, ReLU after the first two (the sharded step runs it on
    per-device copies of the parameters)."""
    k0, b0, k1, b1, k2, b2 = params
    x = torch.relu(x @ k0 + b0)
    x = torch.relu(x @ k1 + b1)
    return x @ k2 + b2


class TwoTower(nn.Module):
    """Shared-weight encoder tower: features → embedding. Parameters in
    flax's layout and names (``Dense_0..Dense_2``, each ``kernel`` [in,
    out] and ``bias`` [out]), initialised as flax's ``nn.Dense`` does
    (lecun_normal kernels, zero biases) from an explicit CPU
    generator."""

    def __init__(self, features: int, hidden: int = 128, dim: int = 64,
                 seed: int = 0):
        super().__init__()
        self.hidden, self.dim = hidden, dim
        self.Dense_0 = Dense(features, hidden)
        self.Dense_1 = Dense(hidden, hidden)
        self.Dense_2 = Dense(hidden, dim)
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        with torch.no_grad():
            for layer in (self.Dense_0, self.Dense_1, self.Dense_2):
                fan_in = layer.kernel.shape[0]
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                layer.kernel.copy_(
                    _truncated_normal(layer.kernel.shape, gen) * std
                )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tower_apply(list(self.parameters()), x)


_LAYERS = ("Dense_0", "Dense_1", "Dense_2")


def _flax_tree(model: TwoTower, tensors: Sequence[torch.Tensor]) -> dict:
    """Per-parameter tensors (the module's order) → the JAX package's
    parameter pytree layout, ``{"params": {"Dense_i": {"bias",
    "kernel"}}}``, as host numpy f32 (keys sorted, as an optax-updated
    flax tree holds them)."""
    named = dict(zip([n for n, _ in model.named_parameters()], tensors))
    return {"params": {
        name: {leaf: named[f"{name}.{leaf}"].detach().cpu().numpy().copy()
               for leaf in ("bias", "kernel")}
        for name in _LAYERS
    }}


def _flax_tensors(model: TwoTower, tree: dict, device) -> list[torch.Tensor]:
    """The parameter pytree layout → per-parameter tensors in the
    module's order, on ``device``; shapes must match the tower's."""
    out = []
    for name, p in model.named_parameters():
        layer, leaf = name.split(".")
        arr = np.asarray(tree["params"][layer][leaf], dtype=np.float32)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                             f"tower shape {tuple(p.shape)}")
        out.append(torch.tensor(arr, device=device))
    return out


def params_to_flax(model: TwoTower) -> dict:
    """The JAX package's parameter pytree of ``model`` (host numpy)."""
    return _flax_tree(model, list(model.parameters()))


def params_from_flax(tree: dict, model: TwoTower) -> TwoTower:
    """Copy the JAX package's parameter pytree (numpy or array-like
    leaves) into ``model`` in place. Returns it."""
    device = next(model.parameters()).device
    with torch.no_grad():
        for p, src in zip(model.parameters(),
                          _flax_tensors(model, tree, device)):
            p.copy_(src)
    return model


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the int32 step ``count`` and the
    moments ``mu`` / ``nu``, one tensor per tower parameter (the
    module's parameter order)."""

    count: torch.Tensor
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: TwoTower
    opt_state: AdamState
    step: int = 0


class NeuralPathSim:
    """Trainer + index for embedding-based PathSim approximation."""

    # Optimizer-state pytree identity, stamped into checkpoints and
    # verified on load: a checkpoint saved under a different optimizer
    # chain fails with a NAMED error, not a msgpack mismatch. The string
    # names the algorithm; the JAX package's checkpoints carry the same.
    _OPT_FORMAT = "clip1.0-adam-huber5-v2"
    # optax.adam's defaults and the clip of the chain
    _B1, _B2, _EPS, _EPS_ROOT, _MAX_NORM = 0.9, 0.999, 1e-8, 0.0, 1.0
    _HUBER_DELTA = 5.0

    def __init__(
        self,
        hin: EncodedHIN,
        metapath: MetaPath | str,
        dim: int = 64,
        hidden: int = 128,
        lr: float = 1e-3,
        mesh=None,
        seed: int = 0,
        variant: str = "rowsum",
        device=None,
    ):
        self.hin = hin
        self.metapath = (
            compile_metapath(metapath, hin.schema)
            if isinstance(metapath, str)
            else metapath
        )
        if not self.metapath.is_symmetric:
            raise ValueError("NeuralPathSim needs a symmetric metapath")
        self._place(mesh, device)

        # Sparse half-chain fold straight to [N, V] (V is the small
        # contraction width); the dense [N, P] intermediate never exists.
        from ..ops import planner

        c = planner.dense_half(hin, self.metapath)
        self._setup_from_c(
            c, dim=dim, hidden=hidden, lr=lr, seed=seed, variant=variant
        )

    QUAD_M = QUAD_M
    _QUAD_MARGIN = 2.0

    def _place(self, mesh, device) -> None:
        """The device of the tower and optimizer state: the mesh's first
        shard, else ``device`` (None: CUDA; DeviceUnavailable without a
        card)."""
        from ..utils.device import resolve_device

        if mesh is not None and mesh.multiprocess:
            raise ValueError(
                "NeuralPathSim trains in one process; pass a mesh of this "
                "process's shards"
            )
        self.mesh = mesh
        self.device = (resolve_device(mesh.devices[0]) if mesh is not None
                       else resolve_device(device))

    def _setup_from_c(
        self, c: np.ndarray, dim: int, hidden: int, lr: float, seed: int,
        variant: str = "rowsum",
        target_scale: float | None = None,
        quad: tuple[np.ndarray, np.ndarray] | None = None,
    ) -> None:
        """Derive all trainer state from the half-chain factor C — shared
        by the constructor and :meth:`load`. ``target_scale`` and
        ``quad`` (nodes, weights) override the from-C derivation when
        restoring a checkpoint: both must match what the params were
        trained against, and a recompute from the f32-cast stored C
        could drift."""
        from ..ops.pathsim import VARIANTS

        if variant not in VARIANTS:
            raise ValueError(
                f"unknown PathSim variant {variant!r}; choose {VARIANTS}"
            )
        self.variant = variant
        self._config = {"dim": dim, "hidden": hidden, "lr": lr,
                        "seed": seed, "variant": variant}
        self.n, self.v = c.shape
        # Exact targets are computed on demand per batch from C — never
        # the dense N×N matrix. The variant choice is made once, here.
        self._c64 = c.astype(np.float64)
        if variant == "rowsum":
            self._d = self._c64 @ self._c64.sum(axis=0)  # rowsums of M
        else:  # diagonal: diag(M)[i] = Σ_v C[i,v]²
            self._d = np.einsum("nv,nv->n", self._c64, self._c64)
        if quad is not None:
            self._quad_t = np.asarray(quad[0], dtype=np.float64)
            self._quad_w = np.asarray(quad[1], dtype=np.float64)
        else:
            self._quad_t, self._quad_w = cauchy_quadrature(
                self._d, m=self.QUAD_M, margin=self._QUAD_MARGIN
            )
        self._gates = quadrature_gates(self._d, self._quad_t)
        # Positive-sample pool without touching M: a pair sharing any
        # contraction column has M[i,j] > 0, so sample a nonzero of C then
        # a co-occupant of its column (CSC column lists, O(1) draws).
        # np.nonzero is row-major, so the same arrays are a CSR layout.
        nz_i, nz_v = np.nonzero(c)
        self._row_ptr = np.searchsorted(nz_i, np.arange(self.n + 1))
        self._row_cols = nz_v
        order = np.argsort(nz_v, kind="stable")
        self._nz_rows, nz_cols = nz_i[order], nz_v[order]
        self._col_ptr = np.searchsorted(nz_cols, np.arange(self.v + 1))
        # features: unit-L2 C rows | scaled log-degree | quadrature gates
        norms = np.linalg.norm(c, axis=1, keepdims=True)
        c_norm = (c / np.where(norms > 0, norms, 1)).astype(np.float32)
        deg = np.log1p(self._d)
        deg = (deg / max(float(deg.max(initial=0.0)), 1.0)).astype(np.float32)
        self.features = np.concatenate(
            [c_norm, deg[:, None], self._gates], axis=1
        )
        # Standardized regression target: scale so the mean positive
        # target is O(1) (persisted in checkpoints).
        if target_scale is not None:
            self.target_scale = float(target_scale)
        else:
            rng0 = np.random.default_rng(seed)
            nnz = len(self._nz_rows)
            if nnz:
                sel = rng0.integers(0, nnz, size=min(4096, nnz))
                pr = self._nz_rows[sel]
                v0 = np.searchsorted(self._col_ptr, sel, side="right") - 1
                lo, hi = self._col_ptr[v0], self._col_ptr[v0 + 1]
                pc = self._nz_rows[
                    lo + rng0.integers(0, np.maximum(hi - lo, 1))
                ]
                pos = self.pair_scores(pr, pc)
                mean_pos = (
                    float(pos[pos > 0].mean()) if (pos > 0).any() else 0.0
                )
            else:
                mean_pos = 0.0
            self.target_scale = 1.0 / mean_pos if mean_pos > 0 else 1.0
        self._scores_cache: np.ndarray | None = None
        self._emb_cache: np.ndarray | None = None
        self._struct_cache: np.ndarray | None = None
        self._c32_cache: np.ndarray | None = None
        self._feat_dev: dict | None = None
        # Hard-candidate pool (mine_hard_candidates / set_hard_pool); not
        # persisted by save(): mining is a cheap, deterministic pass.
        self._hard_src: np.ndarray | None = None
        self._hard_cand: np.ndarray | None = None

        self.lr = float(lr)
        # the step's device constants, made once (a captured step may not
        # copy from the host): Adam's decays and the Huber delta
        self._decays = tuple(torch.tensor(b, dtype=torch.float32,
                                          device=self.device)
                             for b in (self._B1, self._B2))
        self._delta = torch.tensor(self._HUBER_DELTA, dtype=torch.float32,
                                   device=self.device)
        self._graphs: dict = {}
        self.model = TwoTower(
            self.features.shape[1], hidden=hidden, dim=dim, seed=seed
        ).to(self.device)
        params = list(self.model.parameters())
        self.state = TrainState(
            params=self.model,
            opt_state=AdamState(
                count=torch.zeros([], dtype=torch.int32, device=self.device),
                mu=[torch.zeros_like(p) for p in params],
                nu=[torch.zeros_like(p) for p in params],
            ),
        )

    # -- training ----------------------------------------------------------

    # Slate geometry and loss mix (the JAX package's): a per-source KL
    # over SLATE candidates against softmax(score/τ), τ = max(score)/γ per
    # row, plus a Huber calibration term of weight λ.
    SLATE = 32
    _RANK_GAMMA = 8.0
    # Fraction of each batch's sources drawn from the mined hard pool
    # when one is installed (set_hard_pool).
    HARD_FRAC = 0.5
    _MSE_WEIGHT = 1.0

    def _check_true_f32(self) -> None:
        """Exact counts and near-tied similarities need true f32 on the
        card: refuse while TF32 is on."""
        if self.device.type == "cuda":
            from ..ops import cuda_kernels

            cuda_kernels.check_true_f32()

    def _features_device(self) -> dict:
        """The feature corpus resident on each device of the step (one
        copy per distinct mesh device), placed once and cached."""
        if self._feat_dev is None:
            devices = (self.mesh.devices if self.mesh is not None
                       else (self.device,))
            feat = torch.from_numpy(self.features)
            self._feat_dev = {}
            for dev in devices:
                if dev not in self._feat_dev:
                    self._feat_dev[dev] = feat.to(dev, copy=True)
        return self._feat_dev

    def _loss_share(self, params, feat, src_idx, cand_idx, target,
                    n_rows: int):
        """This block's share of the batch's mean loss: the rank term's
        row sum and the calibration term's element sum over the WHOLE
        batch's counts (``n_rows`` sources × SLATE), so the shares of the
        blocks add up to the single-device loss."""
        f_src = feat.index_select(0, src_idx)
        f_cand = feat.index_select(0, cand_idx.reshape(-1)).reshape(
            *cand_idx.shape, feat.shape[1]
        )
        e_src = tower_apply(params, f_src)
        e_cand = tower_apply(params, f_cand)
        pred = torch.einsum("bd,bsd->bs", e_src, e_cand)
        row_max = target.amax(dim=1, keepdim=True)
        tau = torch.where(row_max > 0, row_max / self._RANK_GAMMA, 1.0)
        q = torch.softmax(target / tau, dim=1)
        # true KL(q ‖ softmax(pred)): the target-entropy term is constant
        # in params but pins the floor at 0
        logq = torch.log_softmax(target / tau, dim=1)
        rank = torch.sum(
            q * (logq - torch.log_softmax(pred, dim=1)), dim=1
        ).sum() / n_rows
        # optax.huber_loss(pred, target, delta): quadratic near zero,
        # linear beyond delta (caps the heavy tail's gradient)
        abs_err = torch.abs(pred - target)
        delta = (self._delta if abs_err.device == self._delta.device
                 else self._delta.to(abs_err.device))
        quadratic = torch.minimum(abs_err, delta)
        linear = abs_err - quadratic
        huber = 0.5 * quadratic ** 2 + self._HUBER_DELTA * linear
        cal = huber.sum() / (n_rows * cand_idx.shape[1])
        return rank + self._MSE_WEIGHT * cal

    def _apply_optimizer(self, grads: list[torch.Tensor]) -> None:
        """optax ``chain(clip_by_global_norm(1.0), adam(lr))`` then
        ``apply_updates``, in torch ops on the state's device, in
        optax's arithmetic order (no epsilon in the clip; moments
        updated before the bias correction by the incremented count).
        The state is updated in place, so a captured step replays on
        the same tensors."""
        st = self.state.opt_state
        b1, b2 = self._B1, self._B2
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self._MAX_NORM
        grads = [torch.where(keep, g, (g / g_norm) * self._MAX_NORM)
                 for g in grads]
        # optax's safe_increment: the int32 count saturates
        st.count.copy_(torch.where(st.count < _INT32_MAX, st.count + 1,
                                   st.count))
        countf = st.count.to(torch.float32)
        b1_t, b2_t = self._decays
        bc1 = 1 - torch.pow(b1_t, countf)
        bc2 = 1 - torch.pow(b2_t, countf)
        with torch.no_grad():
            for p, g, m, v in zip(self.model.parameters(), grads, st.mu,
                                  st.nu):
                # (1 - b)·g + b·m, in place (addition commutes bit for bit)
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * (g * g))
                update = (m / bc1) / (torch.sqrt(v / bc2 + self._EPS_ROOT)
                                      + self._EPS)
                p.add_(-self.lr * update)

    def _step_on(self, src_d: torch.Tensor, cand_d: torch.Tensor,
                 tgt_d: torch.Tensor) -> torch.Tensor:
        """One optimizer step on a batch already on the state's device;
        returns the loss (0-d, on the device, not fetched)."""
        params = list(self.model.parameters())
        loss = self._loss_share(params, self._features_device()[self.device],
                                src_d, cand_d, tgt_d, src_d.shape[0])
        grads = torch.autograd.grad(loss, params)
        self._apply_optimizer(list(grads))
        return loss.detach()

    def _step(self, src: np.ndarray, cand: np.ndarray,
              target: np.ndarray) -> torch.Tensor:
        """One optimizer step on one host batch; returns the loss as a
        0-d tensor on the state's device (not fetched; on the card it is
        the captured step's output, valid until the next step)."""
        if self.mesh is not None:
            return self._step_sharded(src, cand, target)
        if self.device.type == "cuda":
            graphed = self._graphs.get(cand.shape)
            if graphed is None:
                graphed = self._graphs[cand.shape] = _GraphedStep(
                    self, *cand.shape)
            return graphed.run(src, cand, target)
        return self._step_on(_to_device(src, self.device),
                             _to_device(cand, self.device),
                             _to_device(target, self.device))

    def _step_sharded(self, src: np.ndarray, cand: np.ndarray,
                      target: np.ndarray) -> torch.Tensor:
        """The step under a mesh: contiguous source blocks per shard, each
        shard's share of the global mean loss and its gradients on its
        own device, the gradients psum'd before the clip."""
        from ..parallel.mesh import psum

        feat = self._features_device()
        params = list(self.model.parameters())
        b = src.shape[0]
        devices = self.mesh.devices
        if b % len(devices):
            raise ValueError(f"{b} sources do not split into "
                             f"{len(devices)} shards")
        per = b // len(devices)
        replicas: dict = {}
        losses, grads = [], []
        for s, dev in enumerate(devices):
            if dev == self.device:
                rep = params
            else:
                if dev not in replicas:
                    replicas[dev] = [p.detach().to(dev).requires_grad_()
                                     for p in params]
                rep = replicas[dev]
            sl = slice(s * per, (s + 1) * per)
            share = self._loss_share(
                rep, feat[dev], _to_device(src[sl], dev),
                _to_device(cand[sl], dev), _to_device(target[sl], dev), b)
            losses.append(share.detach())
            grads.append(torch.autograd.grad(share, rep))
        total = [psum([g[i] for g in grads], self.mesh)[0].to(self.device)
                 for i in range(len(params))]
        self._apply_optimizer(total)
        return psum(losses, self.mesh)[0].to(self.device)

    def pair_scores(self, i: np.ndarray, j: np.ndarray) -> np.ndarray:
        """Exact PathSim (this model's variant) for arbitrary pairs,
        O(batch·V): 2·(C[i]·C[j]) / (d[i]+d[j]) — no N×N matrix
        involved."""
        i = np.asarray(i)
        j = np.asarray(j)
        num = 2.0 * np.einsum("bv,bv->b", self._c64[i], self._c64[j])
        denom = self._d[i] + self._d[j]
        return np.where(denom > 0, num / np.where(denom > 0, denom, 1), 0.0)

    def sample_batch(self, batch_size: int, rng: np.random.Generator):
        """One slate batch: B = batch_size // SLATE sources, each with a
        SLATE-candidate list — half venue co-occupants of the source,
        half uniform negatives. Targets are exact pair scores computed on
        demand. Returns (src [B], cand [B, S], target [B, S] f32).

        With a hard pool installed (:meth:`set_hard_pool`), the first
        ``HARD_FRAC`` of the sources come from the pool and most of their
        random-negative slots are replaced by their mined exact-top
        candidates. Under a mesh the source count rounds up to a shard
        multiple, and with a pool the rows are permuted so the hard rows
        do not all land on the first shards. The rng is consumed exactly
        as the JAX package consumes it: the same generator state gives
        the same batch."""
        s = self.SLATE
        b = max(1, batch_size // s)
        if self.mesh is not None:
            nd = self.mesh.shape["dp"]
            b = -(-b // nd) * nd
        src = rng.integers(0, self.n, size=b)
        hard_rows = 0
        if self._hard_src is not None and len(self._hard_src):
            hard_rows = min(b, max(1, int(round(b * self.HARD_FRAC))))
            pool_idx = rng.integers(0, len(self._hard_src), size=hard_rows)
            src[:hard_rows] = self._hard_src[pool_idx]
        cand = rng.integers(0, self.n, size=(b, s))
        n_pos = s // 2
        if len(self._row_cols):
            lo, hi = self._row_ptr[src], self._row_ptr[src + 1]
            has = hi > lo
            if has.any():
                sel = lo[:, None] + rng.integers(
                    0, np.maximum((hi - lo)[:, None], 1), size=(b, n_pos)
                )
                v = self._row_cols[np.minimum(sel, len(self._row_cols) - 1)]
                clo, chi = self._col_ptr[v], self._col_ptr[v + 1]
                cc = self._nz_rows[
                    clo + rng.integers(0, np.maximum(chi - clo, 1))
                ]
                cand[:, :n_pos] = np.where(has[:, None], cc, cand[:, :n_pos])
        if hard_rows:
            kk = self._hard_cand.shape[1]
            n_hard = min(kk, s - n_pos - max(1, s // 8))
            if n_hard > 0:
                pick = rng.integers(0, kk, size=(hard_rows, n_hard))
                cand[:hard_rows, n_pos:n_pos + n_hard] = self._hard_cand[
                    pool_idx[:, None], pick
                ]
        if self.mesh is not None and hard_rows:
            perm = rng.permutation(b)
            src = src[perm]
            cand = cand[perm]
        tgt = self.pair_scores(
            np.repeat(src, s), cand.reshape(-1)
        ).reshape(b, s)
        return src, cand, tgt.astype(np.float32)

    def train(self, steps: int = 200, batch_size: int = 1024, seed: int = 0):
        """Run optimizer steps; returns the per-step loss history as a
        list of floats. ``batch_size`` counts PAIRS (sources × slate).
        The losses stay on the device and are fetched once, at the
        end."""
        self._check_true_f32()
        rng = np.random.default_rng(seed)
        # params change from the first step: drop the cache up front
        self._emb_cache = None
        losses = torch.empty(steps, dtype=torch.float32, device=self.device)
        for i in range(steps):
            src, cand, target = self.sample_batch(batch_size, rng)
            losses[i].copy_(self._step(src, cand,
                                       target * self.target_scale))
            self.state.step += 1
        return losses.cpu().tolist()

    # -- distillation: exact-teacher hard-candidate mining ----------------

    def mine_hard_candidates(
        self,
        n_sources: int,
        k: int = 64,
        seed: int = 0,
        exclude: Sequence[int] | None = None,
        chunk: int = 256,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Mine exact top-``k`` candidate lists for a pool of sources on
        the device: per source chunk the score rows are 2·(C_S Cᵀ)/(d_S ⊕
        d), a true-f32 GEMM (exact below 2²⁴, which the guard checks),
        the division, the self mask and a stable descending sort (ties to
        the lowest column, as ``lax.top_k`` orders them). The lists equal
        the JAX package's bit for bit.

        ``exclude`` keeps held-out evaluation sources out of the pool.
        Returns ``(sources [T], cands [T, k])`` host arrays; install them
        with :meth:`set_hard_pool`."""
        if self.n < 2:
            raise ValueError("hard-candidate mining needs >= 2 nodes")
        k = min(k, self.n - 1)
        avail = np.arange(self.n)
        if exclude is not None and len(np.asarray(exclude)):
            avail = avail[~np.isin(avail, np.asarray(exclude))]
        rng = np.random.default_rng(seed)
        n_sources = min(n_sources, len(avail))
        sources = np.sort(rng.choice(avail, size=n_sources, replace=False))
        # the teacher must be exact: integer counts are exact in f32 only
        # below 2²⁴, and only in true f32 (never TF32)
        from ..ops.chain import check_exact_counts

        check_exact_counts(float(self._d.max(initial=0.0)), torch.float32)
        self._check_true_f32()
        dev = self.device
        c_dev = torch.tensor(self._c32(), device=dev)
        d_dev = torch.tensor(self._d.astype(np.float32), device=dev)

        def chunk_topk(idx):
            cs = c_dev.index_select(0, idx)              # [T, V]
            ds = d_dev.index_select(0, idx)              # [T]
            cc = cs @ c_dev.T                            # [T, N] true f32
            denom = ds[:, None] + d_dev[None, :]
            sims = torch.where(denom > 0, 2.0 * cc / denom, 0.0)
            sims[torch.arange(idx.shape[0], device=dev), idx] = -math.inf
            order = torch.sort(sims, dim=1, descending=True, stable=True)
            return order.indices[:, :k]

        cands = np.empty((n_sources, k), dtype=np.int64)
        for lo in range(0, n_sources, chunk):
            idx = sources[lo:lo + chunk]
            take = len(idx)
            if take < chunk and n_sources > chunk:
                # pad the tail chunk to the sweep's shape, as JAX does
                idx = np.concatenate(
                    [idx, np.full(chunk - take, idx[-1], dtype=idx.dtype)]
                )
            out = chunk_topk(torch.as_tensor(idx, device=dev)).cpu().numpy()
            cands[lo:lo + take] = out[:take]
        return sources, cands

    def set_hard_pool(self, sources: np.ndarray, cands: np.ndarray) -> None:
        """Install a mined hard-candidate pool; subsequent :meth:`train`
        batches draw ``HARD_FRAC`` of their sources from it (see
        :meth:`sample_batch`). Not persisted by :meth:`save`."""
        # copies, not views: a caller mutating its buffer after install
        # would silently bypass the range validation below
        sources = np.array(sources, copy=True)
        cands = np.array(cands, copy=True)
        if (
            sources.ndim != 1
            or cands.ndim != 2
            or len(sources) != len(cands)
        ):
            raise ValueError(
                "hard pool must be (sources [T], cands [T, K]) with "
                f"matching T; got {sources.shape} / {cands.shape}"
            )
        if not (
            np.issubdtype(sources.dtype, np.integer)
            and np.issubdtype(cands.dtype, np.integer)
        ):
            raise ValueError("hard pool must hold integer node indexes")
        for name, a in (("sources", sources), ("cands", cands)):
            if a.size and (a.min() < 0 or a.max() >= self.n):
                raise ValueError(
                    f"hard pool {name} out of range for this model "
                    f"(n={self.n}): [{a.min()}, {a.max()}]"
                )
        sources.flags.writeable = False
        cands.flags.writeable = False
        self._hard_src, self._hard_cand = sources, cands

    def clear_hard_pool(self) -> None:
        self._hard_src = self._hard_cand = None

    # -- inference ---------------------------------------------------------

    def _c32(self) -> np.ndarray:
        """f32 view of the half-chain factor for device/index math
        (cached; read-only so index paths can't corrupt it)."""
        if self._c32_cache is None:
            c32 = self._c64.astype(np.float32)
            c32.flags.writeable = False
            self._c32_cache = c32
        return self._c32_cache

    def _embed(self, feat: torch.Tensor) -> np.ndarray:
        self._check_true_f32()
        with torch.no_grad():
            return self.model(feat).cpu().numpy()

    def embeddings(self, features: np.ndarray | None = None) -> np.ndarray:
        """Embed the given features, or the full corpus (cached and
        read-only — training invalidates the cache). Host numpy f32; the
        tower runs on the state's device."""
        if features is not None:
            return self._embed(torch.tensor(
                np.asarray(features, dtype=np.float32), device=self.device
            ))
        if self._emb_cache is None:
            emb = self._embed(self._features_device()[self.device])
            emb.flags.writeable = False
            self._emb_cache = emb
        return self._emb_cache

    def predict_pairs(self, i: Sequence[int], j: Sequence[int]) -> np.ndarray:
        """Approximate PathSim scores (inner products un-scaled back to
        score units — training regresses ``score · target_scale``)."""
        i = np.asarray(i)
        j = np.asarray(j)
        if self._emb_cache is not None:
            e = self._emb_cache
            return np.sum(e[i] * e[j], axis=-1) / self.target_scale
        ei = self.embeddings(self.features[i])
        ej = self.embeddings(self.features[j])
        return np.sum(ei * ej, axis=-1) / self.target_scale

    def struct_embeddings(self) -> np.ndarray:
        """The analytic Cauchy-quadrature feature map φ [N, m·V] (cached,
        f32, read-only)."""
        if self._struct_cache is None:
            w = np.sqrt(2.0 * self._quad_w).astype(np.float32)
            c32 = self._c32()
            phi = (
                w[None, :, None] * self._gates[:, :, None] * c32[:, None, :]
            ).reshape(self.n, -1)
            phi.flags.writeable = False
            self._struct_cache = phi
        return self._struct_cache

    def topk(self, source_index: int, k: int = 10) -> list[tuple[int, float]]:
        e = self.embeddings()
        sims = (e @ e[source_index]) / self.target_scale
        sims[source_index] = -np.inf
        order = np.argsort(-sims)[:k]
        return [(int(t), float(sims[t])) for t in order]

    def struct_sims(self, source_index: int) -> np.ndarray:
        """Struct-index similarities of every node to ``source_index``
        without materializing φ: φ(i)·φ(j) = (C_i·C_j) · Σ_k 2·w_k·
        e^(-t_k·d_i)·e^(-t_k·d_j), an O(N·V) matvec plus an O(N·m) gate
        contraction."""
        c32 = self._c32()
        cc = c32 @ c32[source_index]
        gi = (
            2.0 * self._quad_w * self._gates[source_index]
        ).astype(np.float32)
        gg = self._gates @ gi
        return cc.astype(np.float64) * gg.astype(np.float64)

    def topk_struct(
        self, source_index: int, k: int = 10
    ) -> list[tuple[int, float]]:
        """Top-k by the structural index alone — returned scores are the
        quadrature approximations of the exact scores (same units)."""
        sims = self.struct_sims(source_index)
        sims[source_index] = -np.inf
        order = np.argsort(-sims)[:k]
        return [(int(t), float(sims[t])) for t in order]

    def topk_rerank(
        self,
        source_index: int,
        k: int = 10,
        candidates: int = 100,
        index: str = "struct",
    ) -> list[tuple[int, float]]:
        """Two-stage query: an embedding index prefilters ``candidates``
        targets, then the EXACT score re-ranks them through the serving
        ANN path's candidate primitives (ops/pathsim.score_candidates +
        topk_from_candidate_scores): (descending score, ascending
        column), bit-identical to the full exact top-k whenever the true
        top-k is inside the candidate set. ``index``: "struct" (the
        analytic map) or "learned" (the trained tower)."""
        from ..ops.pathsim import score_candidates, topk_from_candidate_scores

        if index == "struct":
            sims = self.struct_sims(source_index)
        elif index == "learned":
            e = self.embeddings()
            sims = e @ e[source_index]
        else:
            raise ValueError(f"unknown index {index!r}")
        sims[source_index] = -np.inf
        cand = np.argpartition(-sims, min(candidates, self.n - 1))[:candidates]
        cand = cand[cand != source_index].astype(np.int64)
        counts = self._c64[cand] @ self._c64[source_index]
        scores = score_candidates(
            counts[None, :],
            np.asarray([self._d[source_index]]),
            self._d[cand][None, :],
        )
        vals, idxs = topk_from_candidate_scores(scores, cand[None, :], k)
        return [
            (int(j), float(v))
            for v, j in zip(vals[0], idxs[0])
            if np.isfinite(v)
        ]

    # Refuse to densify the exact score matrix beyond this many entries.
    _DENSE_SCORES_MAX_ENTRIES = 1 << 26

    def exact_scores(self) -> np.ndarray:
        """The dense supervision-target matrix (exact PathSim of this
        variant), for validation on small graphs. Guarded: training never
        needs it — use :meth:`pair_scores` for O(batch) exact targets."""
        if self._scores_cache is None:
            if self.n * self.n > self._DENSE_SCORES_MAX_ENTRIES:
                raise MemoryError(
                    f"dense scores would be {self.n}x{self.n}; "
                    "use pair_scores(i, j)"
                )
            from ..ops.pathsim import score_matrix

            self._scores_cache = score_matrix(
                self._c64 @ self._c64.T, variant=self.variant, xp=np
            )
        return self._scores_cache

    # -- persistence -------------------------------------------------------

    def _opt_state_tree(self) -> dict:
        """optax's chain state as flax's state dict: ``{"0": {} (the
        clip's EmptyState), "1": {"0": ScaleByAdamState, "1": {}}}``."""
        st = self.state.opt_state
        return {"0": {}, "1": {
            "0": {
                "count": np.asarray(st.count.cpu().numpy(), dtype=np.int32),
                "mu": _flax_tree(self.model, st.mu),
                "nu": _flax_tree(self.model, st.nu),
            },
            "1": {},
        }}

    def save(self, path: str) -> None:
        """Persist the model to one ``.npz`` file in the JAX package's
        format: tower params and optimizer state (flax-msgpack blobs),
        the step counter, hyperparameters, metapath name, the half-chain
        factor C, the target scale and the quadrature. Written
        atomically (tmp + ``os.replace``)."""
        import json
        import os

        from .flax_msgpack import packb

        payload = {
            "c": self._c64.astype(np.float32),
            "params": np.frombuffer(
                packb(params_to_flax(self.model)), dtype=np.uint8
            ),
            "opt_state": np.frombuffer(
                packb(self._opt_state_tree()), dtype=np.uint8
            ),
            "step": np.int64(self.state.step),
            "target_scale": np.float64(self.target_scale),
            "quad_t": self._quad_t,
            "quad_w": self._quad_w,
            "config": np.frombuffer(
                json.dumps(
                    {
                        **self._config,
                        "metapath": self.metapath.name,
                        "opt_format": self._OPT_FORMAT,
                    }
                ).encode(),
                dtype=np.uint8,
            ),
        }
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:  # stream: no second in-memory copy of C
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)

    @classmethod
    def load(
        cls,
        path: str,
        hin: EncodedHIN | None = None,
        mesh=None,
        device=None,
    ) -> "NeuralPathSim":
        """Restore a model saved by :meth:`save` — by this package or by
        the JAX package. ``hin`` is optional: inference and resumed
        training need only the stored C factor; pass it (the same graph)
        to re-attach label lookups and the compiled metapath."""
        import json

        from .flax_msgpack import unpackb

        with np.load(path) as z:
            c = z["c"]
            params_bytes = z["params"].tobytes()
            opt_bytes = z["opt_state"].tobytes()
            step = int(z["step"])
            config = json.loads(z["config"].tobytes().decode())
            if "target_scale" not in z or "quad_t" not in z:
                # the r04 feature map added QUAD_M gate columns: a
                # gate-free tower cannot be restored
                raise ValueError(
                    f"{path!r} is a pre-r04 NeuralPathSim checkpoint "
                    "(no quadrature record); its tower was trained on "
                    "gate-free features and cannot be restored — "
                    "re-train and re-save"
                )
            target_scale = float(z["target_scale"])
            quad = (z["quad_t"], z["quad_w"])

        metapath_name = config.pop("metapath")
        opt_format = config.pop("opt_format", None)
        if opt_format != cls._OPT_FORMAT:
            raise ValueError(
                f"{path!r} was saved under optimizer format "
                f"{opt_format!r}; this build uses {cls._OPT_FORMAT!r} "
                "(different opt_state pytree) — re-train and re-save"
            )
        self = cls.__new__(cls)
        self.hin = hin
        self.metapath = (
            compile_metapath(metapath_name, hin.schema)
            if hin is not None
            else MetaPath(name=metapath_name, node_types=(), steps=())
        )
        self._place(mesh, device)
        self._setup_from_c(c, **config, target_scale=target_scale, quad=quad)
        params_from_flax(unpackb(params_bytes), self.model)
        adam = unpackb(opt_bytes)["1"]["0"]
        self.state = TrainState(
            params=self.model,
            opt_state=AdamState(
                count=torch.tensor(int(np.asarray(adam["count"])),
                                   dtype=torch.int32, device=self.device),
                mu=_flax_tensors(self.model, adam["mu"], self.device),
                nu=_flax_tensors(self.model, adam["nu"], self.device),
            ),
            step=step,
        )
        return self


_INT32_MAX = torch.iinfo(torch.int32).max


class _GraphedStep:
    """The card's train step for one batch shape, captured as a CUDA
    graph: the batch is copied into static device buffers (from pinned
    host memory, asynchronously), and one replay runs the gather, the
    tower, the loss, its gradients and the optimizer — some 250 kernels
    that would otherwise each pay a launch from Python. The first
    ``WARMUP`` steps run eagerly on a side stream (the capture's
    prerequisite), the next is captured and replayed; every later step
    is a replay. Same ops, same arithmetic: only the launches change."""

    WARMUP = 3

    def __init__(self, model: "NeuralPathSim", b: int, s: int):
        dev = model.device
        self.model = model
        self.idx = torch.zeros(b * (s + 1), dtype=torch.int64, device=dev)
        self.src, self.cand = self.idx[:b], self.idx[b:].view(b, s)
        self.tgt = torch.zeros(b, s, dtype=torch.float32, device=dev)
        self.graph = self.loss = None
        self.side = torch.cuda.Stream(device=dev)
        self.calls = 0

    def run(self, src: np.ndarray, cand: np.ndarray,
            target: np.ndarray) -> torch.Tensor:
        idx = np.concatenate([src, cand.reshape(-1)]).astype(np.int64)
        self.idx.copy_(torch.from_numpy(idx).pin_memory(), non_blocking=True)
        self.tgt.copy_(
            torch.from_numpy(np.ascontiguousarray(target)).pin_memory(),
            non_blocking=True)
        if self.graph is None and self.calls < self.WARMUP:
            self.calls += 1
            self.side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.side):
                loss = self.model._step_on(self.src, self.cand, self.tgt)
            torch.cuda.current_stream().wait_stream(self.side)
            return loss
        if self.graph is None:
            from ..utils.compile_counter import record

            graph = torch.cuda.CUDAGraph()
            # thread-local: a service trains at install while its other
            # threads may still fetch from the card
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.loss = self.model._step_on(self.src, self.cand,
                                                self.tgt)
            self.graph = graph
            record("cuda_graph", "neural_train_step")
        self.graph.replay()
        return self.loss


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch array on ``device``: through pinned memory on the
    card, so the copy is asynchronous and the step does not wait for the
    previous one (a pageable copy would synchronize the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
