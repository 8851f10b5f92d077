"""Inductive tower encoder: a row-local feature map and a torch forward.

The inductive contract: every input the tower reads for node ``j`` is
computable from that node's OWN half-chain row ``C_j`` and denominator
``d_j`` once three train-time constants are pinned — the Cauchy
quadrature grid ``(t, w)``, the degree normalizer ``deg_denom`` and the
calibration ``target_scale``. Nothing in the feature map looks at any
other row, so a node appended after training embeds from its typed
adjacency alone, and its embedding is inner-product-consistent with the
corpus embeddings by construction.

The feature map is host numpy f32, the JAX package's arithmetic
(unit-L2 C row | scaled log-degree | quadrature gates), stamped into
checkpoints as ``FEATURE_FORMAT`` so a map change fails a stale
artifact loudly. The forward — three Dense layers, ReLU after the
first two — runs as torch ops on a given device (CUDA unless the
caller asks for the CPU), in true f32: corpus rows and cold-start rows
go through the SAME arithmetic on the same device, so "inductively
embedded" and "corpus" embeddings never drift apart. On the CPU it
equals the JAX package's numpy forward to f32 rounding.

:meth:`InductiveEncoder.from_model` exports a trained
:class:`~..models.neural.NeuralPathSim`'s towers into this form (the
serving tier's model producer, learned/trainer.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# One definition of the feature-map identity, stamped into checkpoints
# and verified on load (the JAX package's string: artifacts are shared).
FEATURE_FORMAT = "l2c-deg-gates-r04"


def _gates(d: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Quadrature denominator gates e^(-d·t_k) — the arithmetic of
    ``models.neural.quadrature_gates``, kept here so loading a
    checkpoint needs nothing of the trainer."""
    return np.exp(
        -np.clip(
            np.asarray(d, np.float64)[:, None] * np.asarray(t)[None, :],
            0.0, 700.0,
        )
    ).astype(np.float32)


@dataclasses.dataclass
class InductiveEncoder:
    """Frozen trained towers + the pinned train-time constants.

    ``layers`` is ``[(kernel, bias), ...]`` for the three Dense layers
    (f32). ``v`` is the half-chain contraction width the towers were
    trained on — a graph whose venue vocabulary grew past it cannot be
    embedded without retraining (the feature dimension moved), which
    callers must treat as a counted degradation, not an error.
    """

    layers: list[tuple[np.ndarray, np.ndarray]]
    quad_t: np.ndarray
    quad_w: np.ndarray
    deg_denom: float
    target_scale: float
    variant: str
    metapath: str
    meta: dict

    def __post_init__(self):
        if len(self.layers) != 3:
            raise ValueError(
                f"expected 3 tower layers, got {len(self.layers)}"
            )
        for kern, bias in self.layers:
            kern.flags.writeable = False
            bias.flags.writeable = False
        # the layers' copies per device, made on first use
        self._dev_layers: dict[torch.device, list] = {}

    @property
    def v(self) -> int:
        """Contraction width of the training graph's half factor."""
        return int(self.layers[0][0].shape[0]) - 1 - len(self.quad_t)

    @property
    def dim(self) -> int:
        return int(self.layers[-1][0].shape[1])

    @property
    def hidden(self) -> int:
        return int(self.layers[0][0].shape[1])

    @classmethod
    def from_model(cls, model, meta: dict | None = None) -> "InductiveEncoder":
        """Export a trained :class:`~..models.neural.NeuralPathSim`'s
        towers into the numpy form (the module's flax-layout parameters
        → plain host f32 arrays)."""
        from ..models.neural import params_to_flax

        params = params_to_flax(model.model)["params"]
        layers = [
            (
                np.array(params[f"Dense_{i}"]["kernel"], dtype=np.float32),
                np.array(params[f"Dense_{i}"]["bias"], dtype=np.float32),
            )
            for i in range(3)
        ]
        deg = np.log1p(model._d)
        return cls(
            layers=layers,
            quad_t=np.asarray(model._quad_t, dtype=np.float64),
            quad_w=np.asarray(model._quad_w, dtype=np.float64),
            deg_denom=max(float(deg.max(initial=0.0)), 1.0),
            target_scale=float(model.target_scale),
            variant=model.variant,
            metapath=model.metapath.name,
            meta=dict(meta or {}),
        )

    # -- the row-local feature map ----------------------------------------

    def features(self, c_rows: np.ndarray, d_rows: np.ndarray) -> np.ndarray:
        """[B, V] half-chain rows + [B] denominators → [B, F] tower
        inputs (host f32). Row-local by construction: the corpus
        statistics this normalization needs (quadrature grid, degree
        max) are the PINNED train-time constants, not recomputed."""
        c_rows = np.asarray(c_rows, dtype=np.float32)
        if c_rows.ndim != 2 or c_rows.shape[1] != self.v:
            raise ValueError(
                f"half-chain width {c_rows.shape} does not match the "
                f"towers' training width V={self.v} — the contraction "
                "vocabulary changed; retrain"
            )
        d_rows = np.asarray(d_rows, dtype=np.float64)
        norms = np.linalg.norm(c_rows, axis=1, keepdims=True)
        c_norm = c_rows / np.where(norms > 0, norms, 1)
        deg = (np.log1p(d_rows) / self.deg_denom).astype(np.float32)
        return np.concatenate(
            [c_norm, deg[:, None], _gates(d_rows, self.quad_t)], axis=1
        )

    def _layers_on(self, device: torch.device) -> list:
        layers = self._dev_layers.get(device)
        if layers is None:
            layers = self._dev_layers[device] = [
                (torch.tensor(k, device=device), torch.tensor(b, device=device))
                for k, b in self.layers
            ]
        return layers

    def embed(self, c_rows: np.ndarray, d_rows: np.ndarray,
              device=None) -> torch.Tensor:
        """Embed rows through the frozen towers: [B, dim] f32 on
        ``device`` (None: CUDA). The features are host work; the three
        layers run on the device in true f32 (never TF32, which would
        move near-tied similarities and with them the candidate set).
        Raises ValueError on a width change before anything runs."""
        from ..utils.device import resolve_device

        x = self.features(c_rows, d_rows)
        dev = resolve_device(device)
        if dev.type == "cuda":
            from ..ops import cuda_kernels

            cuda_kernels.check_true_f32()
        (w0, b0), (w1, b1), (w2, b2) = self._layers_on(dev)
        h = torch.from_numpy(x).to(dev)
        h = torch.relu(h @ w0 + b0)
        h = torch.relu(h @ w1 + b1)
        return h @ w2 + b2
