"""Learned serving tier: inductive two-tower candidates, exact-reranked.

The ``--topk-mode learned`` arm of the serving stack, served from a
tower checkpoint (the JAX package's format, read and written here):

- :mod:`.encoder` — the inductive half: a row-local feature map and a
  torch tower forward, so a node the towers have never seen embeds
  from its typed adjacency alone (cold-start answering);
- :mod:`.checkpoint` — versioned, fingerprint-keyed tower artifacts
  with atomic save/load (the ``index/mips.py`` contract);
- :mod:`.serving` — the query-path state: towers generate candidates
  ONLY (the probe on the card), every answer is exact-f64 reranked
  inside this package (``LEARNED_SURFACE`` seals the raw-score
  surface), a shadow-recall gate disables the arm below floor, and
  every degradation is a counted fallback to ANN-then-exact.

Training towers (exact-teacher distillation, the JAX package's
``learned/trainer.py``) is not ported yet: :func:`train_towers` raises
:class:`TrainingNotPorted`, and a learned-mode service needs a
checkpoint.
"""

from .checkpoint import TowerMismatch, load_towers, save_towers
from .encoder import InductiveEncoder
from .serving import LEARNED_FALLBACK_REASONS, LEARNED_SURFACE, LearnedState


class TrainingNotPorted(NotImplementedError):
    """Training learned towers — the ``learned train`` action, or a
    learned-mode service distilling its own towers when it has no
    usable checkpoint — is not ported yet."""


TRAINING_SLICE = (
    "training learned towers is not ported yet (it comes with the learned "
    "tier's training slice, ROADMAP.md A.1b); train a checkpoint with the "
    "JAX package's `dpathsim learned train` and pass it with "
    "--learned-checkpoint"
)


def train_towers(*args, **kwargs):
    """Distill the exact engine into serving towers — not ported yet."""
    raise TrainingNotPorted(TRAINING_SLICE)


__all__ = [
    "InductiveEncoder",
    "LEARNED_FALLBACK_REASONS",
    "LEARNED_SURFACE",
    "LearnedState",
    "TRAINING_SLICE",
    "TowerMismatch",
    "TrainingNotPorted",
    "load_towers",
    "save_towers",
    "train_towers",
]
