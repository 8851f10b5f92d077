"""Learned serving tier: inductive two-tower candidates, exact-reranked.

The ``--topk-mode learned`` arm of the serving stack:

- :mod:`.encoder` — the inductive half: a row-local feature map and a
  torch tower forward, so a node the towers have never seen embeds
  from its typed adjacency alone (cold-start answering);
- :mod:`.trainer` — exact-teacher distillation (mining on the device +
  optional ``--emit-pairs`` slates) into servable towers, trained with
  torch autograd on the card unless the caller asks for the CPU;
- :mod:`.checkpoint` — versioned, fingerprint-keyed tower artifacts
  with atomic save/load (the JAX package's format, read and written
  here);
- :mod:`.serving` — the query-path state: towers generate candidates
  ONLY (the probe on the card), every answer is exact-f64 reranked
  inside this package (``LEARNED_SURFACE`` seals the raw-score
  surface), a shadow-recall gate disables the arm below floor, and
  every degradation is a counted fallback to ANN-then-exact.
"""

from .checkpoint import TowerMismatch, load_towers, save_towers
from .encoder import InductiveEncoder
from .serving import LEARNED_FALLBACK_REASONS, LEARNED_SURFACE, LearnedState
from .trainer import train_towers

__all__ = [
    "InductiveEncoder",
    "LEARNED_FALLBACK_REASONS",
    "LEARNED_SURFACE",
    "LearnedState",
    "TowerMismatch",
    "load_towers",
    "save_towers",
    "train_towers",
]
