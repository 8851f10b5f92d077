"""Metapath compiler: metapath spec → oriented adjacency-block chain.

This replaces the reference's GraphFrames motif DSL. The reference encodes
the APVPA meta-path as a 4-way motif string with per-binding type and
relationship filters (``DPathSim_APVPA.py:72-84``); every query re-plans
and re-executes the full distributed join. Here a metapath is *compiled
once* into a typed chain of oriented adjacency blocks; the commuting
matrix ``M`` of the metapath is their product, and the reference's two
kernels collapse into entries and row sums of ``M`` (SURVEY.md §3.3):

- pairwise walk(x, y)  = M[x, y]
- global walk(x)       = Σ_y M[x, y]   (row sum — the reference leaves
  ``author_2`` free, so this is NOT the textbook diagonal M[x,x])

For palindromic metapaths (APVPA, APA, APTPA …) the chain factors as
``M = C @ Cᵀ`` with ``C`` the first-half product — half the FLOPs, exact
symmetry by construction, and row sums computable as ``C @ (Σ_rows C)``
without materializing ``M`` at all. The compiler detects and exposes this
factorization; every backend exploits it.

Motif semantics preserved: vertex distinctness is NOT enforced (degenerate
paths with paper_1 == paper_2 or author_2 == author_1 count — exactly what
``gf.find`` returns and what makes the count equal the matrix entry).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..data.schema import HINSchema

# Letter aliases for the compact "APVPA" spec syntax, DBLP convention.
DBLP_ALIASES = {"A": "author", "P": "paper", "V": "venue", "T": "topic"}


@dataclasses.dataclass(frozen=True)
class Step:
    """One oriented traversal: follow ``relationship`` forward (src→dst)
    or reversed (dst→src, i.e. the transposed block)."""

    relationship: str
    reverse: bool

    def __repr__(self) -> str:
        arrow = "←" if self.reverse else "→"
        return f"{arrow}{self.relationship}"


@dataclasses.dataclass(frozen=True)
class MetaPath:
    """A compiled metapath over a schema."""

    name: str
    node_types: tuple[str, ...]
    steps: tuple[Step, ...]

    @property
    def source_type(self) -> str:
        return self.node_types[0]

    @property
    def target_type(self) -> str:
        return self.node_types[-1]

    @property
    def length(self) -> int:
        return len(self.steps)

    @property
    def is_symmetric(self) -> bool:
        """Palindromic node sequence with mirrored steps: guarantees
        ``M = C @ Cᵀ`` with C the first-half chain product."""
        n = len(self.steps)
        if n % 2 != 0:
            return False
        if self.node_types != tuple(reversed(self.node_types)):
            return False
        for i in range(n // 2):
            a, b = self.steps[i], self.steps[n - 1 - i]
            if a.relationship != b.relationship or a.reverse == b.reverse:
                return False
        return True

    def half(self) -> tuple[Step, ...]:
        if not self.is_symmetric:
            raise ValueError(f"metapath {self.name} is not symmetric")
        return self.steps[: len(self.steps) // 2]

    def step_shapes(self, type_sizes: dict[str, int]) -> list[tuple[int, int]]:
        return [
            (type_sizes[self.node_types[i]], type_sizes[self.node_types[i + 1]])
            for i in range(len(self.steps))
        ]


def compile_metapath(
    spec: str | Sequence[str],
    schema: HINSchema,
    aliases: dict[str, str] | None = None,
    name: str | None = None,
) -> MetaPath:
    """Compile a metapath spec against a schema.

    ``spec`` is either a compact letter string (``"APVPA"``, resolved via
    ``aliases``, default DBLP letters) or an explicit node-type sequence
    (``["author", "paper", "venue", "paper", "author"]``). Each
    consecutive type pair is resolved to the unique schema relation with
    that signature, traversed forward or reverse; ambiguity or absence is
    a compile error — typed indices instead of string-interpolated SQL
    predicates (the reference formats filter values straight into Spark
    SQL, ``DPathSim_APVPA.py:77,97-98``).
    """
    if isinstance(spec, str):
        aliases = aliases or DBLP_ALIASES
        try:
            node_types = tuple(aliases[c] for c in spec)
        except KeyError as exc:
            raise ValueError(f"unknown metapath letter {exc} in {spec!r}") from exc
        default_name = spec
    else:
        node_types = tuple(spec)
        default_name = "".join(t[0].upper() for t in node_types)
    if len(node_types) < 2:
        raise ValueError("metapath needs at least two node types")
    schema.validate_metapath(node_types)

    steps: list[Step] = []
    for i in range(len(node_types) - 1):
        s, t = node_types[i], node_types[i + 1]
        forward = [r for r, sig in schema.relations.items() if sig == (s, t)]
        backward = [r for r, sig in schema.relations.items() if sig == (t, s)]
        candidates = [(r, False) for r in forward] + [(r, True) for r in backward]
        if not candidates:
            raise ValueError(
                f"no relation connects {s!r}→{t!r} in schema "
                f"{dict(schema.relations)}"
            )
        if len(candidates) > 1:
            raise ValueError(
                f"ambiguous relation for {s!r}→{t!r}: "
                f"{[c[0] for c in candidates]}; pass explicit steps"
            )
        rel, rev = candidates[0]
        steps.append(Step(relationship=rel, reverse=rev))

    return MetaPath(
        name=name or default_name, node_types=node_types, steps=tuple(steps)
    )
