"""The benchmark's own graph generator: a DBLP-shaped author-paper-venue
graph from the seed, as COO arrays.

The distribution of the port's ``data/synthetic.py`` (copied, not
imported): every paper has 1 + Poisson(authors_per_paper - 1) authors
drawn from a Zipf law over the authors (author i with weight 1/(i+1), so
the head is the lowest ids), duplicates dropped, and exactly one venue
drawn from a Zipf law over the venues. The draws run in torch with a
``torch.Generator`` on the given device (the card in a run, so a graph of
five million papers takes a fraction of a second), by inverse transform
sampling. The same seed on the same device gives the same arrays; the
CPU and the card give different graphs of the same law.

Both sides get the arrays from here: the port as an ``EncodedHIN`` built
by the harness, the reference as plain NumPy copies.
"""

from __future__ import annotations

import numpy as np
import torch


def _zipf_cdf(n: int, device) -> torch.Tensor:
    w = 1.0 / torch.arange(1, n + 1, dtype=torch.float64, device=device)
    return torch.cumsum(w, 0) / w.sum()


def _draw_zipf(cdf: torch.Tensor, size: int, g: torch.Generator
               ) -> torch.Tensor:
    u = torch.rand(size, dtype=torch.float64, device=cdf.device, generator=g)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)


def synthetic_coo(graph: dict, seed: int, device="cpu") -> dict:
    """The graph a configuration's ``graph`` block describes, drawn from
    ``seed`` on ``device``: ``{"ap_rows", "ap_cols", "pv_rows",
    "pv_cols"}`` as int32 NumPy arrays (author→paper and paper→venue
    edges, author→paper sorted by (author, paper)), with the sizes."""
    n_a, n_p, n_v = (int(graph["authors"]), int(graph["papers"]),
                     int(graph["venues"]))
    extra = max(float(graph.get("authors_per_paper", 1.3)) - 1.0, 0.0)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    rate = torch.full((n_p,), extra, dtype=torch.float32, device=device)
    counts = 1 + torch.poisson(rate, generator=g).to(torch.int64)
    total = int(counts.sum())
    authors = _draw_zipf(_zipf_cdf(n_a, device), total, g)
    papers = torch.repeat_interleave(
        torch.arange(n_p, device=device), counts, output_size=total)
    key = torch.unique(authors * n_p + papers)
    venues = _draw_zipf(_zipf_cdf(n_v, device), n_p, g)

    def host(t: torch.Tensor) -> np.ndarray:
        return t.to(torch.int32).cpu().numpy()

    return {
        "authors": n_a, "papers": n_p, "venues": n_v,
        "ap_rows": host(key // n_p), "ap_cols": host(key % n_p),
        "pv_rows": np.arange(n_p, dtype=np.int32), "pv_cols": host(venues),
    }
