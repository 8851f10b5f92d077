"""NeuralPathSim capture on the card: train the learned index and record
convergence, retrieval quality and query throughput.

    python -m distributed_pathsim_tpu_torch.neural_bench [--authors N] [--steps S] [--out FILE] [--platform cuda|cpu]

The port's twin of the repository's ``scripts/neural_bench.py``: the same
flags, defaults, seeds (synthetic graph 42, evaluation draw 123, mining
7, training 0) and record, with the port's two-tower model
(``models/neural.NeuralPathSim``, each training step one CUDA-graph
replay on the card). It runs on the card unless ``--platform cpu`` asks
for the host, and refuses to start when the card is asked for and
missing. ``config.platform`` in the record is the torch device type.

Recall@k of each retrieval arm (the learned index, the analytic
Cauchy-quadrature struct index, each with and without an exact rerank of
a top-100 prefilter) is measured against the exact rowsum-variant
PathSim row in host f64 on held-out sources (:func:`evaluate`).
"""

from __future__ import annotations

import argparse
import json
import resource
import time

import numpy as np

# The four retrieval arms :func:`evaluate` measures, in the record's order.
ARMS = ("learned", "learned_rerank", "struct", "struct_rerank")


def evaluate(model, sources, k: int) -> dict[str, list[float]]:
    """Recall@k per source of each of the :data:`ARMS` against the exact
    scores (an O(N·V) host f64 row per source). Ties are common (integer
    counts): a hit is any returned target whose exact score reaches the
    k-th best, not only the argsort's arbitrary tie-break."""
    c64, d = model._c64, model._d
    recalls: dict[str, list[float]] = {arm: [] for arm in ARMS}
    for s in sources:
        s = int(s)
        num = 2.0 * (c64 @ c64[s])
        denom = d + d[s]
        exact = np.where(denom > 0, num / np.where(denom > 0, denom, 1), 0.0)
        exact[s] = -np.inf
        kth = np.sort(exact)[::-1][k - 1]
        for arm in ARMS:
            if arm == "learned":
                got = model.topk(s, k=k)
            elif arm == "struct":
                got = model.topk_struct(s, k=k)
            else:
                got = model.topk_rerank(s, k=k, candidates=100,
                                        index=arm.split("_")[0])
            recalls[arm].append(
                sum(exact[t] >= kth for t in {t for t, _ in got}) / k)
    return recalls


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default=None,
                   help="GEXF path (e.g. the dblp_large reconstruction); "
                   "default builds the synthetic DBLP-shaped HIN below")
    p.add_argument("--authors", type=int, default=65536)
    p.add_argument("--papers", type=int, default=327680)
    p.add_argument("--venues", type=int, default=64)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--eval-sources", type=int, default=50)
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; refuses without a card) or cpu")
    p.add_argument("--out", default=None)
    p.add_argument("--mine", type=int, default=0, metavar="T",
                   help="mine exact-teacher hard candidates for T "
                   "sources before training and sample half of each "
                   "batch's slates from them (0 = off); evaluation "
                   "sources are excluded from the mined pool")
    p.add_argument("--mine-k", type=int, default=64,
                   help="mined candidates per source (--mine)")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> tuple[dict, list[float]]:
    """The bench at ``args`` (:func:`parse_args`): its record and the
    loss of every training step."""
    from .data.synthetic import synthetic_hin
    from .models.neural import NeuralPathSim
    from .utils.device import resolve_device

    platform = resolve_device(args.platform).type
    if platform == "cuda":
        from .ops import cuda_kernels

        cuda_kernels.true_f32()

    if args.dataset:
        from .engine import load_dataset

        hin = load_dataset(args.dataset)
        args.authors = hin.type_size("author")
        args.papers = hin.type_size("paper")
        args.venues = hin.type_size("venue")
    else:
        hin = synthetic_hin(args.authors, args.papers, args.venues, seed=42)
    model = NeuralPathSim(hin, "APVPA", dim=args.dim, hidden=args.hidden,
                          device=platform)

    # The held-out evaluation draw is fixed (seed 123) and known before
    # training, so the mined pool can exclude it: mined slates never
    # train on an evaluated query's own candidate list.
    rng = np.random.default_rng(123)
    sources = rng.integers(0, args.authors, size=args.eval_sources)

    t_mine = 0.0
    if args.mine:
        t0 = time.perf_counter()
        pool_src, pool_cand = model.mine_hard_candidates(
            args.mine, k=args.mine_k, seed=7, exclude=sources
        )
        model.set_hard_pool(pool_src, pool_cand)
        t_mine = time.perf_counter() - t0

    t0 = time.perf_counter()
    losses = model.train(steps=args.steps, batch_size=args.batch, seed=0)
    t_train = time.perf_counter() - t0

    recalls = evaluate(model, sources, args.top_k)

    # Query throughput: corpus embeddings cached; each query is an
    # O(N·dim) inner-product scan + top-k.
    t0 = time.perf_counter()
    n_q = 200
    for s in rng.integers(0, args.authors, size=n_q):
        model.topk(int(s), k=args.top_k)
    t_query = (time.perf_counter() - t0) / n_q

    record = {
        "metric": f"neural_pathsim_recall_at_{args.top_k}",
        "value": float(np.mean(recalls["learned"])),
        "unit": "recall",
        "vs_baseline": None,
        "config": {
            "dataset": args.dataset or "synthetic",
            "authors": args.authors,
            "papers": args.papers,
            "venues": args.venues,
            "steps": args.steps,
            "batch": args.batch,
            "platform": platform,
            "embedding_dim": model.model.dim,
        },
        "rerank_recall_at_k_top100_prefilter": float(
            np.mean(recalls["learned_rerank"])),
        # the analytic index (no training): raw and exact-reranked
        "struct_recall_at_k": float(np.mean(recalls["struct"])),
        "struct_rerank_recall_at_k_top100_prefilter": float(
            np.mean(recalls["struct_rerank"])),
        # m·V, computed without materializing the map (queries go
        # through the factorized struct_sims path)
        "struct_dim": int(model.QUAD_M * model.v),
        "mined_sources": int(args.mine),
        "mine_k": int(args.mine_k) if args.mine else None,
        "seconds_mine": round(t_mine, 2),
        "loss_first10_mean": float(np.mean(losses[:10])),
        "loss_last10_mean": float(np.mean(losses[-10:])),
        "seconds_train": round(t_train, 2),
        "seconds_per_query": round(t_query, 5),
        "eval_sources": args.eval_sources,
        "recall_min": float(np.min(recalls["learned"])),
        # host memory (KiB -> GiB, as the repository's benches)
        "peak_rss_gb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20),
            2,
        ),
    }
    return record, losses


def main(argv=None) -> dict:
    """Run the bench, print its record as one JSON line (and write it to
    ``--out``); returns the record."""
    args = parse_args(argv)
    record, _ = run(args)
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    return record


if __name__ == "__main__":
    main()
