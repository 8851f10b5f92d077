"""``dpathsim-torch index`` — build / inspect MIPS candidate indexes.

::

    dpathsim-torch index build --dataset dblp/dblp_small.gexf \\
        --metapath APVPA --out idx.npz
    dpathsim-torch index probe --index idx.npz \\
        --dataset dblp/dblp_small.gexf --row 17 --k 10

``build`` folds the half-chain factor, embeds every node (the analytic
Cauchy map, or with ``--embedding learned --model m.npz`` a trained
NeuralPathSim checkpoint's tower on the card), runs k-means,
packs the clusters, and writes the ``.npz`` artifact stamped with the
graph's base fingerprint — ``dpathsim-torch serve --topk-mode ann
--index idx.npz`` refuses any artifact whose fingerprint doesn't match
the served graph. The build is host work (but for a learned
embedding's tower); the artifact is the JAX
package's format, so ``dpathsim index`` and ``dpathsim serve`` read it
too, and the reverse.

``probe`` is the inspection tool: candidates for one row (and, with a
dataset, their exact-reranked scores via the same candidate primitives
serving uses), plus index geometry. It probes on the card unless
``--platform cpu`` is given. Both actions print the JAX package's JSON.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _parse_dataset(spec: str):
    """GEXF path or the router CLI's ``synthetic:`` scheme → EncodedHIN."""
    if spec.startswith("synthetic:"):
        from ..data.synthetic import synthetic_hin
        from ..router.cli import _parse_synthetic

        return synthetic_hin(**_parse_synthetic(spec))
    from ..engine import load_dataset

    return load_dataset(spec)


def _platform_arg(p: argparse.ArgumentParser, help_: str) -> None:
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help=help_)


def build_index_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dpathsim-torch index",
        description="build / probe MIPS candidate-generation indexes",
    )
    sub = p.add_subparsers(dest="action", required=True)

    b = sub.add_parser("build", help="graph -> index artifact")
    b.add_argument("--dataset", required=True,
                   help="GEXF path or synthetic:authors=..,papers=..,"
                   "venues=..,seed=..")
    b.add_argument("--metapath", default="APVPA")
    b.add_argument("--variant", default="rowsum",
                   choices=("rowsum", "diagonal"))
    b.add_argument("--out", required=True, help="index .npz path")
    b.add_argument("--embedding", default="struct",
                   choices=("struct", "learned"),
                   help="embedding source ('learned': the tower of "
                   "--model, run on --platform's device)")
    b.add_argument("--model", default=None,
                   help="NeuralPathSim checkpoint (--embedding learned)")
    b.add_argument("--centroids", type=int, default=None,
                   help="centroid count (default: tuned sqrt(N) mult)")
    b.add_argument("--cluster-cap", type=int, default=None,
                   help="packed-cluster capacity (default: tuned/auto)")
    b.add_argument("--max-dim", type=int, default=1024,
                   help="struct map width cap (JL projection past it)")
    b.add_argument("--headroom", type=float, default=0.25,
                   help="index-capacity reserve, MATCHING the serving "
                   "process's --headroom: the artifact is stamped with "
                   "the padded graph's fingerprint, and serve/worker "
                   "refuse an index built for a different shape")
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--tuning-table", default=None)
    _platform_arg(b, "device the built index is meant for: 'cuda' "
                  "(default) fails when no card is present; the build "
                  "itself is host work but for --embedding learned's "
                  "tower, which runs there")

    q = sub.add_parser("probe", help="query an index artifact")
    q.add_argument("--index", required=True, help="index .npz path")
    q.add_argument("--row", type=int, required=True)
    q.add_argument("--k", type=int, default=10)
    q.add_argument("--nprobe", type=int, default=None)
    q.add_argument("--cand-mult", type=int, default=16)
    q.add_argument("--dataset", default=None,
                   help="with it: exact-rerank the candidates and print "
                   "exact scores (the serving answer)")
    q.add_argument("--metapath", default="APVPA")
    q.add_argument("--variant", default="rowsum",
                   choices=("rowsum", "diagonal"))
    q.add_argument("--headroom", type=float, default=0.25,
                   help="must match the value the index was built with")
    _platform_arg(q, "device of the probe: 'cuda' (default) fails when "
                  "no card is present; 'cpu' probes on the host")
    return p


def _device(args) -> str:
    """The action's device, resolved before any load: 'cuda' without a
    card raises DeviceUnavailable; on the card TF32 is turned off (the
    probe's GEMMs run in true f32)."""
    from ..utils.device import resolve_device

    device = resolve_device(args.platform).type
    if device == "cuda":
        from ..ops import cuda_kernels

        cuda_kernels.true_f32()
    return device


def _build(args) -> int:
    from .. import tuning
    from ..ops.metapath import compile_metapath
    from ..serving.cache import graph_fingerprint
    from .build import build_index, half_chain_and_denominators

    device = _device(args)
    if args.tuning_table:
        tuning.install_table(args.tuning_table)
    hin = _parse_dataset(args.dataset)
    if args.headroom:
        from ..data.delta import with_headroom

        hin = with_headroom(hin, args.headroom)
    metapath = compile_metapath(args.metapath, hin.schema)
    t0 = time.perf_counter()
    c, d = half_chain_and_denominators(hin, metapath, args.variant)
    index = build_index(
        c=c, d=d, variant=args.variant, metapath=metapath,
        embedding=args.embedding, model_path=args.model,
        n_centroids=args.centroids, cluster_cap=args.cluster_cap,
        token=(graph_fingerprint(hin), 0),
        seed=args.seed, max_dim=args.max_dim, device=device,
    )
    index.save(args.out)
    print(json.dumps({
        "out": args.out,
        "n": index.n,
        "dim": index.dim,
        "centroids": index.n_centroids,
        "cluster_cap": index.cluster_cap,
        "embedding": args.embedding,
        "base_fp": index.token[0],
        "build_s": round(time.perf_counter() - t0, 3),
    }, indent=2))
    return 0


def _probe(args) -> int:
    from .. import tuning
    from .mips import CentroidIndex

    device = _device(args)
    index = CentroidIndex.load(args.index, device=device)
    row = int(args.row)
    if not 0 <= row < index.n:
        raise ValueError(f"row {row} out of range [0, {index.n})")
    # the SAME heuristic serving resolves (serving/service._setup_ann):
    # an inspection tool probing a fraction of serving's clusters would
    # report missing candidates serving actually returns
    nprobe = args.nprobe or int(
        tuning.choose(
            "ann_nprobe", n=index.n,
            default=min(max(16, index.n_centroids // 3), 96),
        )
    )
    n_cand = max(args.k, args.cand_mult * args.k)
    sims, mem = index.probe_batch(np.asarray([row]), nprobe)
    cand = index.select_candidates(sims[0], mem[0], n_cand)
    out = {
        "row": row,
        "nprobe": nprobe,
        "stale": bool(index.stale[row]),
        "index": {
            "n": index.n, "dim": index.dim,
            "centroids": index.n_centroids,
            "cluster_cap": index.cluster_cap,
            "epoch": list(index.token),
            "embedding": index.meta.get("embedding"),
        },
        "candidates": [int(x) for x in cand[: max(args.k * 2, 20)]],
        "n_candidates": int(cand.shape[0]),
    }
    if args.dataset:
        from ..ops import pathsim
        from ..ops.metapath import compile_metapath
        from .build import half_chain_and_denominators

        hin = _parse_dataset(args.dataset)
        if args.headroom:
            from ..data.delta import with_headroom

            hin = with_headroom(hin, args.headroom)
        metapath = compile_metapath(args.metapath, hin.schema)
        c, d = half_chain_and_denominators(hin, metapath, args.variant)
        # candidates beyond this dataset's capacity mean a headroom
        # mismatch with the build — drop them rather than crash
        cand = cand[cand < c.shape[0]]
        counts = c[cand] @ c[row]
        scores = pathsim.score_candidates(
            counts[None, :], np.asarray([d[row]]), d[cand][None, :]
        )
        vals, idxs = pathsim.topk_from_candidate_scores(
            scores, cand[None, :], args.k
        )
        out["topk"] = [
            {"row": int(j), "score": float(v)}
            for v, j in zip(vals[0], idxs[0])
            if np.isfinite(v)
        ]
    print(json.dumps(out, indent=2))
    return 0


def index_main(argv: list[str] | None = None) -> int:
    args = build_index_parser().parse_args(argv)
    if args.action == "build":
        return _build(args)
    if args.action == "probe":
        return _probe(args)
    # unreachable: the subparser is required — but fail loudly, not
    # silently, if an action is ever added without a handler
    raise ValueError(f"unknown index action {args.action!r}")
