"""Command-line driver: the batch main path.

Replaces the reference's hard-coded ``__main__`` block
(``DPathSim_APVPA.py:112-180``) with a real CLI::

    dpathsim-torch --dataset g.gexf --source "Didier Dubois" \\
                   --backend torch --metapath APVPA --output out.log

and routes ``dpathsim-torch serve ...`` to the online serving entry
point (serving/cli.py) and ``dpathsim-torch worker / router /
fleet-stats ...`` to the horizontal tier (router/cli.py).

Runs on the CUDA card by default; ``--platform cpu`` runs the same path
on the host through the kernels' plain versions. Without a card and
without ``--platform cpu`` it refuses to run.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .backends.base import available_backends
from .config import RunConfig
from .engine import LOADERS, build
from .ops import cuda_kernels
from .ops.pathsim import VARIANTS
from .utils.device import DeviceUnavailable, resolve_device
from .utils.logging import RunLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dpathsim-torch",
        description="Meta-path similarity (PathSim) over HINs on a CUDA card",
    )
    p.add_argument("--dataset", required=True, help="GEXF file path")
    p.add_argument(
        "--backend",
        default="torch",
        choices=available_backends(),
        help="execution backend: torch (the dense device path), "
        "torch-sparse (the streaming row-tiled device path, for graphs "
        "whose score matrix cannot exist) or numpy (the host f64 oracle)",
    )
    p.add_argument("--metapath", default="APVPA", help="metapath spec, e.g. APVPA")
    p.add_argument("--variant", default="rowsum", choices=list(VARIANTS))
    p.add_argument(
        "--platform",
        default="cuda",
        choices=("cuda", "cpu"),
        help="device: 'cuda' (default) fails when no card is present; "
        "'cpu' runs the kernels' plain versions on the host",
    )
    p.add_argument(
        "--loader",
        default="python",
        choices=LOADERS,
        help="GEXF loader ('native' is not ported yet)",
    )
    p.add_argument("--source", default=None, help="source node label (e.g. author name)")
    p.add_argument("--source-id", default=None, help="source node id (e.g. author_395340)")
    p.add_argument("--output", default=None, help="reference-grammar log file")
    p.add_argument("--top-k", type=int, default=0, help="print top-k similar nodes")
    p.add_argument("--all-pairs", action="store_true", help="compute the full score matrix")
    p.add_argument("--quiet", action="store_true", help="suppress stdout echo")
    p.add_argument(
        "--ranking-out",
        default=None,
        help="with --top-k and no --source: write every node's top-k "
        "ranking as TSV here",
    )
    p.add_argument(
        "--checkpoint-dir",
        default=None,
        help="torch-sparse: resumable ranking state (completed row tiles "
        "are skipped on restart)",
    )
    p.add_argument(
        "--tile-rows",
        type=int,
        default=None,
        help="torch-sparse: rows per streaming tile (memory/throughput "
        "trade-off for the million-author regime)",
    )
    p.add_argument(
        "--approx",
        action="store_true",
        help="torch / torch-sparse: waive the f32 exact-integer-count "
        "guard for graphs whose path counts exceed 2^24 (scores stay "
        "within the 1e-5 gate; only the guard is waived)",
    )
    return p


# ``serve``: one warm service on stdin/stdout; ``worker``: one replica
# speaking the router-facing async protocol; ``router``: the
# fault-tolerant fan-out over N of them; ``fleet-stats``: the one-shot
# merged-fleet summary; ``batch``: the JAX package's corpus-scale
# campaigns, not ported yet.
SUBCOMMANDS = ("serve", "worker", "router", "fleet-stats", "batch")


def _subcommand(name: str):
    if name == "serve":
        from .serving.cli import serve_main

        return serve_main
    if name == "batch":
        raise NotImplementedError(
            "batch campaigns (dpathsim batch, router/batch.py) are not "
            "ported yet"
        )
    from .router import cli as router_cli

    return {
        "worker": router_cli.worker_main,
        "router": router_cli.router_main,
        "fleet-stats": router_cli.fleet_stats_main,
    }[name]


def main(argv: list[str] | None = None) -> int:
    # Subcommand routing (SUBCOMMANDS); everything else stays the
    # flag-driven batch CLI.
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in SUBCOMMANDS:
        try:
            return _subcommand(argv[0])(argv[1:])
        except (KeyError, ValueError, OverflowError, FileNotFoundError,
                NotImplementedError, DeviceUnavailable) as exc:
            msg = exc.args[0] if exc.args else exc
            print(f"error: {msg}", file=sys.stderr)
            return 1
    args = build_parser().parse_args(argv)
    try:
        return _run(args)
    except (KeyError, ValueError, OverflowError, FileNotFoundError,
            NotImplementedError, DeviceUnavailable) as exc:
        # Known, user-actionable failures render as one clean line;
        # anything unexpected still gets a full traceback.
        msg = exc.args[0] if exc.args else exc
        print(f"error: {msg}", file=sys.stderr)
        return 1


def _run(args) -> int:
    if args.ranking_out or args.checkpoint_dir:
        # Both flags belong to the all-sources ranking mode (--top-k with
        # no source); refuse bad combinations up front — the source
        # conflict first, since no --top-k value fixes that one.
        if args.source or args.source_id:
            raise ValueError(
                "--ranking-out/--checkpoint-dir rank ALL sources and "
                "cannot be combined with --source/--source-id"
            )
        if not args.top_k:
            raise ValueError(
                "--ranking-out/--checkpoint-dir requires --top-k "
                "(the all-sources ranking mode)"
            )
    if args.tile_rows is not None and args.backend != "torch-sparse":
        raise ValueError(
            "--tile-rows tunes the streaming tiled path and requires "
            "--backend torch-sparse"
        )
    if args.approx and args.backend not in ("torch", "torch-sparse"):
        raise ValueError(
            "--approx waives the f32 exact-count guard of the device "
            "backends (torch, torch-sparse); the numpy oracle is f64-exact"
        )
    platform = resolve_device(args.platform).type  # before any load
    if platform == "cuda":
        cuda_kernels.true_f32()
    config = RunConfig(
        dataset=args.dataset,
        backend=args.backend,
        metapath=args.metapath,
        variant=args.variant,
        source=args.source,
        source_id=args.source_id,
        output=args.output,
        all_pairs=args.all_pairs,
        top_k=args.top_k,
        loader=args.loader,
        platform=platform,
        tile_rows=args.tile_rows,
        approx=args.approx,
        echo=not args.quiet,
    )
    logger = RunLogger(output_path=config.output, echo=config.echo)
    try:
        return _run_modes(args, config, logger)
    finally:
        logger.close()


def _run_modes(args, config, logger: RunLogger) -> int:
    hin, metapath, backend, driver = build(config)
    if config.echo:
        counts = {t: hin.type_size(t) for t in hin.schema.node_types}
        # The reference prints totals at load (DPathSim_APVPA.py:126-127).
        print(f"Total nodes: {sum(counts.values())}")
        print(f"Total edges: {sum(b.nnz for b in hin.blocks.values())}")
        print(f"Node types: {counts}")
        print(f"Metapath {metapath.name}: {list(metapath.steps)} "
              f"(symmetric={metapath.is_symmetric}) backend={backend.name}")

    ran = False
    if args.source or args.source_id:
        result = driver.run_single_source(
            source=args.source or args.source_id,
            by_label=args.source is not None,
            logger=logger,
        )
        ran = True
        if args.top_k:
            print(f"Top-{args.top_k} similar to {result.source_label}:")
            for nid, label, score in driver.top_k(
                args.source or args.source_id,
                k=args.top_k,
                by_label=args.source is not None,
            ):
                print(f"  {score:.6f}  {label} ({nid})")

    if args.top_k and not (args.source or args.source_id):
        # No source = rank every node, the batched form of the
        # reference's whole program.
        vals, idxs = driver.rank_all(
            k=args.top_k, checkpoint_dir=args.checkpoint_dir
        )
        print(f"Ranked top-{args.top_k} for all {vals.shape[0]} sources")
        if args.ranking_out:
            driver.write_ranking(args.ranking_out, vals, idxs)
            print(f"Ranking written to {args.ranking_out}")
        ran = True

    if args.all_pairs:
        scores = driver.run_all_pairs()
        n = scores.shape[0]
        print(f"All-pairs scores: {n}x{n}, mean={scores.mean():.6g}, "
              f"max offdiag={_max_offdiag(scores):.6g}")
        ran = True

    if not ran:
        print("Nothing to do: pass --source/--source-id, --top-k, "
              "and/or --all-pairs", file=sys.stderr)
        return 2
    return 0


def _max_offdiag(scores) -> float:
    m = scores.copy()
    np.fill_diagonal(m, -np.inf)
    return float(m.max())


if __name__ == "__main__":
    raise SystemExit(main())
