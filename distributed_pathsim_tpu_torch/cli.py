"""Command-line driver: the batch main path.

Replaces the reference's hard-coded ``__main__`` block
(``DPathSim_APVPA.py:112-180``) with a real CLI::

    dpathsim-torch --dataset g.gexf --source "Didier Dubois" \\
                   --backend torch --metapath APVPA --output out.log

and routes ``dpathsim-torch serve ...`` to the online serving entry
point (serving/cli.py), ``dpathsim-torch worker / router /
fleet-stats ...`` to the horizontal tier (router/cli.py), ``batch`` to
the campaigns (batch/cli.py), ``index build / probe`` to the ANN
tier's candidate index (index/cli.py), ``learned train / inspect``
to the learned tier's tower checkpoints (learned/cli.py), ``tune`` to
the offline autotuner (tuning/autotuner.py), which writes the table
``--tuning-table`` reads, and ``lint`` to the static analyzer
(analysis/cli.py), which never touches the card.

Runs on the CUDA card by default; ``--platform cpu`` runs the same path
on the host through the kernels' plain versions. Without a card and
without ``--platform cpu`` it refuses to run.
"""

from __future__ import annotations

import argparse
import os
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
        "whose score matrix cannot exist), torch-sharded (the chain "
        "row-sharded over --n-devices shards, ring top-k) or numpy (the "
        "host f64 oracle)",
    )
    p.add_argument(
        "--metapath",
        default="APVPA",
        help="metapath spec, e.g. APVPA; comma-separate several "
        "(e.g. APVPA,APTPA,APA) for batched multi-path scoring",
    )
    p.add_argument(
        "--weights",
        default=None,
        help="comma-separated per-metapath ensemble weights (multi-path mode)",
    )
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
        default="auto",
        choices=LOADERS,
        help="GEXF loader: 'native' requires the C++ parse+encode path "
        "(built with g++ into the package's _build/ at first use), "
        "'python' forces the pure-Python pipeline (escape hatch), "
        "'auto' prefers native with clean fallback",
    )
    p.add_argument(
        "--tile-rows",
        type=int,
        default=None,
        help="torch-sparse: rows per streaming tile (memory/throughput "
        "trade-off for the million-author regime; default through the "
        "tuning registry, 4096 untuned)",
    )
    p.add_argument(
        "--approx",
        action="store_true",
        help="torch / torch-sparse: waive the f32 exact-integer-count "
        "guard for graphs whose path counts exceed 2^24 (scores stay "
        "within the 1e-5 gate; only the guard is waived)",
    )
    p.add_argument(
        "--factor-format",
        default=None,
        choices=("coo", "blocked", "bitpacked"),
        help="torch-sparse: resident layout of the half-chain factor "
        "(ops/packed.py): the compressed layouts hold it in a fraction of "
        "the COO bytes, bit-identically; default resolves through the "
        "tuning registry ('coo' when untuned)",
    )
    p.add_argument(
        "--headroom",
        type=float,
        default=0.0,
        help="index-capacity reserve (fraction per node type) so array "
        "shapes survive node appends; results are bit-identical either "
        "way (mainly for `serve` update flows)",
    )
    p.add_argument("--source", default=None, help="source node label (e.g. author name)")
    p.add_argument("--source-id", default=None, help="source node id (e.g. author_395340)")
    p.add_argument("--output", default=None, help="reference-grammar log file")
    p.add_argument("--metrics", default=None, help="JSONL metrics file")
    p.add_argument("--top-k", type=int, default=0, help="print top-k similar nodes")
    p.add_argument("--all-pairs", action="store_true", help="compute the full score matrix")
    p.add_argument(
        "--n-devices",
        type=int,
        default=None,
        help="torch-sharded: shards of the row-sharded mesh (several may "
        "share one card; on the host they are virtual); default one per "
        "card. With a comma-separated --metapath: shards of the ensemble's "
        "all-sources ranking",
    )
    p.add_argument(
        "--dtype",
        default="float32",
        help="carry dtype of the device backends: float32, or float64 "
        "(real f64 rows and row sums; rank-all and all-pairs on the card "
        "run the f32 kernels behind the 2^24 guard)",
    )
    p.add_argument("--quiet", action="store_true", help="suppress stdout echo")
    p.add_argument(
        "--explain-plan",
        action="store_true",
        help="print the metapath evaluation plan (DP association "
        "order, estimated FLOPs/density per node) as JSON and exit "
        "without computing anything",
    )
    p.add_argument(
        "--profile-dir",
        default=None,
        help="write a torch.profiler trace of the run (Chrome JSON, "
        "trace.json: host ops and the card's kernels) here",
    )
    p.add_argument(
        "--trace-out",
        default=None,
        help="enable host-side span tracing and write Chrome/Perfetto "
        "trace-event JSON here at exit (bootstrap + run stage tree; "
        "combine with --profile-dir for the device timeline)",
    )
    p.add_argument(
        "--metrics-file",
        default=None,
        help="write one Prometheus textfile snapshot of the obs "
        "registry here at exit",
    )
    p.add_argument(
        "--ranking-out",
        default=None,
        help="with --top-k and no --source: write every node's top-k "
        "ranking as TSV here",
    )
    p.add_argument(
        "--checkpoint-dir",
        default=None,
        help="resumable ranking state (torch-sparse: completed row tiles "
        "are skipped on restart; torch-sharded: mid-ring resume from the "
        "last checkpointed ring step; SIGTERM flushes and exits 75)",
    )
    p.add_argument(
        "--tuning-table",
        default=None,
        help="measured dispatch table (JSON); absent/corrupt/"
        "version-mismatched tables degrade to the built-in heuristics "
        "with a tuning_fallback event. Default: the "
        "PATHSIM_TUNING_TABLE env var when set",
    )
    p.add_argument(
        "--no-tuning",
        action="store_true",
        help="ignore any tuning table (env included): every tile/bucket "
        "knob uses its built-in heuristic",
    )
    p.add_argument(
        "--max-retries",
        type=int,
        default=None,
        help="attempts per failure seam (GEXF load, compile, backend "
        "init, tile execute, checkpoint write); default from "
        "PATHSIM_MAX_RETRIES or 3. 1 disables retries",
    )
    p.add_argument(
        "--no-degrade",
        action="store_true",
        help="fail fast instead of stepping down the backend chain "
        "(torch-sharded→torch and torch-sparse→torch, and →numpy only "
        "with --platform cpu) when backend init keeps failing",
    )
    p.add_argument(
        "--coordinator-address",
        default=None,
        help="multi-process rendezvous address host:port "
        "(torch.distributed over tcp://); run the same command in every "
        "process with its own --process-id",
    )
    p.add_argument(
        "--num-processes",
        type=int,
        default=None,
        help="total processes in the multi-process job",
    )
    p.add_argument(
        "--process-id",
        type=int,
        default=None,
        help="this process's rank in the multi-process job",
    )
    return p


def parse_args(argv: list[str]):
    return build_parser().parse_args(argv)


# ``serve``: one warm service on stdin/stdout; ``worker``: one replica
# speaking the router-facing async protocol; ``router``: the
# fault-tolerant fan-out over N of them; ``fleet-stats``: the one-shot
# merged-fleet summary; ``batch``: corpus-scale campaigns (top-k for
# every row, the similarity join) with checkpointed resume; ``index``:
# build / probe the ANN tier's MIPS candidate index; ``learned``: train
# or inspect a tower checkpoint; ``tune``: measure every knob's arms on
# this device and write the dispatch table; ``lint``: the static
# analyzer over the port's sources.
SUBCOMMANDS = ("serve", "worker", "router", "fleet-stats", "batch", "index",
               "learned", "tune", "lint")


def _subcommand(name: str):
    if name == "serve":
        from .serving.cli import serve_main

        return serve_main
    if name == "batch":
        from .batch.cli import batch_main

        return batch_main
    if name == "index":
        from .index.cli import index_main

        return index_main
    if name == "learned":
        from .learned.cli import learned_main

        return learned_main
    if name == "tune":
        from .tuning.autotuner import tune_main

        return tune_main
    if name == "lint":
        # the static analyzer (analysis/): pure AST work over the port's
        # sources, so it builds no backend and never touches the card
        from .analysis.cli import lint_main

        return lint_main
    from .router import cli as router_cli

    return {
        "worker": router_cli.worker_main,
        "router": router_cli.router_main,
        "fleet-stats": router_cli.fleet_stats_main,
    }[name]


def main(argv: list[str] | None = None) -> int:
    from .resilience import PREEMPTED_EXIT_CODE, Preempted, preemption_handler

    # Subcommand routing (SUBCOMMANDS); everything else stays the
    # flag-driven batch CLI.
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in SUBCOMMANDS:
        try:
            return _subcommand(argv[0])(argv[1:])
        except _USER_ERRORS as exc:
            msg = exc.args[0] if exc.args else exc
            print(f"error: {msg}", file=sys.stderr)
            return 1
    # SIGTERM/SIGINT become a graceful preemption: the streaming tile
    # loop flushes its finished tiles through the CheckpointManager and
    # raises Preempted; we exit 75 (EX_TEMPFAIL — "re-run me") with a
    # one-line resume hint. A second signal aborts the drain.
    installed = preemption_handler.install()
    try:
        args = parse_args(argv)
        _init_multihost(args)  # before any device work or the profiler
        from .utils.profiling import device_trace

        with device_trace(args.profile_dir):
            return _run(args)
    except Preempted as exc:
        print(f"preempted: {exc}", file=sys.stderr)
        return PREEMPTED_EXIT_CODE
    except _USER_ERRORS as exc:
        # Known, user-actionable failures render as one clean line;
        # anything unexpected still gets a full traceback.
        msg = exc.args[0] if exc.args else exc
        print(f"error: {msg}", file=sys.stderr)
        return 1
    finally:
        if installed:
            preemption_handler.uninstall()
            preemption_handler.reset()
        from .parallel.multihost import shutdown_multihost

        shutdown_multihost()


_USER_ERRORS = (KeyError, ValueError, OverflowError, FileNotFoundError,
                NotImplementedError, DeviceUnavailable)


def _platform(args) -> str:
    """The run's device type, resolved before any load: 'cuda' without a
    card raises DeviceUnavailable; on the card TF32 is turned off."""
    platform = resolve_device(args.platform).type
    if platform == "cuda":
        cuda_kernels.true_f32()
    return platform


def _init_multihost(args) -> None:
    """The ``torch.distributed`` rendezvous, the product path onto a
    multi-process mesh. With no flags it is a no-op (or joins the job
    torchrun's environment names), so the same command works on one
    machine and in every process of a job. Processes other than 0 are
    muted: the same command runs everywhere, so a shared ``--output``,
    ``--metrics`` or ``--ranking-out`` path is written once."""
    if (
        args.num_processes is not None or args.process_id is not None
    ) and args.coordinator_address is None:
        raise ValueError(
            "--num-processes/--process-id require --coordinator-address"
        )
    from .parallel.multihost import (
        _CLUSTER_ENV_VARS,
        initialize_multihost,
        process_index,
    )

    rendezvous_requested = args.coordinator_address is not None or all(
        v in os.environ for v in _CLUSTER_ENV_VARS
    )
    if "," in args.metapath and rendezvous_requested:
        # refuse BEFORE the rendezvous: the ensemble scorer runs in one
        # process, so a job would run N identical copies
        raise ValueError(
            "multi-metapath mode does not support multi-process "
            "rendezvous (--coordinator-address or torchrun's MASTER_ADDR/"
            "WORLD_SIZE/RANK); it always runs the batched one-process "
            "scorer"
        )
    if rendezvous_requested and args.backend != "torch-sharded":
        # no other backend is job-aware: N processes would each run the
        # whole computation and interleave appends into shared paths
        raise ValueError(
            f"backend {args.backend!r} is single-process; multi-process "
            "rendezvous requires --backend torch-sharded"
        )
    if rendezvous_requested:
        resolve_device(args.platform)  # no card and no --platform cpu
    multi = initialize_multihost(
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes,
        process_id=args.process_id,
        platform=args.platform,
    )
    if multi and args.backend != "torch-sharded":
        # a job joined by a launcher before main()
        raise ValueError(
            f"backend {args.backend!r} is single-process; this is a "
            "multi-process job: use --backend torch-sharded"
        )
    if multi and process_index() != 0:
        args.output = None
        args.metrics = None
        args.ranking_out = None
        args.quiet = True


def _run(args) -> int:
    if args.max_retries is not None:
        # Seams deep in the stack (per-tile execute, checkpoint write)
        # build their policy from the environment — export the flag so
        # EVERY seam honors it, not just the bootstrap ones that receive
        # the policy object explicitly.
        os.environ["PATHSIM_MAX_RETRIES"] = str(args.max_retries)
    if args.explain_plan:
        return _explain_plan(args)
    if "," in args.metapath:
        return _run_multipath(args)
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
    if args.factor_format is not None and args.backend != "torch-sparse":
        raise ValueError(
            "--factor-format selects the resident layout of the "
            "sparse half-chain factor and requires --backend torch-sparse"
        )
    if args.n_devices is not None and args.backend != "torch-sharded":
        raise ValueError(
            "--n-devices sets the shards of the row-sharded mesh and "
            "requires --backend torch-sharded"
        )
    if args.approx and args.backend not in ("torch", "torch-sparse"):
        raise ValueError(
            "--approx waives the f32 exact-count guard of the device "
            "backends (torch, torch-sparse); the numpy oracle is f64-exact"
        )
    platform = _platform(args)  # before any load
    config = RunConfig(
        dataset=args.dataset,
        backend=args.backend,
        metapath=args.metapath,
        variant=args.variant,
        source=args.source,
        source_id=args.source_id,
        output=args.output,
        metrics=args.metrics,
        all_pairs=args.all_pairs,
        top_k=args.top_k,
        n_devices=args.n_devices,
        dtype=args.dtype,
        loader=args.loader,
        platform=platform,
        tile_rows=args.tile_rows,
        approx=args.approx,
        factor_format=args.factor_format,
        headroom=args.headroom,
        echo=not args.quiet,
        max_retries=args.max_retries,
        degrade=not args.no_degrade,
        tuning_table=args.tuning_table,
        tuning=not args.no_tuning,
    )

    from . import obs
    from .utils.logging import set_event_sink
    from .utils.profiling import StageTimer

    if args.trace_out:
        obs.configure(tracing=True)

    # One logger + timer for the whole run: bootstrap stage timings
    # (load/encode, metapath compile, backend init) and compute stages
    # all land in the same --metrics JSONL. Registering it as the event
    # sink routes resilience events (retry/degrade/preempt/injection)
    # into the same JSONL stream.
    logger = RunLogger(
        output_path=config.output, echo=config.echo, metrics_path=config.metrics
    )
    set_event_sink(logger)
    timer = StageTimer(logger, device=platform)
    try:
        return _run_modes(args, config, logger, timer)
    finally:
        set_event_sink(None)
        logger.close()
        if args.trace_out:
            print(obs.dump_trace(args.trace_out), file=sys.stderr)
        if args.metrics_file:
            obs.write_textfile(args.metrics_file)


def _explain_plan(args) -> int:
    """``--explain-plan``: load + compile + plan, never execute — and
    touch no device. The dump is the auditable record of every ordering
    choice (estimated FLOPs/density per node, DP vs left-to-right)."""
    import json

    from .engine import USE_NATIVE_BY_LOADER, load_dataset
    from .ops.metapath import compile_metapath
    from .ops.planner import plan_metapath

    hin = load_dataset(
        args.dataset, use_native=USE_NATIVE_BY_LOADER[args.loader]
    )
    out = {}
    for spec in [s.strip() for s in args.metapath.split(",") if s.strip()]:
        mp = compile_metapath(spec, hin.schema)
        out[mp.name] = plan_metapath(hin, mp).to_dict()
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


def _run_modes(args, config, logger: RunLogger, timer) -> int:
    hin, metapath, backend, driver = build(config, timer=timer)
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
        # reference's whole program. Streaming + resumable on
        # torch-sparse.
        with timer.stage("rank_all"):
            vals, idxs = driver.rank_all(
                k=args.top_k, checkpoint_dir=args.checkpoint_dir
            )
        print(f"Ranked top-{args.top_k} for all {vals.shape[0]} sources")
        if args.ranking_out:
            driver.write_ranking(args.ranking_out, vals, idxs)
            print(f"Ranking written to {args.ranking_out}")
        ran = True

    if args.all_pairs:
        with timer.stage("all_pairs"):
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


def _run_multipath(args) -> int:
    """Batched multi-metapath mode: per-path + combined scores, top-k."""
    from . import resilience
    from .engine import USE_NATIVE_BY_LOADER, load_dataset
    from .models.multipath import MultiMetapathScorer

    # The batched scorer is a fixed pipeline; reject flags it would
    # otherwise silently ignore (the JAX package's refusal table, with
    # the port's backend name).
    unsupported = {
        "--backend": args.backend != "torch",
        "--dtype": args.dtype != "float32",
        "--output": args.output is not None,
        "--metrics": args.metrics is not None,
        "--trace-out": args.trace_out is not None,
        "--metrics-file": args.metrics_file is not None,
        "--ranking-out": args.ranking_out is not None,
        "--checkpoint-dir": args.checkpoint_dir is not None,
        "--tile-rows": args.tile_rows is not None,
        "--approx": args.approx,
        "--factor-format": args.factor_format is not None,
        "--headroom": args.headroom != 0.0,
        # the batched scorer has no tuned knobs — refuse rather than
        # silently ignore a table the user thinks is active
        "--tuning-table": args.tuning_table is not None,
        "--no-tuning": args.no_tuning,
        # no backend chain to step down in this mode
        "--no-degrade": args.no_degrade,
    }
    bad = [flag for flag, hit in unsupported.items() if hit]
    if bad:
        raise ValueError(
            f"multi-metapath mode does not support {', '.join(bad)} "
            "(it always runs the batched torch scorer)"
        )
    if args.n_devices is not None and not (
        args.top_k and not (args.source or args.source_id)
    ):
        # never silently ignored: in this mode only the all-sources
        # ranking is sharded
        raise ValueError(
            "--n-devices in multi-metapath mode applies to the "
            "all-sources ranking (--top-k without --source)"
        )
    platform = _platform(args)
    hin = load_dataset(
        args.dataset,
        use_native=USE_NATIVE_BY_LOADER[args.loader],
        policy=resilience.policy_from_env(max_attempts=args.max_retries),
    )
    names = [s.strip() for s in args.metapath.split(",") if s.strip()]
    weights = (
        [float(w) for w in args.weights.split(",")] if args.weights else None
    )
    scorer = MultiMetapathScorer(hin, names, variant=args.variant,
                                 device=platform)
    if not args.quiet:
        print(f"Batched metapaths: {scorer.names}")
        gw = scorer.global_walks()
        denom_label = (
            "max global walk" if args.variant == "rowsum"
            else "max diag(M)"
        )
        for r, name in enumerate(scorer.names):
            print(f"  {name}: {denom_label} {int(gw[r].max())}")

    ran = False
    if args.source or args.source_id:
        node_type = scorer.metapaths[0].source_type
        idx = hin.resolve_source(
            node_type, label=args.source or None,
            node_id=args.source_id,
        )
        k = args.top_k or 10
        vals, idxs = scorer.topk_row(idx, k=k, weights=weights)
        labels = hin.indices[node_type].labels
        print(f"Top-{k} similar to {labels[idx]} (combined {scorer.names}):")
        for v, j in zip(vals, idxs):
            print(f"  {v:.6f}  {labels[j]} ({hin.indices[node_type].ids[j]})")
        ran = True
    if args.top_k and not (args.source or args.source_id):
        # All-sources ensemble ranking: sharded over a dp mesh with
        # --n-devices (MultiMetapathScorer.topk_sharded), the host
        # argpartition arm otherwise.
        if args.n_devices is not None:
            vals, idxs = scorer.topk_sharded(
                k=args.top_k, weights=weights, n_devices=args.n_devices
            )
            how = f"sharded over {args.n_devices} devices"
        else:
            vals, idxs = scorer.topk(k=args.top_k, weights=weights)
            how = "host"
        print(
            f"Ranked top-{vals.shape[1]} for all {vals.shape[0]} sources "
            f"(combined {scorer.names}, {how})"
        )
        ran = True
    if args.all_pairs:
        comb = scorer.combined_scores(weights)
        print(
            f"Combined all-pairs scores: {comb.shape[0]}x{comb.shape[1]}, "
            f"mean={comb.mean():.6g}, max offdiag={_max_offdiag(comb):.6g}"
        )
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
