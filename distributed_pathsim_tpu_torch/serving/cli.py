"""``dpathsim-torch serve`` — the online serving entry point.

Bootstraps the engine once (dataset, backend, metapath, variant,
platform), wraps the warm backend in a :class:`PathSimService`, and
speaks the JSONL protocol on stdin/stdout until EOF or a ``shutdown``
op::

    echo '{"id": 1, "op": "topk", "source": "Didier Dubois", "k": 5}' \\
        | dpathsim-torch serve --dataset dblp/dblp_small.gexf --backend torch

Runs on the CUDA card by default; ``--platform cpu`` runs on the host.
Without a card and without ``--platform cpu`` it refuses to start.
Structured events (bucket warm times, batch accounting, sheds, updates)
ride the ``--metrics`` JSONL channel; ``--metrics-file`` keeps a
Prometheus textfile of the live registry, rewritten every
``--metrics-interval`` seconds. Per-request metapaths share a sub-chain
memo (``--memo-budget-mb``, ``--max-metapaths``); background compaction
runs by default (``--no-compact``, ``--compact-*``); ``--factor-format``
holds torch-sparse's factor packed; ``--topk-mode ann`` answers through
the MIPS candidate index (``--index``, ``--ann-*``), ``--topk-mode
learned`` through the two-tower candidates of a tower checkpoint
(``--learned-checkpoint``, ``--learned-*``) or, without one, of towers
distilled in the service at startup (``--learned-dim``,
``--learned-steps``, ``--learned-neg-ratio``).

The setup helpers here (:func:`parse_known`, :func:`prepare_platform`,
:func:`run_config`, :func:`serve_config`, :func:`serving_process`) are
shared with ``dpathsim-torch worker`` (router/cli.py), which is
``serve`` with the router-facing loop.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from ..backends.base import available_backends
from ..config import RunConfig
from ..ops.pathsim import VARIANTS
from .service import ServeConfig, build_service

# Flags of the JAX package's ``dpathsim serve`` whose features the port
# does not have yet: none (the name stays for the commands that pass it
# to :func:`parse_known`).
NOT_PORTED_FLAGS: frozenset[str] = frozenset()


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dpathsim-torch serve",
        description="online PathSim serving on a CUDA card: JSONL "
        "queries on stdin, JSONL answers on stdout",
    )
    p.add_argument("--dataset", required=True, help="GEXF file path")
    p.add_argument("--backend", default="torch", choices=available_backends())
    p.add_argument(
        "--metapath", default="APVPA",
        help="default served metapath; requests may override per query "
        "via the protocol's 'metapath' field (closed metapaths only)",
    )
    p.add_argument(
        "--memo-budget-mb", type=float, default=None,
        help="sub-chain memo budget shared by all metapath engines "
        "(default: the tuned plan_memo_budget_mb knob; 0 disables)",
    )
    p.add_argument(
        "--max-metapaths", type=int, default=8,
        help="bound on lazily-built per-request metapath engines",
    )
    p.add_argument("--variant", default="rowsum", choices=list(VARIANTS))
    p.add_argument(
        "--platform", default="cuda", choices=("cuda", "cpu"),
        help="device: 'cuda' (default) fails when no card is present; "
        "'cpu' serves from the host",
    )
    p.add_argument("--dtype", default="float32",
                   help="carry dtype of the backend (float32 or float64)")
    p.add_argument("--n-devices", type=int, default=None,
                   help="torch-sharded: shards of the row-sharded mesh")
    p.add_argument(
        "--loader", default="auto", choices=("auto", "python", "native"),
        help="GEXF loader: 'native' requires the C++ parse+encode path, "
        "'python' forces the pure-Python pipeline, 'auto' prefers native "
        "with clean fallback",
    )
    p.add_argument(
        "--tuning-table", default=None,
        help="measured dispatch table (JSON; drives the tile and bucket "
        "choices incl. the warmup ladder); unusable tables degrade to "
        "heuristics with a tuning_fallback event. Default: the "
        "PATHSIM_TUNING_TABLE env var when set",
    )
    p.add_argument(
        "--no-tuning", action="store_true",
        help="ignore any tuning table (env included)",
    )
    p.add_argument(
        "--tile-rows", type=int, default=None,
        help="torch-sparse: rows per streaming tile",
    )
    p.add_argument(
        "--approx", action="store_true",
        help="torch / torch-sparse: waive the f32 exact-integer-count guard",
    )
    p.add_argument(
        "--factor-format", default=None,
        choices=("coo", "blocked", "bitpacked"),
        help="torch-sparse: resident layout of the half-chain factor "
        "(ops/packed.py): the compressed layouts hold it in a fraction of "
        "the COO bytes, bit-identically; default resolves through the "
        "tuning registry ('coo' when untuned)",
    )
    p.add_argument("--metrics", default=None, help="JSONL metrics/events file")
    p.add_argument(
        "--metrics-file", default=None,
        help="Prometheus textfile: counters/gauges/latency histograms "
        "re-written atomically every --metrics-interval (node-exporter "
        "textfile-collector format)",
    )
    p.add_argument(
        "--metrics-interval", type=float, default=5.0,
        help="seconds between --metrics-file snapshots",
    )
    p.add_argument("--k", type=int, default=10, help="default top-k")
    p.add_argument(
        "--max-batch", type=int, default=32,
        help="coalescing cap; buckets are powers of two up to this",
    )
    p.add_argument(
        "--max-wait-ms", type=float, default=2.0,
        help="how long a formed batch waits for stragglers",
    )
    p.add_argument(
        "--queue-depth", type=int, default=256,
        help="admission bound; requests beyond it are shed",
    )
    p.add_argument(
        "--cache-entries", type=int, default=4096,
        help="result LRU capacity (0 disables tier 1)",
    )
    p.add_argument(
        "--tile-cache-mb", type=float, default=64.0,
        help="hot-tile score cache budget (0 disables tier 2)",
    )
    p.add_argument(
        "--no-warm", action="store_true",
        help="skip driving the shape buckets at startup",
    )
    p.add_argument(
        "--batch-events", action="store_true",
        help="emit a JSONL event per dispatched batch",
    )
    p.add_argument(
        "--headroom", type=float, default=0.25,
        help="index-capacity reserve for in-place 'update' ops "
        "(fraction of each type's size; 0 disables — every node append "
        "then forces a full rebuild)",
    )
    p.add_argument(
        "--delta-threshold", type=float, default=0.05,
        help="'update' batches changing more than this fraction of "
        "edges rebuild instead of patching",
    )
    p.add_argument(
        "--no-compact", action="store_true",
        help="disable automatic background compaction (the 'compact' "
        "op still works on demand); without it, headroom exhaustion "
        "falls back to the synchronous inline rebuild",
    )
    p.add_argument(
        "--compact-chain-len", type=int, default=None,
        help="deltas absorbed since the last re-encode before a "
        "background compaction triggers (default: the tuned "
        "compact_chain_len knob)",
    )
    p.add_argument(
        "--compact-headroom-frac", type=float, default=0.10,
        help="compact when the capacity reserve falls below this "
        "fraction of the logical size (types that reserved headroom "
        "at build only)",
    )
    p.add_argument(
        "--compact-headroom", type=float, default=None,
        help="fresh capacity reserve of a compaction re-encode, as a "
        "fraction of size, padded to pow-2 (default: the tuned "
        "compact_headroom knob)",
    )
    p.add_argument(
        "--compact-cooldown", type=float, default=5.0,
        help="seconds between background compactions",
    )
    p.add_argument(
        "--trace-out", default=None,
        help="enable request tracing and write the span ring as "
        "Chrome/Perfetto trace-event JSON here on shutdown",
    )
    p.add_argument(
        "--trace-sample", type=int, default=1,
        help="trace every Nth request (head sampling; 1 = every request)",
    )
    p.add_argument(
        "--no-metrics", action="store_true",
        help="disable the in-process metrics registry entirely "
        "(stats/metrics ops then report zeros)",
    )
    p.add_argument(
        "--topk-mode", default="exact",
        choices=("exact", "ann", "learned"),
        help="default topk answer path: 'exact' scores the full O(N) "
        "row; 'ann' probes the MIPS candidate index and exact-reranks "
        "C >> k candidates; 'learned' shortlists via the two-tower "
        "encoder (--learned-checkpoint, or towers distilled at startup) "
        "and exact-reranks (per-request "
        "override via the protocol's 'mode' field; ineligible rows "
        "silently degrade learned -> ann -> exact, counted per reason)",
    )
    p.add_argument(
        "--index", default=None,
        help="prebuilt `dpathsim-torch index build` artifact (.npz); "
        "must match the served graph's base fingerprint. Absent with "
        "--topk-mode ann, the struct-embedded index is built "
        "in-process at startup",
    )
    p.add_argument(
        "--ann-nprobe", type=int, default=None,
        help="clusters probed per ANN query (default: tuning registry)",
    )
    p.add_argument(
        "--ann-cand-mult", type=int, default=None,
        help="candidates per ANN query as a multiple of k (default: "
        "tuning registry)",
    )
    p.add_argument(
        "--ann-centroids", type=int, default=None,
        help="centroid count for the in-process index build "
        "(default: tuned multiplier on sqrt(N))",
    )
    p.add_argument(
        "--ann-cluster-cap", type=int, default=None,
        help="packed-cluster capacity for the in-process index build "
        "(default: tuning registry / auto)",
    )
    p.add_argument(
        "--ann-variant", default=None,
        choices=("rerank-all", "shortlist"),
        help="candidate-generation strategy (default: tuning "
        "registry; 'rerank-all' exact-reranks every probed member, "
        "'shortlist' cuts to cand_mult*k by embedding similarity "
        "first)",
    )
    p.add_argument(
        "--ann-shadow-every", type=int, default=64,
        help="every Nth ANN dispatch also runs the exact oracle and "
        "feeds the recall-confidence gate (0 disables shadowing)",
    )
    p.add_argument(
        "--no-ann-refresh", action="store_true",
        help="disable the background re-embed of delta-staled index "
        "rows (they then stay on the exact path until the "
        "'refresh_index' op)",
    )
    p.add_argument(
        "--learned-checkpoint", default=None,
        help="tower checkpoint (.npz) written by `dpathsim-torch learned "
        "train` or the JAX package's `dpathsim learned train`; must match "
        "the served graph's base fingerprint and token. Absent with "
        "--topk-mode learned, a tower is distilled in-process at startup",
    )
    p.add_argument(
        "--learned-dim", type=int, default=None,
        help="tower output width for the in-process distillation "
        "(default: tuning registry)",
    )
    p.add_argument(
        "--learned-steps", type=int, default=200,
        help="distillation steps for the in-process startup training",
    )
    p.add_argument(
        "--learned-neg-ratio", type=float, default=None,
        help="uniform-negative fraction of in-process training slates "
        "(default: tuning registry)",
    )
    p.add_argument(
        "--learned-cand-mult", type=int, default=None,
        help="candidates per learned query as a multiple of k "
        "(default: tuning registry)",
    )
    p.add_argument(
        "--learned-shadow-every", type=int, default=64,
        help="every Nth learned dispatch also runs the exact oracle "
        "and feeds the recall-confidence gate (0 disables shadowing)",
    )
    p.add_argument(
        "--learned-recall-floor", type=float, default=None,
        help="shadow score-recall floor below which the learned arm "
        "disables itself (default: tuning registry)",
    )
    p.add_argument(
        "--no-learned-refresh", action="store_true",
        help="disable the background tower re-embed after deltas "
        "(stale/appended rows then degrade until the "
        "'refresh_towers' op)",
    )
    return p


def parse_known(parser: argparse.ArgumentParser, argv, not_ported,
                command: str = "serve"):
    """Parse ``argv``; a flag of the JAX package's command that the port
    lacks (``not_ported``) raises ValueError naming it; any other unknown
    flag is argparse's usage error."""
    args, rest = parser.parse_known_args(argv)
    for token in rest:
        flag = token.split("=", 1)[0]
        if flag in not_ported:
            raise ValueError(f"{command} {flag} is not ported yet")
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    return args


def parse_serve_args(argv: list[str] | None):
    return parse_known(build_serve_parser(), argv, NOT_PORTED_FLAGS)


def prepare_platform(args) -> str:
    """The flag checks ``serve`` and ``worker`` share, then the device:
    'cuda' without a card raises DeviceUnavailable before any load."""
    if "," in args.metapath:
        raise ValueError(
            "serve runs one metapath per service; multi-metapath "
            "ensembles are not served yet"
        )
    if args.tile_rows is not None and args.backend != "torch-sparse":
        raise ValueError(
            "--tile-rows tunes the streaming tiled path and requires "
            "--backend torch-sparse"
        )
    if args.n_devices is not None and args.backend != "torch-sharded":
        raise ValueError(
            "--n-devices sets the shards of the row-sharded mesh and "
            "requires --backend torch-sharded"
        )
    if (args.factor_format is not None and args.backend != "torch-sparse"
            and getattr(args, "partition_index", None) is None):
        # other backends would swallow the option and serve uncompressed
        # without a word (a partition worker's slice honors it whatever
        # --backend says: the slice layout is its own surface)
        raise ValueError(
            "--factor-format selects the resident layout of the "
            "sparse half-chain factor and requires --backend torch-sparse"
        )
    from ..ops import cuda_kernels
    from ..utils.device import resolve_device

    platform = resolve_device(args.platform).type
    if platform == "cuda":
        cuda_kernels.true_f32()
    return platform


def run_config(args, platform: str) -> RunConfig:
    return RunConfig(
        dataset=args.dataset,
        backend=args.backend,
        metapath=args.metapath,
        variant=args.variant,
        platform=platform,
        dtype=args.dtype,
        n_devices=args.n_devices,
        tile_rows=args.tile_rows,
        approx=args.approx,
        factor_format=args.factor_format,
        headroom=args.headroom,
        loader=args.loader,
        tuning_table=args.tuning_table,
        tuning=not args.no_tuning,
        echo=False,
    )


def serve_config(args) -> ServeConfig:
    return ServeConfig(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        queue_depth=args.queue_depth,
        cache_entries=args.cache_entries,
        tile_cache_bytes=int(args.tile_cache_mb * (1 << 20)),
        k_default=args.k,
        warm=not args.no_warm,
        batch_events=args.batch_events,
        delta_threshold=args.delta_threshold,
        memo_budget_mb=args.memo_budget_mb,
        max_metapaths=args.max_metapaths,
        compact_auto=not args.no_compact,
        compact_chain_len=args.compact_chain_len,
        compact_headroom_frac=args.compact_headroom_frac,
        compact_headroom=args.compact_headroom,
        compact_cooldown_s=args.compact_cooldown,
        topk_mode=args.topk_mode,
        index_path=args.index,
        ann_nprobe=args.ann_nprobe,
        ann_cand_mult=args.ann_cand_mult,
        ann_centroids=args.ann_centroids,
        ann_cluster_cap=args.ann_cluster_cap,
        ann_variant=args.ann_variant,
        ann_shadow_every=args.ann_shadow_every,
        ann_auto_refresh=not args.no_ann_refresh,
        learned_checkpoint=args.learned_checkpoint,
        learned_dim=args.learned_dim,
        learned_steps=args.learned_steps,
        learned_neg_ratio=args.learned_neg_ratio,
        learned_cand_mult=args.learned_cand_mult,
        learned_shadow_every=args.learned_shadow_every,
        learned_recall_floor=args.learned_recall_floor,
        learned_auto_refresh=not args.no_learned_refresh,
    )


@contextlib.contextmanager
def serving_process(args, artifacts: bool = True):
    """The process-level switches of a serving process, flipped for the
    duration: the obs registry and tracer, the ``--metrics`` JSONL event
    sink, the ``--metrics-file`` Prometheus exporter (started by the
    caller once the service is up — ``start`` is yielded — and given a
    final write on exit) and SIGTERM/SIGINT → a latched graceful drain.
    ``--trace-out`` is written on exit. ``artifacts=False`` (the router,
    whose ``--metrics-file`` and ``--trace-out`` are fleet-wide) skips
    the exporter and the trace file."""
    from .. import obs
    from ..resilience import preemption_handler
    from ..utils.logging import RunLogger, set_event_sink

    obs.configure(
        metrics=not args.no_metrics,
        tracing=True if args.trace_out else None,
        trace_sample=args.trace_sample,
    )
    exporter = (
        obs.PrometheusTextfileExporter(
            args.metrics_file, interval_s=args.metrics_interval
        )
        if artifacts and args.metrics_file
        else None
    )
    logger = RunLogger(output_path=None, echo=False,
                       metrics_path=args.metrics)
    set_event_sink(logger)
    installed = preemption_handler.install()
    try:
        yield (exporter.start if exporter is not None else lambda: None)
    finally:
        if exporter is not None:
            exporter.stop()  # final write: shutdown state preserved
        if artifacts and args.trace_out:
            print(obs.dump_trace(args.trace_out), file=sys.stderr)
        if installed:
            preemption_handler.uninstall()
            preemption_handler.reset()
        set_event_sink(None)
        logger.close()


def serve_main(argv: list[str] | None = None) -> int:
    args = parse_serve_args(argv)
    platform = prepare_platform(args)  # before any load

    from .protocol import serve_loop

    config = run_config(args, platform)
    with serving_process(args) as start_exporter:
        service = build_service(config, serve_config(args))
        try:
            start_exporter()
            print(
                f"serving {service.metapath.name} over {service.n} "
                f"{service.node_type}s (backend={service.backend.name}, "
                f"platform={platform}); JSONL on stdin",
                file=sys.stderr,
            )
            # SIGTERM/SIGINT → graceful drain: serve_loop notices the
            # latched request at the next protocol event, completes
            # in-flight work and returns 0 (serving/protocol.py).
            return serve_loop(service, sys.stdin, sys.stdout)
        finally:
            service.close()
