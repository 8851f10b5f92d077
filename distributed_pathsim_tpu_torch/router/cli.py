"""``dpathsim-torch router`` / ``worker`` / ``fleet-stats`` — the
horizontal tier's CLIs.

``worker`` is ``serve`` with the router-facing loop (router/worker.py):
async query completion, health probes, request-id dedup, graceful
drain. It accepts every serve flag plus ``--worker-id``, and grows one
dataset scheme: ``--dataset synthetic:authors=..,papers=..,venues=..,
seed=..`` builds the deterministic synthetic HIN in-process — the same
graph for every worker given the same spec (and the same graph the JAX
package's worker builds from it), which is what the router's
same-base-fingerprint startup check enforces and what lets tests and
benches bring up a replica set with no file staging.

``router`` spawns N ``python -m distributed_pathsim_tpu_torch.cli
worker`` children with the SAME serving flags (``--platform`` included;
it defaults to ``cuda``, so every worker of one router shares the
card), waits for their ready events, and speaks the serve JSONL
protocol upstream on stdin/stdout — a drop-in horizontal replacement
for one ``dpathsim-torch serve`` process::

    dpathsim-torch router --workers 2 --dataset dblp/dblp_small.gexf \\
        --backend torch --routing hash

SIGTERM drains gracefully: new requests are rejected, in-flight ones
complete, workers drain in turn, exit 0.

``router --mode partition`` shards ONE graph across the workers
instead (router/partition.py): worker ``w<i>`` runs with
``--partition-index i --partitions N --partition-replication R`` and
holds range i plus the next R − 1 ranges of the half-chain factor
(serving/partition.py); queries scatter over the ranges and merge
exactly. ``--factor-format`` is forwarded to every worker
(torch-sparse's packed layouts; in partition mode the slice's layout),
and so are the ANN flags (``--topk-mode ann``, ``--index``, ``--ann-*``:
each replica builds or loads its own candidate index) and the learned
flags (``--topk-mode learned``, ``--learned-checkpoint``,
``--learned-*``: each replica loads the towers, or distills its own
without a checkpoint).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

from ..utils.logging import runtime_event
from .core import Router, RouterConfig, RouterShed
from .transport import SubprocessTransport


def _parse_synthetic(spec: str) -> dict:
    """``synthetic:authors=384,papers=640,venues=12,seed=7`` → kwargs."""
    fields = {}
    body = spec.split(":", 1)[1]
    for part in body.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        fields[key.strip()] = int(val)
    kwargs = {
        "n_authors": fields.pop("authors"),
        "n_papers": fields.pop("papers"),
        "n_venues": fields.pop("venues"),
        "n_topics": fields.pop("topics", 0),
        "seed": fields.pop("seed", 0),
    }
    if fields.pop("ids", 0):
        kwargs["materialize_ids"] = True
    if fields:
        raise ValueError(f"unknown synthetic dataset fields {sorted(fields)}")
    return kwargs


def build_worker_parser() -> argparse.ArgumentParser:
    from ..serving.cli import build_serve_parser

    p = build_serve_parser()
    p.prog = "dpathsim-torch worker"
    p.description = (
        "router-facing PathSim worker: one warm replica speaking the "
        "async JSONL protocol (health probes, request-id dedup, "
        "graceful drain) on stdin/stdout"
    )
    p.add_argument("--worker-id", default="w0",
                   help="replica identity (routing, events, heartbeats); "
                   "must not contain ':'")
    # partition mode: this worker holds only a row-range slice of the
    # half-chain factor and serves the partition exchange ops instead of
    # whole queries
    p.add_argument("--partition-index", type=int, default=None,
                   help="partition index this worker owns (enables "
                   "partition mode; requires --partitions)")
    p.add_argument("--partitions", type=int, default=None,
                   help="total partition count of the fleet")
    p.add_argument("--partition-replication", type=int, default=2,
                   help="chained replication factor: this worker also "
                   "mirrors the next R-1 partitions' ranges")
    return p


def parse_worker_args(argv: list[str] | None):
    from ..serving.cli import NOT_PORTED_FLAGS, parse_known

    return parse_known(build_worker_parser(), argv, NOT_PORTED_FLAGS,
                       "worker")


def build_worker_hin(dataset: str, headroom: float):
    """A ``synthetic:`` dataset spec → the encoded HIN with ``headroom``
    reserved (None for any other dataset: the engine loads it)."""
    if not dataset.startswith("synthetic:"):
        return None
    from ..data.delta import with_headroom
    from ..data.synthetic import synthetic_hin

    hin = synthetic_hin(**_parse_synthetic(dataset))
    return with_headroom(hin, headroom) if headroom else hin


def build_partition_service(args, platform: str):
    """Partition-flag args → a PartitionService holding only its slice
    (the full HIN is fingerprinted, sliced and dropped); its window
    counts run on ``platform``."""
    from ..engine import USE_NATIVE_BY_LOADER, load_dataset
    from ..ops.metapath import compile_metapath
    from ..serving.partition import PartitionConfig, PartitionService

    if args.partitions is None or args.partitions < 1:
        raise ValueError("--partition-index requires --partitions >= 1")
    if not 0 <= args.partition_index < args.partitions:
        raise ValueError(
            f"--partition-index {args.partition_index} out of range "
            f"[0, {args.partitions})"
        )
    hin = build_worker_hin(args.dataset, args.headroom)
    if hin is None:
        from ..data.delta import with_headroom

        hin = load_dataset(args.dataset,
                           use_native=USE_NATIVE_BY_LOADER[args.loader])
        if args.headroom:
            hin = with_headroom(hin, args.headroom)
    metapath = compile_metapath(args.metapath, hin.schema)
    return PartitionService(
        hin, metapath,
        part_index=args.partition_index,
        n_parts=args.partitions,
        replication=args.partition_replication,
        config=PartitionConfig(
            variant=args.variant, k_default=args.k,
            factor_format=args.factor_format, device=platform,
        ),
    )


def worker_main(argv: list[str] | None = None) -> int:
    args = parse_worker_args(argv)
    if ":" in args.worker_id:
        raise ValueError("--worker-id must not contain ':'")
    from ..serving.cli import (
        prepare_platform,
        run_config,
        serve_config,
        serving_process,
    )
    from ..serving.service import build_service
    from .worker import WorkerRuntime, worker_loop

    platform = prepare_platform(args)  # before any load
    config = run_config(args, platform)
    with serving_process(args) as start_exporter:
        if args.partition_index is not None:
            service = build_partition_service(args, platform)
        else:
            service = build_service(
                config, serve_config(args),
                hin=build_worker_hin(args.dataset, args.headroom),
            )
        try:
            start_exporter()
            runtime = WorkerRuntime(service, worker_id=args.worker_id)
            print(
                f"worker {args.worker_id}: {service.metapath.name} over "
                f"{service.n} rows (backend={service.backend.name}, "
                f"platform={platform})",
                file=sys.stderr,
            )
            return worker_loop(runtime, sys.stdin, sys.stdout)
        finally:
            service.close()


# flags forwarded verbatim from the router's command line to each
# worker child (store-value flags; store-true flags handled below)
_FORWARD_VALUE = (
    "dataset", "backend", "metapath", "variant", "loader", "platform",
    "dtype", "n_devices", "tile_rows", "k", "max_batch", "max_wait_ms", "queue_depth",
    "cache_entries", "tile_cache_mb", "headroom", "delta_threshold",
    "tuning_table", "metrics_interval", "trace_sample", "factor_format",
    "compact_chain_len", "compact_headroom_frac", "compact_headroom",
    "compact_cooldown", "topk_mode", "index", "ann_nprobe", "ann_cand_mult",
    "ann_centroids", "ann_cluster_cap", "ann_variant", "ann_shadow_every",
    "learned_checkpoint", "learned_dim", "learned_steps",
    "learned_neg_ratio", "learned_cand_mult", "learned_shadow_every",
    "learned_recall_floor",
)
_FORWARD_TRUE = ("no_warm", "no_metrics", "no_tuning", "approx",
                 "batch_events", "no_compact", "no_ann_refresh",
                 "no_learned_refresh")
# artifact-path flags forwarded with a per-worker suffix: a fleet run
# with --metrics-file/--trace-out/--metrics must leave N+1 artifacts
# (one per process), not N processes clobbering one path
_FORWARD_PATH = ("metrics_file", "trace_out", "metrics")


def _suffix_path(path: str, wid: str) -> str:
    """``fleet.prom`` → ``fleet.w0.prom`` (suffix before the extension
    so collectors globbing ``*.prom`` still pick every worker up)."""
    root, ext = os.path.splitext(path)
    return f"{root}.{wid}{ext}" if ext else f"{path}.{wid}"


def build_router_parser() -> argparse.ArgumentParser:
    from ..serving.cli import build_serve_parser

    p = build_serve_parser()
    p.prog = "dpathsim-torch router"
    p.description = (
        "fault-tolerant horizontal serving: fan the serve JSONL "
        "protocol over N dpathsim-torch worker replicas with failover, "
        "hedging, and delta fencing"
    )
    p.add_argument("--workers", type=int, default=2,
                   help="worker replica count (replicate mode) / "
                   "partition count (partition mode)")
    p.add_argument("--mode", default="replicate",
                   choices=("replicate", "partition"),
                   help="replicate: N full copies of the graph; "
                   "partition: ONE graph row-sharded across N workers "
                   "with the distributed half-chain multiply and an "
                   "exact global top-k merge")
    p.add_argument("--replication", type=int, default=2,
                   help="partition mode: chained replication factor "
                   "(each worker mirrors the next R-1 partitions' "
                   "ranges; R>=2 survives a worker's death with zero "
                   "lost requests)")
    p.add_argument("--routing", default="hash", choices=("hash", "range"),
                   help="replica selection: consistent-hash-by-row "
                   "(cache affinity) or contiguous row ranges")
    p.add_argument("--hedge-ms", type=float, default=100.0,
                   help="age at which an in-flight query is hedged to "
                   "the next replica (0 disables)")
    p.add_argument("--heartbeat-interval", type=float, default=0.25,
                   help="seconds between health probes per worker")
    p.add_argument("--heartbeat-miss", type=int, default=4,
                   help="unanswered intervals before a worker is "
                   "routed around")
    p.add_argument("--max-inflight", type=int, default=512,
                   help="router admission bound (pending requests)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="default per-request budget when the client "
                   "sends none")
    p.add_argument("--scrape-interval", type=float, default=5.0,
                   help="seconds between fleet metrics scrapes (each "
                   "worker's registry pulled and merged exactly; 0 "
                   "disables the scrape loop and the SLO engine's "
                   "periodic evaluation)")
    p.add_argument("--slo-specs", default=None,
                   help="JSON file of SLO specs (obs/slo.py); default: "
                   "built-in availability / p99-latency / "
                   "update-visible objectives")
    p.add_argument("--slow-ms", type=float, default=None,
                   help="flight-recorder tail threshold: requests "
                   "slower than this are kept; default: the latency "
                   "SLO's p99 target")
    p.add_argument("--flight-capacity", type=int, default=256,
                   help="flight-recorder ring bound (records)")
    p.add_argument("--flight-out", default=None,
                   help="write the flight recording (records + kept "
                   "span trees) here at drain/SIGTERM; the in-band "
                   "'flight_dump' op dumps on demand")
    # -- firehose update pipelining -----------------------------------
    p.add_argument("--update-queue", type=int, default=0,
                   help="bounded update-queue admission: queue up to "
                   "this many updates for the coalescing pump; past "
                   "the bound submitters get an immediate "
                   "'backpressure' error (0 = one broadcast per update)")
    p.add_argument("--update-coalesce", type=int, default=8,
                   help="max queued updates folded into ONE broadcast "
                   "(conflicting windows split automatically)")
    p.add_argument("--update-flush-ms", type=float, default=5.0,
                   help="how long the pump lingers for more queued "
                   "updates before broadcasting")
    # -- closed-loop autoscale (router/autoscale.py) -------------------
    p.add_argument("--autoscale", action="store_true",
                   help="let queue-depth / shed / SLO-burn signals "
                   "spawn and drain workers between --workers (the "
                   "floor) and --max-workers; implies epoch-replay "
                   "retention so spawned workers can catch up")
    p.add_argument("--max-workers", type=int, default=None,
                   help="autoscale ceiling (default: 2x --workers)")
    p.add_argument("--autoscale-interval", type=float, default=1.0,
                   help="seconds between autoscale signal evaluations")
    return p


def parse_router_args(argv: list[str] | None):
    from ..serving.cli import NOT_PORTED_FLAGS, parse_known

    return parse_known(build_router_parser(), argv, NOT_PORTED_FLAGS,
                       "router")


def _worker_argv(args, index: int, partition: bool = False) -> list[str]:
    """The child command line of worker ``w<index>``: the port's own
    worker entry point, with the router's serving flags (and, in
    partition mode, its partition)."""
    argv = [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli",
            "worker", "--worker-id", f"w{index}"]
    if partition:
        argv += ["--partition-index", str(index),
                 "--partitions", str(args.workers),
                 "--partition-replication", str(args.replication)]
    for name in _FORWARD_VALUE:
        val = getattr(args, name)
        if val is None:
            continue
        argv += [f"--{name.replace('_', '-')}", str(val)]
    for name in _FORWARD_PATH:
        val = getattr(args, name)
        if val is None:
            continue
        argv += [f"--{name.replace('_', '-')}",
                 _suffix_path(str(val), f"w{index}")]
    for name in _FORWARD_TRUE:
        if getattr(args, name):
            argv.append(f"--{name.replace('_', '-')}")
    return argv


def router_loop(router: Router, in_stream, out_stream) -> int:
    """Upstream JSONL loop: responses stream back as their futures
    resolve (out of order; clients match on ``id``)."""
    from ..resilience import preemption_handler

    wlock = threading.Lock()

    def respond(resp: dict) -> None:
        line = json.dumps(resp) + "\n"
        with wlock:
            out_stream.write(line)
            out_stream.flush()

    for line in in_stream:
        if preemption_handler.requested():
            router.drain()
            return 0
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as exc:
            respond({"id": None, "ok": False, "error": f"bad request: {exc}"})
            continue
        op = req.get("op")
        if op in ("shutdown", "drain"):
            clean = router.drain()
            respond({"id": req.get("id"), "ok": True,
                     "result": {"shutdown": op == "shutdown",
                                "draining": True, "clean": clean}})
            return 0
        try:
            fut = router.submit(req)
        except RouterShed as exc:
            respond({"id": req.get("id"), "ok": False, "error": str(exc),
                     "shed": True})
            continue
        fut.add_done_callback(lambda f: respond(f.result()))
        if preemption_handler.requested():
            router.drain()
            return 0
    router.drain()
    return 0


def router_main(argv: list[str] | None = None) -> int:
    args = parse_router_args(argv)
    if args.workers < 1:
        raise ValueError("--workers must be >= 1")
    from .. import obs
    from ..utils.device import resolve_device

    # the workers run on --platform; refuse here, before spawning any,
    # when it names a card that is not there (or a layout flag their
    # backend would refuse)
    partition_mode = args.mode == "partition"
    if partition_mode and args.autoscale:
        raise ValueError("--autoscale scales replicas; a partition "
                         "fleet's shape is its --workers")
    if (args.factor_format is not None and args.backend != "torch-sparse"
            and not partition_mode):
        raise ValueError(
            "--factor-format selects the resident layout of the "
            "sparse half-chain factor and requires --backend torch-sparse"
        )
    resolve_device(args.platform)

    slo_specs: tuple = ()
    if args.slo_specs:
        with open(args.slo_specs, encoding="utf-8") as f:
            slo_specs = obs.specs_from_json(f.read())
    transports = {
        f"w{i}": SubprocessTransport(
            f"w{i}", _worker_argv(args, i, partition=partition_mode))
        for i in range(args.workers)
    }
    if partition_mode:
        from .partition import PartitionRouter, PartitionRouterConfig

        router = PartitionRouter(
            transports,
            PartitionRouterConfig(
                partitions=args.workers,
                replication=args.replication,
                heartbeat_interval_s=args.heartbeat_interval,
                heartbeat_miss_limit=args.heartbeat_miss,
                max_inflight=args.max_inflight,
                default_deadline_ms=args.deadline_ms,
                scrape_interval_s=args.scrape_interval,
                slo_specs=slo_specs,
                slow_ms=args.slow_ms,
                flight_capacity=args.flight_capacity,
            ),
        )
    else:
        router = _replica_router(args, transports, slo_specs)
    # drain-time artifacts: written by Router.drain() while the
    # workers can still answer the final span-ring scrape
    router.flight_out = args.flight_out
    router.fleet_trace_out = args.trace_out
    return _serve_router(args, router)


def _replica_router(args, transports, slo_specs) -> Router:
    return Router(
        transports,
        RouterConfig(
            routing=args.routing,
            hedge_ms=args.hedge_ms or None,
            heartbeat_interval_s=args.heartbeat_interval,
            heartbeat_miss_limit=args.heartbeat_miss,
            max_inflight=args.max_inflight,
            default_deadline_ms=args.deadline_ms,
            scrape_interval_s=args.scrape_interval,
            slo_specs=slo_specs,
            slow_ms=args.slow_ms,
            flight_capacity=args.flight_capacity,
            update_queue=args.update_queue,
            update_coalesce=args.update_coalesce,
            update_flush_ms=args.update_flush_ms,
            # spawned workers boot the base graph and catch up by
            # replaying the epoch log — it must stay replayable
            retain_replay=args.autoscale,
        ),
    )


def _serve_router(args, router) -> int:
    """Run ``router`` (replica or partition) behind the upstream JSONL
    loop, with the fleet exporter and (replica mode) the autoscaler."""
    from .. import obs
    from ..serving.cli import serving_process

    # the router's --metrics-file is the FLEET export: every scraped
    # worker's series with a worker label, atomically, plus the full
    # fleet_metrics JSON beside it for `dpathsim-torch fleet-stats`
    exporter = (
        obs.FleetTextfileExporter(
            args.metrics_file,
            router.metric_parts,
            interval_s=args.metrics_interval,
            snapshot_fn=lambda: router.fleet_metrics(refresh=False),
        )
        if args.metrics_file
        else None
    )
    autoscaler = None
    if args.autoscale:
        from .autoscale import AutoscaleConfig, Autoscaler

        autoscaler = Autoscaler(
            router,
            # spawned replicas run the exact argv the seed fleet used
            # (the autoscaler always mints fresh w<N> ids)
            lambda wid: SubprocessTransport(
                wid, _worker_argv(args, int(wid[1:]))
            ),
            AutoscaleConfig(
                min_workers=args.workers,
                max_workers=args.max_workers or 2 * args.workers,
                eval_interval_s=args.autoscale_interval,
            ),
        )
    # the router process's own switches (obs, event sink, SIGTERM
    # latch) are serve's; its artifacts are the fleet's (above)
    with serving_process(args, artifacts=False):
        try:
            router.start()
            if exporter is not None:
                exporter.start()
            if autoscaler is not None:
                autoscaler.start()
            how = ("partition" if args.mode == "partition"
                   else f"routing={args.routing}")
            print(
                f"router: {args.workers} workers, {how}, "
                f"n={router.n}; JSONL on stdin",
                file=sys.stderr,
            )
            return router_loop(router, sys.stdin, sys.stdout)
        finally:
            runtime_event("router_exit", echo=False)
            if autoscaler is not None:
                autoscaler.stop()
            # a loop that exited without drain (EOF already drains; an
            # exception might not) still owes the shutdown artifacts
            router._shutdown_dumps()
            router.close()
            if exporter is not None:
                exporter.stop()


def build_fleet_stats_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dpathsim-torch fleet-stats",
        description="one-shot fleet summary (`top` for the router): "
        "worker table, merged fleet-exact latency per op, headline "
        "counters, SLO burn status",
    )
    p.add_argument(
        "snapshot", nargs="?", default="-",
        help="fleet metrics JSON: the file the router's --metrics-file "
        "exporter writes beside the .prom (<file>.json), or '-' to "
        "read a fleet_metrics response from stdin (e.g. piped from "
        "`echo '{\"op\":\"fleet_metrics\"}' | dpathsim-torch router ...`)",
    )
    p.add_argument("--json", action="store_true",
                   help="re-emit the snapshot as JSON instead of the "
                   "rendered table (for tooling)")
    return p


def fleet_stats_main(argv: list[str] | None = None) -> int:
    from ..obs import render_fleet_stats

    args = build_fleet_stats_parser().parse_args(argv)
    if args.snapshot == "-":
        data = json.load(sys.stdin)
    else:
        with open(args.snapshot, encoding="utf-8") as f:
            data = json.load(f)
    # accept a raw fleet_metrics result OR a protocol response envelope
    if "merged" not in data and isinstance(data.get("result"), dict):
        data = data["result"]
    if args.json:
        json.dump(data, sys.stdout, indent=2)
        print()
    else:
        print(render_fleet_stats(data))
    return 0
