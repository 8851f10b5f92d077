"""The port's closed-loop load generators for serving and the fleets.

    python -m distributed_pathsim_tpu_torch.bench_serving [--regime R] [--smoke]

The twin of the repository's ``bench_serving.py`` for the port: the same
regimes, function names, arguments, defaults, JSON keys and smoke
checks, with every service, worker and in-process fleet serving from
``--backend`` (default ``torch``; the compress regime's arms are
``torch-sparse``) on ``--platform`` (default ``cuda``). The numpy
backend serves only as the f64 oracle the answers are held against.
Twelve regimes are here:

- **load**: serial (per-row dispatch, caches off), cold (coalesced
  batches, caches off), warm (every tier cached, a hot working set) and
  mixed (half hot, half cold) closed-loop QPS and p50/p95/p99;
- **update**: update-to-fresh-answer latency of ``service.update`` on
  the delta path against the full reload, zero steady-state compiles,
  and cache retention for every unaffected row;
- **obs**: observability overhead (off / metrics / sampled / traced
  arms, interleaved) and the connectivity audit of the traces;
- **router**: a QPS-vs-replicas curve over real ``dpathsim-torch
  worker`` processes, then one worker SIGKILLed mid-load;
- **ann**: exact against ANN closed-loop arms over a concurrency sweep,
  measured recall@k against the exact oracle, and the staleness
  fallback;
- **fleet-obs**: fleet observability overhead over in-process fleets,
  and (``--smoke``) cross-process trace stitching, the exact metrics
  merge, SLO burn and the flight recorder over worker processes;
- **partition**: one graph sharded over P partition workers: resident
  bytes per worker, the max-N model, routed deltas, trace stitching, a
  replica baseline and the kill ledger;
- **metapath**: the planner's association order against the naive
  left-to-right fold (host numpy f64), and a mixed APVPA/APA/APTPA
  workload with the sub-chain memo on and off;
- **compress**: one ``torch-sparse`` backend per factor layout (coo,
  blocked, bitpacked): resident bytes, the max-N model, bit parity
  through deltas, the compile ledger;
- **firehose**: a sustained update stream under query load with
  background compaction, coalesced fleet updates, the autoscale step;
- **batch**: top-k-all and simjoin campaigns, a preempted and resumed
  campaign, the ``batch_blocks`` fleet fan-out;
- **learned**: exact, ANN and learned arms (towers distilled in the
  service), recall against the exact oracle, the cold start.

"Compiles" are the port's own (``utils/compile_counter``): kernel
builds and loads and CUDA-graph captures, counted in this process by
:class:`~.utils.compile_counter.CompileCounter` and in each worker by
the ``compiles`` field of its ``health`` answer.

``--smoke`` runs a regime's small fixed run and exits non-zero if any of
its ``smoke_checks`` fails. Six checks are decided by the clock
(:data:`CLOCK_CHECKS`); the rest are deterministic. The checks of each
regime are built by one function (``*_checks``), shared by the smoke
and the tests.

It needs a card unless ``--platform cpu`` is given: without one it
exits 2 and prints no result. On the card the JSON carries the card's
name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import threading
import time

import numpy as np

from .router.loadgen import run_router_clients

# The repository harness's --regime choices, in its order.
REGIMES = ("load", "update", "obs", "router", "ann", "fleet-obs",
           "partition", "metapath", "compress", "firehose", "batch",
           "learned")

# The smoke checks the clock decides; every other check is
# deterministic (it holds on any machine, loaded or not).
CLOCK_CHECKS = {
    "load": ("warm_p50_lt_cold_p50",),
    "update": ("speedup_ge_10x",),
    "obs": ("overhead_under_1ms_per_request",),
    "firehose": ("update_visible_p99_bounded", "compaction_pause_bounded"),
    "metapath": ("planner_beats_naive_measured",),
}

# Checks a run on the card is not held to. ``recall_ge_0_99`` of the
# learned smoke: its towers are distilled in the service from a torch
# generator's initial weights, the repository harness's from
# jax.random's, so the two packages' towers differ by design; the
# harness's own gate fails on its own package (recall 0.972917 on the
# smoke graph). The check is computed and reported as the harness
# computes it, and ``run_learned_smoke`` raises on it as the harness's
# does; parity of the recall audit is held on towers both packages load
# from one checkpoint.
CARD_EXEMPT_CHECKS = {
    "learned": ("recall_ge_0_99",),
}

# The smokes' fixed runs (the repository harness's own arguments).
LOAD_SMOKE = dict(n_authors=384, n_papers=640, n_venues=12, clients=8,
                  queries_per_client=24, max_batch=8, max_wait_ms=2.0, k=5)
OBS_SMOKE = dict(n_authors=384, n_papers=640, n_venues=12, clients=8,
                 queries_per_client=48, max_batch=8, max_wait_ms=1.0,
                 reps=3, k=5)
ROUTER_SMOKE = dict(n_authors=256, n_papers=448, n_venues=10,
                    replicas=(1, 2), clients=6, queries_per_client=16,
                    max_batch=8, max_wait_ms=1.0, k=5, kill_phase=True)
PARTITION_SMOKE = dict(n_authors=192, n_papers=320, n_venues=8,
                       partitions=(1, 3), replication=2, clients=4,
                       queries_per_client=12, k=5, deltas=3,
                       kill_phase=True)
FLEET_OBS_SPEC = "synthetic:authors=256,papers=448,venues=10,seed=0"
ANN_SMOKE = dict(n_authors=768, n_papers=1280, n_venues=16, clients=8,
                 queries_per_client=24, max_batch=8, max_wait_ms=1.0,
                 reps=2, k=10, oracle_samples=64)
LEARNED_SMOKE = dict(n_authors=768, n_papers=1280, n_venues=16, clients=6,
                     queries_per_client=16, max_batch=8, max_wait_ms=1.0,
                     reps=2, k=10, oracle_samples=48, learned_steps=120,
                     learned_cand_mult=16)
FIREHOSE_SMOKE = dict(n_authors=256, n_papers=448, n_venues=10,
                      deltas=260, clients=4, k=5, chain_len=96,
                      frontier_sleeps_ms=(0.0,), fleet_updates=24)
METAPATH_SMOKE = dict(n_authors=768, n_papers=1536, n_venues=8,
                      n_topics=96, clients=6, queries_per_client=12,
                      rounds=2, reps=3, k=5, max_batch=8, max_wait_ms=1.0,
                      seed=7)
COMPRESS_SMOKE = dict(n_authors=768, n_papers=1536, n_venues=16,
                      batches=10, batch_rows=8, k=5, deltas=3,
                      partitions=3, seed=7)
BATCH_SMOKE = dict(n_authors=192, n_papers=384, n_venues=12, k=5, tau=0.1,
                   block_rows=32, sample_rows=48, workers=2, seed=7)


def _create_backend(name: str, hin, mp, platform: str, **options):
    """A backend of ``name`` over ``hin``; every backend but the numpy
    oracle on ``platform``."""
    from .backends.base import create_backend

    if name == "numpy":
        return create_backend(name, hin, mp, **options)
    return create_backend(name, hin, mp, device=platform, **options)


def card_device() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    from .bench import card_state

    name, _, limit = card_state().partition(", ")
    return {"name": name, "power_limit": limit}


def _write(result: dict, out_path: str | None) -> None:
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=2)


def _require(checks: dict, label: str, detail: str = "") -> None:
    if not all(checks.values()):
        raise AssertionError(f"{label} smoke failed: {checks}{detail}")


def _percentiles(lat_s: list[float]) -> dict:
    a = np.asarray(sorted(lat_s))
    return {
        "p50_ms": round(float(np.percentile(a, 50)) * 1e3, 4),
        "p95_ms": round(float(np.percentile(a, 95)) * 1e3, 4),
        "p99_ms": round(float(np.percentile(a, 99)) * 1e3, 4),
        "mean_ms": round(float(a.mean()) * 1e3, 4),
    }


def _run_clients(service, schedule: list[list[int]], k: int,
                 mode=None) -> dict:
    """Closed-loop: client c issues schedule[c] row queries back to
    back. Returns QPS + latency percentiles + shed count. ``mode``:
    None → the service default; a string → every query; "mixed" →
    alternating ann/exact per query (the ann regime's mixed arm)."""
    from .serving import LoadShedError

    lats: list[list[float]] = [[] for _ in schedule]
    shed = [0]
    barrier = threading.Barrier(len(schedule) + 1)

    def client(ci: int, rows: list[int]) -> None:
        barrier.wait()
        for j, r in enumerate(rows):
            m = mode
            if mode == "mixed":
                m = "ann" if j % 2 else "exact"
            t0 = time.perf_counter()
            try:
                service.topk_index(int(r), k=k, mode=m)
            except LoadShedError:
                shed[0] += 1
                continue
            lats[ci].append(time.perf_counter() - t0)

    threads = [
        threading.Thread(target=client, args=(ci, rows), daemon=True)
        for ci, rows in enumerate(schedule)
    ]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    flat = [x for sub in lats for x in sub]
    return {
        "queries": len(flat),
        "wall_s": round(wall, 4),
        "qps": round(len(flat) / wall, 2) if wall > 0 else float("inf"),
        "shed": shed[0],
        **_percentiles(flat),
    }


def _build_service(hin, backend_name, max_batch, max_wait_ms, caches,
                   queue_depth=4096, warm=True, k=10, platform="cuda",
                   **extra_cfg):
    from .ops.metapath import compile_metapath
    from .serving import PathSimService, ServeConfig

    mp = compile_metapath("APVPA", hin.schema)
    backend = _create_backend(backend_name, hin, mp, platform)
    return PathSimService(
        backend,
        config=ServeConfig(
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            queue_depth=queue_depth,
            cache_entries=4096 if caches else 0,
            tile_cache_bytes=(64 << 20) if caches else 0,
            k_default=k,
            warm=warm,
            **extra_cfg,
        ),
    )


def run_bench(
    n_authors: int = 2048,
    n_papers: int = 4096,
    n_venues: int = 48,
    clients: int = 32,
    queries_per_client: int = 64,
    max_batch: int = 32,
    max_wait_ms: float = 2.0,
    k: int = 10,
    backend: str = "torch",
    platform: str = "cuda",
    seed: int = 0,
) -> dict:
    from .data.synthetic import synthetic_hin

    hin = synthetic_hin(n_authors, n_papers, n_venues, seed=seed)
    rng = np.random.default_rng(seed)
    n = hin.type_size("author")
    total = clients * queries_per_client

    # Workloads. Cold/serial: every query a distinct-ish uniform row
    # (caches are OFF for those regimes anyway, so reuse wouldn't help).
    # Warm/mixed: a small Zipf-hot working set, pre-touched, so warm
    # traffic is pure cache and mixed is half-and-half.
    uniform = rng.integers(0, n, size=(clients, queries_per_client))
    hot_set = rng.choice(n, size=max(8, n // 64), replace=False)
    hot = rng.choice(hot_set, size=(clients, queries_per_client))
    mixed = np.where(
        rng.random((clients, queries_per_client)) < 0.5,
        hot,
        rng.integers(0, n, size=(clients, queries_per_client)),
    )

    out: dict = {
        "graph": {"authors": n, "papers": n_papers, "venues": n_venues,
                  "seed": seed},
        "load": {"clients": clients,
                 "queries_per_client": queries_per_client,
                 "total_queries": total, "k": k,
                 "max_batch": max_batch, "max_wait_ms": max_wait_ms},
        "backend": backend,
        "regimes": {},
    }

    # -- serial baseline: per-row dispatch, no coalescing, no cache ----
    svc = _build_service(hin, backend, max_batch=1, max_wait_ms=0.0,
                         caches=False, k=k, platform=platform)
    out["regimes"]["serial"] = _run_clients(svc, uniform.tolist(), k)
    out["regimes"]["serial"]["service"] = svc.stats()["dispatch"]
    svc.close()

    # -- cold: coalesced/batched dispatch, caches still off ------------
    svc = _build_service(hin, backend, max_batch=max_batch,
                         max_wait_ms=max_wait_ms, caches=False, k=k,
                         platform=platform)
    out["regimes"]["cold"] = _run_clients(svc, uniform.tolist(), k)
    out["regimes"]["cold"]["service"] = svc.stats()["dispatch"]
    svc.close()

    # -- warm: caches on, hot working set pre-touched ------------------
    svc = _build_service(hin, backend, max_batch=max_batch,
                         max_wait_ms=max_wait_ms, caches=True, k=k,
                         platform=platform)
    for r in hot_set:
        svc.topk_index(int(r), k=k)
    out["regimes"]["warm"] = _run_clients(svc, hot.tolist(), k)
    warm_stats = svc.stats()
    out["regimes"]["warm"]["service"] = warm_stats["dispatch"]
    out["regimes"]["warm"]["cache"] = warm_stats["result_cache"]

    # -- mixed: 50% hot / 50% uniform on the SAME warm service ---------
    out["regimes"]["mixed"] = _run_clients(svc, mixed.tolist(), k)
    mixed_stats = svc.stats()
    out["regimes"]["mixed"]["service"] = mixed_stats["dispatch"]
    out["regimes"]["mixed"]["cache"] = mixed_stats["result_cache"]
    svc.close()

    r = out["regimes"]
    out["speedups"] = {
        "batched_vs_serial_qps": round(
            r["cold"]["qps"] / r["serial"]["qps"], 2
        ),
        "warm_vs_cold_qps": round(r["warm"]["qps"] / r["cold"]["qps"], 2),
        "mixed_vs_cold_qps": round(r["mixed"]["qps"] / r["cold"]["qps"], 2),
    }
    return out


def load_checks(result: dict) -> dict:
    """The load regime's two gates: warm-cache p50 under cold-cache p50
    (the clock's) and zero shed events."""
    r = result["regimes"]
    return {
        "warm_p50_lt_cold_p50": r["warm"]["p50_ms"] < r["cold"]["p50_ms"],
        "zero_shed": all(
            reg["shed"] == 0 and reg["service"]["shed"] == 0
            for reg in r.values()
        ),
    }


def run_smoke(out_path: str | None = None, backend: str = "torch",
              platform: str = "cuda") -> dict:
    """Small fixed-seed run with the two gates of :func:`load_checks`."""
    result = run_bench(**LOAD_SMOKE, backend=backend, platform=platform)
    result["smoke_checks"] = checks = load_checks(result)
    _write(result, out_path)
    _require(checks, "serve")
    return result


def _random_delta(hin, rng, edge_frac: float, append_nodes: bool):
    """A Δ batch touching ``edge_frac`` of the author_of edges (half
    adds of fresh pairs, half removes of existing ones), optionally
    with an author append wired in by an added edge."""
    from .data import delta as dl

    ap = hin.blocks["author_of"]
    n_auth = hin.type_size("author")
    n_pap = hin.type_size("paper")
    total_edges = sum(b.nnz for b in hin.blocks.values())
    n_changes = max(2, int(edge_frac * total_edges))
    n_rem = n_changes // 2
    rem_i = rng.choice(ap.nnz, size=n_rem, replace=False)
    removes = np.stack([ap.rows[rem_i], ap.cols[rem_i]], axis=1)
    # keep removed pairs in the exclusion set: an add colliding with a
    # remove is a malformed batch apply_delta rejects
    existing = set(zip(ap.rows.tolist(), ap.cols.tolist()))
    adds = []
    nodes = ()
    if append_nodes:
        # one appended author, wired in by this batch's first add
        if hin.indices["author"].size_override is None:
            nodes = (
                dl.NodeAppend(
                    node_type="author", ids=(f"author_{n_auth}",)
                ),
            )
        else:
            nodes = (dl.NodeAppend(node_type="author", count=1),)
        adds.append((n_auth, int(rng.integers(0, n_pap))))
    while len(adds) < n_changes - n_rem:
        e = (int(rng.integers(0, n_auth)), int(rng.integers(0, n_pap)))
        if e not in existing:
            existing.add(e)
            adds.append(e)
    return dl.DeltaBatch(
        edges=(dl.edge_delta("author_of", add=adds, remove=removes),),
        nodes=nodes,
    )


def run_update_bench(
    n_authors: int = 2048,
    n_papers: int = 4096,
    n_venues: int = 48,
    edge_frac: float = 0.01,
    reps: int = 5,
    k: int = 10,
    backend: str = "torch",
    platform: str = "cuda",
    headroom: float = 0.25,
    seed: int = 0,
) -> dict:
    """Update-to-fresh-answer latency: ``service.update`` (delta patch)
    vs the reload path, each followed by one query for a row the change
    affected. The reload timing covers what the production ``reload``
    op actually runs end-to-end — loader + encode (``synthetic_hin`` is
    this graph's loader; the DBLP GEXF reparse it stands in for is far
    costlier), headroom padding, fresh backend build, swap + rewarm +
    total cache flush — because that is exactly the work a graph change
    forced before deltas existed. Also checks the two hard contracts:
    zero new compiles (kernel builds, loads, CUDA-graph captures)
    across steady-state updates, and cache
    retention for every unaffected row."""
    import tempfile

    from .data import delta as dl
    from .data.encode import encode_hin
    from .data.gexf import read_gexf
    from .data.synthetic import (
        DBLP_SCHEMA, synthetic_hin, write_gexf,
    )
    from .ops.metapath import compile_metapath
    from .serving import PathSimService, ServeConfig
    from .utils.compile_counter import CompileCounter

    rng = np.random.default_rng(seed)
    # materialized ids so the graph round-trips through GEXF — the
    # reload baseline below re-runs the real loader on a real file
    hin = dl.with_headroom(
        synthetic_hin(n_authors, n_papers, n_venues, seed=seed,
                      materialize_ids=True),
        headroom,
    )
    gexf_dir = tempfile.TemporaryDirectory(prefix="dpathsim_bench_")
    gexf_path = f"{gexf_dir.name}/serving_graph.gexf"
    write_gexf(hin, gexf_path)
    mp = compile_metapath("APVPA", hin.schema)
    svc = PathSimService(
        _create_backend(backend, hin, mp, platform),
        # near-zero linger: single-probe latencies should measure the
        # update/reload machinery, not the batch-former's straggler wait
        config=ServeConfig(max_batch=8, k_default=k, max_wait_ms=0.1),
    )
    try:
        # ---- cache retention: warm a working set, apply one delta,
        # every unaffected row must still answer from tier 1 ----------
        working_set = rng.choice(n_authors, size=128, replace=False)
        for r in working_set:
            svc.topk_index(int(r), k=k)
        delta = _random_delta(svc.hin, rng, edge_frac, append_nodes=True)
        info0 = svc.update(delta)  # warmup update: compiles delta progs
        if info0["mode"] != "delta":
            raise AssertionError(f"warmup update fell back: {info0}")
        affected = info0["affected_rows"]
        # re-query the working set; count tier-1 hits
        h0 = svc.stats()["result_cache"]["hits"]
        unaffected_hits = 0
        for r in working_set:
            before = svc.stats()["result_cache"]["hits"]
            svc.topk_index(int(r), k=k)
            unaffected_hits += svc.stats()["result_cache"]["hits"] - before
        retained = {
            "working_set": int(working_set.shape[0]),
            "affected_rows": int(affected),
            "tier1_hits_after_update": int(
                svc.stats()["result_cache"]["hits"] - h0
            ),
            "unaffected_in_set_retained": unaffected_hits,
        }

        # ---- steady state: updates + fresh-answer queries, counting
        # compiles the whole time -------------------------------------
        t_update = []
        with CompileCounter() as cc:
            for i in range(reps):
                delta = _random_delta(
                    svc.hin, rng, edge_frac, append_nodes=(i % 2 == 0)
                )
                probe = int(delta.edges[0].add[0][0])  # an affected row
                t0 = time.perf_counter()
                info = svc.update(delta)
                svc.topk_index(min(probe, svc.n - 1), k=k)
                t_update.append(time.perf_counter() - t0)
                if info["mode"] != "delta":
                    raise AssertionError(f"steady-state fallback: {info}")
            compiles = cc.count

        # ---- the old world: the full reload path — GEXF reparse,
        # re-encode, re-pad, fresh backend build, swap (rewarm + total
        # cache flush), first fresh answer. Exactly the work a serving
        # layer without deltas forces on ANY graph change. -------------------
        t_reload = []
        for i in range(reps):
            probe = int(rng.integers(0, n_authors))
            t0 = time.perf_counter()
            hin_r = dl.with_headroom(
                encode_hin(read_gexf(gexf_path), DBLP_SCHEMA), headroom
            )
            svc.reload(_create_backend(backend, hin_r, mp, platform))
            svc.topk_index(probe, k=k)
            t_reload.append(time.perf_counter() - t0)

        upd_ms = sorted(1e3 * t for t in t_update)
        rel_ms = sorted(1e3 * t for t in t_reload)
        med_upd = upd_ms[len(upd_ms) // 2]
        med_rel = rel_ms[len(rel_ms) // 2]
        return {
            "graph": {"authors": n_authors, "papers": n_papers,
                      "venues": n_venues, "seed": seed,
                      "headroom": headroom},
            "load": {"edge_frac": edge_frac, "reps": reps, "k": k},
            "backend": backend,
            "update_ms": {"median": round(med_upd, 3),
                          "min": round(upd_ms[0], 3),
                          "max": round(upd_ms[-1], 3)},
            "reload_ms": {"median": round(med_rel, 3),
                          "min": round(rel_ms[0], 3),
                          "max": round(rel_ms[-1], 3)},
            "speedup_vs_reload": round(med_rel / med_upd, 2),
            "steady_state_compiles": compiles,
            "cache_retention": retained,
            "service": svc.stats()["delta"],
        }
    finally:
        svc.close()
        gexf_dir.cleanup()


def update_checks(result: dict) -> dict:
    """The update regime's three gates: ≥10× faster than reload (the
    clock's), zero steady-state compiles, and full cache retention for
    unaffected rows."""
    ret = result["cache_retention"]
    return {
        "speedup_ge_10x": result["speedup_vs_reload"] >= 10.0,
        "zero_steady_state_compiles": result["steady_state_compiles"] == 0,
        # every working-set row outside the affected set must hit tier 1
        "unaffected_rows_retained": (
            ret["unaffected_in_set_retained"]
            >= ret["working_set"]
            - min(ret["affected_rows"], ret["working_set"])
        ),
    }


def run_update_smoke(out_path: str | None = None, backend: str = "torch",
                     platform: str = "cuda") -> dict:
    """The acceptance run: 2048-author graph, Δ ≤ 1% of edges, with
    the three gates of :func:`update_checks`."""
    result = run_update_bench(backend=backend, platform=platform)
    result["smoke_checks"] = checks = update_checks(result)
    _write(result, out_path)
    _require(checks, "update")
    return result


def _trace_is_connected(spans) -> dict:
    """Audit the tracer ring for the acceptance contract: EVERY
    dispatched request trace reaches the device work — batch heads
    directly (a connected enqueue → dispatch → device_execute →
    complete chain inside the trace), non-head batch members through
    the ``batch_span`` link their enqueue span carries (it must
    resolve to a live ``serve.dispatch`` span). Shed requests never
    dispatch, so they are exempt; anything else with an enqueue span
    but no path to a dispatch is reported as unlinked."""
    by_id = {s.span_id: s for s in spans}
    by_trace: dict[int, list] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    needed = {
        "serve.enqueue", "serve.dispatch", "serve.device_execute",
        "serve.complete",
    }
    connected = 0
    linked = 0
    unlinked = 0
    broken_parents = 0
    for tid, members in by_trace.items():
        names = {s.name for s in members}
        if "serve.request" not in names or "serve.enqueue" not in names:
            continue  # cache hits / bootstrap stages: no dispatch due
        ok = True
        for s in members:
            if s.parent_id is None:
                continue
            parent = by_id.get(s.parent_id)
            if parent is None or parent.trace_id != tid:
                ok = False
                broken_parents += 1
        if needed <= names:  # batch head: device chain in-trace
            if ok:
                connected += 1
            continue
        enq = next(s for s in members if s.name == "serve.enqueue")
        if enq.args.get("outcome") == "shed":
            continue
        ref = enq.args.get("batch_span")
        dispatch = (
            by_id.get(int(ref.split(":")[1])) if ref else None
        )
        if ok and dispatch is not None and dispatch.name == "serve.dispatch":
            linked += 1
        else:
            unlinked += 1
    return {
        "dispatched_request_traces": connected + linked,
        "head_traces": connected,
        "linked_member_traces": linked,
        "unlinked_request_traces": unlinked,
        "broken_parent_links": broken_parents,
        "total_spans": len(spans),
    }


def run_obs_bench(
    n_authors: int = 2048,
    n_papers: int = 4096,
    n_venues: int = 48,
    clients: int = 32,
    queries_per_client: int = 64,
    max_batch: int = 32,
    max_wait_ms: float = 2.0,
    reps: int = 3,
    k: int = 10,
    backend: str = "torch",
    platform: str = "cuda",
    seed: int = 0,
) -> dict:
    """The observability overhead contract, measured head to head.

    Same graph/load shape as the steady-state (mixed 50% hot / 50%
    uniform) regime of BENCH_SERVING_r06; each rep runs the identical
    workload on a fresh service under FOUR arms, interleaved so machine
    drift hits every arm equally:

    - ``off``      — metrics registry off, tracing off (the baseline);
    - ``metrics``  — metrics on, tracing off (the serve default);
    - ``sampled``  — metrics on, tracing on at 1-in-16 head sampling
      (the production tracing posture, DESIGN.md §20);
    - ``traced``   — metrics on, EVERY request traced (the debugging
      posture, what ``--trace-out`` alone gives you).

    Reports median QPS and per-request added cost vs ``off`` for each
    arm, steady-state compile counts (all must be zero — obs must
    never perturb the shape-bucket contract), and a connectivity audit
    of each tracing arm (one dispatched sampled-in request = one
    connected enqueue→dispatch→device→complete chain)."""
    from . import obs
    from .data.synthetic import synthetic_hin
    from .utils.compile_counter import CompileCounter

    hin = synthetic_hin(n_authors, n_papers, n_venues, seed=seed)
    rng = np.random.default_rng(seed)
    n = hin.type_size("author")
    hot_set = rng.choice(n, size=max(8, n // 64), replace=False)
    hot = rng.choice(hot_set, size=(clients, queries_per_client))
    mixed = np.where(
        rng.random((clients, queries_per_client)) < 0.5,
        hot,
        rng.integers(0, n, size=(clients, queries_per_client)),
    ).tolist()

    from .utils import benchrunner as br

    ARMS = {
        "off": dict(metrics=False, tracing=False, trace_sample=1),
        "metrics": dict(metrics=True, tracing=False, trace_sample=1),
        "sampled": dict(metrics=True, tracing=True, trace_sample=16),
        "traced": dict(metrics=True, tracing=True, trace_sample=1),
    }

    def one_arm(cfg: dict) -> dict:
        obs.configure(**cfg)
        if cfg["tracing"]:
            obs.get_tracer().clear()
        svc = _build_service(hin, backend, max_batch=max_batch,
                             max_wait_ms=max_wait_ms, caches=True, k=k,
                             platform=platform)
        try:
            for r in hot_set:  # warm: hot set cached, buckets compiled
                svc.topk_index(int(r), k=k)
            with CompileCounter() as cc:
                res = _run_clients(svc, mixed, k)
            res["steady_state_compiles"] = cc.count
        finally:
            svc.close()
        if cfg["tracing"]:
            res["trace_audit"] = _trace_is_connected(
                obs.get_tracer().spans()
            )
        return res

    try:
        # interleaved arms via the shared estimator (benchrunner):
        # round r runs every arm once, so machine drift hits all arms
        # equally — the BENCH_OBS_r08 discipline, now at one site
        runs = br.interleave(
            {name: (lambda cfg=cfg: one_arm(cfg)) for name, cfg in
             ARMS.items()},
            reps,
        )
    finally:
        # restore process defaults (metrics on, tracing off) — later
        # code in this process must not inherit a bench arm's switches
        obs.configure(metrics=True, tracing=False, trace_sample=1)
        obs.get_tracer().clear()

    med = br.median
    arms_out: dict[str, dict] = {}
    qps_off = med([a["qps"] for a in runs["off"]])
    # Best-window estimator alongside the median: on a shared box,
    # background load only ever SLOWS a run down (noise is additive),
    # so each arm's fastest rep is its least-contended window and the
    # best-vs-best delta is the closest this box gets to a dedicated-
    # machine measurement. The medians stay recorded; when the two
    # disagree, drift was larger than the effect being measured.
    best_off = max(a["qps"] for a in runs["off"])
    for name in ARMS:
        qps = med([a["qps"] for a in runs[name]])
        best = max(a["qps"] for a in runs[name])
        arm = {"qps_median": qps, "qps_best": best, "runs": runs[name]}
        if name != "off":
            arm["qps_regression"] = round(1.0 - qps / qps_off, 4)
            arm["added_us_per_request"] = round(
                (1.0 / qps - 1.0 / qps_off) * 1e6, 2
            )
            arm["qps_regression_best"] = round(1.0 - best / best_off, 4)
            arm["added_us_per_request_best"] = round(
                (1.0 / best - 1.0 / best_off) * 1e6, 2
            )
        if ARMS[name]["tracing"]:
            # the final rep's audit is the recorded one (each arm run
            # re-audits its own ring; any rep failing connectivity
            # would already show broken links there)
            arm["trace_audit"] = runs[name][-1]["trace_audit"]
        arms_out[name] = arm
    return {
        "graph": {"authors": n, "papers": n_papers, "venues": n_venues,
                  "seed": seed},
        "load": {"clients": clients,
                 "queries_per_client": queries_per_client,
                 "regime": "mixed (steady state)", "k": k,
                 "max_batch": max_batch, "max_wait_ms": max_wait_ms,
                 "reps": reps},
        "backend": backend,
        "arms": arms_out,
        "steady_state_compiles": {
            name: sum(a["steady_state_compiles"] for a in runs[name])
            for name in ARMS
        },
        "estimator_note": (
            "multi-tenant box: baseline drifts up to 3x between reps, "
            "so medians bound drift, qps_best/added_us_per_request_best "
            "(fastest window per arm) is the dedicated-machine estimate; "
            "compile counts and trace audits are deterministic. Arm "
            "interleaving + estimators come from utils/benchrunner.py "
            "(shared with dpathsim-torch tune)"
        ),
    }


def obs_checks(result: dict) -> dict:
    """The obs regime's four gates (see :func:`run_obs_smoke`); the
    last, the absolute cost per request, is the clock's."""
    arms = result["arms"]
    traced_audit = arms["traced"]["trace_audit"]
    sampled_audit = arms["sampled"]["trace_audit"]
    return {
        "zero_additional_compiles": all(
            v == 0 for v in result["steady_state_compiles"].values()
        ),
        "traces_connected": (
            traced_audit["dispatched_request_traces"] > 0
            and traced_audit["unlinked_request_traces"] == 0
            and traced_audit["broken_parent_links"] == 0
        ),
        "sampling_suppresses_spans": (
            sampled_audit["total_spans"]
            < traced_audit["total_spans"] / 4
            and sampled_audit["dispatched_request_traces"] > 0
            and sampled_audit["unlinked_request_traces"] == 0
            and sampled_audit["broken_parent_links"] == 0
        ),
        # best-window estimate: drift on a shared box only inflates a
        # rep, so the fastest off-vs-traced pair is the stable gate
        "overhead_under_1ms_per_request": (
            arms["traced"]["added_us_per_request_best"] < 1000.0
        ),
    }


def run_obs_smoke(out_path: str | None = None, backend: str = "torch",
                  platform: str = "cuda") -> dict:
    """The tier-1 obs gate: a small fixed run with four hard checks —
    (1) no obs arm causes a single additional steady-state
    compile, (2) the full-tracing arm's traces are connected
    enqueue→dispatch→device→complete chains with zero broken parent
    links, (3) head sampling genuinely suppresses span creation (the
    sampled arm's ring carries a fraction of the traced arm's spans,
    and its sampled-in traces are still connected), (4) the ABSOLUTE
    cost full obs adds per request stays under 1 ms. The smoke graph's
    per-query device work is microseconds, so a relative-QPS bound
    here would measure scheduler noise, not obs (observed 4×
    run-to-run QPS swings on a loaded CI box); the absolute bound is
    stable there and still catches every pathology this gate exists
    for (per-observation allocation, lock collapse, sample retention).
    The relative steady-state numbers per arm are the full-size
    artifact's claim (BENCH_OBS_r08.json)."""
    result = run_obs_bench(**OBS_SMOKE, backend=backend, platform=platform)
    result["smoke_checks"] = checks = obs_checks(result)
    _write(result, out_path)
    _require(checks, "obs")
    return result


def _router_worker_argv(spec: str, backend: str, wid: str, max_batch: int,
                        max_wait_ms: float, k: int,
                        platform: str = "cuda") -> list[str]:
    return [
        sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", "worker",
        "--worker-id", wid, "--dataset", spec, "--backend", backend,
        "--platform", platform, "--max-batch", str(max_batch),
        "--max-wait-ms", str(max_wait_ms), "--k", str(k),
    ]


def _spawn_router(n_workers: int, spec: str, backend: str, max_batch: int,
                  max_wait_ms: float, k: int, hedge_ms: float = 150.0,
                  platform: str = "cuda"):
    from .router import (
        Router, RouterConfig, SubprocessTransport,
    )

    transports = {
        f"w{i}": SubprocessTransport(
            f"w{i}",
            _router_worker_argv(spec, backend, f"w{i}", max_batch,
                                max_wait_ms, k, platform),
        )
        for i in range(n_workers)
    }
    router = Router(
        transports,
        RouterConfig(
            heartbeat_interval_s=0.2,
            # generous stall window: on a shared 2-core bench box the
            # workers compete with the clients for CPU, and a slow pong
            # is load, not death — kill detection rides the pipe EOF,
            # which is immediate regardless
            heartbeat_miss_limit=15,
            hedge_ms=hedge_ms,
            max_inflight=4096,
        ),
    )
    router.start()
    return router


def _run_router_clients(router, schedule: list[list[int]], k: int) -> dict:
    """Closed-loop load through the router (the clients and ledger of
    ``router/loadgen.run_router_clients``), reported as
    :func:`_run_clients` reports a service: admission sheds counted
    apart from the lost requests, failover and hedge counts from the
    response flags, and the failed-over requests' own latencies."""
    res = run_router_clients(router, schedule, k)
    lats = res["latencies_s"]
    failover_lats = [dt for (_, resp), dt in zip(res["answers"], lats)
                     if resp.get("failovers")]
    wall = res["wall_s"]
    out = {
        "queries": res["queries"],
        "lost": res["lost"] - res["shed"],
        "errors": res["errors"],
        "wall_s": round(wall, 4),
        "qps": round(res["qps"], 2) if wall > 0 else float("inf"),
        "shed": res["shed"],
        "hedged": res["hedged"],
        "failover_affected": res["failover_affected"],
        **_percentiles(lats),
    }
    if failover_lats:
        out["failover_recovery"] = _percentiles(failover_lats)
    return out


def run_router_bench(
    n_authors: int = 2048,
    n_papers: int = 4096,
    n_venues: int = 48,
    replicas: tuple = (1, 2, 4),
    clients: int = 16,
    queries_per_client: int = 48,
    max_batch: int = 16,
    max_wait_ms: float = 1.0,
    k: int = 10,
    backend: str = "torch",
    platform: str = "cuda",
    seed: int = 0,
    kill_phase: bool = True,
) -> dict:
    """The multi-process closed-loop regime: a QPS-vs-replicas curve
    (each worker a real ``dpathsim-torch worker`` subprocess over the same
    synthetic graph), then a mid-load worker kill measuring failover —
    detection time, recovery latency of the affected in-flight
    requests, and the zero-lost-request ledger. A local single-process
    numpy service is the bit-exactness oracle for a sampled subset of
    the answered queries."""
    from .data.synthetic import synthetic_hin
    from .ops.metapath import compile_metapath
    from .serving import PathSimService, ServeConfig

    spec = (
        f"synthetic:authors={n_authors},papers={n_papers},"
        f"venues={n_venues},seed={seed}"
    )
    rng = np.random.default_rng(seed)
    hin = synthetic_hin(n_authors, n_papers, n_venues, seed=seed)
    n = hin.type_size("author")
    mp = compile_metapath("APVPA", hin.schema)
    oracle = PathSimService(
        _create_backend("numpy", hin, mp, platform),
        config=ServeConfig(max_wait_ms=0.5, warm=False),
    )
    uniform = rng.integers(0, n, size=(clients, queries_per_client))
    out: dict = {
        "graph": {"authors": n, "papers": n_papers, "venues": n_venues,
                  "seed": seed},
        "load": {"clients": clients,
                 "queries_per_client": queries_per_client, "k": k,
                 "max_batch": max_batch, "max_wait_ms": max_wait_ms},
        "backend": backend,
        "environment": {
            "cpu_count": os.cpu_count(),
            "note": (
                "every worker is a real OS process pinned to the same "
                "box as the router and the closed-loop clients; with "
                "replicas >= cpu_count the curve measures CPU "
                "oversubscription, not the tier. The robustness gates "
                "(zero lost, zero recompiles, oracle bit-parity, "
                "detection/recovery times) are load-invariant and are "
                "the artifact's claim on this box; the scaling story "
                "needs one host per worker."
            ),
        },
        "replicas": {},
    }
    try:
        for n_workers in replicas:
            router = _spawn_router(n_workers, spec, backend, max_batch,
                                   max_wait_ms, k, platform=platform)
            try:
                # warmup: touch the buckets, then measure steady state
                # with the compile ledger open on every worker
                _run_router_clients(router, uniform[:4, :8].tolist(), k)
                h0 = _router_worker_compiles(router)
                res = _run_router_clients(router, uniform.tolist(), k)
                res["steady_state_compiles"] = sum(
                    _router_worker_compiles(router).values()
                ) - sum(h0.values())
                res["oracle_checked"] = _router_oracle_check(
                    router, oracle, rng, n, k, samples=16
                )
                out["replicas"][str(n_workers)] = res
            finally:
                router.close()
        base = out["replicas"][str(replicas[0])]["qps"]
        out["scaling"] = {
            str(r): round(out["replicas"][str(r)]["qps"] / base, 2)
            for r in replicas
        }
        if kill_phase:
            out["failover"] = _router_kill_phase(
                spec, backend, max_batch, max_wait_ms, k, uniform, oracle,
                rng, n, platform=platform,
            )
    finally:
        oracle.close()
    return out


def _router_worker_compiles(router) -> dict:
    """Per-worker compile counts (kernel builds, loads and CUDA-graph
    captures), self-reported through a fresh
    health round-trip (Router.worker_health probes and waits for the
    pong, so the count reflects everything up to now)."""
    counts = {}
    for wid, w in router.workers.items():
        if w.status != "up":
            continue
        counts[wid] = int(router.worker_health(wid).get("compiles", 0))
    return counts


def _router_oracle_check(router, oracle, rng, n, k, samples: int) -> dict:
    """Bit-exactness: routed answers vs the single-process oracle —
    exact ids, exact f64 scores, same tie order."""
    checked = mismatches = 0
    for row in rng.integers(0, n, size=samples):
        resp = router.request({"op": "topk", "row": int(row), "k": k},
                              timeout=30)
        if not resp.get("ok"):
            mismatches += 1
            continue
        vals, idxs = oracle.topk_index(int(row), k)
        want = [
            (oracle._ident(int(j))[0], float(v))
            for v, j in zip(vals, idxs) if np.isfinite(v)
        ]
        got = [(h["id"], h["score"]) for h in resp["result"]["topk"]]
        checked += 1
        if got != want:
            mismatches += 1
    return {"checked": checked, "mismatches": mismatches}


def _router_kill_phase(spec, backend, max_batch, max_wait_ms, k, uniform,
                       oracle, rng, n, platform: str = "cuda") -> dict:
    """Two workers under load; SIGKILL one mid-batch. Measures
    detection (kill → router marks it down), recovery (latency of the
    requests the death orphaned), and the ledger: zero lost requests,
    answers still oracle-exact afterward."""
    router = _spawn_router(2, spec, backend, max_batch, max_wait_ms, k,
                           hedge_ms=300.0, platform=platform)
    try:
        _run_router_clients(router, uniform[:4, :8].tolist(), k)  # warm
        detect = {}
        started = threading.Event()

        def killer():
            started.wait()
            time.sleep(0.05)  # mid-load: in-flight work must be orphaned
            victim = router.workers["w0"]
            t_kill = time.perf_counter()
            victim.transport.kill()
            while victim.status == "up":
                time.sleep(0.001)
            detect["detect_ms"] = round(
                (time.perf_counter() - t_kill) * 1e3, 2
            )

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        # enough closed-loop work that the kill lands INSIDE the run
        # (the QPS phases finish a small schedule in well under a
        # second on this graph)
        schedule = np.tile(uniform, (1, 6)).tolist()
        started.set()
        res = _run_router_clients(router, schedule, k)
        kt.join(timeout=30)
        res.update(detect)
        res["post_kill_oracle"] = _router_oracle_check(
            router, oracle, rng, n, k, samples=8
        )
        return res
    finally:
        router.close()


def router_checks(result: dict) -> dict:
    """The router regime's five gates (see :func:`run_router_smoke`),
    none of them the clock's."""
    fo = result["failover"]
    return {
        "zero_lost_requests": all(
            r["lost"] == 0 for r in result["replicas"].values()
        ) and fo["lost"] == 0,
        "zero_steady_state_recompiles": all(
            r["steady_state_compiles"] == 0
            for r in result["replicas"].values()
        ),
        "oracle_bit_identical": all(
            r["oracle_checked"]["mismatches"] == 0
            for r in result["replicas"].values()
        ) and fo["post_kill_oracle"]["mismatches"] == 0,
        "kill_detected": "detect_ms" in fo,
        # the kill must have orphaned real in-flight work that then
        # completed elsewhere — otherwise this run proved nothing
        "failover_rerouted": fo["failover_affected"] > 0,
    }


def run_router_smoke(out_path: str | None = None, backend: str = "torch",
                     platform: str = "cuda") -> dict:
    """The tier-1 router gate: 2 real worker
    subprocesses on a small graph, closed-loop load, one SIGKILL mid
    load. Hard gates: ZERO lost requests (every admitted query answers
    ok despite the kill), zero steady-state recompiles on the
    surviving workers, failover answers bit-identical to the
    single-process oracle, and the QPS curve exists (1 vs 2 replicas
    measured, no scaling claim — a 2-core CI box cannot prove
    scaling, only the artifact run on real hardware can)."""
    result = run_router_bench(**ROUTER_SMOKE, backend=backend,
                              platform=platform)
    result["smoke_checks"] = checks = router_checks(result)
    _write(result, out_path)
    _require(checks, "router")
    return result


def _inproc_fleet(hin, mp, n_workers, backend="torch", max_batch=8,
                  max_wait_ms=1.0, platform="cuda", **router_cfg):
    """N inproc workers + a router sharing this process (the overhead
    bench's fleet: obs switches are process-global, so toggling an arm
    toggles router AND workers at once — exactly the full-stack cost
    being measured)."""
    from .router import (
        InprocTransport, Router, RouterConfig, WorkerRuntime,
    )
    from .serving import PathSimService, ServeConfig

    transports = {}
    for i in range(n_workers):
        wid = f"w{i}"
        svc = PathSimService(
            _create_backend(backend, hin, mp, platform),
            config=ServeConfig(max_batch=max_batch,
                               max_wait_ms=max_wait_ms),
        )
        transports[wid] = InprocTransport(
            wid, WorkerRuntime(svc, worker_id=wid)
        )
    router_cfg.setdefault("heartbeat_interval_s", 0.5)
    router_cfg.setdefault("hedge_ms", None)
    router_cfg.setdefault("max_inflight", 4096)
    router = Router(transports, RouterConfig(**router_cfg))
    router.start()
    return router, transports


def _close_inproc_fleet(router, transports) -> None:
    router.close()
    for t in transports.values():
        t.runtime.service.close()


def run_fleet_obs_bench(
    n_authors: int = 1024,
    n_papers: int = 2048,
    n_venues: int = 24,
    clients: int = 8,
    queries_per_client: int = 48,
    max_batch: int = 16,
    max_wait_ms: float = 1.0,
    reps: int = 3,
    k: int = 10,
    backend: str = "torch",
    platform: str = "cuda",
    seed: int = 0,
) -> dict:
    """The fleet observability overhead envelope (BENCH_FLEET_OBS_r12):
    one closed-loop router workload timed under four arms with the
    shared paired-ratio estimator (utils/benchrunner.py — within-round
    ratios cancel the multi-minute drift a shared box carries):

    - ``off``      — metrics and tracing off (the floor);
    - ``metrics``  — the metrics registry on (the serving default);
    - ``stitched`` — + full cross-process trace stitching (router root
      span, per-attempt dispatch spans, wire contexts, worker trees);
    - ``tail``     — + the flight recorder keeping EVERY request
      (``slow_ms=0``), the worst-case tail-sampling write rate.

    Fleets are inproc (same WorkerRuntime/Router code, no process
    boundary) so the per-request cost is the instrumentation's, not
    pipe-crossing noise; background scrape loops are off during timing
    and the scrape+merge round is measured separately
    (``scrape_round_ms``) — a periodic cost, not a per-request one."""
    from . import obs
    from .data.synthetic import synthetic_hin
    from .ops.metapath import compile_metapath
    from .utils import benchrunner as br

    hin = synthetic_hin(n_authors, n_papers, n_venues, seed=seed)
    mp = compile_metapath("APVPA", hin.schema)
    rng = np.random.default_rng(seed)
    n = hin.type_size("author")
    schedule = rng.integers(
        0, n, size=(clients, queries_per_client)
    ).tolist()

    ARMS = {
        "off": dict(metrics=False, tracing=False, sample=1, tail=False),
        "metrics": dict(metrics=True, tracing=False, sample=1,
                        tail=False),
        "stitched": dict(metrics=True, tracing=True, sample=1,
                         tail=False),
        "tail": dict(metrics=True, tracing=True, sample=1, tail=True),
    }
    fleets = {}
    try:
        for name, cfg in ARMS.items():
            fleets[name] = _inproc_fleet(
                hin, mp, 2, backend=backend, max_batch=max_batch,
                max_wait_ms=max_wait_ms, platform=platform,
                scrape_interval_s=0.0,
                # tail arm: slow_ms=0 keeps every request — the
                # worst-case recorder write rate
                slow_ms=(0.0 if cfg["tail"] else 1e9),
                flight_capacity=512,
            )

        def one_arm(name: str) -> None:
            cfg = ARMS[name]
            obs.configure(metrics=cfg["metrics"], tracing=cfg["tracing"],
                          trace_sample=cfg["sample"])
            if cfg["tracing"]:
                obs.get_tracer().clear()  # bound ring growth per round
            router, _ = fleets[name]
            _run_router_clients(router, schedule, k)

        results = br.time_interleaved(
            {name: (lambda name=name: one_arm(name)) for name in ARMS},
            reps=reps, warmup=1,
        )
        # the scrape+merge round, measured apart: its cost is per
        # INTERVAL (default 5 s), not per request
        obs.configure(metrics=True, tracing=False, trace_sample=1)
        router, _ = fleets["metrics"]
        t_scrape = []
        for _ in range(max(3, reps)):
            t0 = time.perf_counter()
            router.fleet_metrics(refresh=True)
            t_scrape.append((time.perf_counter() - t0) * 1e3)
        # stitched-trace audit on the tracing fleet (deterministic gate
        # material, recorded alongside the timings)
        obs.configure(metrics=True, tracing=True, trace_sample=1)
        obs.get_tracer().clear()
        router, _ = fleets["stitched"]
        _run_router_clients(router, schedule[:2], k)
        from .obs import fleet as obs_fleet

        audit = obs_fleet.audit_fleet_traces(router.collect_trace_parts())
        tail_router, _ = fleets["tail"]
        flight = {
            "kept_total": tail_router.flight.kept_total,
            "dropped": tail_router.flight.dropped,
        }
    finally:
        obs.configure(metrics=True, tracing=False, trace_sample=1)
        obs.get_tracer().clear()
        for fleet in fleets.values():
            _close_inproc_fleet(*fleet)

    total_q = clients * queries_per_client
    per_req_off_us = (
        results["off"]["median_of_best_ms"] * 1e3 / total_q
    )
    arms_out: dict[str, dict] = {}
    for name in ARMS:
        arm = {
            **{key: results[name][key] for key in
               ("best_ms", "median_ms", "median_of_best_ms", "worst_ms")},
            "per_request_us": round(
                results[name]["median_of_best_ms"] * 1e3 / total_q, 2
            ),
        }
        if name != "off":
            ratio = br.paired_ratio(results, name, ["off"])
            arm["paired_ratio_vs_off"] = round(ratio, 4)
            arm["added_us_per_request"] = round(
                (ratio - 1.0) * per_req_off_us, 2
            )
        arms_out[name] = arm
    full_stack_us = arms_out["tail"]["added_us_per_request"]
    # the acceptance envelope: the single-process tracing artifact
    # (the keys' "pr4") recorded +40 µs per fully-traced request; the
    # full fleet stack
    # (metrics + scrape plane + stitching + tail recording) must stay
    # within 2× that budget
    pr4_budget_us = 40.0
    return {
        "graph": {"authors": n, "papers": n_papers, "venues": n_venues,
                  "seed": seed},
        "load": {"clients": clients,
                 "queries_per_client": queries_per_client,
                 "total_queries": total_q, "k": k,
                 "max_batch": max_batch, "max_wait_ms": max_wait_ms,
                 "reps": reps, "workers": 2, "transport": "inproc"},
        "backend": backend,
        "arms": arms_out,
        "scrape_round_ms": {
            "median": round(sorted(t_scrape)[len(t_scrape) // 2], 3),
            "min": round(min(t_scrape), 3),
            "max": round(max(t_scrape), 3),
            "note": "per scrape interval (default 5 s), amortized to "
            "~zero per request; measured apart so the per-request "
            "arms stay clean",
        },
        "trace_audit": {
            **audit,
            "note": "inproc fleet = one pid, so cross_process counts "
            "are structurally 0 here; the zero-broken-links gate over "
            "the full span set is the meaningful column. Real "
            "cross-process stitching is gated by the fleet-obs smoke "
            "(subprocess workers).",
        },
        "tail_flight": flight,
        "overhead_envelope": {
            "pr4_tracing_budget_us": pr4_budget_us,
            "full_stack_added_us_per_request": full_stack_us,
            "budget_ratio": round(full_stack_us / pr4_budget_us, 3),
            "within_2x_pr4_budget": bool(
                full_stack_us <= 2.0 * pr4_budget_us
            ),
        },
        "estimator_note": (
            "arms interleaved with rotated starting order; "
            "added_us_per_request from PAIRED within-round ratios vs "
            "the off arm (utils/benchrunner.paired_ratio — cancels the "
            "multi-minute drift this box carries, the BENCH_TUNING "
            "discipline). Inproc transports isolate instrumentation "
            "cost from pipe noise; cross-PROCESS stitching correctness "
            "is the subprocess smoke's gate (--regime fleet-obs --smoke)."
        ),
    }


def _fleet_obs_router_args(tmp: str, backend: str = "torch",
                           platform: str = "cuda"):
    """The fleet-obs smoke's router command line (its workers' argv
    comes from the router CLI's own builder, ``router/cli._worker_argv``):
    ``backend`` on ``platform``, metrics and traces forwarded into
    ``tmp``."""
    from .router.cli import build_router_parser

    return build_router_parser().parse_args([
        "--dataset", FLEET_OBS_SPEC, "--backend", backend,
        "--platform", platform,
        "--max-batch", "8", "--max-wait-ms", "1.0", "--k", "5",
        "--metrics-file", os.path.join(tmp, "fleet.prom"),
        "--trace-out", os.path.join(tmp, "trace.json"),
        "--metrics-interval", "1.0",
    ])


def fleet_obs_checks(seen: dict) -> dict:
    """The fleet-obs smoke's ten gates (see :func:`run_fleet_obs_smoke`),
    none of them the clock's, from what the smoke saw: the kill run's
    ledger, the stitched-trace audit, the merged and per-worker request
    counts, the SLO snapshot, the flight recorder's reasons and dump,
    the survivors' compile delta, the forwarded artifacts and the fleet
    textfile."""
    audit = seen["audit"]
    merged_count = seen["merged_count"]
    worker_counts = seen["worker_counts"]
    slo = seen["slo"]
    dump = seen["dump"]
    return {
        "zero_lost_requests": seen["load"]["lost"] == 0,
        "stitched_cross_process_trace": (
            audit["stitched_cross_process"] >= 1
            and audit["broken_parent_links"] == 0
        ),
        "merged_count_equals_worker_sum": (
            merged_count == sum(worker_counts.values())
            and merged_count > 0
            # the merge genuinely crossed workers: both subprocesses
            # contributed observed requests, not just one
            and sum(
                1 for wid, n in worker_counts.items()
                if wid != "router" and n > 0
            ) == 2
        ),
        "slo_burn_fired_on_latency_fault": (
            slo["latency_p99"]["alerts"] >= 1
        ),
        "availability_slo_quiet": slo["availability"]["alerts"] == 0,
        "flight_captured_failover": any(
            "failover" in reasons for reasons in seen["flight_reasons"]
        ),
        "flight_dump_written": dump["records"] > 0 and dump["spans"] > 0,
        "zero_added_steady_state_compiles": seen["compile_delta"] == 0,
        "worker_artifacts_forwarded": seen["w1_artifacts"],
        "fleet_prom_has_worker_labels": 'worker="w1"' in seen["prom_text"],
    }


def run_fleet_obs_smoke(out_path: str | None = None, backend: str = "torch",
                        platform: str = "cuda") -> dict:
    """The tier-1 fleet-observability gate: a REAL router + 2
    ``dpathsim-torch worker`` subprocesses under closed-loop load with
    one mid-load SIGKILL. Hard gates:

    - ≥1 stitched cross-process trace with ZERO broken parent links
      (router root → dispatch attempts → worker subtrees, scraped via
      the ``trace`` op and merged);
    - the merged fleet histogram's count equals the sum of the
      per-worker counts (the exact-merge contract, end to end);
    - the SLO burn-rate engine fires on an injected latency fault (a
      100 µs p99 objective no real fleet meets — deterministic burn);
    - the flight recorder captured the failed-over requests the kill
      orphaned (tail sampling's reason for existing);
    - zero lost requests and zero added steady-state compiles on the
      surviving worker;
    - the satellite artifact forwarding left per-worker files
      (suffixed --trace-out/--metrics-file) and the fleet textfile
      renders with worker labels.

    The fleet snapshot the router answered last is written beside them
    (``fleet.json``, what ``dpathsim-torch fleet-stats`` reads)."""
    import tempfile

    from . import obs
    from .obs import fleet as obs_fleet
    from .obs.slo import SLOSpec
    from .router import Router, RouterConfig, SubprocessTransport
    from .router.cli import _worker_argv

    tmp = tempfile.mkdtemp(prefix="dpathsim_fleet_obs_")
    spec = FLEET_OBS_SPEC
    router_args = _fleet_obs_router_args(tmp, backend, platform)
    obs.configure(metrics=True, tracing=True, trace_sample=1)
    obs.get_tracer().clear()
    windows = ((1.0, 1.0), (3.0, 1.0))
    specs = (
        SLOSpec(name="availability", kind="availability",
                metric="dpathsim_router_requests_total",
                objective=0.999, good_labels=(("outcome", "ok"),),
                windows=windows),
        # the injected latency fault: a 100 µs p99 objective that no
        # subprocess round-trip can meet, so the budget burns in every
        # window — deterministic on any box, unlike a delay injection
        # racing a scrape tick
        SLOSpec(name="latency_p99", kind="latency",
                metric="dpathsim_router_request_seconds",
                objective=0.99, threshold=1e-4, windows=windows),
    )
    transports = {
        f"w{i}": SubprocessTransport(f"w{i}", _worker_argv(router_args, i))
        for i in range(2)
    }
    router = Router(
        transports,
        RouterConfig(
            heartbeat_interval_s=0.2, heartbeat_miss_limit=15,
            hedge_ms=300.0, max_inflight=4096,
            scrape_interval_s=0.4, slo_specs=specs,
            slow_ms=1e9,  # isolate failover/error reasons from "slow"
            flight_capacity=256,
        ),
    )
    rng = np.random.default_rng(0)
    uniform = rng.integers(0, 256, size=(6, 16))
    try:
        router.start()
        _run_router_clients(router, uniform[:4, :8].tolist(), 5)  # warm
        # pin a post-warm scrape of BOTH workers before the killer can
        # take w0: the merge-crosses-workers gate needs w0 to have a
        # snapshot at all, and on a warm box the kill (50 ms into main
        # load) legitimately outruns the first 0.4 s scrape tick
        router.fleet_metrics(refresh=True)
        h0 = _router_worker_compiles(router)
        started = threading.Event()

        def killer():
            started.wait()
            time.sleep(0.05)
            router.workers["w0"].transport.kill()

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        schedule = np.tile(uniform, (1, 6)).tolist()
        started.set()
        res = _run_router_clients(router, schedule, 5)
        kt.join(timeout=30)
        # two full scrape windows so the SLO engine evaluates over the
        # load it just saw
        time.sleep(1.0)
        router._evaluate_slo(time.monotonic())
        survivors = _router_worker_compiles(router)
        compile_delta = sum(survivors.values()) - sum(
            h0[w] for w in survivors
        )
        fm = router.fleet_metrics(refresh=True)
        parts = router.metric_parts()
        # the merge-equality family: the serve-layer request histogram
        # (real query traffic, observed per worker as its coalescer
        # resolves topk futures). Every part that carries the family
        # contributes — including the router's own registry when this
        # process hosted in-proc services (pytest shares the process
        # registry across tests).
        fam_name = "dpathsim_serve_request_seconds"
        worker_counts = {
            wid: sum(
                c["count"]
                for c in (snap.get(fam_name) or {"values": []})["values"]
            )
            for wid, snap in parts.items()
        }
        merged_count = sum(
            c["count"]
            for c in (fm["merged"].get(fam_name) or
                      {"values": []})["values"]
        )
        trace_parts = router.collect_trace_parts()
        audit = obs_fleet.audit_fleet_traces(trace_parts)
        flight_reasons = [
            r["reasons"] for r in router.flight.records()
        ]
        dump = router.flight_dump(os.path.join(tmp, "flight.json"))
        obs_fleet.write_fleet_textfile(
            os.path.join(tmp, "fleet.prom"), parts
        )
        with open(os.path.join(tmp, "fleet.prom"), encoding="utf-8") as f:
            prom_text = f.read()
        with open(os.path.join(tmp, "fleet.json"), "w",
                  encoding="utf-8") as f:
            json.dump(fm, f)
    finally:
        router.close()
        obs.configure(metrics=True, tracing=False, trace_sample=1)
        obs.get_tracer().clear()
    # the forwarded per-worker artifacts: w0 was SIGKILLed (its files
    # may be absent/stale — a killed process writes nothing, by
    # design); the drained survivor must have left both
    checks = fleet_obs_checks({
        "load": res, "audit": audit, "merged_count": merged_count,
        "worker_counts": worker_counts, "slo": fm["slo"],
        "flight_reasons": flight_reasons, "dump": dump,
        "compile_delta": compile_delta,
        "w1_artifacts": (
            os.path.exists(os.path.join(tmp, "trace.w1.json"))
            and os.path.exists(os.path.join(tmp, "fleet.w1.prom"))
        ),
        "prom_text": prom_text,
    })
    result = {
        "graph": {"spec": spec}, "tmpdir": tmp,
        "load": res, "trace_audit": audit,
        "merged_request_count": merged_count,
        "per_worker_request_counts": worker_counts,
        "slo": fm["slo"], "flight_dump": dump,
        "flight_reasons": flight_reasons[:10],
        "steady_state_compiles": compile_delta,
        "smoke_checks": checks,
    }
    _write(result, out_path)
    _require(checks, "fleet-obs",
             f" (merged={merged_count}, per_worker={worker_counts})")
    return result


def _partition_worker_argv(spec: str, index: int, partitions: int,
                           replication: int, k: int,
                           trace_out: str | None = None,
                           backend: str = "torch",
                           platform: str = "cuda") -> list[str]:
    argv = [
        sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", "worker",
        "--worker-id", f"w{index}", "--dataset", spec,
        "--backend", backend, "--platform", platform, "--k", str(k),
        "--partition-index", str(index),
        "--partitions", str(partitions),
        "--partition-replication", str(replication),
    ]
    if trace_out:
        # enables the worker-side tracer; the span ring is scraped
        # through the `trace` op for the stitched export
        argv += ["--trace-out", trace_out, "--trace-sample", "1"]
    return argv


def _spawn_partition_router(partitions: int, replication: int, spec: str,
                            k: int, trace_dir: str | None = None,
                            backend: str = "torch", platform: str = "cuda"):
    from .router import (
        PartitionRouter, PartitionRouterConfig, SubprocessTransport,
    )

    transports = {
        f"w{i}": SubprocessTransport(
            f"w{i}",
            _partition_worker_argv(
                spec, i, partitions, replication, k,
                trace_out=(
                    os.path.join(trace_dir, f"trace.w{i}.json")
                    if trace_dir else None
                ),
                backend=backend, platform=platform,
            ),
        )
        for i in range(partitions)
    }
    router = PartitionRouter(
        transports,
        PartitionRouterConfig(
            partitions=partitions,
            replication=replication,
            heartbeat_interval_s=0.2,
            # generous stall window on a shared 2-core box (see the
            # router regime's note): death detection rides the pipe EOF
            heartbeat_miss_limit=15,
            max_inflight=4096,
        ),
    )
    router.start()
    return router


def _worker_rss_kb(router) -> dict:
    """Per-worker resident memory (VmRSS) read from /proc — a measured
    number, not a model. It is host memory: on the card a worker's
    slice lives in device memory, which VmRSS does not count."""
    out = {}
    for wid, w in router.workers.items():
        proc = getattr(w.transport, "_proc", None)
        if proc is None or proc.poll() is not None:
            continue
        try:
            with open(f"/proc/{proc.pid}/status", encoding="utf-8") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        out[wid] = int(line.split()[1])
                        break
        except OSError:
            continue
    return out


def _partition_compiles(router) -> dict:
    counts = {}
    for wid, w in router.workers.items():
        if w.status != "up":
            continue
        health = router.worker_health(wid)
        counts[wid] = int(health.get("compiles", 0))
    return counts


def _partition_oracle_check(router, oracle, rng, n, k, samples: int) -> dict:
    checked = mismatches = 0
    for row in rng.integers(0, n, size=samples):
        resp = router.request({"op": "topk", "row": int(row), "k": k},
                              timeout=30)
        if not resp.get("ok"):
            mismatches += 1
            continue
        vals, idxs = oracle.topk_index(int(row), k)
        want = [
            (oracle._ident(int(j))[0], float(v))
            for v, j in zip(vals, idxs) if np.isfinite(v)
        ]
        got = [(h["id"], h["score"]) for h in resp["result"]["topk"]]
        checked += 1
        if got != want:
            mismatches += 1
    # one scores-row spot check: the full f64 row, entry-for-entry
    row = int(rng.integers(0, n))
    resp = router.request({"op": "scores", "row": row}, timeout=30)
    scores_exact = bool(
        resp.get("ok")
        and resp["result"]["scores"] == oracle.scores_index(row).tolist()
    )
    return {"checked": checked, "mismatches": mismatches,
            "scores_row_exact": scores_exact}


def _partition_delta_phase(router, oracle, rng, n_papers, deltas: int,
                           k: int) -> dict:
    """Routed deltas under measurement: each ``update`` is timed
    submit→sealed (the update-visible latency for partition mode — the
    answer path is fenced until the seal, so sealed IS visible), the
    oracle absorbs the same records, and parity is re-checked after."""
    from .data.delta import delta_from_records

    lat = []
    for i in range(deltas):
        cur = oracle.hin.blocks["author_of"]
        j = int(rng.integers(0, cur.rows.shape[0]))
        removes = [{"rel": "author_of", "src_row": int(cur.rows[j]),
                    "dst_row": int(cur.cols[j])}]
        existing = set(zip(cur.rows.tolist(), cur.cols.tolist()))
        adds = []
        while len(adds) < 2:
            a = int(rng.integers(0, oracle.n))
            p = int(rng.integers(0, n_papers))
            if (a, p) not in existing and not any(
                x["src_row"] == a and x["dst_row"] == p for x in adds
            ):
                adds.append({"rel": "author_of", "src_row": a,
                             "dst_row": p})
        t0 = time.perf_counter()
        resp = router.request(
            {"op": "update", "add_edges": adds, "remove_edges": removes},
            timeout=60,
        )
        lat.append(time.perf_counter() - t0)
        assert resp.get("ok"), resp
        assert not resp["result"]["lagging"], resp
        oracle.update(delta_from_records(
            oracle.hin, add_edges=adds, remove_edges=removes
        ))
    rng2 = np.random.default_rng(7)
    return {
        "deltas": deltas,
        "update_visible": _percentiles(lat),
        "post_delta_oracle": _partition_oracle_check(
            router, oracle, rng2, oracle.n, k, samples=8
        ),
    }


def _partition_trace_phase(spec: str, partitions: int, replication: int,
                           k: int, rng, n: int, backend: str = "torch",
                           platform: str = "cuda") -> dict:
    """Partition-aware trace stitching: a traced
    fleet of REAL worker subprocesses, a handful of scatters, one
    stitched export. The gate: every ``tile_pull``/``partial_topk``
    sub-request's worker subtree hangs under its router dispatch span
    — ≥1 stitched cross-process trace, ZERO broken parent links."""
    import tempfile

    from . import obs
    from .obs import fleet as obs_fleet

    trace_dir = tempfile.mkdtemp(prefix="dpathsim_ptrace_")
    obs.configure(metrics=True, tracing=True, trace_sample=1)
    obs.get_tracer().clear()
    router = _spawn_partition_router(
        partitions, replication, spec, k, trace_dir=trace_dir,
        backend=backend, platform=platform,
    )
    try:
        for row in rng.integers(0, n, size=6):
            resp = router.request(
                {"op": "topk", "row": int(row), "k": k}, timeout=30,
            )
            assert resp.get("ok"), resp
        resp = router.request(
            {"op": "scores", "row": int(rng.integers(0, n))}, timeout=30,
        )
        assert resp.get("ok"), resp
        parts = router.collect_trace_parts()
        audit = obs_fleet.audit_fleet_traces(parts)
        trace_path = os.path.join(trace_dir, "fleet_trace.json")
        events = router.write_fleet_trace(trace_path, parts=parts)
        return {
            "trace_parts": len(parts),
            "trace_events": events,
            "trace_path": trace_path,
            **audit,
        }
    finally:
        router.close()
        obs.configure(metrics=True, tracing=False, trace_sample=1)
        obs.get_tracer().clear()


def _partition_kill_phase(spec, partitions, replication, k, uniform,
                          oracle, rng, n, backend: str = "torch",
                          platform: str = "cuda") -> dict:
    """The partition fleet under a mid-load SIGKILL: chained
    replication means every range still has a live holder, so the
    ledger must show zero lost requests and post-kill answers stay
    oracle-exact."""
    router = _spawn_partition_router(partitions, replication, spec, k,
                                     backend=backend, platform=platform)
    try:
        _run_router_clients(router, uniform[:4, :8].tolist(), k)  # warm
        h0 = _partition_compiles(router)
        detect = {}
        started = threading.Event()

        def killer():
            started.wait()
            time.sleep(0.05)
            victim = router.workers["w0"]
            t_kill = time.perf_counter()
            victim.transport.kill()
            while victim.status == "up":
                time.sleep(0.001)
            detect["detect_ms"] = round(
                (time.perf_counter() - t_kill) * 1e3, 2
            )

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        schedule = np.tile(uniform, (1, 6)).tolist()
        started.set()
        res = _run_router_clients(router, schedule, k)
        kt.join(timeout=30)
        res.update(detect)
        res["survivor_compiles"] = sum(
            _partition_compiles(router).values()
        ) - sum(v for w, v in h0.items() if w != "w0")
        res["post_kill_oracle"] = _partition_oracle_check(
            router, oracle, rng, n, k, samples=8
        )
        return res
    finally:
        router.close()


def run_partition_bench(
    n_authors: int = 2048,
    n_papers: int = 4096,
    n_venues: int = 48,
    partitions: tuple = (1, 2, 3),
    replication: int = 2,
    clients: int = 8,
    queries_per_client: int = 32,
    k: int = 10,
    seed: int = 0,
    deltas: int = 6,
    budget_gb: float = 8.0,
    kill_phase: bool = True,
    backend: str = "torch",
    platform: str = "cuda",
) -> dict:
    """``--regime partition``: ONE graph sharded across P real worker
    subprocesses. Measures, per worker
    count: per-worker resident slice (measured factor bytes + process
    VmRSS), the max-N model those bytes imply at a fixed per-worker
    budget (max-N grows with P because each worker holds ~R/P of the
    rows), closed-loop query latency (the tile-exchange overhead shows
    up here vs the replica-mode baseline at equal N), routed-delta
    update-visible latency, oracle bit-parity, and the kill ledger.
    ``worker_vm_rss_kb`` is each worker's host memory; on the card its
    slice lives in device memory (``factor_bytes`` weighs it)."""
    from .data.synthetic import synthetic_hin
    from .ops.metapath import compile_metapath
    from .serving import PathSimService, ServeConfig
    from .serving.partition import PartitionConfig, PartitionService

    spec = (
        f"synthetic:authors={n_authors},papers={n_papers},"
        f"venues={n_venues},seed={seed}"
    )
    rng = np.random.default_rng(seed)
    hin = synthetic_hin(n_authors, n_papers, n_venues, seed=seed)
    n = hin.type_size("author")
    mp = compile_metapath("APVPA", hin.schema)
    oracle = PathSimService(
        _create_backend("numpy", hin, mp, platform),
        config=ServeConfig(max_wait_ms=0.5, warm=False,
                           delta_threshold=1.0),
    )
    uniform = rng.integers(0, n, size=(clients, queries_per_client))
    budget_bytes = budget_gb * (1 << 30)
    out: dict = {
        "graph": {"authors": n, "papers": n_papers, "venues": n_venues,
                  "seed": seed},
        "load": {"clients": clients,
                 "queries_per_client": queries_per_client, "k": k},
        "replication": replication,
        "environment": {
            "cpu_count": os.cpu_count(),
            "note": (
                "every partition is a real OS process sharing this box "
                "with the router and the closed-loop clients, so QPS "
                "numbers measure CPU oversubscription past "
                "cpu_count workers — the honest claims here are the "
                "correctness gates (bit-parity, zero lost, zero "
                "recompiles), the MEASURED per-worker resident bytes "
                "(the max-N model multiplies those into a per-worker "
                "budget; the curve's growth with P is arithmetic over "
                "measured slices, not a throughput claim), and the "
                "measured update-visible latency of routed deltas."
            ),
            "max_n_model": (
                f"max-N at {budget_gb} GiB/worker = budget / "
                "measured-bytes-per-held-row; each worker holds "
                "~R/P of the rows under chained replication"
            ),
        },
        "partitions": {},
    }
    try:
        # ascending, deduplicated: the routed-delta phase (which
        # mutates the shared oracle) runs at the LARGEST count, so it
        # must come last — later arms would otherwise be checked
        # against a mutated oracle while serving the base graph
        partitions = tuple(sorted(set(int(p) for p in partitions)))
        for p_count in partitions:
            # measured resident slice: build ONE partition worker's
            # state in-process and weigh its arrays exactly
            svc0 = PartitionService(
                hin, mp, 0, p_count, replication=replication,
                config=PartitionConfig(device=platform),
            )
            factor_bytes = int(svc0.stats()["factor_bytes"])
            rows_held = int(svc0.fs.n_held)
            block_bytes = sum(
                int(b.rows.nbytes + b.cols.nbytes + b.weights.nbytes)
                if hasattr(b, "weights")
                else int(b.rows.nbytes + b.cols.nbytes)
                for b in svc0.hin.blocks.values()
            )
            per_row = (factor_bytes + block_bytes) / max(rows_held, 1)
            held_fraction = rows_held / n
            max_n_model = int(budget_bytes / (per_row * held_fraction))
            router = _spawn_partition_router(
                p_count, replication, spec, k, backend=backend,
                platform=platform,
            )
            try:
                _run_router_clients(router, uniform[:4, :8].tolist(), k)
                h0 = _partition_compiles(router)
                res = _run_router_clients(router, uniform.tolist(), k)
                res["steady_state_compiles"] = sum(
                    _partition_compiles(router).values()
                ) - sum(h0.values())
                res["oracle_checked"] = _partition_oracle_check(
                    router, oracle, rng, n, k, samples=12
                )
                res["resident"] = {
                    "rows_held_per_worker": rows_held,
                    "factor_bytes": factor_bytes,
                    "sliced_block_bytes": block_bytes,
                    "bytes_per_held_row": round(per_row, 1),
                    "worker_vm_rss_kb": _worker_rss_kb(router),
                }
                res["max_n_at_budget"] = max_n_model
                if p_count == max(partitions):
                    res["routed_deltas"] = _partition_delta_phase(
                        router, oracle, rng, n_papers, deltas, k
                    )
                out["partitions"][str(p_count)] = res
            finally:
                router.close()
        # partition-aware trace stitching: its own
        # traced fleet so the QPS arms above stay untraced
        out["trace_stitching"] = _partition_trace_phase(
            spec, max(max(partitions), 2), replication, k, rng, n,
            backend=backend, platform=platform,
        )
        # replica-mode baseline at equal N: the per-query overhead of
        # the tile exchange is partition p50 vs this p50
        rep_router = _spawn_router(2, spec, backend, 8, 1.0, k,
                                   hedge_ms=300.0, platform=platform)
        try:
            _run_router_clients(rep_router, uniform[:4, :8].tolist(), k)
            out["replica_baseline"] = _run_router_clients(
                rep_router, uniform.tolist(), k
            )
        finally:
            rep_router.close()
        part_ref = out["partitions"][str(max(partitions))]
        if out["replica_baseline"]["p50_ms"] > 0:
            out["tile_exchange_overhead_p50"] = round(
                part_ref["p50_ms"] / out["replica_baseline"]["p50_ms"], 2
            )
        if kill_phase:
            # the delta phase mutated the oracle graph: re-anchor the
            # kill fleet on a FRESH oracle over the same spec
            oracle.close()
            hin2 = synthetic_hin(n_authors, n_papers, n_venues,
                                 seed=seed)
            oracle = PathSimService(
                _create_backend("numpy", hin2, mp, platform),
                config=ServeConfig(max_wait_ms=0.5, warm=False),
            )
            out["failover"] = _partition_kill_phase(
                spec, max(max(partitions), 2), replication, k, uniform,
                oracle, rng, n, backend=backend, platform=platform,
            )
    finally:
        oracle.close()
    return out


def partition_checks(result: dict) -> dict:
    """The partition regime's seven gates (see
    :func:`run_partition_smoke`), none of them the clock's."""
    parts = result["partitions"]
    fo = result["failover"]
    return {
        "zero_lost_requests": all(
            r["lost"] == 0 for r in parts.values()
        ) and fo["lost"] == 0,
        "zero_steady_state_recompiles": all(
            r["steady_state_compiles"] == 0 for r in parts.values()
        ) and fo["survivor_compiles"] == 0,
        "oracle_bit_identical": all(
            r["oracle_checked"]["mismatches"] == 0
            and r["oracle_checked"]["scores_row_exact"]
            for r in parts.values()
        ) and fo["post_kill_oracle"]["mismatches"] == 0,
        "routed_delta_exact": (
            parts["3"]["routed_deltas"]["post_delta_oracle"]["mismatches"]
            == 0
        ),
        "kill_detected": "detect_ms" in fo,
        "max_n_grows_with_workers": (
            parts["3"]["max_n_at_budget"] > parts["1"]["max_n_at_budget"]
        ),
        # partition-aware trace stitching: one
        # Perfetto tree per scatter, sub-requests included
        "trace_stitched_zero_broken": (
            result["trace_stitching"]["broken_parent_links"] == 0
            and result["trace_stitching"]["stitched_cross_process"] >= 1
        ),
    }


def run_partition_smoke(out_path: str | None = None, backend: str = "torch",
                        platform: str = "cuda") -> dict:
    """The tier-1 partition gate: 3 real
    partition-worker subprocesses (chained replication 2) over a small
    graph. Hard gates: answers bit-identical to the single-host oracle
    (top-k ids + f64 scores + a full scores row), routed deltas stay
    oracle-exact, one mid-load SIGKILL loses ZERO requests and the
    survivors add ZERO steady-state compiles, and the measured
    per-worker slice shrinks as the partition count grows (the max-N
    model the curve exists for)."""
    result = run_partition_bench(**PARTITION_SMOKE, backend=backend,
                                 platform=platform)
    result["smoke_checks"] = checks = partition_checks(result)
    _write(result, out_path)
    _require(checks, "partition")
    return result


# ---------------------------------------------------------------------------
# ANN serving (--regime ann): the exact lane against the ANN lane


def _ann_recall_audit(ann_svc, exact_svc, rows, k: int,
                      mode: str = "ann") -> dict:
    """Measured recall@k + bit-parity of the ANN (or learned) path vs
    the exact oracle over ``rows``. Two recall readings:

    - ``recall_at_k`` (the gate) is SCORE recall: a returned item
      whose exact f64 score ≥ the oracle's k-th score is a hit. On
      integer-count graphs the k boundary routinely sits inside a
      large exactly-tied set, and id-recall would punish returning a
      tie member the oracle only rejects by its arbitrary
      ascending-column convention; ann scores are exact, so the score
      comparison is bit-meaningful.
    - ``id_recall_at_k`` (reported) is the strict index-set overlap.

    ``bit_identical`` additionally requires identical f64 values AND
    tie order — the acceptance contract whenever the true top-k is
    inside the candidate set."""
    recalls, id_recalls = [], []
    bit_identical = 0
    for row in rows:
        av, ai = ann_svc.topk_index(int(row), k=k, mode=mode)
        ev, ei = exact_svc.topk_index(int(row), k=k, mode="exact")
        want = [int(i) for i, v in zip(ei, ev) if np.isfinite(v)]
        got = {int(i) for i, v in zip(ai, av) if np.isfinite(v)}
        if want:
            id_recalls.append(
                sum(1 for i in want if i in got) / len(want)
            )
            kth = min(v for v in ev if np.isfinite(v))
            got_v = av[np.isfinite(av)]
            recalls.append(
                min(float((got_v >= kth).sum()) / len(want), 1.0)
            )
        if np.array_equal(ai, ei) and np.array_equal(av, ev):
            bit_identical += 1
    return {
        "samples": len(rows),
        "recall_at_k": round(float(np.mean(recalls)), 6),
        "min_recall": round(float(np.min(recalls)), 6),
        "id_recall_at_k": round(float(np.mean(id_recalls)), 6),
        "bit_identical": bit_identical,
        "bit_identical_frac": round(bit_identical / max(len(rows), 1), 6),
    }


def _arm_summary(runs: dict) -> dict:
    """Per arm of an interleaved run: median and best QPS, median p50
    and p99, the sheds summed, and the runs themselves."""
    from .utils import benchrunner as br

    return {
        name: {
            "qps_median": br.median([r["qps"] for r in rs]),
            "qps_best": max(r["qps"] for r in rs),
            "p50_ms_median": br.median([r["p50_ms"] for r in rs]),
            "p99_ms_median": br.median([r["p99_ms"] for r in rs]),
            "shed": sum(r["shed"] for r in rs),
            "runs": rs,
        }
        for name, rs in runs.items()
    }


def run_ann_bench(
    n_authors: int = 32768,
    n_papers: int = 65536,
    n_venues: int = 64,
    clients: int = 16,
    queries_per_client: int = 64,
    max_batch: int = 32,
    max_wait_ms: float = 1.0,
    reps: int = 3,
    k: int = 10,
    backend: str = "torch",
    platform: str = "cuda",
    seed: int = 0,
    oracle_samples: int = 128,
    exercise_staleness: bool = True,
) -> dict:
    """Closed-loop exact-vs-ann arms on one graph:

    - **exact** — the pre-index path: every query scores a full O(N)
      row (caches off, so the arm measures the dispatch path, not the
      working set);
    - **ann** — candidate generation (the index probe on the backend's
      device) + exact f64 rerank of C = cand_mult·k candidates;
    - **mixed** — alternating exact/ann per query on the ann service
      (both lanes through one coalescer, the production posture).

    Arms are interleaved per round on the shared estimator
    (utils/benchrunner.py) so machine drift taxes them equally. The
    result also records measured recall@k + bit-parity vs the exact
    oracle, steady-state compile counts (kernel builds and CUDA-graph
    captures; must be 0 — the probe is warmed per bucket exactly like
    the exact path), and a staleness/fallback exercise (delta → stale
    row answers exactly → refresh → ann again)."""
    from .data.synthetic import synthetic_hin
    from .utils import benchrunner as br
    from .utils.compile_counter import CompileCounter

    hin = synthetic_hin(n_authors, n_papers, n_venues, seed=seed)
    rng = np.random.default_rng(seed)
    n = hin.type_size("author")

    exact_svc = _build_service(hin, backend, max_batch=max_batch,
                               max_wait_ms=max_wait_ms, caches=False, k=k,
                               platform=platform)
    ann_svc = _build_service(hin, backend, max_batch=max_batch,
                             max_wait_ms=max_wait_ms, caches=False, k=k,
                             platform=platform, topk_mode="ann",
                             ann_shadow_every=0)
    ann_snapshot = ann_svc.stats()["ann"]
    # Query population: degree>0 authors. The synthetic Zipf tail
    # leaves a large fraction of authors with no papers at all; those
    # rows answer through the exact path BY DESIGN (the 'degenerate'
    # fallback — their whole score row is zero), so leaving them in
    # the schedule would silently turn the ann arm into a mixed arm.
    # The fallback machinery is exercised explicitly below instead.
    eligible = np.flatnonzero(ann_svc._d > 0)
    try:
        def one_round(svc, mode, cl):
            sched = rng.choice(
                eligible, size=(cl, queries_per_client)
            )
            return _run_clients(svc, sched.tolist(), k, mode=mode)

        # Concurrency sweep per arm: "≥ X× QPS at equal p99" is a
        # load-curve comparison — each arm runs at several closed-loop
        # client counts, and the headline compares the best QPS each
        # path reaches without exceeding the other's p99 SLO.
        sweep = tuple(
            sorted({
                c for c in (clients, 2 * clients, 4 * clients,
                            8 * clients, 16 * clients, 32 * clients)
                if 1 <= c <= max(64, clients)
            })
        )
        arms_fns = {}
        for cl in sweep:
            arms_fns[f"exact_c{cl}"] = (
                lambda cl=cl: one_round(exact_svc, "exact", cl)
            )
            arms_fns[f"ann_c{cl}"] = (
                lambda cl=cl: one_round(ann_svc, "ann", cl)
            )
        arms_fns[f"mixed_c{clients}"] = (
            lambda: one_round(ann_svc, "mixed", clients)
        )
        # warm every arm once (kernel builds, allocator), then measure
        # with the compile ledger open: steady state must add nothing
        for fn in arms_fns.values():
            fn()
        with CompileCounter() as cc:
            runs = br.interleave(arms_fns, reps)
        compiles = cc.count

        arms_out = _arm_summary(runs)
        sample_rows = rng.choice(
            eligible, size=min(oracle_samples, eligible.size),
            replace=False,
        )
        recall = _ann_recall_audit(ann_svc, exact_svc, sample_rows, k)
        fallbacks = None
        if exercise_staleness:
            fallbacks = _ann_staleness_exercise(hin, backend, k,
                                                max_wait_ms, seed,
                                                platform=platform)
        out = {
            "graph": {"authors": n, "papers": n_papers,
                      "venues": n_venues, "seed": seed},
            "load": {"clients": clients,
                     "queries_per_client": queries_per_client,
                     "k": k, "max_batch": max_batch,
                     "max_wait_ms": max_wait_ms, "reps": reps,
                     "eligible_rows": int(eligible.size),
                     "row_population": "degree>0 authors (zero-degree "
                     "rows answer exactly by design — the 'degenerate' "
                     "fallback — and are exercised separately)"},
            "backend": backend,
            "index": ann_snapshot,
            "arms": arms_out,
            "speedups": _ann_speedups(arms_out, clients, sweep),
            "recall": recall,
            "steady_state_compiles": compiles,
            "ann_service_stats": ann_svc.stats()["ann"],
            "estimator_note": (
                "arms interleaved per round (utils/benchrunner.py); "
                "medians + best-window recorded. Recall/bit-parity and "
                "compile counts are deterministic gates; QPS is the "
                "machine-dependent claim. The index probe runs on the "
                "backend's device and the rerank is host f64, so at "
                "high batch occupancy the exact arm's one batched "
                "scoring call per coalesced batch compresses the ann "
                "speedup (the per-concurrency curves show it)."
            ),
        }
        if fallbacks is not None:
            out["staleness_exercise"] = fallbacks
        return out
    finally:
        exact_svc.close()
        ann_svc.close()


def _ann_speedups(arms_out: dict, base_clients: int, sweep) -> dict:
    """The headline comparisons from the concurrency sweep:

    - ``ann_vs_exact_qps_same_concurrency``: both arms at the base
      client count (the naive comparison);
    - ``ann_vs_exact_qps_at_equal_p99``: exact's best-QPS sweep point
      sets the p99 SLO; ann's best QPS among sweep points meeting that
      SLO is the numerator — the load-curve comparison "X× the QPS at
      equal p99" actually means."""
    exact_pts = {
        name: a for name, a in arms_out.items()
        if name.startswith("exact_c")
    }
    ann_pts = {
        name: a for name, a in arms_out.items()
        if name.startswith("ann_c")
    }
    out: dict = {}
    base_e = exact_pts.get(f"exact_c{base_clients}")
    base_a = ann_pts.get(f"ann_c{base_clients}")
    if base_e and base_a:
        out["ann_vs_exact_qps_same_concurrency"] = round(
            base_a["qps_median"] / base_e["qps_median"], 2
        )
    best_e = max(exact_pts.values(), key=lambda a: a["qps_median"])
    slo = best_e["p99_ms_median"]
    within = [
        (name, a) for name, a in ann_pts.items()
        if a["p99_ms_median"] <= slo
    ]
    if within:
        name, best_a = max(within, key=lambda kv: kv[1]["qps_median"])
        out["ann_vs_exact_qps_at_equal_p99"] = round(
            best_a["qps_median"] / best_e["qps_median"], 2
        )
        out["equal_p99_detail"] = {
            "exact_best_qps": best_e["qps_median"],
            "exact_p99_ms_slo": slo,
            "ann_point": name,
            "ann_qps": best_a["qps_median"],
            "ann_p99_ms": best_a["p99_ms_median"],
        }
    return out


def _ann_staleness_exercise(hin, backend, k, max_wait_ms, seed,
                            platform: str = "cuda") -> dict:
    """The fallback path, exercised for real on a fresh warm service:
    apply a delta (auto-refresh off) → the affected row must answer
    through the exact path (counted fallback) and match the live
    oracle bit-for-bit → refresh_index → the row answers via ann
    again. Returns the ledger the smoke gates check."""
    from .data import delta as dl

    hin2 = dl.with_headroom(hin, 0.25)
    svc = _build_service(hin2, backend, max_batch=8,
                         max_wait_ms=max_wait_ms, caches=False, k=k,
                         platform=platform, topk_mode="ann",
                         ann_shadow_every=0, ann_auto_refresh=False)
    try:
        ap = svc.hin.blocks["author_of"]
        rng = np.random.default_rng(seed)
        i = int(rng.integers(0, ap.nnz))
        row = int(ap.rows[i])
        delta = dl.DeltaBatch(edges=(dl.edge_delta(
            "author_of", add=(),
            remove=[(row, int(ap.cols[i]))],
        ),))
        info = svc.update(delta)
        av, ai = svc.topk_index(row, k=k, mode="ann")   # stale → exact
        ev, ei = svc.topk_index(row, k=k, mode="exact")
        stale_exact = bool(
            np.array_equal(ai, ei) and np.array_equal(av, ev)
        )
        fb = svc.stats()["ann"]
        refresh = svc.refresh_index()
        av2, ai2 = svc.topk_index(row, k=k, mode="ann")
        return {
            "update_mode": info["mode"],
            "stale_rows_after_update": info.get("ann_stale_rows"),
            "stale_row_answered_exactly": stale_exact,
            "stale_rows_after_refresh": refresh["stale_remaining"],
            "post_refresh_ann_matches": bool(np.array_equal(ai2, ei)),
            "ann_state": fb,
        }
    finally:
        svc.close()


def ann_checks(result: dict) -> dict:
    """The ann regime's five gates (see :func:`run_ann_smoke`), none of
    them the clock's."""
    st = result["staleness_exercise"]
    return {
        "recall_ge_0_99": result["recall"]["recall_at_k"] >= 0.99,
        "zero_steady_state_compiles": (
            result["steady_state_compiles"] == 0
        ),
        "stale_row_answered_exactly": (
            st["update_mode"] == "delta"
            and st["stale_rows_after_update"] > 0
            and st["stale_row_answered_exactly"]
        ),
        "refresh_restores_ann": (
            st["stale_rows_after_refresh"] == 0
            and st["post_refresh_ann_matches"]
        ),
        "zero_shed": all(
            a["shed"] == 0 for a in result["arms"].values()
        ),
    }


def run_ann_smoke(out_path: str | None = None, backend: str = "torch",
                  platform: str = "cuda") -> dict:
    """The ANN gate: build a small index, serve a mixed exact/ann
    closed-loop load, and hard-gate what is deterministic on shared
    hardware — recall@10 ≥ 0.99 at the shipped default knobs, ZERO
    steady-state recompiles (probe buckets are pre-warmed like the
    exact buckets), the delta-staleness fallback exercised for real
    (stale row answered exactly, never from the stale index; refresh
    restores ann), and zero shed. QPS claims belong to full-size runs:
    tiny graphs measure Python overhead, not the O(N) vs O(C)
    asymptotic."""
    result = run_ann_bench(**ANN_SMOKE, backend=backend, platform=platform)
    result["smoke_checks"] = checks = ann_checks(result)
    _write(result, out_path)
    _require(checks, "ann")
    return result


# ---------------------------------------------------------------------------
# Learned serving (--regime learned): two-tower candidate generation with
# exact-f64 rerank, vs the exact and ann arms, plus the cold-start exercise


def _learned_cold_start_exercise(hin, backend, k, max_wait_ms, seed,
                                 learned_steps,
                                 learned_cand_mult=None,
                                 platform: str = "cuda") -> dict:
    """The cold-start path, exercised for real: append a NEVER-SEEN
    author (new row + edges in one delta, auto-refresh off) → the row
    answers immediately in learned mode through the counted 'stale'
    fallback, bit-identical to the exact oracle → ``refresh_towers``
    re-embeds O(Δ) rows through the inductive encoder (no retrain, no
    full re-embed) → the row answers through the learned arm proper,
    still bit-identical. The timings are the cold-start-latency arm:
    first answer after the delta, the absorb itself, and the first
    post-absorb learned answer."""
    from .data import delta as dl

    hin2 = dl.with_headroom(hin, 0.25)
    svc = _build_service(hin2, backend, max_batch=8,
                         max_wait_ms=max_wait_ms, caches=False, k=k,
                         platform=platform, topk_mode="learned",
                         learned_shadow_every=0,
                         learned_auto_refresh=False,
                         learned_steps=learned_steps,
                         learned_cand_mult=learned_cand_mult)
    try:
        n0 = svc.n  # the appended author's row index
        rng = np.random.default_rng(seed)
        papers = sorted({
            int(p) for p in
            rng.integers(0, hin.type_size("paper"), size=6)
        })
        info = svc.update(dl.DeltaBatch(
            nodes=(dl.NodeAppend(node_type="author", count=1),),
            edges=(dl.edge_delta(
                "author_of", add=[[n0, p] for p in papers]
            ),),
        ))
        pre_reason = svc.learned_fallback_reason(n0, "learned")
        t0 = time.perf_counter()
        lv, li = svc.topk_index(n0, k=k, mode="learned")
        cold_ms = (time.perf_counter() - t0) * 1e3
        ev, ei = svc.topk_index(n0, k=k, mode="exact")
        pre_identical = bool(
            np.array_equal(li, ei) and np.array_equal(lv, ev)
        )
        snap_pre = svc.stats()["learned"]
        t0 = time.perf_counter()
        refresh = svc.refresh_towers()
        refresh_ms = (time.perf_counter() - t0) * 1e3
        post_reason = svc.learned_fallback_reason(n0, "learned")
        t0 = time.perf_counter()
        lv2, li2 = svc.topk_index(n0, k=k, mode="learned")
        post_ms = (time.perf_counter() - t0) * 1e3
        post_identical = bool(
            np.array_equal(li2, ei) and np.array_equal(lv2, ev)
        )
        snap_post = svc.stats()["learned"]
        return {
            "update_mode": info["mode"],
            "stale_rows_after_update": info.get("learned_stale_rows"),
            "pending_appends_after_update": info.get(
                "learned_pending_appends"
            ),
            "pre_refresh_fallback_reason": pre_reason,
            "pre_refresh_answer_bit_identical": pre_identical,
            "cold_first_answer_ms": round(cold_ms, 3),
            "cold_start_ratio_before_refresh": snap_pre[
                "cold_start_ratio"
            ],
            "refresh": refresh,
            "refresh_ms": round(refresh_ms, 3),
            "post_refresh_fallback_reason": post_reason,
            "post_refresh_answer_bit_identical": post_identical,
            "post_refresh_answer_ms": round(post_ms, 3),
            "cold_start_ratio_after_refresh": snap_post[
                "cold_start_ratio"
            ],
        }
    finally:
        svc.close()


def run_learned_bench(
    n_authors: int = 2048,
    n_papers: int = 4096,
    n_venues: int = 48,
    clients: int = 8,
    queries_per_client: int = 32,
    max_batch: int = 16,
    max_wait_ms: float = 1.0,
    reps: int = 3,
    k: int = 10,
    backend: str = "torch",
    platform: str = "cuda",
    seed: int = 0,
    oracle_samples: int = 128,
    learned_steps: int = 3000,
    learned_cand_mult: int = 32,
) -> dict:
    """Closed-loop exact-vs-ann-vs-learned arms on one graph: the
    learned arm distills two towers from the exact engine at startup
    (the port's trainer, on the backend's device), probes them for
    C = cand_mult·k candidates, and exact-f64 reranks through the same
    ``score_candidates`` doorway as ann — so its scores are exact by
    construction, and recall is a question of candidate coverage only.
    The full-size defaults train longer and shortlist wider than the
    service's startup defaults (3000 steps / cand_mult 32 vs 200 / 16 —
    distillation budget scales with corpus).
    The result records QPS/latency per arm at two concurrency
    points, measured score-recall + bit-parity vs the exact oracle for
    BOTH approximate arms, steady-state compile counts (kernel builds
    and CUDA-graph captures; must be 0), and the cold-start exercise
    (never-seen appended author: answered through the counted fallback
    immediately, through the towers after one O(Δ) absorb)."""
    from .data.synthetic import synthetic_hin
    from .utils import benchrunner as br
    from .utils.compile_counter import CompileCounter

    hin = synthetic_hin(n_authors, n_papers, n_venues, seed=seed)
    rng = np.random.default_rng(seed)
    n = hin.type_size("author")

    exact_svc = _build_service(hin, backend, max_batch=max_batch,
                               max_wait_ms=max_wait_ms, caches=False,
                               k=k, platform=platform)
    ann_svc = _build_service(hin, backend, max_batch=max_batch,
                             max_wait_ms=max_wait_ms, caches=False,
                             k=k, platform=platform, topk_mode="ann",
                             ann_shadow_every=0)
    t0 = time.perf_counter()
    lrn_svc = _build_service(hin, backend, max_batch=max_batch,
                             max_wait_ms=max_wait_ms, caches=False,
                             k=k, platform=platform, topk_mode="learned",
                             learned_shadow_every=0,
                             learned_steps=learned_steps,
                             learned_cand_mult=learned_cand_mult)
    train_s = time.perf_counter() - t0
    lrn_snapshot = lrn_svc.stats()["learned"]
    if lrn_snapshot is None:
        for svc in (exact_svc, ann_svc, lrn_svc):
            svc.close()
        raise RuntimeError(
            "learned tier failed to come up — see the "
            "learned_unavailable runtime event"
        )
    try:
        # degree>0 rows, same population rationale as run_ann_bench:
        # zero-denominator rows answer exactly BY DESIGN (the
        # 'degenerate' fallback) and are exercised in the tests
        d = np.asarray(lrn_svc._learned.d)[:n]
        eligible = np.flatnonzero(d > 0)

        def one_round(svc, mode, cl):
            sched = rng.choice(
                eligible, size=(cl, queries_per_client)
            )
            return _run_clients(svc, sched.tolist(), k, mode=mode)

        arms_fns = {}
        for cl in (clients, 4 * clients):
            arms_fns[f"exact_c{cl}"] = (
                lambda cl=cl: one_round(exact_svc, "exact", cl)
            )
            arms_fns[f"ann_c{cl}"] = (
                lambda cl=cl: one_round(ann_svc, "ann", cl)
            )
            arms_fns[f"learned_c{cl}"] = (
                lambda cl=cl: one_round(lrn_svc, "learned", cl)
            )
        # warm every arm once (kernel builds, allocator), then measure
        # with the compile ledger open: steady state must add nothing
        for fn in arms_fns.values():
            fn()
        with CompileCounter() as cc:
            runs = br.interleave(arms_fns, reps)
        compiles = cc.count

        arms_out = _arm_summary(runs)
        sample_rows = rng.choice(
            eligible, size=min(oracle_samples, eligible.size),
            replace=False,
        )
        recall = _ann_recall_audit(lrn_svc, exact_svc, sample_rows, k,
                                   mode="learned")
        ann_recall = _ann_recall_audit(ann_svc, exact_svc, sample_rows,
                                       k, mode="ann")
        cold = _learned_cold_start_exercise(hin, backend, k,
                                            max_wait_ms, seed,
                                            learned_steps,
                                            learned_cand_mult,
                                            platform=platform)
        return {
            "graph": {"authors": n, "papers": n_papers,
                      "venues": n_venues, "seed": seed},
            "load": {"clients": clients,
                     "queries_per_client": queries_per_client,
                     "k": k, "max_batch": max_batch,
                     "max_wait_ms": max_wait_ms, "reps": reps,
                     "eligible_rows": int(eligible.size)},
            "backend": backend,
            "learned_state": lrn_snapshot,
            "train_startup_s": round(train_s, 3),
            "arms": arms_out,
            "recall": recall,
            "ann_recall": ann_recall,
            "steady_state_compiles": compiles,
            "cold_start": cold,
            "estimator_note": (
                "arms interleaved per round (utils/benchrunner.py). "
                "Recall/bit-parity, compile counts, and the cold-start "
                "exercise are deterministic gates; QPS is the "
                "machine-dependent claim. The learned probe is one "
                "true-f32 tower product on the backend's device — its "
                "win over exact is O(C) rerank vs O(N) scan, and over "
                "ann it trades index rebuild cost for O(Δ) inductive "
                "absorbs on delta landings."
            ),
        }
    finally:
        exact_svc.close()
        ann_svc.close()
        lrn_svc.close()


def learned_checks(result: dict) -> dict:
    """The learned regime's five gates (see :func:`run_learned_smoke`),
    none of them the clock's; ``recall_ge_0_99`` is computed as the
    repository harness computes it (see :data:`CARD_EXEMPT_CHECKS`)."""
    cs = result["cold_start"]
    return {
        "recall_ge_0_99": result["recall"]["recall_at_k"] >= 0.99,
        "zero_steady_state_compiles": (
            result["steady_state_compiles"] == 0
        ),
        "cold_start_answered_before_refresh": (
            cs["update_mode"] == "delta"
            and cs["pending_appends_after_update"] == 1
            and cs["pre_refresh_fallback_reason"] == "stale"
            and cs["pre_refresh_answer_bit_identical"]
        ),
        "refresh_restores_learned": (
            cs["refresh"]["appended"] == 1
            and cs["refresh"]["pending_appends"] == 0
            and cs["post_refresh_fallback_reason"] is None
            and cs["post_refresh_answer_bit_identical"]
            and cs["cold_start_ratio_after_refresh"] == 1.0
        ),
        "zero_shed": all(
            a["shed"] == 0 for a in result["arms"].values()
        ),
    }


def run_learned_smoke(out_path: str | None = None, backend: str = "torch",
                      platform: str = "cuda") -> dict:
    """The learned gate: distill a tiny tower in-process on a synthetic
    graph, serve all three arms, and hard-gate what is deterministic on
    shared hardware — score recall@10 ≥ 0.99 at the shipped default
    knobs (exact rerank makes every returned score exact; only coverage
    can lose), ZERO steady-state recompiles, the cold-start exercise
    for real (a never-seen appended author answers bit-identically
    through the counted 'stale' fallback BEFORE any refresh, and
    through the learned arm after one O(Δ) absorb), and zero shed."""
    result = run_learned_bench(**LEARNED_SMOKE, backend=backend,
                               platform=platform)
    result["smoke_checks"] = checks = learned_checks(result)
    _write(result, out_path)
    _require(checks, "learned")
    return result


# ---------------------------------------------------------------------------
# Firehose regime (--regime firehose): sustained deltas concurrent with
# closed-loop serving load, background compaction hot-swaps, coalesced
# fleet updates, and the autoscale load step
# ---------------------------------------------------------------------------


class _DeltaStream:
    """Deterministic firehose source: tracks its own view of the edge
    set (seeded from the initial graph), so generated batches are
    always valid against the service's current graph no matter how the
    service mutates underneath — the generator is the only updater."""

    def __init__(self, hin, seed: int = 0, adds_per_delta: int = 2,
                 remove_every: int = 3, append_every: int = 4):
        from .data import delta as dl

        self._dl = dl
        self.rng = np.random.default_rng(seed)
        ap = hin.blocks["author_of"]
        self.n_authors = hin.type_size("author")
        self.n_papers = hin.type_size("paper")
        self.materialized = hin.indices["author"].size_override is None
        self.existing = set(zip(ap.rows.tolist(), ap.cols.tolist()))
        self.our_adds: list[tuple[int, int]] = []
        self.adds_per_delta = adds_per_delta
        self.remove_every = remove_every
        self.append_every = append_every
        self.seq = 0

    def next(self):
        dl = self._dl
        self.seq += 1
        adds = []
        while len(adds) < self.adds_per_delta:
            e = (int(self.rng.integers(0, self.n_authors)),
                 int(self.rng.integers(0, self.n_papers)))
            if e not in self.existing:
                self.existing.add(e)
                adds.append(e)
        removes = []
        if self.remove_every and self.seq % self.remove_every == 0 and (
            self.our_adds
        ):
            # remove only edges WE added (never racing the base graph)
            e = self.our_adds.pop(
                int(self.rng.integers(0, len(self.our_adds)))
            )
            self.existing.discard(e)
            removes.append(e)
        nodes = ()
        if self.append_every and self.seq % self.append_every == 0:
            if self.materialized:
                nodes = (dl.NodeAppend(
                    node_type="author",
                    ids=(f"fh_author_{self.n_authors}",),
                ),)
            else:
                nodes = (dl.NodeAppend(node_type="author", count=1),)
            # wire the appended author in so it has a score row (and
            # RECORD the edge — a later random add may land on this
            # row once n_authors includes it)
            wire = (self.n_authors,
                    int(self.rng.integers(0, self.n_papers)))
            self.existing.add(wire)
            adds.append(wire)
            self.n_authors += 1
        self.our_adds.extend(adds)
        return dl.DeltaBatch(
            edges=(dl.edge_delta("author_of", add=adds, remove=removes),),
            nodes=nodes,
        )


def _firehose_single_phase(
    n_authors: int, n_papers: int, n_venues: int, deltas: int,
    clients: int, backend: str, k: int, chain_len: int,
    headroom: float = 0.25, update_sleep_ms: float = 0.0, seed: int = 0,
    platform: str = "cuda",
) -> tuple[dict, object]:
    """ONE warm service under a sustained delta stream concurrent with
    closed-loop query load. Returns (measurements, service) — the
    caller owns the service (steady-state compaction probe + close).

    Measured: sustained updates/sec and query QPS over the same wall
    window, update-visible latency (update submitted → fresh answer
    for an affected row returned; the cache purge makes the re-score
    real), compaction count/pause/build/compile accounting, and the
    whole-window compile ledger split into compaction-attributed vs
    everything else (the steady-state gate)."""
    from .data import delta as dl
    from .obs.metrics import get_registry
    from .ops.metapath import compile_metapath
    from .serving import LoadShedError, PathSimService, ServeConfig
    from .utils.compile_counter import CompileCounter

    hin = dl.with_headroom(
        synthetic_hin_cached(n_authors, n_papers, n_venues, seed=seed),
        headroom,
    )
    mp = compile_metapath("APVPA", hin.schema)
    svc = PathSimService(
        _create_backend(backend, hin, mp, platform),
        config=ServeConfig(
            max_batch=16, max_wait_ms=0.5, queue_depth=4096,
            k_default=k, compact_auto=True,
            compact_chain_len=chain_len, compact_cooldown_s=0.5,
        ),
    )
    stream = _DeltaStream(hin, seed=seed)
    rng = np.random.default_rng(seed + 1)
    qrows = rng.integers(0, n_authors, size=4096)
    stop = threading.Event()
    visible_lat: list[float] = []
    q_lats: list[list[float]] = [[] for _ in range(clients)]
    shed = [0]

    updater_err: list = []

    def updater():
        try:
            for _ in range(deltas):
                delta = stream.next()
                probe = int(delta.edges[0].add[0][0])
                t0 = time.perf_counter()
                svc.update(delta)
                svc.topk_index(min(probe, svc.n - 1), k=k)
                visible_lat.append(time.perf_counter() - t0)
                if update_sleep_ms:
                    time.sleep(update_sleep_ms / 1e3)
        except BaseException as exc:  # surfaced below — never silent
            updater_err.append(exc)
        finally:
            stop.set()

    def client(ci: int):
        j = ci
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                svc.topk_index(int(qrows[j % qrows.shape[0]]), k=k)
            except LoadShedError:
                shed[0] += 1
                j += clients
                continue
            q_lats[ci].append(time.perf_counter() - t0)
            j += clients

    # warm one query + one update so the timed window is steady state
    svc.topk_index(0, k=k)
    svc.update(stream.next())
    reg = get_registry()
    compiles_cell = reg.counter(
        "dpathsim_compaction_compiles_total",
        "run-time compiles attributed to compaction builds",
    ).labels()
    pause_cell = reg.histogram(
        "dpathsim_compaction_pause_seconds",
        "swap-lock hold (drain + delta replay + install) per swap",
    ).labels()
    compaction_compiles0 = compiles_cell.value
    threads = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(clients)]
    t0 = time.perf_counter()
    with CompileCounter() as cc:
        ut = threading.Thread(target=updater, daemon=True)
        ut.start()
        for t in threads:
            t.start()
        ut.join()
        for t in threads:
            t.join()
        # fold any still-running background build into the ledger
        svc._compactor._done.wait(120.0)
    wall = time.perf_counter() - t0
    if updater_err:
        svc.close()
        raise AssertionError(
            f"firehose updater failed after {len(visible_lat)} deltas"
        ) from updater_err[0]
    compaction_compiles = compiles_cell.value - compaction_compiles0
    flat = [x for sub in q_lats for x in sub]
    comp = svc.stats()["compaction"]
    out = {
        "deltas": len(visible_lat),
        "clients": clients,
        "wall_s": round(wall, 3),
        "updates_per_s": round(len(visible_lat) / wall, 2),
        "qps": round(len(flat) / wall, 2) if wall > 0 else 0.0,
        "queries": len(flat),
        "shed": shed[0],
        "update_visible": _percentiles(visible_lat),
        "query": _percentiles(flat) if flat else {},
        "compaction": {
            "count": comp["compactions"],
            "abandoned": comp["abandoned"],
            "failures": comp["failures"],
            "last": comp["last"],
            "pause_p99_ms": round(pause_cell.quantile(0.99) * 1e3, 3)
            if pause_cell.count else None,
            "compiles": compaction_compiles,
        },
        "compiles_total": cc.count,
        "compiles_outside_compaction": cc.count - compaction_compiles,
        "inline_rebuilds": svc.stats()["delta"]["rebuilds"],
    }
    return out, svc


@functools.lru_cache(maxsize=8)
def synthetic_hin_cached(n_authors, n_papers, n_venues, seed=0):
    """The firehose arms re-encode the same base graph repeatedly;
    memoize the synthesis (each caller re-pads its own copy)."""
    from .data.synthetic import synthetic_hin

    return synthetic_hin(n_authors, n_papers, n_venues, seed=seed,
                         materialize_ids=True)


def _firehose_fleet_phase(n_authors: int, n_papers: int, n_venues: int,
                          updates: int, k: int, seed: int = 0,
                          backend: str = "torch",
                          platform: str = "cuda") -> dict:
    """Coalesced fleet updates: an in-proc 2-replica router with the
    bounded update queue, a burst of K concurrent updates plus
    closed-loop queries. Gates: broadcasts < K (coalescing really
    folded), zero lost queries, both replicas at the SAME consistency
    token afterwards, answers bit-identical to a numpy oracle absorbing
    the identical update stream sequentially."""
    from .data import delta as dl
    from .ops.metapath import compile_metapath
    from .router import InprocTransport, Router, RouterConfig, WorkerRuntime
    from .serving import PathSimService, ServeConfig

    mp = None

    def make_service(name):
        nonlocal mp
        hin = dl.with_headroom(
            synthetic_hin_cached(n_authors, n_papers, n_venues,
                                 seed=seed),
            0.25,
        )
        if mp is None:
            mp = compile_metapath("APVPA", hin.schema)
        return PathSimService(
            _create_backend(name, hin, mp, platform),
            config=ServeConfig(max_batch=8, max_wait_ms=0.5,
                               warm=False),
        )

    transports = {
        wid: InprocTransport(
            wid, WorkerRuntime(make_service(backend), worker_id=wid)
        )
        for wid in ("w0", "w1")
    }
    router = Router(transports, RouterConfig(
        heartbeat_interval_s=0.1, heartbeat_miss_limit=50,
        hedge_ms=None, max_inflight=8192, scrape_interval_s=0,
        update_queue=max(updates, 16), update_coalesce=8,
        update_flush_ms=5.0,
    ))
    router.start()
    oracle = make_service("numpy")
    try:
        hin0 = oracle.hin
        stream = _DeltaStream(hin0, seed=seed + 7, append_every=0)
        reqs = []
        for i in range(updates):
            batch = stream.next()
            e = batch.edges[0]
            reqs.append({
                "op": "update", "id": f"fh{i}",
                "add_edges": [
                    {"rel": "author_of", "src_row": int(r),
                     "dst_row": int(c)} for r, c in e.add
                ],
                "remove_edges": [
                    {"rel": "author_of", "src_row": int(r),
                     "dst_row": int(c)} for r, c in e.remove
                ],
            })
        rng = np.random.default_rng(seed)
        uniform = rng.integers(0, n_authors, size=(4, 24))
        t0 = time.perf_counter()
        futs = [router.submit(dict(r)) for r in reqs]
        qres = _run_router_clients(router, uniform.tolist(), k)
        results = [f.result(timeout=120) for f in futs]
        wall = time.perf_counter() - t0
        for r in reqs:
            oracle.update(dl.delta_from_records(
                oracle.hin, add_edges=r["add_edges"],
                remove_edges=r["remove_edges"],
            ))
        ok_updates = sum(1 for r in results if r.get("ok"))
        st = router.stats()["router"]
        tokens = {
            wid: tuple(w["token"]) if w["token"] else None
            for wid, w in st["workers"].items()
        }
        oracle_check = _router_oracle_check(
            router, oracle, rng, n_authors, k, samples=12
        )
        return {
            "updates": updates,
            "updates_ok": ok_updates,
            "wall_s": round(wall, 3),
            "broadcasts": st["firehose"]["broadcasts"],
            "coalesced": st["firehose"]["coalesced"],
            "backpressure": st["firehose"]["backpressure"],
            "query_load": qres,
            "worker_tokens": {w: list(t) if t else None
                              for w, t in tokens.items()},
            "tokens_agree": len(set(tokens.values())) == 1,
            "oracle_checked": oracle_check,
        }
    finally:
        router.close()
        oracle.close()
        for t in transports.values():
            t.runtime.service.close()


def _firehose_autoscale_phase(n_authors: int, n_papers: int,
                              n_venues: int, k: int, seed: int = 0,
                              backend: str = "torch",
                              platform: str = "cuda") -> dict:
    """The deterministic load step: an in-proc fleet starting at ONE
    worker, the autoscaler ticked explicitly between load stages.
    Stage 1 (idle) must hold; stage 2 (a sustained async query burst
    against a deliberately slow-draining worker) must spawn within
    ``up_consecutive`` high ticks; stage 3 (idle again) must drain
    back to the floor. The decision log is the result."""
    from .data import delta as dl
    from .ops.metapath import compile_metapath
    from .router import (
        AutoscaleConfig, Autoscaler, InprocTransport, Router,
        RouterConfig, WorkerRuntime,
    )
    from .serving import PathSimService, ServeConfig

    mp = None

    def make_transport(wid: str):
        nonlocal mp
        hin = dl.with_headroom(
            synthetic_hin_cached(n_authors, n_papers, n_venues,
                                 seed=seed),
            0.25,
        )
        if mp is None:
            mp = compile_metapath("APVPA", hin.schema)
        svc = PathSimService(
            _create_backend(backend, hin, mp, platform),
            # slow drain under burst: small batches + a real linger +
            # caches OFF (a 256-row pool would turn pure-LRU-hit in
            # one wave), so the queue-depth signal is unambiguous
            config=ServeConfig(max_batch=4, max_wait_ms=20.0,
                               queue_depth=4096, warm=False,
                               cache_entries=0, tile_cache_bytes=0),
        )
        t = InprocTransport(wid, WorkerRuntime(svc, worker_id=wid))
        made.append(t)
        return t

    made: list = []
    transports = {"w0": make_transport("w0")}
    router = Router(transports, RouterConfig(
        heartbeat_interval_s=0.05, heartbeat_miss_limit=100,
        hedge_ms=None, max_inflight=16384, scrape_interval_s=0,
        worker_queue_limit=4096, retain_replay=True,
    ))
    router.start()
    auto = Autoscaler(router, make_transport, AutoscaleConfig(
        min_workers=1, max_workers=3, up_consecutive=2,
        down_consecutive=3, cooldown_ticks=2,
        pending_high=48.0, pending_low=2.0,
    ))
    rng = np.random.default_rng(seed)
    try:
        # stage 1: idle ticks — must hold at the floor
        idle = [auto.tick()["action"] for _ in range(3)]
        # stage 2: the load step — each wave submits a 64-query burst
        # and ticks while the backlog is live (the router's OWN
        # pending table is the signal: synchronous, deterministic)
        futs = []
        spawn_tick = None
        for wave in range(30):
            for row in rng.integers(0, n_authors, size=64):
                futs.append(router.submit(
                    {"op": "topk", "row": int(row), "k": k}
                ))
            d = auto.tick()
            if d["action"] == "spawn":
                spawn_tick = d["tick"]
                break
        for f in futs:
            resp = f.result(timeout=120)
            if not (resp.get("ok") or resp.get("shed")):
                raise AssertionError(f"autoscale burst lost: {resp}")
        # stage 3: idle again — must drain back to the floor
        drain_tick = None
        for _ in range(12):
            time.sleep(0.12)
            d = auto.tick()
            if d["action"] == "drain":
                drain_tick = d["tick"]
                break
        # settle: the drained worker exits and is reaped
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            router.reap_workers()
            with router._lock:
                n_up = sum(
                    1 for w in router.workers.values()
                    if w.status == "up"
                )
            if n_up == 1:
                break
            time.sleep(0.05)
        post = router.request(
            {"op": "topk", "row": 3, "k": k}, timeout=30
        )
        return {
            "idle_actions": idle,
            "spawn_tick": spawn_tick,
            "drain_tick": drain_tick,
            "workers_after_settle": n_up,
            "post_scale_ok": bool(post.get("ok")),
            "decisions": [
                {kk: d[kk] for kk in ("tick", "action", "reason")}
                for d in auto.decisions
            ],
        }
    finally:
        router.close()
        for t in made:
            t.runtime.service.close()


def run_firehose_bench(
    n_authors: int = 512,
    n_papers: int = 1024,
    n_venues: int = 16,
    deltas: int = 10_000,
    clients: int = 8,
    k: int = 10,
    backend: str = "torch",
    platform: str = "cuda",
    chain_len: int = 64,
    frontier_sleeps_ms: tuple = (0.0, 2.0, 10.0),
    fleet_updates: int = 48,
    seed: int = 0,
) -> dict:
    """``--regime firehose``: the fleet under a continuous update
    stream concurrent with closed-loop serving load. Four phases:

    1. **sustained**: one warm service, ``deltas`` updates back to
       back against ``clients`` closed-loop queriers — updates/sec,
       QPS, update-visible p99, ≥1 background compaction hot-swap
       with measured pause, compile ledger split compaction vs rest;
       plus a steady-state compaction probe (a forced re-encode at
       unchanged capacity must add ZERO compiles — the pow-2 bucket
       contract).
    2. **frontier**: the same workload at throttled update rates —
       the sustained updates/sec × QPS trade.
    3. **fleet**: coalesced updates through the router's bounded
       queue (broadcasts < K, tokens agree, oracle-exact).
    4. **autoscale**: the deterministic load step (spawn within the
       hysteresis bound, drain back at idle, decision log)."""
    out: dict = {
        "graph": {"authors": n_authors, "papers": n_papers,
                  "venues": n_venues, "seed": seed},
        "load": {"deltas": deltas, "clients": clients, "k": k,
                 "chain_len": chain_len},
        "backend": backend,
        "environment": {
            "cpu_count": os.cpu_count(),
            "note": (
                "updater and query clients share one host with the "
                "service; updates/sec and QPS here measure the "
                "CONTENTION point, not isolated ceilings. The "
                "load-invariant claims are the gates: zero lost, "
                "zero non-compaction compiles, zero steady-state "
                "compaction compiles, bounded swap pause."
            ),
        },
    }
    sustained, svc = _firehose_single_phase(
        n_authors, n_papers, n_venues, deltas, clients, backend, k,
        chain_len, seed=seed, platform=platform,
    )
    try:
        # steady-state compaction probe: same capacity → the build
        # reuses every built kernel and captured graph, compiling NOTHING
        pre_cap = dict(
            (svc.stats()["compaction"]["last"].get("capacity") or {})
        )
        probe = svc.compact()
        sustained["steady_compact_probe"] = {
            "swapped": probe.get("swapped"),
            "compiles": probe.get("compiles"),
            "capacity_unchanged": (
                probe.get("capacity") == pre_cap or not pre_cap
            ),
            "pause_ms": probe.get("pause_ms"),
        }
    finally:
        svc.close()
    out["sustained"] = sustained
    frontier = []
    for sleep_ms in frontier_sleeps_ms:
        if sleep_ms == 0.0:
            frontier.append({
                "update_sleep_ms": 0.0,
                "updates_per_s": sustained["updates_per_s"],
                "qps": sustained["qps"],
                "update_visible_p99_ms":
                    sustained["update_visible"]["p99_ms"],
            })
            continue
        point, svc2 = _firehose_single_phase(
            n_authors, n_papers, n_venues,
            max(deltas // 10, 50), clients, backend, k, chain_len,
            update_sleep_ms=sleep_ms, seed=seed, platform=platform,
        )
        svc2.close()
        frontier.append({
            "update_sleep_ms": sleep_ms,
            "updates_per_s": point["updates_per_s"],
            "qps": point["qps"],
            "update_visible_p99_ms": point["update_visible"]["p99_ms"],
        })
    out["frontier"] = frontier
    out["fleet"] = _firehose_fleet_phase(
        n_authors, n_papers, n_venues, fleet_updates, k, seed=seed,
        backend=backend, platform=platform,
    )
    out["autoscale"] = _firehose_autoscale_phase(
        n_authors, n_papers, n_venues, k, seed=seed, backend=backend,
        platform=platform,
    )
    return out


def firehose_checks(result: dict) -> dict:
    """The firehose regime's seventeen gates (see
    :func:`run_firehose_smoke`); the two millisecond bounds are the
    clock's."""
    s = result["sustained"]
    fleet = result["fleet"]
    auto = result["autoscale"]
    return {
        "zero_query_sheds_single": s["shed"] == 0,
        "updates_all_visible": s["update_visible"]["p99_ms"] is not None,
        "update_visible_p99_bounded":
            s["update_visible"]["p99_ms"] < 2000.0,
        "compaction_happened": s["compaction"]["count"] >= 1,
        "compaction_pause_bounded": (
            s["compaction"]["pause_p99_ms"] is not None
            and s["compaction"]["pause_p99_ms"] < 2000.0
        ),
        "zero_compiles_outside_compaction":
            s["compiles_outside_compaction"] == 0,
        "steady_compaction_zero_compiles": (
            s["steady_compact_probe"]["swapped"]
            and s["steady_compact_probe"]["compiles"] == 0
            and s["steady_compact_probe"]["capacity_unchanged"]
        ),
        "zero_inline_rebuilds": s["inline_rebuilds"] == 0,
        "fleet_zero_lost": fleet["query_load"]["lost"] == 0,
        "fleet_updates_all_ok":
            fleet["updates_ok"] == fleet["updates"],
        "fleet_coalesced": fleet["broadcasts"] < fleet["updates"],
        "fleet_tokens_agree": fleet["tokens_agree"],
        "fleet_oracle_exact":
            fleet["oracle_checked"]["mismatches"] == 0,
        "autoscale_spawned": auto["spawn_tick"] is not None,
        "autoscale_drained": auto["drain_tick"] is not None,
        "autoscale_settled": auto["workers_after_settle"] == 1,
        "autoscale_idle_held": all(
            a == "hold" for a in auto["idle_actions"]
        ),
    }


def run_firehose_smoke(out_path: str | None = None, backend: str = "torch",
                       platform: str = "cuda") -> dict:
    """The firehose gate: a short sustained stream + one forced
    steady-state compaction + the fleet coalescing burst + one
    autoscale step. Hard gates: zero lost requests anywhere, every
    non-compaction compile is zero, ≥1 background compaction hot-swap
    with bounded pause, the steady-state compaction probe compiles
    NOTHING, update-visible p99 bounded, coalescing really folded
    broadcasts, and the autoscaler spawned on the load step and
    drained at idle."""
    result = run_firehose_bench(**FIREHOSE_SMOKE, backend=backend,
                                platform=platform)
    result["smoke_checks"] = checks = firehose_checks(result)
    _write(result, out_path)
    _require(checks, "firehose")
    return result


# ---------------------------------------------------------------------------
# Metapath planner regime (--regime metapath): DP chain ordering vs the
# naive left-to-right fold, plus the workload-level sub-chain memo
# ---------------------------------------------------------------------------


def _best_of(fn, reps: int) -> tuple[float, object]:
    """(best wall seconds, last result) over ``reps`` calls."""
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def _metapath_ordering_phase(n_authors, n_papers, n_venues, n_topics,
                             reps, seed) -> dict:
    """Planner (DP) vs naive left-to-right on an asymmetric chain where
    association order genuinely matters: APVPT runs tall·narrow·tall·
    wide (A×P · P×V · V×P · P×T), so the naive fold pays the full-width
    A×P intermediate against the topic block while the DP contracts
    V·P·T down to a tiny V×T first. Both estimated and measured costs
    are recorded; results are asserted bit-identical (integer counts
    are association-invariant — that is WHY ordering is a free lever).

    Host numpy f64 on purpose, on every platform: the phase measures
    the planner's association order, not a device (at the smoke's
    shapes both chains are a few microseconds of card time against
    the launches around them)."""
    from .data.synthetic import synthetic_hin
    from .ops import chain as _chain
    from .ops import planner
    from .ops.metapath import compile_metapath

    hin = synthetic_hin(
        n_authors, n_papers, n_venues, n_topics=n_topics,
        topics_per_paper=1.4, seed=seed,
    )
    mp = compile_metapath("APVPT", hin.schema)
    plan = planner.plan_metapath(hin, mp)
    blocks = _chain.oriented_dense_blocks(hin, mp.steps, dtype=np.float64)
    # one untimed call of each, then the two arms in turns, so that a
    # cold BLAS pool or a busy spell of the host's other threads falls
    # on both alike
    m_dp = planner.execute_dense(plan, blocks)
    m_naive = planner.naive_dense(blocks)
    t_dp = t_naive = float("inf")
    for _ in range(reps):
        t, m_dp = _best_of(lambda: planner.execute_dense(plan, blocks), 1)
        t_dp = min(t_dp, t)
        t, m_naive = _best_of(lambda: planner.naive_dense(blocks), 1)
        t_naive = min(t_naive, t)
    if not np.array_equal(m_dp, m_naive):
        raise AssertionError(
            "association order changed integer path counts — planner bug"
        )
    return {
        "metapath": mp.name,
        "shapes": [list(b.shape) for b in blocks],
        "plan_order": plan.order(),
        "dp_ran": plan.dp,
        "est_flops_planner": plan.est_flops,
        "est_flops_naive": plan.naive_flops,
        "est_speedup": round(plan.naive_flops / max(plan.est_flops, 1), 3),
        "measured_ms_planner": round(t_dp * 1e3, 3),
        "measured_ms_naive": round(t_naive * 1e3, 3),
        "measured_speedup": round(t_naive / max(t_dp, 1e-9), 3),
        "bit_identical": True,
        "plan": plan.to_dict(),
    }


_MP_WORKLOAD_SPECS = ("APVPA", "APA", "APTPA")


def _metapath_workload_arm(hin_kwargs, backend, max_batch, max_wait_ms,
                           k, clients, queries_per_client, rounds,
                           memo_on: bool, seed: int,
                           platform: str = "cuda") -> dict:
    """One closed-loop arm of the mixed-metapath workload: warm the
    three engines, then alternate query rounds with delta rounds (a
    delta drops the engines, so the next round pays the re-fold — the
    regime the sub-chain memo exists for). Returns throughput, memo
    accounting, the compile ledger, and a bit-identity audit vs
    dedicated per-metapath numpy oracles."""
    from concurrent.futures import ThreadPoolExecutor

    from .data.delta import with_headroom
    from .data.synthetic import synthetic_hin
    from .ops.metapath import compile_metapath
    from .serving import PathSimService, ServeConfig
    from .utils.compile_counter import CompileCounter

    hin = with_headroom(synthetic_hin(**hin_kwargs), 0.25)
    mp = compile_metapath("APVPA", hin.schema)
    svc = PathSimService(
        _create_backend(backend, hin, mp, platform),
        config=ServeConfig(
            max_batch=max_batch, max_wait_ms=max_wait_ms,
            queue_depth=4096, k_default=k, warm=True,
            memo_budget_mb=(64.0 if memo_on else 0.0),
        ),
    )
    rng = np.random.default_rng(seed)
    n = svc.n
    try:
        # -- warmup: build + warm every engine, run the delta path
        # once (one warmup update, like the update smoke)
        for spec in _MP_WORKLOAD_SPECS:
            svc.topk_index(0, k=k, metapath=spec)
        delta0 = _random_delta(hin, rng, 0.002, append_nodes=False)
        svc.update(delta0)
        for spec in _MP_WORKLOAD_SPECS:
            svc.topk_index(1, k=k, metapath=spec)

        # -- bit-identity audit vs dedicated oracles on the live graph
        oracle_hin = svc.hin
        audit_ok = True
        for spec in _MP_WORKLOAD_SPECS:
            oracle = _create_backend(
                "numpy", oracle_hin, compile_metapath(spec, hin.schema),
                platform,
            )
            for row in rng.integers(0, n, size=4):
                want_v, want_i = oracle.topk_row(int(row), k=k)
                got_v, got_i = svc.topk_index(int(row), k=k, metapath=spec)
                audit_ok = audit_ok and np.array_equal(got_i, want_i) \
                    and np.array_equal(got_v, want_v)

        # -- measured window: closed-loop mixed-metapath clients, one
        # delta per round (drops engines → next round refolds, hitting
        # the memo for factors the delta did not touch)
        schedule = [
            rng.integers(0, n, size=queries_per_client).tolist()
            for _ in range(clients)
        ]

        def client(ci: int, rows) -> int:
            done = 0
            for qi, row in enumerate(rows):
                spec = _MP_WORKLOAD_SPECS[(ci + qi) % 3]
                svc.topk_index(int(row), k=k, metapath=spec)
                done += 1
            return done

        total_queries = 0
        t0 = time.perf_counter()
        with CompileCounter() as cc:
            for rnd in range(rounds):
                with ThreadPoolExecutor(max_workers=clients) as ex:
                    total_queries += sum(
                        ex.map(client, range(clients), schedule)
                    )
                if rnd < rounds - 1:
                    svc.update(
                        _random_delta(svc.hin, rng, 0.002,
                                      append_nodes=False)
                    )
            wall = time.perf_counter() - t0
            compiles = cc.count
        stats = svc.stats()
        memo = stats["plan"]["memo"]
        return {
            "memo_on": memo_on,
            "queries": total_queries,
            "wall_s": round(wall, 4),
            "qps": round(total_queries / max(wall, 1e-9), 1),
            "steady_state_compiles": compiles,
            "memo": memo,
            "engines": stats["plan"]["engines"],
            "bit_identical_vs_oracles": audit_ok,
        }
    finally:
        svc.close()


def run_metapath_bench(
    n_authors: int = 2048,
    n_papers: int = 4096,
    n_venues: int = 12,
    n_topics: int = 128,
    clients: int = 16,
    queries_per_client: int = 32,
    rounds: int = 3,
    reps: int = 3,
    k: int = 10,
    backend: str = "torch",
    platform: str = "cuda",
    max_batch: int = 32,
    max_wait_ms: float = 2.0,
    seed: int = 0,
    out_path: str | None = None,
) -> dict:
    """``--regime metapath``: (1) DP chain ordering vs naive
    left-to-right on a measured asymmetric chain (estimated AND wall
    time, bit-identity asserted; host numpy f64); (2) a mixed
    APVPA/APA/APTPA closed-loop workload through the per-request
    ``metapath`` lanes on ``platform``, memo-on vs memo-off arms (hit
    rate, QPS, engine-rebuild sharing across deltas) with the
    steady-state compile ledger."""
    from .data.synthetic import synthetic_hin
    from .ops import planner
    from .ops.metapath import compile_metapath

    ordering = _metapath_ordering_phase(
        n_authors, n_papers, n_venues, n_topics, reps, seed
    )
    hin_kwargs = dict(
        n_authors=n_authors, n_papers=n_papers, n_venues=n_venues,
        n_topics=max(n_topics // 8, 8), topics_per_paper=1.2, seed=seed,
    )
    arm_kwargs = dict(
        hin_kwargs=hin_kwargs, backend=backend, max_batch=max_batch,
        max_wait_ms=max_wait_ms, k=k, clients=clients,
        queries_per_client=queries_per_client, rounds=rounds, seed=seed,
        platform=platform,
    )
    memo_arm = _metapath_workload_arm(memo_on=True, **arm_kwargs)
    nomemo_arm = _metapath_workload_arm(memo_on=False, **arm_kwargs)

    # Direct sub-chain refold cost, warm vs cold: the component the
    # memo actually accelerates (engine rebuilds after a delta). The
    # closed-loop QPS arms above are dominated by query serving at
    # bench scale, so the fold win is reported where it is measurable.
    refold_hin = synthetic_hin(**hin_kwargs)
    paths = [
        compile_metapath(spec, refold_hin.schema)
        for spec in _MP_WORKLOAD_SPECS
    ]
    t_cold, _ = _best_of(
        lambda: [planner.fold_half(refold_hin, p) for p in paths], reps
    )
    memo = planner.SubchainCache(64 << 20)
    for p in paths:
        planner.fold_half(refold_hin, p, memo=memo)  # populate
    t_warm, _ = _best_of(
        lambda: [planner.fold_half(refold_hin, p, memo=memo)
                 for p in paths], reps
    )
    refold = {
        "specs": list(_MP_WORKLOAD_SPECS),
        "cold_ms": round(t_cold * 1e3, 3),
        "warm_ms": round(t_warm * 1e3, 3),
        "memo_fold_speedup": round(t_cold / max(t_warm, 1e-9), 2),
    }
    result = {
        "bench": "metapath",
        "config": {
            "authors": n_authors, "papers": n_papers,
            "venues": n_venues, "topics": n_topics,
            "clients": clients, "rounds": rounds, "k": k,
            "backend": backend, "seed": seed,
        },
        "ordering": ordering,
        "workload": {
            "specs": list(_MP_WORKLOAD_SPECS),
            "memo_on": memo_arm,
            "memo_off": nomemo_arm,
            "memo_qps_uplift": round(
                memo_arm["qps"] / max(nomemo_arm["qps"], 1e-9), 3
            ),
            "refold": refold,
        },
    }
    result["checks"] = metapath_checks(result)
    _write(result, out_path)
    return result


def metapath_checks(result: dict) -> dict:
    """The metapath regime's five gates (the repository harness keeps
    them under the result's ``checks``); the measured planner-vs-naive
    wall time is the clock's."""
    ordering = result["ordering"]
    memo_arm = result["workload"]["memo_on"]
    nomemo_arm = result["workload"]["memo_off"]
    return {
        "planner_beats_naive_measured": (
            ordering["measured_ms_planner"]
            < ordering["measured_ms_naive"]
        ),
        "planner_beats_naive_estimated": (
            ordering["est_flops_planner"] < ordering["est_flops_naive"]
        ),
        "memo_subchain_shared_across_lanes": (
            memo_arm["memo"] is not None
            and memo_arm["memo"]["hits"] > 0
            and len(memo_arm["engines"]) >= 2
        ),
        "mixed_lanes_bit_identical": (
            memo_arm["bit_identical_vs_oracles"]
            and nomemo_arm["bit_identical_vs_oracles"]
        ),
        "zero_steady_state_recompiles": (
            memo_arm["steady_state_compiles"] == 0
            and nomemo_arm["steady_state_compiles"] == 0
        ),
    }


def run_metapath_smoke(out_path: str | None = None, backend: str = "torch",
                       platform: str = "cuda") -> dict:
    """Small fixed-seed metapath run with hard gates. The ordering
    shapes are skewed (wide topic axis) so the planner-vs-naive
    wall-time gap is far above scheduler noise."""
    result = run_metapath_bench(**METAPATH_SMOKE, backend=backend,
                                platform=platform, out_path=out_path)
    ordering = result["ordering"]
    _require(result["checks"], "metapath",
             f"; planner {ordering['measured_ms_planner']} ms, naive "
             f"{ordering['measured_ms_naive']} ms")
    return result


# ---------------------------------------------------------------------------
# Compressed factor formats (--regime compress): resident bytes, max-N at
# budget, decode overhead, bit-parity + compile ledger
# ---------------------------------------------------------------------------


def _self_rss_kb() -> int:
    """This process's VmRSS (kB) from /proc — the coarse corroboration
    of the exact per-array factor-bytes accounting (0 off-Linux). Host
    memory: the card's allocation is not in it."""
    try:
        with open("/proc/self/status", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def _compile_count() -> int:
    """Run-time compiles (kernel builds and loads, CUDA-graph captures)
    the registry has counted since process start."""
    from .utils.compile_counter import compiles_total, install_compile_metrics

    install_compile_metrics()
    return compiles_total()


def _compress_random_delta(hin, rng, n_changes: int = 8):
    """Random edge adds/removes over both half-chain blocks — the
    delta shape each format arm must absorb recompile-free AND
    bit-identically (every arm replays the same seeded sequence)."""
    from .data import delta as dl

    edges = []
    per_rel = max(n_changes // 2, 2)
    for rel in ("author_of", "submit_at"):
        b = hin.blocks[rel]
        n_src = hin.type_size(b.src_type)
        n_dst = hin.type_size(b.dst_type)
        n_rem = per_rel // 2
        rem_i = rng.choice(b.nnz, size=n_rem, replace=False)
        removes = np.stack([b.rows[rem_i], b.cols[rem_i]], axis=1)
        existing = set(zip(b.rows.tolist(), b.cols.tolist()))
        adds = []
        while len(adds) < per_rel - n_rem:
            e = (int(rng.integers(0, n_src)), int(rng.integers(0, n_dst)))
            if e not in existing:
                existing.add(e)
                adds.append(e)
        edges.append(dl.edge_delta(rel, add=adds, remove=removes))
    return dl.DeltaBatch(edges=tuple(edges))


def _compress_partition_model(hin_plain, mp, fmt, partitions, replication,
                              budget_bytes, platform) -> dict:
    """The per-partition max-N model from one worker's measured packed
    slice (partition 0 of ``partitions``)."""
    from .serving.partition import PartitionConfig, PartitionService

    psvc = PartitionService(
        hin_plain, mp, 0, partitions, replication=replication,
        config=PartitionConfig(factor_format=fmt, device=platform),
    )
    p_bytes = psvc.fs.factor_bytes()
    rows_held = int(psvc.fs.n_held)
    p_block = sum(
        int(b.rows.nbytes + b.cols.nbytes)
        for b in psvc.hin.blocks.values()
    )
    per_row = (p_bytes + p_block) / max(rows_held, 1)
    held_fraction = rows_held / max(hin_plain.type_size("author"), 1)
    return {
        "partitions": partitions,
        "replication": replication,
        "rows_held": rows_held,
        "slice_factor_bytes": int(p_bytes),
        "bytes_per_held_row": round(per_row, 1),
        "max_n_at_budget_per_partition": int(
            budget_bytes / (per_row * held_fraction)
        ),
    }


def run_compress_bench(
    n_authors: int = 4096,
    n_papers: int = 8192,
    n_venues: int = 48,
    batches: int = 24,
    batch_rows: int = 16,
    k: int = 10,
    deltas: int = 4,
    headroom: float = 0.25,
    budget_gb: float = 8.0,
    partitions: int = 3,
    replication: int = 2,
    seed: int = 0,
    backend: str = "torch-sparse",
    platform: str = "cuda",
) -> dict:
    """``--regime compress``: one ``backend`` (torch-sparse) per
    resident factor layout (the ``factor_format`` knob) over the SAME
    graph and the SAME seeded workload. Measured per format: exact
    resident factor bytes (+ VmRSS corroboration), build/pack time,
    batched-serving latency (where packed layouts pay their decode
    cost), the max-N-at-budget model single-chip AND per-partition
    (budget / measured bytes-per-row — the number this whole tier
    exists to raise; ``budget_gb`` is a parameter of the model, not a
    measured memory), the compile ledger through a delta-interleaved
    phase, and bit parity of counts/f64 scores/top-k ties against the
    COO arm before and after every delta."""
    import gc

    from .data import delta as dl
    from .data.synthetic import synthetic_hin
    from .ops.metapath import compile_metapath

    rng = np.random.default_rng(seed)
    base = dl.with_headroom(
        synthetic_hin(n_authors, n_papers, n_venues, seed=seed), headroom
    )
    hin_plain = synthetic_hin(n_authors, n_papers, n_venues, seed=seed)
    mp = compile_metapath("APVPA", base.schema)
    n = base.type_size("author")
    block_bytes = sum(
        int(b.rows.nbytes + b.cols.nbytes) for b in base.blocks.values()
    )
    budget_bytes = int(budget_gb * (1 << 30))
    rows_w = [rng.integers(0, n, size=batch_rows) for _ in range(batches)]
    sample_rows = rng.integers(0, n, size=8)
    out: dict = {
        "graph": {"authors": n, "papers": n_papers, "venues": n_venues,
                  "headroom": headroom, "seed": seed},
        "load": {"batches": batches, "batch_rows": batch_rows, "k": k,
                 "deltas": deltas},
        "budget_gb": budget_gb,
        "environment": {
            "cpu_count": os.cpu_count(),
            "note": (
                "factor_bytes is EXACT array accounting (the gauge the "
                "fleet exports); VmRSS deltas (host memory) corroborate "
                "it coarsely (allocator slack, shared pages). The max-N "
                "columns are arithmetic over measured bytes-per-row at "
                "a fixed budget — the claim is the measured resident "
                "reduction and the measured serve/fold cost of "
                "earning it; parity and the compile ledger are hard "
                "gates, not estimates."
            ),
            "max_n_model": (
                f"single-chip: {budget_gb} GiB / measured "
                "(factor+block) bytes per author; per-partition: "
                f"{budget_gb} GiB per worker / measured bytes per "
                f"held row x held fraction (P={partitions}, "
                f"R={replication})"
            ),
        },
        "formats": {},
    }
    ref: dict | None = None
    for fmt in ("coo", "blocked", "bitpacked"):
        gc.collect()
        rss0 = _self_rss_kb()
        t0 = time.perf_counter()
        sparse = _create_backend(backend, base, mp, platform,
                                 factor_format=fmt)
        build_s = time.perf_counter() - t0
        info = sparse.factor_info()
        rss1 = _self_rss_kb()
        sparse.topk_rows(rows_w[0], k=k)  # warm: kernel builds, buffers
        c0 = _compile_count()
        lat = []
        for r in rows_w:
            t1 = time.perf_counter()
            sparse.topk_rows(r, k=k)
            lat.append(time.perf_counter() - t1)
        steady_compiles = _compile_count() - c0
        pre_topk = sparse.topk_rows(sample_rows, k=k)
        pre_scores = sparse.scores_rows(sample_rows[:4])
        # delta-interleaved phase: every arm replays the SAME seeded
        # delta sequence, serving between deltas; compiles must stay 0
        rng_d = np.random.default_rng(seed + 17)
        hin_f = base
        dc0 = _compile_count()
        t_delta = []
        for _ in range(deltas):
            delta = _compress_random_delta(hin_f, rng_d)
            plan = dl.plan_delta(hin_f, delta, mp, max_delta_fraction=1.0)
            if plan.fallback:
                raise AssertionError(f"delta fell back: {plan.reason}")
            t1 = time.perf_counter()
            sparse.apply_delta(plan)
            t_delta.append(time.perf_counter() - t1)
            hin_f = plan.hin_new
            sparse.topk_rows(rows_w[0], k=k)
        delta_compiles = _compile_count() - dc0
        post_topk = sparse.topk_rows(sample_rows, k=k)
        post_scores = sparse.scores_rows(sample_rows[:4])
        post_info = sparse.factor_info()
        res = {
            "factor_bytes": int(info["bytes"]),
            "factor_nnz": int(info["nnz"]),
            "coo_equiv_bytes": int(info["coo_bytes"]),
            "factor_bytes_post_delta": int(post_info["bytes"]),
            "build_s": round(build_s, 4),
            "rss_build_delta_kb": rss1 - rss0,
            "serve_p50_ms": round(
                float(np.median(lat)) * 1e3, 4
            ),
            "serve_p99_ms": round(
                float(np.quantile(lat, 0.99)) * 1e3, 4
            ),
            "delta_apply_p50_ms": round(
                float(np.median(t_delta)) * 1e3, 4
            ),
            "steady_state_compiles": int(steady_compiles),
            "delta_phase_compiles": int(delta_compiles),
        }
        per_author = (res["factor_bytes"] + block_bytes) / max(n, 1)
        res["resident_bytes_per_author"] = round(per_author, 1)
        res["max_n_at_budget_single_chip"] = int(
            budget_bytes / per_author
        )
        res["partition"] = _compress_partition_model(
            hin_plain, mp, fmt, partitions, replication, budget_bytes,
            platform,
        )
        if ref is None:
            ref = {
                "pre_topk": pre_topk, "pre_scores": pre_scores,
                "post_topk": post_topk, "post_scores": post_scores,
                "factor_bytes": res["factor_bytes"],
                "max_n_chip": res["max_n_at_budget_single_chip"],
                "max_n_part": res["partition"][
                    "max_n_at_budget_per_partition"],
                "serve_p50_ms": res["serve_p50_ms"],
            }
            res["bit_identical_to_coo"] = True
        else:
            res["reduction_vs_coo"] = round(
                ref["factor_bytes"] / max(res["factor_bytes"], 1), 2
            )
            res["serve_p50_vs_coo"] = round(
                res["serve_p50_ms"] / max(ref["serve_p50_ms"], 1e-9), 2
            )
            res["bit_identical_to_coo"] = bool(
                np.array_equal(pre_topk[0], ref["pre_topk"][0])
                and np.array_equal(pre_topk[1], ref["pre_topk"][1])
                and np.array_equal(pre_scores, ref["pre_scores"])
                and np.array_equal(post_topk[0], ref["post_topk"][0])
                and np.array_equal(post_topk[1], ref["post_topk"][1])
                and np.array_equal(post_scores, ref["post_scores"])
            )
        out["formats"][fmt] = res
        del sparse
    packed = [
        out["formats"][f] for f in ("blocked", "bitpacked")
    ]
    out["summary"] = {
        "best_factor_reduction": max(
            r["reduction_vs_coo"] for r in packed
        ),
        "max_n_single_chip_coo": ref["max_n_chip"],
        "max_n_single_chip_best": max(
            r["max_n_at_budget_single_chip"] for r in packed
        ),
        "max_n_per_partition_coo": ref["max_n_part"],
        "max_n_per_partition_best": max(
            r["partition"]["max_n_at_budget_per_partition"]
            for r in packed
        ),
    }
    return out


def compress_checks(result: dict) -> dict:
    """The compress regime's five gates (see :func:`run_compress_smoke`),
    none of them the clock's."""
    fmts = result["formats"]
    s = result["summary"]
    return {
        "factor_reduction_ge_1p5": s["best_factor_reduction"] >= 1.5,
        "bit_identical_all_formats": all(
            r["bit_identical_to_coo"] for r in fmts.values()
        ),
        "zero_steady_state_recompiles": all(
            r["steady_state_compiles"] == 0
            and r["delta_phase_compiles"] == 0
            for r in fmts.values()
        ),
        "max_n_single_chip_improves": (
            s["max_n_single_chip_best"] > s["max_n_single_chip_coo"]
        ),
        "max_n_per_partition_improves": (
            s["max_n_per_partition_best"] > s["max_n_per_partition_coo"]
        ),
    }


def run_compress_smoke(out_path: str | None = None,
                       backend: str = "torch-sparse",
                       platform: str = "cuda") -> dict:
    """The compressed-factors gate. Hard gates: ≥1.5× measured resident
    factor-bytes reduction for at least one packed format,
    bit-identical counts/f64 scores/top-k ties vs the COO arm before
    AND after a delta-interleaved run, ZERO steady-state recompiles in
    every arm (serving and delta phases), and a strictly higher
    modeled max-N-at-budget than COO — single-chip and
    per-partition."""
    result = run_compress_bench(**COMPRESS_SMOKE, backend=backend,
                                platform=platform)
    result["smoke_checks"] = checks = compress_checks(result)
    _write(result, out_path)
    _require(checks, "compress")
    return result


# ---------------------------------------------------------------------------
# Batch campaign tier (--regime batch): corpus-scale top-k-all sweep +
# threshold similarity join, single-host and fleet arms
# ---------------------------------------------------------------------------

# $-per-sweep extrapolation assumption: one on-demand cloud accelerator
# host at the repository harness's list price. The result records the
# assumption next to the number so the extrapolation can be re-based; the
# measured quantity is rows/sec on the hardware that ran it.
BATCH_USD_PER_HOST_HOUR = 3.22
BATCH_CORPUS_ROWS = 4_190_000  # the paper's author-corpus sweep size


def _batch_fleet(hin, metapath, workers: int = 2, backend: str = "torch",
                 platform: str = "cuda"):
    """Inproc 2-replica fleet for the batch_blocks fan-out arm."""
    from .router import InprocTransport, WorkerRuntime
    from .router.batch import BlockScheduler
    from .serving import PathSimService, ServeConfig

    services = [
        PathSimService(
            _create_backend(backend, hin, metapath, platform),
            config=ServeConfig(warm=False, max_wait_ms=0.5),
        )
        for _ in range(workers)
    ]
    transports = {
        f"w{i}": InprocTransport(
            f"w{i}", WorkerRuntime(svc, worker_id=f"w{i}")
        )
        for i, svc in enumerate(services)
    }
    sched = BlockScheduler(transports, straggler_after_s=10.0)
    sched.start()
    return services, sched


def run_batch_bench(
    n_authors: int = 2048,
    n_papers: int = 4096,
    n_venues: int = 48,
    k: int = 10,
    tau: float = 0.05,
    block_rows: int = 256,
    sample_rows: int = 64,
    workers: int = 2,
    seed: int = 0,
    out_path: str | None = None,
    backend: str = "torch",
    platform: str = "cuda",
) -> dict:
    """``--regime batch``: the corpus-sweep campaign tier measured end
    to end on one synthetic graph. Arms: (1) single-host top-k-all
    (each block's counts one f64 GEMM on ``platform`` against the
    resident Cᵀ) with the sampled-row oracle parity gate and the
    steady-state compile ledger, (2) a SIGTERM-shaped resume
    (preemption requested mid-campaign, shard files compared
    byte-for-byte against an uninterrupted run), (3) threshold simjoin
    with certificate prune accounting and a brute-force soundness
    check, (4) the 2-worker ``batch_blocks`` fleet fan-out (``backend``
    services on ``platform``), bit-parity vs arm 1. Reports rows/sec,
    bytes read per row, prune ratio, and the $-per-full-corpus-sweep
    extrapolation."""
    import hashlib
    import pathlib
    import tempfile

    from .batch import BatchEngine, run_simjoin_campaign, run_topk_campaign
    from .data.synthetic import synthetic_hin
    from .ops.metapath import compile_metapath
    from .resilience import Preempted, preemption_handler

    rng = np.random.default_rng(seed)
    hin = synthetic_hin(n_authors, n_papers, n_venues, seed=seed)
    metapath = compile_metapath("APVPA", hin.schema)
    engine = BatchEngine(hin, metapath, block_rows=block_rows,
                         device=platform)
    ev: dict = {}
    out: dict = {
        "bench": "batch",
        "graph": {
            "authors": n_authors, "papers": n_papers,
            "venues": n_venues, "seed": seed,
        },
        "k": k, "tau": tau,
        "block_rows": engine.block_rows,
        "factor_format": engine.factor_format,
        "backend_mode": engine.backend_mode,
    }

    # -- arm 1: single-host top-k-all + parity + compile ledger ----------
    warm = run_topk_campaign(engine, k)  # first pass: builds, buffers
    c0 = _compile_count()
    res = run_topk_campaign(engine, k)
    ev["steady_compiles"] = steady_compiles = _compile_count() - c0
    sample = np.sort(rng.choice(engine.n, size=min(sample_rows, engine.n),
                                replace=False))
    oracle = _create_backend("numpy", hin, metapath, platform)
    vals, idxs = oracle.topk_rows(sample, k, variant="rowsum")
    ev["sample_parity"] = bool(
        np.array_equal(res.vals[sample], vals)
        and np.array_equal(res.idxs[sample], idxs)
    )
    out["topk_single_host"] = {
        "rows_per_s": round(res.rows_per_s, 2),
        "bytes_read_per_row": round(res.bytes_read_per_row, 2),
        "elapsed_s": round(res.elapsed_s, 4),
        "blocks": res.blocks_total,
        "steady_state_compiles": steady_compiles,
        "warmup_rows_per_s": round(warm.rows_per_s, 2),
        "usd_per_corpus_sweep": round(
            BATCH_CORPUS_ROWS / max(res.rows_per_s, 1e-9) / 3600.0
            * BATCH_USD_PER_HOST_HOUR, 4,
        ),
        "usd_assumption": {
            "usd_per_host_hour": BATCH_USD_PER_HOST_HOUR,
            "corpus_rows": BATCH_CORPUS_ROWS,
        },
    }

    # -- arm 2: preempt → resume, shard files byte-identical -------------
    def _hashes(d):
        return {
            p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in pathlib.Path(d).glob("*.npy")
        }

    with tempfile.TemporaryDirectory() as td:
        ck_ref = os.path.join(td, "ref")
        ck_cut = os.path.join(td, "cut")
        ref = run_topk_campaign(engine, k, checkpoint_dir=ck_ref)
        ev["cut_at"] = cut_at = max(res.blocks_total // 2, 1)

        def _cut(done, total):
            if done == cut_at:
                preemption_handler.request("bench")

        ev["resumable"] = False
        try:
            run_topk_campaign(engine, k, checkpoint_dir=ck_cut,
                              on_block=_cut)
        except Preempted as e:
            ev["resumable"] = e.resumable
        finally:
            preemption_handler.reset()
        resumed = run_topk_campaign(engine, k, checkpoint_dir=ck_cut)
        ev["blocks_resumed"] = resumed.blocks_resumed
        ev["resume_identical"] = bool(
            _hashes(ck_cut) == _hashes(ck_ref)
            and np.array_equal(resumed.vals, ref.vals)
            and np.array_equal(resumed.idxs, ref.idxs)
        )
        out["resume"] = {
            "blocks_resumed": resumed.blocks_resumed,
            "blocks_total": resumed.blocks_total,
        }

    # -- arm 3: simjoin prune soundness + accounting ---------------------
    sj = run_simjoin_campaign(engine, tau, grouping="degree")
    scores = oracle.scores_rows(
        np.arange(engine.n), variant="rowsum"
    )
    iu = np.arange(engine.n)
    ii, jj = np.nonzero((scores >= tau) & (iu[:, None] < iu[None, :]))
    want = set(zip(ii.tolist(), jj.tolist()))
    got = set(zip(sj.rows.tolist(), sj.cols.tolist()))
    ev["simjoin_sound"] = got == want
    out["simjoin"] = {
        "pairs": int(sj.rows.shape[0]),
        "prune_ratio": round(sj.prune_ratio, 4),
        "block_pairs_pruned": sj.block_pairs_pruned,
        "block_pairs_total": sj.block_pairs_total,
        "rows_per_s": round(sj.rows_per_s, 2),
        "elapsed_s": round(sj.elapsed_s, 4),
    }

    # -- arm 4: 2-worker fleet fan-out, bit-parity vs single host --------
    services, sched = _batch_fleet(hin, metapath, workers=workers,
                                   backend=backend, platform=platform)
    try:
        fres = run_topk_campaign(engine, k, scheduler=sched)
    finally:
        sched.close()
        for svc in services:
            svc.close()
    ev["fleet_parity"] = bool(
        np.array_equal(fres.vals, res.vals)
        and np.array_equal(fres.idxs, res.idxs)
    )
    out["topk_fleet"] = {
        "workers": workers,
        "rows_per_s": round(fres.rows_per_s, 2),
        "elapsed_s": round(fres.elapsed_s, 4),
    }

    out["checks"] = batch_checks(ev)
    _write(out, out_path)
    return out


def batch_checks(ev: dict) -> dict:
    """The batch regime's six gates (see :func:`run_batch_smoke`), none
    of them the clock's, from the evidence ``run_batch_bench`` gathers
    (array comparisons done there, counts and flags here)."""
    return {
        "sampled_rows_bit_identical_to_oracle": ev["sample_parity"],
        "zero_steady_state_recompiles": ev["steady_compiles"] == 0,
        "resume_skips_completed_blocks": (
            ev["resumable"] and ev["blocks_resumed"] == ev["cut_at"]
        ),
        "resume_shards_byte_identical": ev["resume_identical"],
        "zero_pairs_dropped_by_pruning": ev["simjoin_sound"],
        "fleet_bit_identical_to_single_host": ev["fleet_parity"],
    }


def run_batch_smoke(out_path: str | None = None, backend: str = "torch",
                    platform: str = "cuda") -> dict:
    """The batch-campaign gate. Hard gates: sampled-row top-k
    bit-identical to the serving oracle, preempt → resume
    byte-identical shard files, zero pairs ≥ τ dropped by the simjoin
    certificates, zero steady-state recompiles, and fleet bit-parity —
    on a small fixed-seed corpus, both arms recorded."""
    result = run_batch_bench(**BATCH_SMOKE, out_path=None, backend=backend,
                             platform=platform)
    result["smoke_checks"] = result.pop("checks")
    _write(result, out_path)
    _require(result["smoke_checks"], "batch")
    return result


# ---------------------------------------------------------------------------
def main(argv: list[str] | None = None) -> int:
    import torch

    p = argparse.ArgumentParser(
        prog="python -m distributed_pathsim_tpu_torch.bench_serving",
        description=__doc__.splitlines()[0],
    )
    p.add_argument("--smoke", action="store_true",
                   help="small fixed run with hard pass/fail gates")
    p.add_argument("--regime", default="load", choices=REGIMES,
                   help="'load': the closed-loop QPS regimes; 'update': "
                   "delta-ingestion vs reload latency; 'obs': "
                   "observability overhead (obs on vs off, steady "
                   "state); 'router': multi-process QPS-vs-replicas "
                   "curve + mid-load worker-kill failover; 'ann': "
                   "exact-vs-ann closed-loop arms with measured recall@k "
                   "vs the exact oracle; 'fleet-obs': fleet "
                   "observability overhead arms (off / metrics / "
                   "stitched tracing / tail recording), with --smoke "
                   "the cross-process stitching smoke; 'partition': one "
                   "graph sharded over partition workers; 'metapath': "
                   "planner vs naive chain order + the mixed-metapath "
                   "memo workload; 'compress': the factor layouts' "
                   "resident bytes, max-N model and parity; "
                   "'firehose': sustained update stream x serving load "
                   "with background compaction, coalesced fleet updates "
                   "and the autoscale load step; 'batch': corpus-sweep "
                   "campaigns — top-k-all + threshold simjoin, "
                   "single-host and fleet arms, resume + parity gates; "
                   "'learned': exact-vs-ann-vs-learned closed-loop arms "
                   "with measured recall vs the exact oracle and the "
                   "cold-start exercise")
    p.add_argument("--deltas", type=int, default=10_000,
                   help="firehose regime: sustained updates in phase 1")
    p.add_argument("--replicas", default="1,2,4",
                   help="router and partition regimes: comma-separated "
                   "worker counts")
    p.add_argument("--edge-frac", type=float, default=0.01,
                   help="update regime: fraction of edges per Δ batch")
    p.add_argument("--reps", type=int, default=5,
                   help="update regime: measured update/reload pairs")
    p.add_argument("--headroom", type=float, default=0.25,
                   help="update regime: index-capacity reserve")
    p.add_argument("--authors", type=int, default=2048)
    p.add_argument("--papers", type=int, default=4096)
    p.add_argument("--venues", type=int, default=48)
    p.add_argument("--clients", type=int, default=32)
    p.add_argument("--queries-per-client", type=int, default=64)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--backend", default="torch",
                   help="the serving backend (the compress regime's arms "
                   "are torch-sparse whatever this says)")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="where every service and worker serves: the card "
                   "(default; exit 2 without one) or the host")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write the JSON here")
    args = p.parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        from .utils.logging import runtime_event

        runtime_event("bench_refused", reason="no CUDA device available; "
                      "pass --platform cpu to run on the host")
        return 2

    where = dict(backend=args.backend, platform=args.platform)
    graph = dict(n_authors=args.authors, n_papers=args.papers,
                 n_venues=args.venues)
    load = dict(clients=args.clients,
                queries_per_client=args.queries_per_client)
    batching = dict(max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
    counts = tuple(int(r) for r in args.replicas.split(",") if r.strip())
    smokes = {
        "load": run_smoke, "update": run_update_smoke, "obs": run_obs_smoke,
        "router": run_router_smoke, "ann": run_ann_smoke,
        "fleet-obs": run_fleet_obs_smoke,
        "partition": run_partition_smoke, "metapath": run_metapath_smoke,
        "compress": run_compress_smoke, "firehose": run_firehose_smoke,
        "batch": run_batch_smoke, "learned": run_learned_smoke,
    }
    benches = {
        "load": lambda: run_bench(**graph, **load, **batching, k=args.k,
                                  seed=args.seed, **where),
        "update": lambda: run_update_bench(
            **graph, edge_frac=args.edge_frac, reps=args.reps, k=args.k,
            headroom=args.headroom, seed=args.seed, **where),
        "obs": lambda: run_obs_bench(**graph, **load, **batching,
                                     reps=args.reps, k=args.k,
                                     seed=args.seed, **where),
        "router": lambda: run_router_bench(
            **graph, replicas=counts, **load, **batching, k=args.k,
            seed=args.seed, **where),
        "ann": lambda: run_ann_bench(
            **graph, **load, **batching, reps=args.reps, k=args.k,
            seed=args.seed, **where),
        "fleet-obs": lambda: run_fleet_obs_bench(
            **graph, **load, **batching, reps=args.reps, k=args.k,
            seed=args.seed, **where),
        "partition": lambda: run_partition_bench(
            **graph, partitions=counts, **load, k=args.k, seed=args.seed,
            deltas=args.reps, **where),
        "metapath": lambda: run_metapath_bench(
            **graph, **load, reps=args.reps, k=args.k, **batching,
            seed=args.seed, **where),
        "compress": lambda: run_compress_bench(
            **graph, k=args.k, deltas=args.reps, headroom=args.headroom,
            seed=args.seed, platform=args.platform),
        "firehose": lambda: run_firehose_bench(
            **graph, deltas=args.deltas, clients=args.clients, k=args.k,
            seed=args.seed, **where),
        "batch": lambda: run_batch_bench(
            **graph, k=args.k, seed=args.seed, **where),
        "learned": lambda: run_learned_bench(
            **graph, **load, **batching, reps=args.reps, k=args.k,
            seed=args.seed, **where),
    }
    if args.smoke:
        smoke_where = dict(where)
        if args.regime == "compress":
            smoke_where.pop("backend")
        result = smokes[args.regime](args.out, **smoke_where)
    else:
        result = benches[args.regime]()
    if args.platform == "cuda":
        result["device"] = card_device()
    _write(result, args.out)
    json.dump(result, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
