"""The port's closed-loop load generators for serving and the fleets.

    python -m distributed_pathsim_tpu_torch.bench_serving [--regime R] [--smoke]

The twin of the repository's ``bench_serving.py`` for the port: the same
regimes, function names, arguments, defaults, JSON keys and smoke
checks, with every service, worker and in-process fleet serving from
``--backend`` (default ``torch``) on ``--platform`` (default ``cuda``).
The numpy backend serves only as the f64 oracle the answers are held
against. Six regimes are here:

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
- **fleet-obs**: fleet observability overhead over in-process fleets,
  and (``--smoke``) cross-process trace stitching, the exact metrics
  merge, SLO burn and the flight recorder over worker processes;
- **partition**: one graph sharded over P partition workers: resident
  bytes per worker, the max-N model, routed deltas, trace stitching, a
  replica baseline and the kill ledger.

"Compiles" are the port's own (``utils/compile_counter``): kernel
builds and loads and CUDA-graph captures, counted in this process by
:class:`~.utils.compile_counter.CompileCounter` and in each worker by
the ``compiles`` field of its ``health`` answer.

``--smoke`` runs a regime's small fixed run and exits non-zero if any of
its ``smoke_checks`` fails. Three checks are decided by the clock
(:data:`CLOCK_CHECKS`); the rest are deterministic. The checks of each
regime are built by one function (``*_checks``), shared by the smoke
and the tests.

It needs a card unless ``--platform cpu`` is given: without one it
exits 2 and prints no result. On the card the JSON carries the card's
name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

from .router.loadgen import run_router_clients

REGIMES = ("load", "update", "obs", "router", "fleet-obs", "partition")

# The smoke checks the clock decides; every other check is
# deterministic (it holds on any machine, loaded or not).
CLOCK_CHECKS = {
    "load": ("warm_p50_lt_cold_p50",),
    "update": ("speedup_ge_10x",),
    "obs": ("overhead_under_1ms_per_request",),
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


def _create_backend(name: str, hin, mp, platform: str):
    """A backend of ``name`` over ``hin``; every backend but the numpy
    oracle on ``platform``."""
    from .backends.base import create_backend

    if name == "numpy":
        return create_backend(name, hin, mp)
    return create_backend(name, hin, mp, device=platform)


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
                   "curve + mid-load worker-kill failover; 'fleet-obs': "
                   "fleet observability overhead arms (off / metrics / "
                   "stitched tracing / tail recording), with --smoke "
                   "the cross-process stitching smoke; 'partition': one "
                   "graph sharded over partition workers")
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
    p.add_argument("--backend", default="torch")
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
        "router": run_router_smoke, "fleet-obs": run_fleet_obs_smoke,
        "partition": run_partition_smoke,
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
        "fleet-obs": lambda: run_fleet_obs_bench(
            **graph, **load, **batching, reps=args.reps, k=args.k,
            seed=args.seed, **where),
        "partition": lambda: run_partition_bench(
            **graph, partitions=counts, **load, k=args.k, seed=args.seed,
            deltas=args.reps, **where),
    }
    if args.smoke:
        result = smokes[args.regime](args.out, **where)
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
