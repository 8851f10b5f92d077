#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``distributed_pathsim_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py     # exit 0 only if every phase passes

Phases (each prints its lines; any failure raises, so the exit code is
nonzero and no result line is printed):

0. lint on the card, first, before anything touches the card: the
   port's static analyzer (``python3 -m distributed_pathsim_tpu_torch.cli
   lint --json``) in a child with its parse cache removed (cold) and
   again on the cache it wrote (warm), each with its files, findings
   (must be 0), baselined findings and wall seconds; then ``lint_main``
   in this process, whose JSON must equal the children's byte for byte,
   which must launch no kernel (``launches_lint`` in the kernels line)
   and after which ``torch.cuda.is_initialized()`` must still be False;
1. device and build: the card's name and power limit, the nvcc build of
   every kernel in ``distributed_pathsim_tpu_torch/csrc`` (all sources
   compiled in parallel, the native host libraries' g++ builds beside
   them) and the compiler's registers and spill bytes for each kernel
   instance;
2. every kernel against its plain torch version, zero tolerance
   (``torch.equal`` on values and indices), at small odd shapes, tie-heavy
   rows, zero-degree targets, wide contractions, a factor with 1-, 2- and
   3-limb rows (all four kernels multiply u8 limbs on the int8 tensor
   cores; K2 there also against the correctly rounded exact scores, since
   a 3-limb row's own count is past 2^24), K1 at several stripe widths,
   K4 past the k its lists keep in shared memory, and at the main path's
   shapes; a CUDA factor that is not integer counts must raise;
3. the main path through the port's CLI (``--platform cuda``) on
   synthetic GEXF files written by the port: rank-all at 32768 authors x
   45000 papers x 384 venues (seed 42) with ``--backend torch`` at k = 10
   (K1) and k = 20 (K4) checked bit for bit against the numpy f64
   oracle's counts, the same ranking through ``--backend torch-sparse``
   (K3) byte-identical to the ``torch`` one, single source with its log's
   line count, all-pairs at 8192 authors; then the dense backend's rect
   arm (K3) at the smallest author count past K1's candidate budget;
3b. the rest of the batch CLI on the bench graph: ``--loader native``
   timed against ``python`` (identical encoded graphs) and the native
   fold against the numpy join (identical COO); ``--dtype float64``
   single source and rank-all byte-identical to the f32 runs (K1 on the
   cast factor), and past 2^24 rank-all raising OverflowError on the
   card while rows stay exact f64; the ensemble ``--metapath APVPA,APA
   --weights 0.7,0.3 --top-k 10 --all-pairs`` at full width, spot rows
   of the combined scores equal to a host oracle; ``--metrics``,
   ``--trace-out``, ``--metrics-file`` and ``--profile-dir`` (the
   profiler trace names K1); a ``backend_init`` fault on torch-sparse
   degrading to torch on the card, a persistent torch failure exiting 1
   without numpy, ``tile_execute`` faults retried, SIGTERM mid-sweep →
   exit 75 → a resumed TSV cmp-identical; a tuning table for this card
   changing torch-sparse's tile height and a JAX-fingerprinted one
   falling back; 0 compiles; the launches of its CLI runs counted apart
   (``launches_batch_cli`` in the kernels line);
4. serving on the card: a warm ``PathSimService`` over the bench graph
   (headroom 0.25, max_batch 32) under cold, warm and mixed load from 32
   client threads x 64 ``topk`` (k = 10), every answer equal to the host
   f64 oracle, warm load all result-cache hits, p50/p95/p99 and QPS per
   regime from the service's own histograms, the layers of a served
   request from its tracer spans; one ``update`` (64 author_of edges
   added, 16 removed, 8 authors appended) taking the delta path, the
   patched C and row sums equal to a rebuild's, K1 (k = 10) and K4
   (k = 20) on the patched backend and K2 on an 8192-author backend
   patched the same way equal to rebuilt ones (each ranked before its
   patch, so stale u8 limbs would show), affected rows against the new
   oracle and unaffected ones still result-cache hits; 0 compiles from
   the end of warmup to the end of the phase; ``dpathsim-torch serve
   --platform cuda`` as a subprocess with a short JSONL script;
5. the router fleet on the card: two ``dpathsim-torch worker --platform
   cuda`` processes on the one card over the bench graph (headroom 0.25)
   behind an in-process port ``Router`` with ``RouterConfig`` defaults
   (hedge 100 ms, heartbeat 0.25 s): 32 client threads x 64 ``topk``
   (k = 10) with one worker SIGKILLed after a quarter of the answers —
   zero lost, every answer equal to the host f64 oracle, at least one
   failover, no other replica down, the heartbeat suspicions printed —
   then the respawn, a warm load, the serving phase's update broadcast
   and applied on both replicas on the delta path, the affected and
   appended rows against the new oracle with both replicas owning some,
   each worker's ``health`` compiles unchanged from the end of its warmup;
   QPS and p50/p95/p99 by outcome from the router's own histogram, the
   hedges, failovers, sheds and dispatches per worker, the fleet's cold
   QPS beside the single service's; ``dpathsim-torch router --workers 2
   --platform cuda`` as a subprocess with a short JSONL script;
5b. the rest of the serving lanes on the card: a service over the bench
   graph with 2048 topics (headroom 0.25, max_batch 32, compaction on with
   a chain of 8 and no cooldown) under 32 client threads sending ``topk``
   (k = 10) mixed over APVPA and the per-request metapaths APA and APTPA
   (each its own engine and lane, all sharing the sub-chain memo) while a
   firehose of 18 small updates lands: every update on the delta path, at
   least one chain-triggered background compaction mid-load, sampled
   answers of every lane, before and after the swaps, equal to the host
   f64 oracle of the graph they were admitted on; then a forced
   ``compact`` op through ``handle_request`` with the consistency token,
   the fingerprint and the result-cache entries unchanged, 2 or more
   compactions and none failed, 0 compiles from the end of warmup; K1
   (k = 10), K4 (k = 20) and K2 on the compacted (pow-2 re-padded)
   backend equal to a freshly built backend's and to the plain versions,
   K1 on the APTPA engine's factor equal to its plain version; the
   first-request latency of each engine, memo hits and misses, request
   p50/p99 by lane, each swap's build and pause, update ms before and
   after the first swap, K1's time on the factor before and after
   compaction, the phase's peak device memory; its launches are
   ``launches_serving_rest`` in the kernels line;
6. BASELINE config 5 on the card at full size: 1048576 authors x 5242880
   papers x 64 venues (seed 42), ``torch-sparse`` with tile_rows 8192 and
   ``--approx`` semantics, ``PathSimDriver.rank_all(k=10)`` with a
   checkpoint directory: K3 once per row tile, 3 seeded spot rows
   against host f64 arithmetic from the COO factor, K3 against its plain
   version on a 1024-row tile, its host set-up with the native fold
   beside the numpy join's (identical COO), a resumed rerun returning
   identical arrays, rank-all seconds, author-pairs/s, layer times and busy share,
   how many (row block, column subtile) pairs needed 1, 2, 3, 4, 6 or 9
   limb products, and K3's time at tile 0 (the Zipf head) and at a
   middle tile; the same backend behind a service, 64 requests, 3 rows
   within 1e-6 of host f64 arithmetic;
6b. compressed factors, the symmetric half-sweep and the batch tier:
   config 5's graph through ``torch-sparse`` with the ``blocked`` and
   ``bitpacked`` layouts (K3 once per row tile, rank-all values and
   indices equal to the COO run's; factor bytes, bytes/nnz, init and
   rank-all seconds per format); a bitpacked ``torch-sparse`` service
   beside a COO one at the bench shape (headroom 0.25), sampled answers
   equal to the host f64 oracle and to each other before and after the
   serving phase's update, K3 on both patched backends equal, and
   ``dpathsim-torch router --workers 1 --backend torch-sparse
   --factor-format bitpacked`` answering the same; the symmetric
   half-sweep (``topk_scores(symmetric=True)``, approx) on config 5's
   shape cut to 393216 authors against the full sweep (K3) by config 5's
   rule (values within 1e-6, the same columns where the k-th and
   (k+1)-th scores are further apart), seconds and ms per tile pair, a
   child process running it SIGTERMed mid-sweep (exit 75) and the resume
   from its ``sym_partials`` snapshot returning the same arrays;
   ``dpathsim-torch batch topk-all`` on the 8192-author graph
   bit-identical to the host f64 oracle for every row, the device share
   of its wall time (CUDA events over the block GEMMs); on the same graph
   ``--factor-format bitpacked`` and ``--workers 2`` with the bytes of
   the coo run, a SIGTERM mid-campaign (exit 75) and ``resume`` with
   sha256-identical ``--out`` and ``--emit-pairs``, ``simjoin`` at tau
   0.5 and 0.02 with degree and natural grouping the same pair set;
   every campaign's seconds and author-pairs/s,
   ``dpathsim_batch_score_backend_total`` on the card arm only; 0
   compiles; its launches are ``launches_packed_sym_batch`` in the
   kernels line;
6c. multi-device and partition mode: ``torch-sharded`` at the bench
   shape with D = 1, 2, 4 and 8 shards on the one card, values and
   indices equal to K1's ``backend.topk`` on both variants, D² K3
   launches a run (no fold), each D's wall time and K3's CUDA-event time
   over its steps (one card: the rotation moves no bytes, so nothing
   here measures NVLink); all-pairs at 8192 authors through the
   allgather and the ring strategies, M exact and its f32 scores equal
   to K2's; the CLI with ``--backend torch-sharded --n-devices 4``: the
   single-source log equal to ``--backend torch``'s outside the ``***``
   lines and the ranking cmp-identical, a child SIGTERMed mid-ring with
   ``--checkpoint-dir`` (exit 75) and the resume launching K3 only for
   the steps left, the ensemble ``--n-devices 4`` equal to the host
   ensemble (indices to a stable sort of the combined scores), a
   one-process rendezvous (``--coordinator-address``, ``--num-processes
   1``, ``--process-id 0``); a partition fleet of four port partition
   workers on the card (replication 2) behind an in-process
   ``PartitionRouter``: 32 clients x 64 ``topk`` (k = 10) with one worker
   SIGKILLed after a quarter of the answers, 0 lost and every answer
   equal to the host f64 oracle, one routed update (64 author_of edges
   added, 16 removed; a delta appending 8 authors is refused, as the JAX
   package refuses it) and the affected rows against the new oracle,
   QPS, p50/p95/p99 and update ms, worker compiles unchanged; its
   launches are ``launches_sharded_partition`` in the kernels line;
6d. the ANN tier at the bench shape (headroom 0.25): the centroid index
   built in-process (build seconds, K, cap, dim, packed bytes), saved
   and loaded (arrays and fingerprint equal),
   ``dpathsim-torch index probe --platform cuda``, the
   recall gate (mean score recall@10 >= 0.99 over 512 rows, the route on
   the card) on the struct map unprojected; for each probe variant
   (``rerank-all``, ``shortlist``) a ``topk_mode="ann"`` service at the
   default knobs loading the CLI's artifact under 32 client threads x 64
   ``topk`` (k = 10) on rows with d > 0: every answer the exact rerank of
   its candidates (each score the exact f64 score of its pair, the
   (descending score, ascending id) order, no rank above the oracle's),
   every answer that covers the oracle's set bit-identical to the host
   f64 oracle, the mean score recall@10 printed (shadow sampling off for
   the load), QPS and p50/p95/p99 beside the exact lane's on the same rows,
   the device route's cluster sets equal to ``route_batch_host``'s
   wherever the nprobe-th and (nprobe+1)-th similarities are more than
   1e-6 apart (the rows under that rule counted), the probe's CUDA-event
   ms per batch and ``dpathsim_ann_{probe,rerank}_seconds``; the serving
   phase's update (affected and appended rows answered exactly, counted
   ``stale`` or ``uncovered``), ``refresh_index`` through
   ``handle_request`` (stale_remaining 0, the index token the
   service's), answers after it checked as before, the shadow gate with
   every request sampled at its default floor (its state printed), then
   tripped on purpose (a recall floor above 1: every query then exact,
   counted ``low_confidence``); 0 compiles from
   the end of each service's warmup; ``dpathsim-torch router --workers 2
   --topk-mode ann --platform cuda`` as a subprocess with the artifact,
   its answers on rows the services covered equal to the oracle; its
   launches are ``launches_ann`` in the kernels line (the exact lane's
   own: the probe is torch ops, no kernel);
6e. the learned tier at the bench shape (headroom 0.25), served from the
   JAX-written tower artifact committed with the port
   (``distributed_pathsim_tpu_torch/learned/data/towers_bench_shape.npz``,
   keyed to the graph's fingerprint): a ``topk_mode="learned"`` service
   whose corpus embeddings sit on the card, 32 client threads x 64
   ``topk`` (k = 10) on the ANN phase's rows at the default knobs
   (shadow sampling off for the load): every answer the exact rerank of
   its candidates, every answer whose candidate set covers the host f64
   oracle's top-k bit-identical to the exact lane's answer on the same
   rows, the mean score recall@10 within 0.005 of the JAX package's on
   the same rows and towers, 0 compiles in the load, QPS and p50/p95/p99
   beside the exact lane's, the probe's CUDA-event ms at 32 rows beside
   the exact lane's gather + GEMM, the fetch and rerank p50s, and K1's
   rank-all of the served graph against the oracle's sets; each fallback
   counted (``degenerate``, ``uncovered``, ``metapath``,
   ``low_confidence``) and answered as the exact lane answers, the gate
   re-armed by ``refresh_towers``; a never-seen author appended by a
   delta, answered through ``stale`` before ``refresh_towers`` and
   through the towers after it, bit-identical both times, with the
   refresh re-embedding only the stale rows; a foreign artifact refused
   (``TowerMismatch``), and a learned-mode service given it distilling
   its own towers; ``dpathsim-torch serve`` and a two-worker
   ``router`` with ``--topk-mode learned --learned-checkpoint`` as
   subprocesses, their learned answers equal to the oracle; its
   launches are ``launches_learned`` in the kernels line (K1 once, for
   the rank-all; the probe is torch ops);
6f. the learned tier's training on the card: on a 2000-author graph a
   CPU model and a card model from one seed start from equal weights,
   mine equal lists, and agree over 5 steps from one pool (losses rtol
   1e-4, embeddings atol 1e-5), and two 200-step card runs are
   bit-identical; at the bench shape (headroom 0.25) mining 512 sources
   (k 32) on the card equals the CPU port's lists bit for bit (its ms
   printed), a window of train steps at the artifact's recipe gives the
   ms per step and the card's busy share with 0 compiles after the first
   (captured) steps; ``dpathsim-torch learned train`` as a subprocess at
   the committed artifact's recipe cut to a tenth of its steps (dim 32,
   hidden 64, 6000 of its 60000 steps, seed 0, 512 hard sources, k 32),
   its token the graph's fingerprint, its train_s and steps/s printed; a
   learned service on those card-trained towers under the learned
   phase's load (every covering answer bit-identical to the exact
   lane's, score recall@10 printed beside the full recipe's, QPS, 0
   compiles, K1's rank-all against the oracle's sets); a learned-mode service with no checkpoint distilling
   its towers at install (startup s; 256 learned queries, covering
   answers bit-identical) and ``dpathsim-torch serve --topk-mode learned
   --learned-steps 200`` as a subprocess answering with no checkpoint;
   ``neural_cli train --mine 64`` on the card on a written GEXF, its
   ``query --index rerank`` answers equal to the host f64 oracle where
   they cover it, ``index build --embedding learned --model`` and
   ``index probe`` on the card; its launches are ``launches_train`` in
   the kernels line (K1 once, for the rank-all; the train step and
   mining are torch ops);
6g. tuning on the card: K1 and K3 against their plain versions
   (``torch.equal``) at every stripe width the ``twopass_stripe_tiles``
   and ``rect_target_units`` knobs can hand them, on a 6000-row factor
   with 1-, 2- and 3-limb rows; ``dpathsim-torch tune --knobs
   twopass_stripe_tiles,rect_target_units,sparse_tile_rows,ring_kernel,
   serve_buckets`` in a child process at the bench shape and a 131072 x
   64 sparse point (2 rounds): exit 0, every entry keyed with the card's
   name, K1 and K3 launched, no plain version (nor the ring's torch fold)
   called with a CUDA tensor; the main path's rank-all under the table it
   wrote cmp-identical to the untuned ranking, K1 at the tuned width (the
   width and the lookup counts printed); a 512-author service under the
   table with hit lookups, its answers equal to the host f64 oracle and 0
   compiles after warmup, no plain version on the card there either; K1
   at the bench shape and K3's tile sweeps (the bench factor, the sparse
   point) at the tuned setting against the default, in turns; its
   launches are ``launches_tune`` and its times ``tuned`` in the kernels
   line;
6h. the bench twins on the card: the port's ``bench_serving`` smokes of
   the load, update, obs, router, fleet-obs and partition regimes (every
   service, worker and in-process fleet ``--backend torch --platform
   cuda``), each with every check true, the three the clock decides
   included (warm p50 under cold p50, update at least 10x faster than
   reload, full tracing under 1 ms a request); ``run_bench`` at its
   defaults (2048 x 4096 x 48, 32 clients x 64 queries, max_batch 32):
   serial, cold, warm and mixed QPS and p50/p95/p99, nothing shed; the
   update smoke's run is ``run_update_bench`` at its defaults (edge_frac
   0.01, 5 reps), update against reload ms; ``bench_backends``' tiers
   ``torch``, ``torch-sparse`` and ``torch-sharded`` (D = 2 on the one
   card) at the bench shape, k = 10, each JSON line with pairs/s > 0 and
   a ranking equal to K1's, the sharded line with the ring step's K3 ms;
   the launches of this process in the phase are ``launches_bench`` in
   the kernels line (the workers' launches are in their own processes);
6i. the tier twins on the card: the port's ``bench_serving`` smokes of
   the ann, firehose, metapath, compress and batch regimes (every
   service, in-process fleet and backend ``torch``, the compress arms
   ``torch-sparse``, on the card; the metapath ordering phase host numpy
   f64 as the repository harness runs it), each with every check true,
   the clock's included (firehose's update-visible and pause bounds,
   metapath's measured planner-vs-naive); the learned bench at the
   learned smoke's arguments with every check true but
   ``recall_ge_0_99`` (``CARD_EXEMPT_CHECKS``: the towers are distilled
   from the port's own initial weights), its recall printed beside the
   JAX run's 0.972917; per regime its wall and figures (recall and QPS
   per arm, the staleness and cold-start exercises, update-visible p99,
   compactions and their pause, broadcasts against updates, autoscale
   ticks, planner against naive ms, the memo uplift, factor bytes and
   ``torch.cuda.memory_allocated`` per layout, rows/s and the share of
   block GEMMs on the card, the prune ratio); the launches of this
   process in the phase are ``launches_bench_tiers`` in the kernels line;
7. times on the card (CUDA events, median of 7 after 2 warm-ups): each
   kernel, its plain version, a library yardstick that the port never
   calls, the least time the card could take (bound), K1 at several
   stripe widths, and the rank-all wall time as author-pairs/s with its
   per-layer breakdown.

The kernels' launch counters are zeroed before each main-path run (the
serving phase's included) and read after it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Nothing here imports JAX.
"""

from __future__ import annotations

import collections
import filecmp
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parent

# The rank-all shape of the repository's benchmark (bench.py): APVPA over
# 32768 authors, 45000 papers, 384 venues, top-10, seed 42.
N_AUTHORS, N_PAPERS, N_VENUES, TOP_K, SEED = 32768, 45_000, 384, 10, 42
# All-pairs runs at 8192 authors: the host copy of a 32768² f32 score
# matrix would be 4 GB per copy.
N_AUTHORS_ALL_PAIRS = 8192
# k of the CLI run that takes the single-pass kernel K4 (k > 16).
TOP_K_FOLD = 20
# BASELINE.json config 5 (scripts/scale_config5.py's defaults): APVPA,
# top-10, approx (its counts pass 2^24 by construction), 8192-row tiles.
C5_AUTHORS, C5_PAPERS, C5_VENUES, C5_TILE_ROWS = 1_048_576, 5_242_880, 64, 8192
C5_SPOT_SEED, C5_SPOT_ROWS, C5_ATOL = 7, 3, 1e-6

# Published H100 SXM peaks (NVIDIA data sheet): u8 x u8 on the int8 tensor
# cores (all four kernels multiply exact u8 limbs there; never TF32), f32
# on the CUDA cores (the bound the kernels had before), HBM3 bandwidth.
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# The serving phase: the bench graph with serve's default capacity
# headroom, 32 client threads x 64 topk requests per load regime; one
# update of 64 author_of edges added, 16 removed and 8 authors appended;
# 64 requests against the config 5 backend.
SERVE_HEADROOM, SERVE_MAX_BATCH = 0.25, 32
SERVE_CLIENTS, SERVE_PER_CLIENT = 32, 64
UPDATE_ADDS, UPDATE_REMOVES, UPDATE_APPENDS = 64, 16, 8
C5_SERVE_REQUESTS = 64
# The ANN tier: the serving phase's graph, headroom, load and update, once
# per probe variant at the default knobs; the score-recall floor of the
# JAX package's ann gate held on ANN_FULL_ROWS rows of the same graph
# with the struct map unprojected (the default max_dim of 1024 projects
# its 12 x 480-wide map, and the recall follows the projection).
ANN_VARIANTS = ("rerank-all", "shortlist")
ANN_RECALL_FLOOR = 0.99
ANN_FULL_ROWS = 512
# The learned tier: the serving phase's graph and headroom, towers from the
# JAX-written artifact committed with the port (made on the CPU by
# `PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_learned_checkpoint.py
# make`: the JAX package's trainer on this graph, 60000 steps, dim 32,
# hidden 64, seed 0), the ANN phase's rows and load at the default knobs
# (cand_mult 16; shadow sampling off for the load). LEARNED_JAX_RECALL is
# the JAX package's mean score recall@10 over the same rows with the same
# artifact and knobs, measured on the CPU by `... recall` (the same
# script); the port's must land within LEARNED_RECALL_TOL of it. The
# metapath fallback asks APA: the bench graph has no topics for APTPA.
LEARNED_ARTIFACT = (HERE / "distributed_pathsim_tpu_torch" / "learned"
                    / "data" / "towers_bench_shape.npz")
LEARNED_JAX_RECALL = 0.836474609375
LEARNED_RECALL_TOL = 0.005
LEARNED_OTHER_METAPATH = "APA"
LEARNED_RETRAIN_STEPS = 50
# The learned tier's training (phase 6f): card against CPU on a small graph
# (5 steps at batch 256, two 200-step card runs); mining and the committed
# artifact's recipe at the bench shape with serve's headroom, `learned
# train` as a subprocess (TRAIN_RECIPE, the trainer's batch of 512 pairs,
# cut to TRAIN_CLI_STEPS of the recipe's steps to make room for phase 6i);
# a window of TRAIN_WINDOW steps for the step time and the busy share; the
# card-trained towers served on the learned phase's rows, their recall
# printed beside TRAINED_FULL_RECIPE_RECALL, the recall of towers trained
# at the full recipe on an NVIDIA H100 80GB HBM3 at 700 W (no floor: the
# cut towers are not the recipe's); in-service
# distillation at the default learned_steps with DISTILL_QUERIES queries.
TRAIN_SMALL = dict(n_authors=2000, n_papers=3000, n_venues=64, seed=11)
TRAIN_SMALL_MODEL = dict(dim=32, hidden=64, seed=5)
TRAIN_REPEAT_STEPS = 200
TRAIN_RECIPE = dict(dim=32, hidden=64, steps=60000, seed=0, hard_sources=512,
                    hard_k=32)
TRAIN_CLI_STEPS = 6000
TRAINED_FULL_RECIPE_RECALL = 0.82251
TRAIN_BATCH, TRAIN_WINDOW = 512, 2000
DISTILL_QUERIES = 256
NEURAL_CLI_ROWS = 3
# The router fleet: two workers on the one card over the bench graph
# (author ids materialized, so the update's appended authors can be
# named on the wire), the serving phase's load and update.
ROUTER_SPEC = (f"synthetic:authors={N_AUTHORS},papers={N_PAPERS},"
               f"venues={N_VENUES},seed={SEED},ids=1")

# The rest of the serving lanes: the bench graph with topics (its own
# graph), headroom 0.25, max_batch 32, compaction on with a chain of 8 and
# no cooldown; 32 client threads sending topk (k = 10) mixed over the
# three metapaths while a firehose of small updates lands (each one
# author appended and wired to 3 papers, 6 author_of edges added between
# existing nodes, 2 removed), then one forced compact op.
SR_TOPICS, SR_TOPICS_PER_PAPER = 2048, 1.4
SR_LANES = ("APVPA", "APA", "APTPA")
SR_CHAIN_LEN, SR_UPDATES, SR_UPDATE_GAP_S = 8, 18, 0.12
SR_CLIENTS, SR_MIN_PER_CLIENT = 32, 24
SR_APPENDS, SR_ADDS, SR_REMOVES = 1, 6, 2
SR_SAMPLES_PER_VERSION = 4

# Compressed factors, the symmetric half-sweep and the batch tier: config
# 5's graph through the packed layouts; a bitpacked service and router at
# the bench shape under the serving phase's update (PK_SERVE_SAMPLES rows
# sampled before it); the symmetric half-sweep on config 5's shape cut to
# SYM_AUTHORS authors (3/8 of config 5, cut from 3/4 to make room for the
# learned tier's training phase: ~10.7 ms a tile pair on an H100 80GB
# HBM3 at 700 W puts its 1176 pairs near 13 s; papers cut with them;
# 64 venues, 8192-row tiles and approx kept), SIGTERMed after
# SYM_KILL_AFTER row units; the first batch campaign on the bench graph,
# the others on the 8192-author all-pairs graph (a campaign is host-bound:
# 47-63 s at the bench shape, ~3 s there, on that card's host), one of
# them SIGTERMed after BATCH_KILL_AFTER blocks of
# BATCH_KILL_BLOCK_ROWS rows; simjoin at each of BATCH_TAUS (0.5 finds no
# pair on that graph, 0.02 finds some).
PACKED_FORMATS = ("blocked", "bitpacked")
PK_SERVE_SAMPLES = 64
SYM_AUTHORS = 393_216
SYM_PAPERS = SYM_AUTHORS * (C5_PAPERS // C5_AUTHORS)
SYM_KILL_AFTER = 8
BATCH_TAUS, BATCH_KILL_AFTER, BATCH_KILL_BLOCK_ROWS = (0.5, 0.02), 40, 32

REPS, WARMUP = 7, 2
# K1's stripe widths timed beside the default (column tiles of 128).
STRIPE_SWEEP = (8, 32, 64)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(torch, fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_s(torch, fn, reps: int = 5):
    """Host wall times of ``fn`` (each ending in a synchronize), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def device_busy_share(torch, fn, reps: int = 3):
    """Share of the wall time of ``reps`` calls of ``fn`` in which the
    card ran a kernel (the union of the device events' intervals in a
    torch.profiler trace), or None when the trace holds no device
    event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return busy_us / 1e6 / wall if spans else None


def scores_flops(n: int, v: int) -> float:
    """f32 FLOP the score function needs: S is symmetric, so only the
    n (n + 1) / 2 upper-triangle dot products of 2 v FLOP each. The
    kernels compute every tile, 2 n² v."""
    return float(n) * (n + 1) * v


def bound(ops: float, nbytes: float,
          peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """The least time (ms) for ``ops`` operations at ``peak`` per second
    and ``nbytes`` at the HBM rate, and which of the two bounds it."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def u8_square_ops(counts, v):
    """u8 operations of the symmetric score function on the int8 tensor
    cores: the n (n + 1) / 2 upper-triangle pairs (i, j), each l_i l_j
    limb products of 2 v operations."""
    s1 = float(counts.sum())
    s2 = float((counts * counts).sum())
    return v * (s1 * s1 + s2)


def max_abs_err(torch, got, want) -> float:
    """Largest |got - want| over entries finite in both; inf entries
    must coincide (checked by the caller's torch.equal)."""
    fin = torch.isfinite(got) & torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0
    return float((got[fin].double() - want[fin].double()).abs().max())


# -- phases -----------------------------------------------------------------


def gpu_state() -> str:
    """The card's SM clock, power draw and temperature (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def lint_phase(torch, ck):
    """Phase 0: the static analyzer over the checkout, cold and warm in
    children, then in this process with the kernels' counters zeroed.
    Returns the launches of the in-process run."""
    import contextlib
    import io

    from distributed_pathsim_tpu_torch.analysis.cache import CACHE_REL
    from distributed_pathsim_tpu_torch.analysis.cli import lint_main

    phase("lint on the card (before anything touches the card)")
    if torch.cuda.is_initialized():
        raise AssertionError("CUDA is initialized before the lint phase")
    (HERE / CACHE_REL).unlink(missing_ok=True)
    outputs = []
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli",
             "lint", "--json"],
            cwd=str(HERE), capture_output=True, text=True, timeout=300,
        )
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"lint ({label}) exited {proc.returncode}: "
                                 f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        doc = json.loads(proc.stdout)
        print(f"lint {label}: files {doc['files']}, findings "
              f"{len(doc['findings'])}, suppressed {len(doc['suppressed'])}, "
              f"{dt:.3f} s (the child's wall time, interpreter start and "
              "imports included)")
        if doc["findings"]:
            raise AssertionError(f"lint ({label}) findings: "
                                 f"{doc['findings'][:3]}")
        outputs.append(proc.stdout)
    if outputs[0] != outputs[1]:
        raise AssertionError("the warm lint's JSON differs from the cold one")
    ck.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = lint_main(["--json"])
    dt = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    same = buf.getvalue() == outputs[0]
    if rc != 0 or not same:
        raise AssertionError(f"in-process lint: rc {rc}, JSON "
                             f"{'equal to' if same else 'unlike'} the "
                             "children's")
    if torch.cuda.is_initialized():
        raise AssertionError("lint_main created a CUDA context")
    if any(launches.values()):
        raise AssertionError(f"lint launched kernels: {launches}")
    print(f"lint in-process (warm cache): rc 0, {dt:.3f} s, JSON "
          "byte-identical to the children's, torch.cuda.is_initialized() "
          f"False, launches {launches}")
    return launches


def device_and_build(torch, ck):
    import threading

    from distributed_pathsim_tpu_torch.native import build as native_build

    phase("device and build")
    # the host libraries (g++) build beside the kernels (nvcc)
    native = {}

    def build_native():
        t0 = time.perf_counter()
        native.update({lib: native_build.shared_lib(lib)
                       for lib in ("gexf_fast", "coo_fast")})
        native["seconds"] = time.perf_counter() - t0

    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    reports = ck.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(reports) or 'already built'})")
    native_thread.join()
    if None in native.values():
        raise AssertionError(f"native host libraries did not build: {native}")
    print(f"native host libraries (g++, beside nvcc): "
          f"{native.pop('seconds'):.1f} s "
          f"({', '.join(p.name for p in native.values())})")
    instances = {kname: kernel_instances(text)
                 for kname, text in reports.items()}
    for kname, insts in instances.items():
        for inst, (regs, spill) in insts.items():
            print(f"  {kname}: {inst}: {regs} registers, {spill} bytes "
                  "spill stores + loads")
    return name, smi, instances


def kernel_instances(report: str) -> dict:
    """Each kernel instance's registers and spill bytes (stores + loads)
    from nvcc's ``-Xptxas -v`` report, keyed by the instance's name with
    its template flags (``topk_fold_kernel<1,0>``)."""
    import re

    out, current, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Function properties for (_Z\w+)", line)
        if m:
            name = re.search(r"pathsim\d+(\w+?)I", m.group(1))
            flags = re.findall(r"Lb([01])E", m.group(1))
            current = (f"{name.group(1) if name else m.group(1)}"
                       f"<{','.join(flags)}>")
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out[current] = (int(m.group(1)), spill)
            current = None
    return out


def check_topk(torch, ck, c, d, k, mask_self, label, stripe_tiles=None,
               limbs=None):
    """K1 (stripe candidates and the final top-k) against the plain
    versions; ``limbs`` the factor split beforehand, as the backend hands
    it over."""
    cv, cc = ck.topk_twopass_candidates(c, d, k, mask_self, limbs=limbs,
                                        stripe_tiles=stripe_tiles)
    pv, pc = ck.topk_twopass_candidates_plain(c, d, k, mask_self,
                                              stripe_tiles=stripe_tiles)
    torch.cuda.synchronize()
    if not (torch.equal(cv, pv) and torch.equal(cc, pc)):
        bad = (cv != pv) | (cc != pc)
        raise AssertionError(
            f"K1 candidates differ from the plain version ({label}, k={k}, "
            f"mask_self={mask_self}, stripe_tiles={stripe_tiles}): "
            f"{int(bad.sum())} entries"
        )
    fv, fc = ck.fused_topk_twopass(c, d, k=k, mask_self=mask_self,
                                   limbs=limbs)
    gv, gc = ck.fused_topk_twopass_plain(c, d, k=k, mask_self=mask_self)
    if not (torch.equal(fv, gv) and torch.equal(fc, gc)):
        raise AssertionError(
            f"K1 top-k differs from the plain version ({label}, k={k}, "
            f"mask_self={mask_self})"
        )
    return max_abs_err(torch, fv, gv)


def check_scores(torch, ck, c, d, label, limbs=None):
    """K2 against the correctly rounded scores of the exact integer
    counts everywhere (f64 sums of integer products are exact below
    2^53), and equal to the plain version wherever the counts are exact
    in f32 (below 2^24: every entry of an exact-count factor)."""
    got = ck.fused_scores(c, d, limbs=limbs)
    want = ck.fused_scores_plain(c, d)
    m = c.double() @ c.double().T
    den = d[:, None] + d[None, :]
    exact = torch.where(den > 0, (2.0 * m.float()) / den, 0.0)
    f32_exact = m < 2**24
    torch.cuda.synchronize()
    if not (torch.equal(got, exact)
            and torch.equal(got[f32_exact], want[f32_exact])):
        diff = (got - exact).abs().max()
        raise AssertionError(
            f"K2 differs from the exact scores or the plain version "
            f"({label}): max |diff| {diff}"
        )
    return max_abs_err(torch, got, want)


def check_rect(torch, ck, c, d, r0, t, k, label, stripe_tiles=None,
               pad_cols=3):
    """K3 (stripe candidates and the final top-k) against the plain
    versions for rows r0 .. r0+t-1 against every column, the last
    ``pad_cols`` columns as padding (n_true_cols = n - pad_cols)."""
    n = c.shape[0]
    n_true = n - pad_cols
    ids = torch.arange(n, dtype=torch.int32, device=c.device)
    args = (c[r0:r0 + t], c, d[r0:r0 + t], d, ids[r0:r0 + t], k)
    cv, cc = ck.topk_rect_candidates(*args, n_true, stripe_tiles)
    pv, pc = ck.topk_rect_candidates_plain(*args, n_true, stripe_tiles)
    torch.cuda.synchronize()
    if not (torch.equal(cv, pv) and torch.equal(cc, pc)):
        bad = (cv != pv) | (cc != pc)
        raise AssertionError(
            f"K3 candidates differ from the plain version ({label}, k={k}, "
            f"stripe_tiles={stripe_tiles}): {int(bad.sum())} entries"
        )
    fv, fc = ck.fused_topk_twopass_rect(*args, n_true_cols=n_true)
    gv, gc = ck.fused_topk_twopass_rect_plain(*args, n_true_cols=n_true)
    if not (torch.equal(fv, gv) and torch.equal(fc, gc)):
        raise AssertionError(
            f"K3 top-k differs from the plain version ({label}, k={k})"
        )
    return max_abs_err(torch, fv, gv)


def check_fold(torch, ck, c, d, k, mask_self, label):
    """K4 against its plain version."""
    fv, fc = ck.fused_topk(c, d, k=k, mask_self=mask_self)
    gv, gc = ck.fused_topk_plain(c, d, k=k, mask_self=mask_self)
    torch.cuda.synchronize()
    if not (torch.equal(fv, gv) and torch.equal(fc, gc)):
        bad = (fv != gv) | (fc != gc)
        raise AssertionError(
            f"K4 differs from the plain version ({label}, k={k}, "
            f"mask_self={mask_self}): {int(bad.sum())} entries"
        )
    return max_abs_err(torch, fv, gv)


def check_k3_k4(torch, ck, c, d, label, masks=(True, False)):
    """K3 at k in {1, 10, 15} (all rows with the default stripes; an odd
    row tile with 4-tile stripes) and K4 at k in {1, 16, 17, 40} and one
    past the k its lists keep in shared memory, with the self mask each
    of ``masks`` ways."""
    n = c.shape[0]
    r0, t = n // 5, n // 3 + 7
    for k in (1, 10, 15):
        check_rect(torch, ck, c, d, 0, n, k, label)
        check_rect(torch, ck, c, d, r0, t, k, label, stripe_tiles=4)
    for k in (1, 16, 17, 40, ck.FOLD_SMEM_K_MAX + 1):
        for mask_self in masks:
            check_fold(torch, ck, c, d, k, mask_self, label)


def multilimb_factor(torch, np, device, n=1500, v=96, seed=5):
    """An integer factor with 1-, 2- and 3-limb rows whose path counts
    between distinct rows stay below 2^24 (so the plain f32 product is
    exact there; a 3-limb row's own count is past it, so the checks mask
    the self pair): random 0..3 entries, and 12 rows with one entry of
    300-850 (2 limbs) or past 65536 (3 limbs), each in its own column,
    where every other row holds at most 1. Some tile pairs are narrow
    (one s32 sum) and some not (the f64 fold): 65536^2 · 96 >= 2^31."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, (n, v)).astype(np.float64)
    c[rng.random((n, v)) < 0.5] = 0
    big_cols = rng.choice(v, 12, replace=False)
    c[:, big_cols] = np.minimum(c[:, big_cols], 1)
    rows = rng.choice(n, 12, replace=False)
    for i, (r, col) in enumerate(zip(rows, big_cols)):
        c[r, col] = (65536 + 17 * i) if i < 4 else (300 + 50 * i)
    d = c @ c.sum(0)
    m = c @ c.T
    np.fill_diagonal(m, 0)
    assert m.max() < 2**24
    return (torch.tensor(c, dtype=torch.float32, device=device),
            torch.tensor(d, dtype=torch.float32, device=device))


def factor(hin, spec, device):
    """Dense f32 half factor and row-sum denominators of ``spec``."""
    import numpy as np

    from distributed_pathsim_tpu_torch.data.encode import factor_from_arrays
    from distributed_pathsim_tpu_torch.ops import planner
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    mp = compile_metapath(spec, hin.schema)
    c = planner.dense_half(hin, mp, dtype=np.float64)
    return factor_from_arrays(c, c @ c.sum(0), device)


def kernel_checks(torch, ck, np, synthetic_hin):
    phase("kernels against plain versions (zero tolerance)")
    dev = torch.device("cuda")
    hin = synthetic_hin(3001, 4500, 64, seed=SEED)
    c, d = factor(hin, "APVPA", dev)
    for k in (1, 10, 16):
        for mask_self in (True, False):
            check_topk(torch, ck, c, d, k, mask_self, "APVPA 3001x64")
    for stripe_tiles in (1, 3):
        check_topk(torch, ck, c, d, 10, True, "APVPA 3001x64", stripe_tiles)
    check_scores(torch, ck, c, d, "APVPA 3001x64")
    print("K1/K2 narrow (APVPA, n=3001, v=64, k in 1/10/16, both masks; K1 "
          "also with stripes of 1 and 3 tiles besides the default "
          f"{ck.twopass_stripe_tiles(*c.shape, 10, dev)}): equal")
    check_k3_k4(torch, ck, c, d, "APVPA 3001x64")
    print("K3/K4 narrow (APVPA, n=3001, v=64; K3 k in 1/10/15, all rows with "
          "the default stripes and an odd row tile with 4-tile stripes; K4 k "
          "in 1/16/17/40, both masks): equal")

    cm, dm = multilimb_factor(torch, np, dev)
    lim = ck.split_limbs(cm)
    counts = lim.counts.long()
    if not ck._needs_wide(lim, lim):
        raise AssertionError("the multi-limb factor does not take the "
                             "kernels' wide instances")
    for k in (1, 10, 16):
        check_topk(torch, ck, cm, dm, k, True, "multi-limb", limbs=lim)
    check_topk(torch, ck, cm, dm, 10, True, "multi-limb", stripe_tiles=1)
    check_scores(torch, ck, cm, dm, "multi-limb", limbs=lim)
    check_scores(torch, ck, cm, dm, "multi-limb")
    check_k3_k4(torch, ck, cm, dm, "multi-limb", masks=(True,))
    print(f"K1/K2/K3/K4 multi-limb factor, wide instances (n={cm.shape[0]}, "
          f"v={cm.shape[1]}, rows of 1/2/3 limbs: "
          f"{[int((counts == i).sum()) for i in (1, 2, 3)]}; K1 k in "
          "1/10/16 and 1-tile stripes, self masked; K2 also equal to the "
          "correctly rounded exact scores on the diagonal, past 2^24; K4 "
          f"also at k={ck.FOLD_SMEM_K_MAX + 1}, lists in device memory): "
          "equal")
    bad = torch.full((4, 4), 0.5, device=dev)
    one = torch.ones(4, device=dev)
    for label, call in (
            ("K1", lambda: ck.fused_topk_twopass(bad, one, k=2)),
            ("K2", lambda: ck.fused_scores(bad, one)),
            ("K4", lambda: ck.fused_topk(bad, one, k=2))):
        try:
            call()
        except ValueError as exc:
            print(f"{label}: a CUDA factor holding 0.5 raises ValueError: "
                  f"{exc}")
        else:
            raise AssertionError(f"{label} took a factor holding 0.5")

    cw, dw = factor(hin, "APA", dev)  # v = #papers: 282 K steps of 16
    for mask_self in (True, False):
        check_topk(torch, ck, cw, dw, 10, mask_self, "APA wide")
    check_scores(torch, ck, cw, dw, "APA wide")
    print(f"K1/K2 wide (APA, n=3001, v={cw.shape[1]}): equal")
    check_k3_k4(torch, ck, cw, dw, "APA wide")
    print(f"K3/K4 wide (APA, n=3001, v={cw.shape[1]}): equal")

    rng = np.random.default_rng(SEED)
    base = rng.integers(0, 3, size=(40, 24))
    rows = base[rng.integers(0, 40, size=1537)].astype(np.float64)
    rows[rng.integers(0, 1537, size=200)] = 0.0  # zero-degree targets
    ct = torch.tensor(rows, dtype=torch.float32, device=dev)
    dt = ct @ ct.sum(0)
    for k in (1, 10, 16):
        for mask_self in (True, False):
            check_topk(torch, ck, ct, dt, k, mask_self, "ties")
    check_scores(torch, ck, ct, dt, "ties")
    print("K1/K2 tie-heavy rows + zero-degree targets (n=1537): equal")
    check_k3_k4(torch, ck, ct, dt, "ties")
    print("K3/K4 tie-heavy rows + zero-degree targets (n=1537): equal")


def oracle_rows_match(np, got, ids, d, pairwise_row, k, rows, label):
    """Check ranking rows bit for bit: the f32 scores renormalized from
    the f64 oracle's exact integer counts (row sums ``d``,
    ``pairwise_row(r)``), ordered (desc score, asc column), and within
    1e-6 of the f64 scores. ``got`` maps a source id to its [(target id,
    score)] ranking."""
    d32 = d.astype(np.float32)
    for row in rows:
        m = pairwise_row(row)
        den = d32[row] + d32
        s32 = np.where(den > 0, np.float32(2.0) * m.astype(np.float32)
                       / np.where(den > 0, den, np.float32(1.0)),
                       np.float32(0.0))
        s32[row] = -np.inf
        order = np.argsort(-s32, kind="stable")[:k]
        want = [(ids[j], float(s32[j])) for j in order]
        if got[ids[row]] != want:
            raise AssertionError(f"{label}: row {row} differs from the oracle")
        s64 = np.where(d[row] + d > 0,
                       2.0 * m / np.maximum(d[row] + d, 1), 0.0)
        s64[row] = -np.inf
        np.testing.assert_allclose(
            [v for _, v in got[ids[row]]], np.sort(s64)[::-1][:k], atol=1e-6,
        )


def read_ranking(path):
    got: dict[str, list[tuple[str, float]]] = {}
    with open(path, encoding="utf-8") as f:
        next(f)
        for line in f:
            s, _, t, v = line.rstrip("\n").split("\t")
            got.setdefault(s, []).append((t, float(v)))
    return got


def counted(torch, ck, launches, fn, label):
    """Run one main-path step with the launch counters zeroed before it
    and read after it; adds them to ``launches``."""
    ck.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(ck.LAUNCHES)
    for name, cnt in counts.items():
        launches[name] += cnt
    print(f"{label}: {dt:.2f} s, launches {counts}")
    return out, counts, dt


def main_path(torch, ck, np, workdir):
    """The CLI runs of the main path, then the bench-shape backend built
    once more through the engine with a StageTimer (the bootstrap's
    layer times). Returns the graphs, the launches per kernel and that
    backend."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.cli import main as cli_main
    from distributed_pathsim_tpu_torch.config import RunConfig
    from distributed_pathsim_tpu_torch.data.synthetic import (
        synthetic_hin,
        write_gexf,
    )
    from distributed_pathsim_tpu_torch.engine import build_backend
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.utils.profiling import StageTimer

    phase("main path through the CLI")
    launches = {name: 0 for name in ck.LAUNCHES}

    def run_cli(argv, label):
        rc, counts, dt = counted(torch, ck, launches,
                                 lambda: cli_main(argv), label)
        if rc != 0:
            raise AssertionError(f"{label}: CLI exited {rc}")
        return counts, dt

    hin = synthetic_hin(N_AUTHORS, N_PAPERS, N_VENUES, seed=SEED,
                        materialize_ids=True)
    gexf = workdir / "bench.gexf"
    write_gexf(hin, str(gexf))
    ranking = workdir / "ranking.tsv"
    common = ["--dataset", str(gexf), "--platform", "cuda",
              "--backend", "torch", "--quiet"]
    counts, _ = run_cli(
        common + ["--top-k", str(TOP_K), "--ranking-out", str(ranking)],
        f"rank-all {N_AUTHORS}x{N_PAPERS}x{N_VENUES} k={TOP_K}",
    )
    if counts["topk_twopass_candidates"] < 1:
        raise AssertionError("rank-all did not launch K1")

    # Check rows of the TSV bit for bit: f32 scores renormalized from the
    # numpy f64 oracle's exact integer counts, (desc score, asc column).
    oracle = create_backend("numpy", hin, compile_metapath("APVPA", hin.schema))
    got = read_ranking(ranking)
    if len(got) != N_AUTHORS:
        raise AssertionError(f"ranking has {len(got)} sources")
    ids = hin.indices["author"].ids
    d = oracle.global_walks()
    oracle_rows_match(np, got, ids, d, oracle.pairwise_row, TOP_K,
                      (0, 7, 12345, N_AUTHORS - 1), "rank-all k=10")
    print("rank-all rows 0/7/12345/32767: bit-identical to the f32 "
          "renormalization of the f64 oracle's counts")

    sparse_ranking = workdir / "ranking_sparse.tsv"
    counts, _ = run_cli(
        ["--dataset", str(gexf), "--platform", "cuda", "--backend",
         "torch-sparse", "--quiet", "--top-k", str(TOP_K), "--ranking-out",
         str(sparse_ranking)],
        f"rank-all torch-sparse k={TOP_K}",
    )
    tiles = -(-N_AUTHORS // 4096)  # the backend's default tile_rows
    if counts["topk_rect_candidates"] != tiles:
        raise AssertionError(
            f"torch-sparse launched K3 {counts['topk_rect_candidates']} "
            f"times for {tiles} row tiles")
    if not filecmp.cmp(ranking, sparse_ranking, shallow=False):
        raise AssertionError("torch-sparse ranking differs from torch's")
    print("torch-sparse ranking: cmp-identical to the torch ranking")

    ranking20 = workdir / "ranking20.tsv"
    counts, _ = run_cli(
        common + ["--top-k", str(TOP_K_FOLD), "--ranking-out",
                  str(ranking20)],
        f"rank-all k={TOP_K_FOLD}",
    )
    if counts["topk_fold"] < 1:
        raise AssertionError(f"rank-all k={TOP_K_FOLD} did not launch K4")
    oracle_rows_match(np, read_ranking(ranking20), ids, d,
                      oracle.pairwise_row, TOP_K_FOLD,
                      (0, 7, 12345, N_AUTHORS - 1), f"rank-all k={TOP_K_FOLD}")
    print(f"rank-all k={TOP_K_FOLD} rows 0/7/12345/32767: bit-identical to "
          "the f32 renormalization of the f64 oracle's counts")

    log = workdir / "single.log"
    run_cli(common + ["--source", ids[7], "--output", str(log)],
            f"single source {ids[7]}")
    with open(log, encoding="utf-8") as f:
        n_lines = sum(1 for _ in f)
    want_lines = 1 + 5 * (N_AUTHORS - 1) + 1
    if n_lines != want_lines:
        raise AssertionError(f"log has {n_lines} lines, want {want_lines}")
    print(f"single-source log: {n_lines} lines (1 + 5*(N-1) + 1)")

    hin_ap = synthetic_hin(N_AUTHORS_ALL_PAIRS, N_PAPERS, N_VENUES, seed=SEED,
                           materialize_ids=True)
    gexf_ap = workdir / "allpairs.gexf"
    write_gexf(hin_ap, str(gexf_ap))
    counts, _ = run_cli(
        ["--dataset", str(gexf_ap), "--platform", "cuda", "--backend",
         "torch", "--all-pairs"],
        f"all-pairs {N_AUTHORS_ALL_PAIRS} authors",
    )
    if counts["fused_scores"] < 1:
        raise AssertionError("all-pairs did not launch K2")

    timer = StageTimer(device="cuda")
    _, _, backend = build_backend(
        RunConfig(dataset=str(gexf), platform="cuda"), timer=timer
    )
    with timer.stage("first_topk"):  # includes the scatter-build of C
        backend.topk(k=TOP_K)
    print("bootstrap at the rank-all shape (StageTimer, s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in timer.summary().items()))
    dense_rect_arm(torch, ck, np, launches)
    return hin, hin_ap, launches, backend


# -- batch CLI, the rest ------------------------------------------------------


def _same_hin(a, b) -> bool:
    """Two encoded graphs with the same index spaces and COO blocks."""
    if list(a.indices) != list(b.indices) or list(a.blocks) != list(b.blocks):
        return False
    for t in a.indices:
        if (a.indices[t].ids != b.indices[t].ids
                or a.indices[t].labels != b.indices[t].labels):
            return False
    for r in a.blocks:
        x, y = a.blocks[r], b.blocks[r]
        if (x.shape != y.shape or x.rows.dtype != y.rows.dtype
                or not (x.rows == y.rows).all()
                or not (x.cols == y.cols).all()):
            return False
    return True


def _same_coo(a, b) -> bool:
    return (tuple(a.shape) == tuple(b.shape)
            and a.rows.dtype == b.rows.dtype
            and all((getattr(a, f) == getattr(b, f)).all()
                    for f in ("rows", "cols", "weights")))


def numpy_fold(planner, coo_native, hin, mp):
    """The half-chain fold through the numpy join (the native SpGEMM
    switched off for the call)."""
    real = coo_native.available
    coo_native.available = lambda: False
    try:
        return planner.fold_half(hin, mp)
    finally:
        coo_native.available = real


def grammar(path):
    with open(path, encoding="utf-8") as f:
        return [line for line in f if not line.startswith("***")]


def events(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def fma_chain_np(np, parts, weights):
    """The ensemble's combination in numpy: acc = fl32(acc + s_r·w_r)
    rounded once per step (an f64 sum rounded to odd, then to f32)."""
    acc = np.zeros_like(parts[0], dtype=np.float32)
    for s, w in zip(parts, weights):
        a = acc.astype(np.float64)
        p = s.astype(np.float64) * float(np.float32(w))
        hi = a + p
        bb = hi - a
        lo = (a - (hi - bb)) + (p - bb)
        even = (hi.view(np.int64) & 1) == 0
        fix = (lo != 0) & even
        hi[fix] = np.nextafter(hi[fix], np.where(lo[fix] > 0, np.inf, -np.inf))
        acc = hi.astype(np.float32)
    return acc


def ensemble_oracle_rows(np, hin, specs, weights, rows):
    """Each spot row's combined ensemble scores from host arithmetic on
    the COO factors (scipy): exact f64 counts and row sums, the f32
    score 2m/(d_i+d_j) correctly rounded, the weighted f32 FMA chain."""
    import scipy.sparse as ssp

    from distributed_pathsim_tpu_torch.ops import planner
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    parts = []
    for spec in specs:
        c = planner.fold_half(hin, compile_metapath(spec, hin.schema)).summed()
        cs = ssp.csr_matrix((c.weights, (c.rows, c.cols)), shape=c.shape)
        d = np.asarray(cs @ np.asarray(cs.sum(0)).ravel()).ravel()
        m = np.asarray((cs[rows] @ cs.T).todense())  # [len(rows), N]
        d32 = d.astype(np.float32)
        den = d32[rows][:, None] + d32[None, :]
        parts.append(np.where(
            den > 0, (np.float32(2.0) * m.astype(np.float32))
            / np.where(den > 0, den, np.float32(1.0)), np.float32(0.0)))
    return fma_chain_np(np, parts, weights)


def batch_cli_rest(torch, ck, np, workdir, card, hin):
    """The rest of the batch CLI on the card over the bench graph: the
    native loader and fold, ``--dtype float64``, the multi-metapath
    ensemble, the observability flags, the degradation chain, the
    streaming sweep's retries and SIGTERM resume, and tuning dispatch.
    Returns the kernel launches of its CLI runs."""
    import os
    import signal

    from distributed_pathsim_tpu_torch import tuning
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.cli import main as cli_main
    from distributed_pathsim_tpu_torch.config import RunConfig
    from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
    from distributed_pathsim_tpu_torch.driver import PathSimDriver
    from distributed_pathsim_tpu_torch.engine import build_backend, load_dataset
    from distributed_pathsim_tpu_torch.models.multipath import (
        MultiMetapathScorer,
    )
    from distributed_pathsim_tpu_torch.native import coo_native
    from distributed_pathsim_tpu_torch.ops import planner
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.resilience import inject
    from distributed_pathsim_tpu_torch.utils.compile_counter import (
        CompileCounter,
    )

    phase("batch CLI, the rest: native loader and fold, float64, ensemble, "
          "observability, degradation, sweep resilience, tuning")
    t_phase = time.perf_counter()
    launches = {name: 0 for name in ck.LAUNCHES}
    gexf = str(workdir / "bench.gexf")
    ranking = workdir / "ranking.tsv"
    ids = hin.indices["author"].ids
    src = ids[7]

    def run_cli(argv, label, env=None, want_rc=0):
        old = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        inject.reset()
        try:
            rc, counts, dt = counted(torch, ck, launches,
                                     lambda: cli_main(argv), label)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            inject.reset()
        if rc != want_rc:
            raise AssertionError(f"{label}: CLI exited {rc}, want {want_rc}")
        return counts, dt

    common = ["--dataset", gexf, "--platform", "cuda", "--quiet"]
    with CompileCounter() as compiles:
        # -- loader and fold
        t0 = time.perf_counter()
        h_native = load_dataset(gexf, use_native=True)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        h_python = load_dataset(gexf, use_native=False)
        python_s = time.perf_counter() - t0
        if not _same_hin(h_native, h_python):
            raise AssertionError("native and python loaders differ")
        mp = compile_metapath("APVPA", h_native.schema)
        t0 = time.perf_counter()
        f_native = planner.fold_half(h_native, mp)
        fold_native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        f_numpy = numpy_fold(planner, coo_native, h_native, mp)
        fold_numpy_s = time.perf_counter() - t0
        if not _same_coo(f_native, f_numpy):
            raise AssertionError("native fold differs from the numpy join")
        print(f"bench GEXF load: --loader native {native_s:.3f} s, python "
              f"{python_s:.3f} s (encoded graphs identical); APVPA fold: "
              f"native {fold_native_s:.3f} s, numpy join {fold_numpy_s:.3f} s "
              f"(COO identical, nnz {f_native.rows.shape[0]}) on {card}")

        # -- float64: the log and ranking of the f32 run, the kernels
        log64 = workdir / "single64.log"
        run_cli(common + ["--dtype", "float64", "--source", src, "--top-k",
                          str(TOP_K), "--output", str(log64)],
                f"float64 single source {src}")
        if grammar(log64) != grammar(workdir / "single.log"):
            raise AssertionError("float64 log differs from the f32 log")
        tsv64 = workdir / "ranking64.tsv"
        counts, _ = run_cli(common + ["--dtype", "float64", "--top-k",
                                      str(TOP_K), "--ranking-out", str(tsv64)],
                            f"float64 rank-all k={TOP_K}")
        if counts["topk_twopass_candidates"] < 1:
            raise AssertionError("float64 rank-all did not launch K1")
        if not filecmp.cmp(tsv64, ranking, shallow=False):
            raise AssertionError("float64 ranking differs from the f32 one")
        big = synthetic_hin(1500, 40_000, 3, seed=1)
        bmp = compile_metapath("APVPA", big.schema)
        b64 = create_backend("torch", big, bmp, dtype=torch.float64,
                             device="cuda")
        for fn in (lambda: b64.topk(k=TOP_K), b64.all_pairs_scores):
            try:
                fn()
            except OverflowError as exc:
                if "--approx" not in str(exc):
                    raise
            else:
                raise AssertionError("float64 rank-all past 2^24 did not "
                                     "raise OverflowError on the card")
        c = planner.fold_half(big, bmp).summed()
        c64 = np.zeros(c.shape)
        np.add.at(c64, (c.rows, c.cols), c.weights)
        d64 = c64 @ c64.sum(0)
        if not (np.array_equal(b64.global_walks(), d64)
                and np.array_equal(b64.pairwise_row(11), c64 @ c64[11])):
            raise AssertionError("float64 rows past 2^24 are not exact")
        print(f"float64: log and ranking identical to the f32 run's; past "
              f"2^24 (max row sum {d64.max():.4g}) rank-all and all-pairs "
              "raise OverflowError naming --approx, row sums and "
              "single-source rows exact in f64")

        # -- the multi-metapath ensemble at full width
        specs, weights = ("APVPA", "APA"), (0.7, 0.3)
        _, ens_s = run_cli(
            common + ["--metapath", ",".join(specs), "--weights",
                           ",".join(map(str, weights)), "--top-k",
                           str(TOP_K), "--all-pairs"],
            f"ensemble {','.join(specs)} top-k + all-pairs")
        scorer = MultiMetapathScorer(h_native, list(specs), device="cuda")
        comb = scorer.combined_scores(list(weights))
        rows = [0, 7, 12345, N_AUTHORS - 1]
        want = ensemble_oracle_rows(np, h_native, specs, weights, rows)
        for i, r in enumerate(rows):
            got_row, want_row = comb[r].copy(), want[i].copy()
            got_row[r] = want_row[r] = -np.inf
            if not np.array_equal(got_row, want_row):
                raise AssertionError(f"ensemble row {r} differs from the "
                                     "host oracle")
            top = np.sort(got_row)[::-1][:TOP_K]
            if not np.array_equal(top, np.sort(want_row)[::-1][:TOP_K]):
                raise AssertionError(f"ensemble top-{TOP_K} of row {r}")
        del comb, scorer
        torch.cuda.empty_cache()
        print(f"ensemble {specs} weights {weights}: CLI top-{TOP_K} + "
              f"all-pairs {ens_s:.2f} s on {card}; rows {rows} equal to the "
              "host oracle (exact f64 counts, f32 scores, f32 FMA chain)")

        # -- observability (--trace-out turns tracing on for the process;
        # the switch is put back after)
        from distributed_pathsim_tpu_torch import obs

        tracing = obs.get_tracer().enabled
        obs_dir = workdir / "obs"
        obs_dir.mkdir()
        run_cli(common + ["--source", src, "--output",
                          str(obs_dir / "s.log"),
                          "--metrics", str(obs_dir / "m.jsonl"),
                          "--trace-out", str(obs_dir / "t.json"),
                          "--metrics-file", str(obs_dir / "m.prom")],
                "observability: single source")
        names = [e["event"] for e in events(obs_dir / "m.jsonl")]
        if "source_global_walk" not in names or "stage_time" not in names:
            raise AssertionError(f"metrics JSONL events {names}")
        spans = {e["name"]: e for e in json.loads(
            (obs_dir / "t.json").read_text())["traceEvents"]
            if e.get("ph") == "X"}
        root = spans["driver.run_single_source"]
        for stage in ("device_denominators", "device_pairwise_row",
                      "emit_log"):
            s = spans[f"stage:{stage}"]
            if not (root["ts"] <= s["ts"]
                    and s["ts"] + s["dur"] <= root["ts"] + root["dur"]):
                raise AssertionError(f"stage:{stage} outside the root span")
        obs.configure(tracing=tracing)
        prom = (obs_dir / "m.prom").read_text()
        if "dpathsim_stage_seconds" not in prom:
            raise AssertionError("metrics file lacks the stage histogram")
        run_cli(common + ["--top-k", str(TOP_K), "--profile-dir",
                          str(obs_dir / "prof")],
                "observability: rank-all under --profile-dir")
        prof = json.loads((obs_dir / "prof" / "trace.json").read_text())
        k1 = [e for e in prof["traceEvents"]
              if "topk_twopass_kernel" in str(e.get("name", ""))]
        if not k1:
            raise AssertionError("the profiler trace does not name K1")
        print(f"observability: metrics JSONL {len(names)} events, trace "
              f"{len(spans)} spans with stage:* under "
              "driver.run_single_source, Prometheus textfile parsed; "
              f"profiler trace names K1 ({len(k1)} events, "
              f"{sum(e.get('dur', 0) for e in k1) / 1e3:.3f} ms)")

        # -- degradation, sweep retries
        deg = workdir / "degrade"
        deg.mkdir()
        run_cli(common + ["--backend", "torch-sparse", "--top-k", str(TOP_K),
                          "--ranking-out", str(deg / "r.tsv"), "--metrics",
                          str(deg / "m.jsonl")],
                "backend_init fault on torch-sparse",
                env={"PATHSIM_FAULT_PLAN": "backend_init:error:3",
                     "PATHSIM_RETRY_BASE_DELAY": "0"})
        steps = [(e["from_"], e["to"], e["platform"])
                 for e in events(deg / "m.jsonl") if e["event"] == "degrade"]
        if steps != [("torch-sparse", "torch", "cuda")]:
            raise AssertionError(f"degrade steps {steps}")
        if not filecmp.cmp(deg / "r.tsv", ranking, shallow=False):
            raise AssertionError("the degraded ranking differs")
        proc = subprocess.run(
            [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli",
             "--dataset", str(workdir / "allpairs.gexf"), "--platform",
             "cuda", "--top-k", str(TOP_K), "--quiet"],
            capture_output=True, text=True, timeout=300, cwd=str(HERE),
            env={**os.environ, "PATHSIM_FAULT_PLAN": "backend_init:error:100",
                 "PATHSIM_RETRY_BASE_DELAY": "0"})
        if proc.returncode != 1 or "[pathsim:degrade]" in proc.stderr:
            raise AssertionError(
                f"persistent torch failure: rc {proc.returncode}, "
                f"stderr tail {proc.stderr[-400:]}")
        counts, _ = run_cli(
            common + ["--backend", "torch-sparse", "--top-k", str(TOP_K),
                      "--ranking-out", str(deg / "r2.tsv"), "--metrics",
                      str(deg / "m2.jsonl")],
            "tile_execute fault on torch-sparse",
            env={"PATHSIM_FAULT_PLAN": "tile_execute:error:2",
                 "PATHSIM_RETRY_BASE_DELAY": "0"})
        retries = [e for e in events(deg / "m2.jsonl")
                   if e["event"] == "retry"]
        if (len(retries) != 2 or counts["topk_rect_candidates"] != 8
                or not filecmp.cmp(deg / "r2.tsv", ranking, shallow=False)):
            raise AssertionError("tile_execute retries")
        print("degradation: backend_init faults on torch-sparse -> torch on "
              "the card (event + same ranking); persistent torch failure "
              "exits 1, numpy never built; 2 tile_execute faults retried, "
              "ranking cmp-identical")

        # -- SIGTERM mid-sweep, exit 75, resume
        ck_dir = workdir / "sigterm_ckpt"
        sweep = ["--dataset", gexf, "--platform", "cuda", "--quiet",
                 "--backend", "torch-sparse", "--top-k", str(TOP_K),
                 "--tile-rows", "1024", "--checkpoint-dir", str(ck_dir),
                 "--ranking-out", str(workdir / "resumed.tsv")]
        proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli",
             *sweep], cwd=str(HERE), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True,
            env={**os.environ,
                 "PATHSIM_FAULT_PLAN": "tile_execute:delay:1000:0.2"})
        manifest = ck_dir / "manifest.json"
        try:
            deadline = time.time() + 240
            while time.time() < deadline and proc.poll() is None:
                if manifest.exists() and sum(
                        k.startswith("topk10_rowtile_")
                        for k in json.loads(manifest.read_text())) >= 2:
                    break
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            _, err = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        done = sum(k.startswith("topk10_rowtile_")
                   for k in json.loads(manifest.read_text()))
        if proc.returncode != 75 or not 2 <= done < N_AUTHORS // 1024:
            raise AssertionError(f"SIGTERM run: rc {proc.returncode}, "
                                 f"{done} tiles saved; {err[-400:]}")
        counts, _ = run_cli(sweep, "resume after SIGTERM")
        if counts["topk_rect_candidates"] != N_AUTHORS // 1024 - done:
            raise AssertionError("the resumed sweep redid saved tiles")
        if not filecmp.cmp(workdir / "resumed.tsv", ranking, shallow=False):
            raise AssertionError("resumed ranking differs")
        print(f"SIGTERM mid-sweep: exit 75 with {done} of "
              f"{N_AUTHORS // 1024} row tiles saved; the rerun launched K3 "
              f"{counts['topk_rect_candidates']} times and wrote a TSV "
              "cmp-identical to the uninterrupted ranking")

        # -- tuning dispatch
        coo = f_native
        table = tuning.TuningTable(torch.cuda.get_device_name(0))
        table.put(tuning.make_key(
            "sparse_tile_rows", torch.cuda.get_device_name(0),
            n=coo.shape[0], v=coo.shape[1], nnz=int(coo.rows.shape[0]),
            dtype="float32"), 8192)
        path = str(workdir / "tuning.json")
        table.save(path)
        before = tuning.lookup_stats().get("hit", 0)
        _, _, tuned = build_backend(RunConfig(
            dataset=gexf, backend="torch-sparse", platform="cuda",
            tuning_table=path))
        hits = tuning.lookup_stats().get("hit", 0) - before
        ck.reset_launches()
        tv, _ = PathSimDriver(tuned).rank_all(k=TOP_K)
        if (hits < 1 or tuned.tiled.tile_rows != 8192
                or ck.LAUNCHES["topk_rect_candidates"] != N_AUTHORS // 8192):
            raise AssertionError("the tuned tile height was not taken")
        del tuned
        # a table as the JAX package writes it: a jax version, no torch one
        jax_doc = table.to_json()
        del jax_doc["torch_version"]
        jax_doc["jax_version"] = "0.4"
        jpath = workdir / "jax_table.json"
        jpath.write_text(json.dumps(jax_doc))
        fallbacks = tuning.lookup_stats().get("fallback", 0)
        tuning.reset()
        if tuning.install_table(str(jpath)) or tuning.install_table(
                str(jpath)):
            raise AssertionError("a JAX-fingerprinted table was installed")
        if tuning.lookup_stats().get("fallback", 0) - fallbacks != 2:
            raise AssertionError("no tuning_fallback for the JAX table")
        tuning.reset()
        print(f"tuning: a table for {torch.cuda.get_device_name(0)} "
              f"(sparse_tile_rows 8192 at the bench key) hit {hits}x, 8192-row "
              f"tiles, K3 launched {N_AUTHORS // 8192}x; a JAX-fingerprinted "
              "table falls back to heuristics (tuning_fallback)")
    if compiles.count:
        raise AssertionError(f"{compiles.count} compiles in the phase: "
                             f"{compiles.by_kind}")
    print(f"batch CLI phase: {time.perf_counter() - t_phase:.1f} s, 0 kernel "
          f"builds or loads, CLI launches {launches}")
    return launches


def uniform_hin(n_authors, n_papers, n_venues, seed):
    """A DBLP-shaped graph without the Zipf head: each paper has one
    author and one venue, both drawn uniformly, so row sums stay far
    below 2^24 at a few hundred thousand authors (counts stay exact)."""
    import numpy as np

    from distributed_pathsim_tpu_torch.data.encode import (
        encoded_hin_from_arrays,
    )

    rng = np.random.default_rng(seed)
    papers = np.arange(n_papers, dtype=np.int32)
    return encoded_hin_from_arrays({
        "name": f"uniform_a{n_authors}_p{n_papers}_v{n_venues}",
        "node_types": ["author", "paper", "venue"],
        "relations": {"author_of": ("author", "paper"),
                      "submit_at": ("paper", "venue")},
        "types": {"author": {"size": n_authors}, "paper": {"size": n_papers},
                  "venue": {"size": n_venues}},
        "blocks": {
            "author_of": {
                "relationship": "author_of", "src_type": "author",
                "dst_type": "paper",
                "rows": rng.integers(0, n_authors, n_papers), "cols": papers,
                "shape": (n_authors, n_papers),
            },
            "submit_at": {
                "relationship": "submit_at", "src_type": "paper",
                "dst_type": "venue", "rows": papers,
                "cols": rng.integers(0, n_venues, n_papers),
                "shape": (n_papers, n_venues),
            },
        },
    })


def smallest_past_twopass(ck, k, device, v) -> int:
    """The smallest row count whose K1 candidate buffer exceeds its
    budget on ``device`` for a factor V wide
    (cuda_kernels.candidate_bytes)."""
    lo, hi = 1, 1 << 22
    while lo < hi:
        mid = (lo + hi) // 2
        if ck.twopass_fits(mid, k, device, v):
            lo = mid + 1
        else:
            hi = mid
    return lo


def dense_rect_arm(torch, ck, np, launches):
    """backend.topk on the dense ``torch`` backend just past K1's
    candidate budget: K3 over row tiles, and K1 not at all."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    phase("dense backend past K1's candidate budget (the rect arm)")
    dev = torch.device("cuda")
    n = smallest_past_twopass(ck, TOP_K, dev, 64)
    hin = uniform_hin(n, 2 * n, 64, SEED)
    mp = compile_metapath("APVPA", hin.schema)
    backend = create_backend("torch", hin, mp)
    (vals, idxs), counts, _ = counted(
        torch, ck, launches, lambda: backend.topk(k=TOP_K),
        f"dense topk at n={n} (candidate buffer "
        f"{ck.candidate_bytes(n, TOP_K, 64, dev)} > budget "
        f"{ck.candidate_budget_bytes(dev)} bytes) k={TOP_K}",
    )
    if counts["topk_rect_candidates"] < 1 or counts["topk_twopass_candidates"]:
        raise AssertionError(f"the rect arm did not run K3 alone: {counts}")
    oracle = create_backend("numpy", hin, mp)
    d = oracle.global_walks()
    if d.max() >= 2**24:
        raise AssertionError("the rect-arm graph's row sums pass 2^24")
    rows = (0, 1, n // 2, n - 1)
    ids = [str(i) for i in range(n)]
    got = {ids[r]: [(ids[int(j)], float(v)) for v, j in zip(vals[r], idxs[r])]
           for r in rows}
    oracle_rows_match(np, got, ids, d, oracle.pairwise_row, TOP_K, rows,
                      "dense rect arm")
    print(f"dense rect arm rows {rows}: bit-identical to the f32 "
          "renormalization of the f64 oracle's counts")


def rect_bounds(rows, cols, t, n, v, k, n_stripes):
    """K3's least times on this tile's data. At the int8 tensor cores'
    rate: 2 v u8 operations for each of the l_i l_j limb products of
    every (row, column) pair (a row tile against every column has no
    symmetry), or the bytes: both factors' limb planes and denominators
    read once, the row ids, the candidates written. Beside it, the f32
    CUDA-core bound of 2 t n v FLOP the kernel had before."""
    ops = 2.0 * v * float(rows.counts.long().sum()) * float(
        cols.counts.long().sum())
    out = 8.0 * t * n_stripes * k
    int8 = bound(ops, rows.planes.numel() + cols.planes.numel()
                 + 4.0 * (2 * t + n) + out, PEAK_INT8_OPS)
    f32 = bound(2.0 * t * n * v,
                4.0 * (t * v + n * v + 2 * t + n) + out)
    return int8, f32


def products_histogram(torch, lim, v_pad):
    """How many (128-row block, 64-column subtile) pairs of a rank-all
    over the factor ``lim`` need 1, 2, 3, 4, 6 or 9 limb products, and
    how many of them fold through f64 (v_pad · largest row entry ·
    largest column entry >= 2^31) rather than one s32 sum."""
    rb = torch.nn.functional.pad(lim.rmax.long(), (0, -lim.rmax.shape[0] % 128))
    rb = rb.view(-1, 128).amax(1)
    sub = lim.sub.long()

    def limbs(m):
        return 1 + (m >= 256).long() + (m >= 65536).long()

    lr, lc = limbs(rb), limbs(sub)
    hist = {}
    for a in (1, 2, 3):
        for b in (1, 2, 3):
            pairs = int((lr == a).sum()) * int((lc == b).sum())
            hist[a * b] = hist.get(a * b, 0) + pairs
    # pairs past the s32 bound: for each row block, the subtiles whose
    # largest entry reaches (2^31 - 1) // (v_pad · its largest) + 1
    cut = torch.div(2**31 - 1, v_pad * rb.clamp(min=1), rounding_mode="floor") + 1
    sub_sorted = torch.sort(sub).values
    wide = int((sub.numel() - torch.searchsorted(sub_sorted, cut)).sum())
    return {p: c for p, c in sorted(hist.items()) if c}, wide


def tiles_device_s(torch, ck, sparse, cc, dc, lim, n, T, tiles):
    """Device seconds of every row tile's K3 and pass 2, launched back to
    back with CUDA events around each (read after one synchronize)."""
    marks = []
    for i in range(tiles):
        i0 = i * T
        ids = torch.arange(i0, i0 + T, dtype=torch.int32, device=cc.device)
        a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        a.record()
        cv, cand = ck.topk_rect_candidates(cc[i0:i0 + T], cc, dc[i0:i0 + T],
                                           dc, ids, TOP_K, n,
                                           limbs=(lim.rows(i0, i0 + T), lim))
        b.record()
        sparse.chunked_row_topk(cv.view(T, -1), cand.view(T, -1), TOP_K)
        c.record()
        marks.append((a, b, c))
    torch.cuda.synchronize()
    return (sum(a.elapsed_time(b) for a, b, _ in marks) / 1e3,
            sum(b.elapsed_time(c) for _, b, c in marks) / 1e3)


def c5_folds(np, hin, mp, backend, graph_s, init_s, card):
    """Config 5's host set-up: the half-chain fold through the native
    SpGEMM (what the backend's init ran) beside the numpy join, both
    identical to the backend's factor."""
    from distributed_pathsim_tpu_torch.native import coo_native
    from distributed_pathsim_tpu_torch.ops import planner

    t0 = time.perf_counter()
    native = planner.fold_half(hin, mp)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    joined = numpy_fold(planner, coo_native, hin, mp)
    numpy_s = time.perf_counter() - t0
    if not (_same_coo(native, joined) and _same_coo(native, backend._c)):
        raise AssertionError("config 5: native fold differs from the numpy "
                             "join")
    print(f"config 5 host set-up on {card}: synthetic graph {graph_s:.3f} s, "
          f"backend init {init_s:.3f} s (its fold native); fold alone: "
          f"native {native_s:.3f} s, numpy join {numpy_s:.3f} s (COO "
          f"identical, nnz {native.rows.shape[0]})")


def config5(torch, ck, np, launches, workdir, card):
    """BASELINE config 5 through torch-sparse on the card. Returns K3's
    numbers at its row tile (the kernels line) and the graph with its COO
    rank-all (the packed arms are held against it)."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
    from distributed_pathsim_tpu_torch.driver import PathSimDriver
    from distributed_pathsim_tpu_torch.ops import sparse
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    phase(f"config 5: {C5_AUTHORS} authors x {C5_PAPERS} papers x "
          f"{C5_VENUES} venues through torch-sparse")
    t0 = time.perf_counter()
    hin = synthetic_hin(C5_AUTHORS, C5_PAPERS, C5_VENUES, seed=SEED)
    graph_s = time.perf_counter() - t0
    mp = compile_metapath("APVPA", hin.schema)

    def make():
        return create_backend("torch-sparse", hin, mp,
                              tile_rows=C5_TILE_ROWS, exact_counts=False)

    t0 = time.perf_counter()
    backend = make()
    init_s = time.perf_counter() - t0
    n, v = backend.n, backend.tiled.v
    c5_folds(np, hin, mp, backend, graph_s, init_s, card)
    tiles = backend._n_live_tiles
    ckdir = str(workdir / "config5_ckpt")
    (vals, idxs), counts, rank_s = counted(
        torch, ck, launches,
        lambda: PathSimDriver(backend).rank_all(k=TOP_K, checkpoint_dir=ckdir),
        f"config 5 rank_all k={TOP_K}",
    )
    if counts["topk_rect_candidates"] != tiles:
        raise AssertionError(
            f"K3 launched {counts['topk_rect_candidates']} times for "
            f"{tiles} row tiles")
    if backend._run_config(TOP_K)["compute_path"] != "rect":
        raise AssertionError("config 5 did not run the rect arm")
    if vals.shape != (n, TOP_K) or not np.isfinite(vals).all():
        raise AssertionError("config 5 result is not [N, k] finite scores")
    pairs = float(n) * (n - 1)
    print(f"config 5 rank-all: {rank_s:.3f} s ({tiles} row tiles of "
          f"{C5_TILE_ROWS}) -> {pairs / rank_s:.4g} author-pairs/s on "
          f"{card}; set-up: synthetic graph {graph_s:.1f} s, backend init "
          f"(host fold + COO tiling) {init_s:.1f} s")

    # Spot rows against host f64 arithmetic from the COO factor.
    coo = backend._c
    c64 = np.zeros(coo.shape, dtype=np.float64)
    np.add.at(c64, (coo.rows, coo.cols), coo.weights)
    d64 = c64 @ c64.sum(0)
    rng = np.random.default_rng(C5_SPOT_SEED)
    spot = [int(r) for r in rng.integers(0, n, size=C5_SPOT_ROWS)]
    for r in spot:
        m = c64 @ c64[r]
        den = d64[r] + d64
        s64 = np.where(den > 0, 2.0 * m / np.where(den > 0, den, 1.0), 0.0)
        s64[r] = -np.inf
        expect = np.sort(s64)[::-1][:TOP_K]
        np.testing.assert_allclose(vals[r], expect, atol=C5_ATOL,
                                   err_msg=f"config 5 spot row {r}")
        np.testing.assert_allclose(s64[idxs[r]], expect, atol=C5_ATOL,
                                   err_msg=f"config 5 spot row {r} columns")
    print(f"config 5 spot rows {spot}: within {C5_ATOL} of host f64 "
          "arithmetic from the COO factor (values and chosen columns)")
    serve_config5(np, backend, c64, d64, card)
    del c64, d64

    # K3 against its plain version on one 1024-row tile at full N. The
    # counts pass 2^24 here, so sums in another order round differently:
    # values within 1e-6, columns equal where the k-th and (k+1)-th
    # plain values are further apart than that.
    _, cc, dc, lim = backend._rect_factor
    r0 = n // 2
    ids = torch.arange(r0, r0 + 1024, dtype=torch.int32, device=cc.device)
    tile_args = (cc[r0:r0 + 1024], cc, dc[r0:r0 + 1024], dc, ids)
    kv, kc = ck.fused_topk_twopass_rect(*tile_args, k=TOP_K, n_true_cols=n)
    pv, pc = ck.fused_topk_twopass_rect_plain(*tile_args, k=TOP_K + 1,
                                              n_true_cols=n)
    c5_err = float((kv.double() - pv[:, :TOP_K].double()).abs().max())
    clear = (pv[:, TOP_K - 1] - pv[:, TOP_K]) > C5_ATOL
    same = (torch.sort(kc, 1).values
            == torch.sort(pc[:, :TOP_K], 1).values).all(1)
    if c5_err > C5_ATOL or not bool(same[clear].all()):
        raise AssertionError(
            f"K3 vs plain at config 5: max |diff| {c5_err}, "
            f"{int((~same & clear).sum())} rows with other columns")
    print(f"K3 vs plain, 1024-row tile at N={n}: max |diff| {c5_err:.3g}; "
          f"columns equal in all {int(clear.sum())} rows whose k-th and "
          f"(k+1)-th scores differ by more than {C5_ATOL}")

    # A fresh backend on the same checkpoint directory resumes every tile.
    resumed = make()
    done = len(CheckpointManager(ckdir).done_keys())
    (v2, i2), counts, resume_s = counted(
        torch, ck, {name: 0 for name in ck.LAUNCHES},
        lambda: PathSimDriver(resumed).rank_all(k=TOP_K, checkpoint_dir=ckdir),
        "config 5 resumed rank_all",
    )
    if done != tiles or any(counts.values()):
        raise AssertionError(f"resume: {done} of {tiles} units, {counts}")
    if not (np.array_equal(v2, vals) and np.array_equal(i2, idxs)):
        raise AssertionError("the resumed rank-all differs")
    print(f"config 5 resume: all {tiles} row tiles from the checkpoint in "
          f"{resume_s:.2f} s, identical arrays")

    # Layers: row sums, densify, one row tile's K3, pass 2 and fetch (CUDA
    # events), and every tile's K3 + pass 2 back to back (CUDA events
    # around each) against an unprofiled sweep's wall time: the device
    # busy share. (torch.profiler's tracing slows this sweep's kernels,
    # so a profile would overstate it.)
    t0 = time.perf_counter()
    resumed.global_walks()
    rowsum_s = time.perf_counter() - t0
    t = resumed.tiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.dense_device()
    torch.cuda.synchronize()
    densify_s = time.perf_counter() - t0
    t.drop_dense()
    T = C5_TILE_ROWS

    def k3_tile(i0):
        ids = torch.arange(i0, i0 + T, dtype=torch.int32, device=cc.device)
        return ((cc[i0:i0 + T], cc, dc[i0:i0 + T], dc, ids, TOP_K, n),
                (lim.rows(i0, i0 + T), lim))

    # K3 at tile 0 (the Zipf head, where the multi-limb rows lie) and at
    # a middle tile (the tail's tie-heavy rows)
    mid = (tiles // 2) * T
    k3_args0, k3_limbs0 = k3_tile(0)
    k3_args, k3_limbs = k3_tile(mid)
    row_ids = k3_args[4]
    k3_ms0 = time_ms(torch, lambda: ck.topk_rect_candidates(
        *k3_args0, limbs=k3_limbs0))
    k3_ms = time_ms(torch, lambda: ck.topk_rect_candidates(
        *k3_args, limbs=k3_limbs))
    cv, ccand = ck.topk_rect_candidates(*k3_args, limbs=k3_limbs)
    pass2_ms = time_ms(torch, lambda: sparse.chunked_row_topk(
        cv.view(T, -1), ccand.view(T, -1), TOP_K))
    fv, fi = ck.fused_topk_twopass_rect(*k3_args[:5], k=TOP_K, n_true_cols=n,
                                        limbs=k3_limbs)
    hv = torch.empty(fv.shape, dtype=fv.dtype, pin_memory=True)
    hi = torch.empty(fi.shape, dtype=fi.dtype, pin_memory=True)
    fetch_ms = time_ms(torch, lambda: (hv.copy_(fv, non_blocking=True),
                                       hi.copy_(fi, non_blocking=True)))
    state_before = gpu_state()
    k3_s, pass2_s = tiles_device_s(torch, ck, sparse, cc, dc, lim, n, T,
                                   tiles)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed.topk_scores(k=TOP_K)  # row sums cached: the sweep alone
    sweep_s = time.perf_counter() - t0
    print(f"config 5 layers: row sums ({tiles} tile scatters + GEMVs, one "
          f"fetch) {rowsum_s * 1e3:.1f} ms, densify of C "
          f"{densify_s * 1e3:.1f} ms, K3 {k3_s:.3f} s over all {tiles} tiles "
          f"(tile 0 {k3_ms0:.3f} ms, middle tile {k3_ms:.3f} ms), pass 2 "
          f"{pass2_s:.3f} s (middle tile "
          f"{pass2_ms:.3f} ms), fetch {fetch_ms:.4f} ms a tile; sweep "
          f"{sweep_s:.3f} s, device busy share "
          f"{(k3_s + pass2_s) / sweep_s:.3f} (sm clock, power, temperature "
          f"before: {state_before}; after: {gpu_state()})")

    # K3's times at this row tile: kernel, plain version, library.
    k3_plain_ms = time_ms(torch, lambda: ck.fused_topk_twopass_rect_plain(
        *k3_args[:5], k=TOP_K, n_true_cols=n), reps=3, warmup=1)

    def lib_rect():
        # matmul + normalize + torch.topk, 1024 rows at a time (one
        # [8192, 1M] f32 block and its temporaries would not fit)
        cols = torch.arange(n, device=cc.device)
        out = []
        for q in range(mid, mid + T, 1024):
            m = torch.matmul(cc[q:q + 1024], cc[:n].T)
            den = dc[q:q + 1024, None] + dc[None, :n]
            m = torch.where(den > 0, m.mul_(2.0).div_(den), 0.0)
            m.masked_fill_(cols[None, :] == row_ids[q - mid:q - mid + 1024,
                                                    None], float("-inf"))
            out.append(torch.topk(m, TOP_K, dim=1))
        return out

    k3_lib_ms = time_ms(torch, lib_rect, reps=3, warmup=1)
    n_st = cv.shape[1]
    (k3_bound, k3_by), (k3_f32, _) = rect_bounds(
        k3_limbs[0], lim, T, cc.shape[0], v, TOP_K, n_st)
    (k3_bound0, _), _ = rect_bounds(k3_limbs0[0], lim, T, cc.shape[0], v,
                                    TOP_K, n_st)
    hist, wide = products_histogram(torch, lim, lim.planes.shape[2])
    wide_tiles = [i for i in range(tiles)
                  if ck._needs_wide(lim.rows(i * T, (i + 1) * T), lim)]
    print(f"config 5 limb products per (128-row block, 64-column subtile) "
          f"pair of the rank-all: {hist} (products: pairs); {wide} pairs "
          "fold through f64, the rest sum in one s32 accumulator; row "
          f"tiles whose row sums leave M unbounded below 2^31 (K3's "
          f"instance with the f64 fold): {wide_tiles}")
    print(f"K3 topk_rect_candidates {T}x{cc.shape[0]}x{v} k={TOP_K} "
          f"({n_st} stripes): middle tile (rows {mid}..) {k3_ms:.3f} ms, "
          f"tile 0 {k3_ms0:.3f} ms (int8 tensor-core bound {k3_bound:.3f} / "
          f"{k3_bound0:.3f} ms by {k3_by}; f32 CUDA-core bound {k3_f32:.3f} "
          f"ms); K3 + pass 2 per tile {k3_ms + pass2_ms:.3f} ms; plain "
          f"{k3_plain_ms:.3f} ms; library (matmul+normalize+topk, 1024-row "
          f"chunks) {k3_lib_ms:.3f} ms")
    c5 = {"hin": hin, "mp": mp, "vals": vals, "idxs": idxs,
          "rank_s": rank_s, "init_s": init_s, "tiles": tiles,
          "factor": backend.factor_info()}
    return {"ms": k3_ms, "ms_tile0": k3_ms0, "plain_ms": k3_plain_ms,
            "bound_ms": k3_bound, "bound_by": k3_by, "bound_f32_ms": k3_f32,
            "bound_int8_ms": k3_bound, "library_ms": k3_lib_ms,
            "c5_err": c5_err}, c5


# -- serving on the card ------------------------------------------------------


def f64_topk(np, hin, mp):
    """The host f64 oracle of a served graph: exact counts from its COO
    factor (f64 on the host), denominators from them, the repo's f64
    normalize and (descending score, ascending column) top-k. Returns
    ``topk(rows, k) -> (values, indices)`` and the f64 factor."""
    from distributed_pathsim_tpu_torch.ops import pathsim, planner

    coo = planner.fold_half(hin, mp).summed()
    n = hin.type_size(mp.source_type)
    c64 = np.zeros(coo.shape, dtype=np.float64)
    np.add.at(c64, (coo.rows, coo.cols), coo.weights)
    c64 = c64[:n]  # capacity rows hold no edges
    d64 = c64 @ c64.sum(0)

    def topk(rows, k):
        rows = np.asarray(rows, dtype=np.int64)
        vals, idxs = [], []
        for q in range(0, rows.shape[0], 256):
            r = rows[q:q + 256]
            s = pathsim.score_rows(c64[r] @ c64.T, d64[r], d64, xp=np)
            s[np.arange(r.shape[0]), r] = -np.inf
            v, i = pathsim.topk_from_score_rows(s, min(k, n - 1))
            vals.append(v)
            idxs.append(i)
        return np.concatenate(vals), np.concatenate(idxs)

    return topk, c64


def check_served(np, answers, rows, oracle, k, label):
    """Every served (values, indices) equals the oracle's, bit for bit."""
    rows = np.asarray(rows, dtype=np.int64)
    uniq, inv = np.unique(rows, return_inverse=True)
    ov, oi = oracle(uniq, k)
    for j, (v, i) in enumerate(answers):
        u = inv[j]
        if not (np.array_equal(v, ov[u]) and np.array_equal(i, oi[u])):
            raise AssertionError(f"{label}: row {rows[j]} differs from the "
                                 "f64 oracle")
    print(f"{label}: {len(answers)} answers ({uniq.shape[0]} distinct rows) "
          "bit-identical to the host f64 oracle")


def run_clients(svc, rows_by_client, k):
    """Each client thread sends its rows one ``topk`` at a time; returns
    the answers in client order and the wall time."""
    import threading

    results = [[None] * len(r) for r in rows_by_client]
    errors = []

    def client(c):
        try:
            for j, r in enumerate(rows_by_client[c]):
                results[c][j] = svc.topk_index(int(r), k)
        except Exception as exc:  # surfaced below, the phase fails
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(rows_by_client))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"load clients failed: {errors[:1]}")
    return [a for per in results for a in per], wall


def regime_latencies(svc, n_requests, wall, label, card):
    """p50/p95/p99 per outcome from the service's own histograms (reset
    before the regime) and the regime's requests/s."""
    parts = []
    for outcome, cell in svc._m_latency.items():
        if cell.count:
            parts.append(
                f"{outcome} n={cell.count} p50 {cell.quantile(0.5) * 1e3:.3f}"
                f" p95 {cell.quantile(0.95) * 1e3:.3f} p99 "
                f"{cell.quantile(0.99) * 1e3:.3f} ms")
        cell.reset()
    print(f"{label}: {n_requests} requests in {wall:.3f} s -> "
          f"{n_requests / wall:.1f} QPS; " + "; ".join(parts)
          + f" ({card})")


def update_records(np, hin, rng, tag):
    """The update op's records: UPDATE_APPENDS authors appended, each
    wired to 4 papers, UPDATE_ADDS new author_of edges in all (the rest
    between existing authors and papers), UPDATE_REMOVES existing ones
    removed."""
    blk = hin.blocks["author_of"]
    a_ids = hin.indices["author"].ids
    p_ids = hin.indices["paper"].ids
    n_a, n_p = hin.type_size("author"), hin.type_size("paper")
    existing = set(zip(blk.rows.tolist(), blk.cols.tolist()))
    rem = rng.choice(blk.nnz, UPDATE_REMOVES, replace=False)
    removes = [{"rel": "author_of", "src_row": int(blk.rows[i]),
                "dst_row": int(blk.cols[i])} for i in rem]
    new_ids = [f"{tag}_{i}" for i in range(UPDATE_APPENDS)]
    adds = []
    for a in new_ids:
        for p in rng.choice(n_p, 4, replace=False):
            adds.append({"rel": "author_of", "src": a, "dst": p_ids[p]})
    while len(adds) < UPDATE_ADDS:
        e = (int(rng.integers(0, n_a)), int(rng.integers(0, n_p)))
        if e not in existing:
            existing.add(e)
            adds.append({"rel": "author_of", "src": a_ids[e[0]],
                         "dst": p_ids[e[1]]})
    return {
        "add_nodes": [{"type": "author", "id": a, "label": a}
                      for a in new_ids],
        "add_edges": adds, "remove_edges": removes,
    }


def serving(torch, ck, np, launches, workdir, card, hin, hin_ap):
    """The online path on the card: a warm service over the bench graph
    under cold, warm and mixed load from 32 client threads, one
    ``update`` patched into the resident factor, the kernels on the
    patched backends, and ``dpathsim-torch serve`` as a subprocess."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.data import delta as tdl
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.serving import (
        PathSimService,
        ServeConfig,
    )
    from distributed_pathsim_tpu_torch.serving.protocol import handle_request
    from distributed_pathsim_tpu_torch.utils.compile_counter import (
        CompileCounter,
    )

    phase(f"serving on the card: {N_AUTHORS}x{N_PAPERS}x{N_VENUES}, "
          f"headroom {SERVE_HEADROOM}, max_batch {SERVE_MAX_BATCH}, "
          f"{SERVE_CLIENTS} clients x {SERVE_PER_CLIENT} topk k={TOP_K}")
    hin_h = tdl.with_headroom(hin, SERVE_HEADROOM)
    mp = compile_metapath("APVPA", hin_h.schema)
    t0 = time.perf_counter()
    backend = create_backend("torch", hin_h, mp, device="cuda")
    svc = PathSimService(backend, config=ServeConfig(
        max_batch=SERVE_MAX_BATCH, k_default=TOP_K))
    print(f"service start (backend init + warmup of buckets "
          f"{svc._bucket_ladder}): {time.perf_counter() - t0:.3f} s")
    try:
        with CompileCounter() as compiles:
            cold_qps = serving_load_and_update(
                torch, ck, np, launches, card, svc, mp, hin_ap, tdl,
                create_backend, handle_request)
            serve_subprocess(np, workdir, hin_ap, card)
        if compiles.count:
            raise AssertionError(
                f"{compiles.count} compiles after warmup: {compiles.by_kind}")
        print("compile counter: 0 kernel builds, loads or graph captures "
              "from the end of warmup to the end of the phase")
        return cold_qps
    finally:
        svc.close()


def serving_load_and_update(torch, ck, np, launches, card, svc, mp, hin_ap,
                            tdl, create_backend, handle_request):
    """Cold, warm and mixed load against the f64 oracle, then the update
    and the kernels on the patched backends. Returns the cold load's
    requests/s."""
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    backend = svc.backend
    rng = np.random.default_rng(SEED)
    n = svc.n
    cold_rows = rng.integers(0, n, (SERVE_CLIENTS, SERVE_PER_CLIENT))
    for cell in svc._m_latency.values():
        cell.reset()
    cold, wall = run_clients(svc, cold_rows, TOP_K)
    cold_qps = len(cold) / wall
    regime_latencies(svc, len(cold), wall, "cold load", card)
    oracle, _ = f64_topk(np, svc.hin, mp)
    check_served(np, cold, cold_rows.ravel(), oracle, TOP_K, "cold load")

    hits0 = svc.result_cache.hits
    sent0 = svc.coalescer.dispatched_requests
    warm, wall = run_clients(svc, cold_rows, TOP_K)
    regime_latencies(svc, len(warm), wall, "warm load", card)
    if (svc.result_cache.hits - hits0 != len(warm)
            or svc.coalescer.dispatched_requests != sent0):
        raise AssertionError("warm load: not every request hit the result "
                             "cache")
    if any(not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
           for a, b in zip(warm, cold)):
        raise AssertionError("warm load: an answer differs from cold")
    print(f"warm load: all {len(warm)} requests result-cache hits, answers "
          "identical to the cold load's")

    fresh = rng.integers(0, n, (SERVE_CLIENTS, SERVE_PER_CLIENT // 2))
    mixed_rows = np.empty((SERVE_CLIENTS, SERVE_PER_CLIENT), dtype=np.int64)
    mixed_rows[:, 0::2] = cold_rows[:, : SERVE_PER_CLIENT // 2]
    mixed_rows[:, 1::2] = fresh
    mixed, wall = run_clients(svc, mixed_rows, TOP_K)
    regime_latencies(svc, len(mixed), wall, "mixed load (50/50 warm/cold "
                     "rows)", card)
    check_served(np, mixed, mixed_rows.ravel(), oracle, TOP_K, "mixed load")
    serving_layers(torch, np, svc, rng, card)

    # The update: the served backend ranks once first, so C's u8 limbs
    # are split and cached when the patch lands.
    counted(torch, ck, launches, lambda: backend.topk(k=TOP_K),
            "served backend rank-all before the update (limbs cached)")
    recs = update_records(np, svc.hin, np.random.default_rng(SEED + 1),
                          "serve_new")
    old_hin = svc.hin
    resp = handle_request(svc, {"id": 1, "op": "update", **recs,
                                "want_rows": True})
    if not resp["ok"] or resp["result"]["mode"] != "delta":
        raise AssertionError(f"update did not patch: {resp}")
    res = resp["result"]
    print(f"update: {res['edge_changes']} edge changes, "
          f"{res['node_appends']} appended authors, mode {res['mode']}, "
          f"{res['affected_rows']} affected rows, {res['purged_entries']} "
          f"cache entries purged, {res['ms']:.3f} ms ({card})")
    update_layers(torch, np, backend, tdl, old_hin, recs, mp, card)
    rebuilt = create_backend("torch", svc.hin, mp, device="cuda")
    c, rs = backend._half()
    rc, rrs = rebuilt._half()
    if not (torch.equal(c, rc) and torch.equal(rs, rrs)):
        raise AssertionError("patched C or row sums differ from a rebuild")
    print("patched device C and row sums: torch.equal to a backend rebuilt "
          "from the delta-applied graph")
    for k, kernel, label in ((TOP_K, "topk_twopass_candidates", "K1"),
                             (TOP_K_FOLD, "topk_fold", "K4")):
        (got, want), counts, _ = counted(
            torch, ck, launches,
            lambda: (backend.topk(k=k), rebuilt.topk(k=k)),
            f"rank-all k={k} on the patched and the rebuilt backend")
        if counts[kernel] < 2:
            raise AssertionError(f"rank-all k={k} did not launch {label}")
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])):
            raise AssertionError(f"{label} on the patched backend differs "
                                 "from the rebuilt backend")
        print(f"{label} (k={k}) on the patched backend: bit-identical to "
              "the rebuilt backend")

    new_oracle, _ = f64_topk(np, svc.hin, mp)
    affected = np.asarray(res["affected_row_list"], dtype=np.int64)
    appended = np.arange(n, svc.n)
    probe = np.unique(np.concatenate([affected[:256], appended]))
    answers, _ = run_clients(svc, np.array_split(probe, SERVE_CLIENTS), TOP_K)
    check_served(np, answers, probe, new_oracle, TOP_K,
                 "affected and appended rows after the update")
    keep = ~np.isin(cold_rows.ravel(), affected)
    unaffected = np.unique(cold_rows.ravel()[keep])[:256]
    if unaffected.shape[0] == 0:
        raise AssertionError("the update left no cached row unaffected")
    hits0 = svc.result_cache.hits
    answers = [svc.topk_index(int(r), TOP_K) for r in unaffected]
    if svc.result_cache.hits - hits0 != unaffected.shape[0]:
        raise AssertionError("unaffected rows missed the result cache")
    check_served(np, answers, unaffected, new_oracle, TOP_K,
                 "unaffected rows after the update (all result-cache hits)")

    # K2 on the all-pairs graph, patched the same way
    hin_a = tdl.with_headroom(hin_ap, SERVE_HEADROOM)
    mp_a = compile_metapath("APVPA", hin_a.schema)
    b2 = create_backend("torch", hin_a, mp_a, device="cuda")
    counted(torch, ck, launches, b2.all_pairs_scores,
            f"all-pairs {N_AUTHORS_ALL_PAIRS} before its update (limbs "
            "cached)")
    recs = update_records(np, hin_a, np.random.default_rng(SEED + 2),
                          "pairs_new")
    delta = tdl.delta_from_records(hin_a, **recs)
    plan = tdl.plan_delta(hin_a, delta, mp_a)
    if plan.fallback:
        raise AssertionError(f"all-pairs update fell back: {plan.reason}")
    b2.apply_delta(plan)
    r2 = create_backend("torch", plan.hin_new, mp_a, device="cuda")
    (got, want), counts, _ = counted(
        torch, ck, launches,
        lambda: (b2.all_pairs_scores(), r2.all_pairs_scores()),
        "all-pairs on the patched and the rebuilt backend")
    if counts["fused_scores"] < 2:
        raise AssertionError("all-pairs did not launch K2")
    if not np.array_equal(got, want):
        raise AssertionError("K2 on the patched backend differs from the "
                             "rebuilt backend")
    print(f"K2 on the patched {N_AUTHORS_ALL_PAIRS}-author backend "
          f"({got.shape[0]} authors after the update): bit-identical to "
          "the rebuilt backend")
    return cold_qps


def serving_layers(torch, np, svc, rng, card):
    """Where a served request's time goes: 8 cold requests from each
    client with tracing on, the mean of each span of the service's own
    instrumentation (enqueue; the dispatcher's issue of gather + GEMM on
    the serving stream; the completion thread's wait for the GEMM and the
    pinned copy; the f64 normalize and top-k; the cache fill), and the
    card's part alone at a batch of SERVE_MAX_BATCH (CUDA events)."""
    from distributed_pathsim_tpu_torch import obs
    from distributed_pathsim_tpu_torch.obs.trace import get_tracer

    tracer = get_tracer()
    tracer.clear()
    obs.configure(tracing=True)
    try:
        rows = rng.integers(0, svc.n, (SERVE_CLIENTS, 8))
        _, wall = run_clients(svc, rows, TOP_K)
    finally:
        obs.configure(tracing=False)
    spans = {}
    for sp in tracer.spans():
        spans.setdefault(sp.name, []).append(sp.duration_s * 1e3)
    tracer.clear()
    mean = {k: float(np.mean(v)) for k, v in spans.items()}
    cnt = {k: len(v) for k, v in spans.items()}
    host = (mean["serve.complete"] - mean["serve.host_transfer"]
            - mean["serve.cache_fill"])
    c, _ = svc.backend._half()
    idx = torch.as_tensor(np.arange(SERVE_MAX_BATCH) * 997 % svc.n,
                          device=c.device)
    gemm_ms = time_ms(torch, lambda: c[idx] @ c.T)
    out = c[idx] @ c.T
    pinned = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    copy_ms = time_ms(torch, lambda: pinned.copy_(out, non_blocking=True))
    print(f"serving layers ({rows.size} cold requests, {cnt['serve.dispatch']}"
          f" batches, tracer spans, mean ms): request "
          f"{mean['serve.request']:.3f}, queue {mean['serve.enqueue']:.3f}, "
          f"issue of gather + GEMM {mean['serve.device_execute']:.3f}, "
          f"host transfer (GEMM wait + pinned copy) "
          f"{mean['serve.host_transfer']:.3f}, f64 normalize + top-k "
          f"{host:.3f}, cache fill {mean['serve.cache_fill']:.3f}; on the "
          f"card at {SERVE_MAX_BATCH} rows: gather + GEMM {gemm_ms:.4f} ms, "
          f"copy of the {out.shape[0]}x{out.shape[1]} f32 counts "
          f"{copy_ms:.4f} ms (CUDA events; {card})")


def update_layers(torch, np, backend, tdl, old_hin, recs, mp, card):
    """The update's layers, measured again after it: the host plan with
    the factor fold already cached on the graph (the update's own first
    plan paid that fold), and the ΔC scatter + row sums on a copy of C
    (CUDA events)."""
    from distributed_pathsim_tpu_torch.backends.torch_dense import (
        _pad_coo_bucket,
    )
    from distributed_pathsim_tpu_torch.ops import chain

    delta = tdl.delta_from_records(old_hin, **recs)
    t0 = time.perf_counter()
    plan = tdl.plan_delta(old_hin, delta, mp)
    plan_ms = (time.perf_counter() - t0) * 1e3
    dc = plan.delta_c
    r, cidx, w = _pad_coo_bucket(dc.rows, dc.cols, dc.weights)
    c, _ = backend._half()
    c2 = c.clone()
    rr = torch.as_tensor(r, device=c.device)
    cc = torch.as_tensor(cidx, device=c.device)
    ww = torch.as_tensor(w, dtype=c.dtype, device=c.device)
    patch_ms = time_ms(torch, lambda: (
        c2.index_put_((rr, cc), ww, accumulate=True),
        chain.rowsums_from_half(c2)))
    print(f"update layers: plan (fold cached) {plan_ms:.3f} ms, dC nnz "
          f"{dc.rows.shape[0]} (padded {r.shape[0]}), scatter + row sums "
          f"on the card {patch_ms:.4f} ms (CUDA events; {card})")


def serve_subprocess(np, workdir, hin_ap, card):
    """``dpathsim-torch serve --platform cuda`` on the all-pairs GEXF with
    a short JSONL script: every response ok, exit 0."""
    blk = hin_ap.blocks["author_of"]
    a_ids = hin_ap.indices["author"].ids
    p_ids = hin_ap.indices["paper"].ids
    mine = set(blk.cols[blk.rows == 7].tolist())
    paper = next(p for p in range(len(p_ids)) if p not in mine)
    script = [
        {"id": 1, "op": "topk", "source_id": a_ids[7], "k": TOP_K},
        {"id": 2, "op": "topk", "source_id": a_ids[7], "k": TOP_K},
        {"id": 3, "op": "update", "add_edges": [
            {"rel": "author_of", "src": a_ids[7], "dst": p_ids[paper]}]},
        {"id": 4, "op": "metrics"},
        {"id": 5, "op": "health"},
        {"id": 6, "op": "shutdown"},
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", "serve",
         "--dataset", str(workdir / "allpairs.gexf"), "--platform", "cuda",
         "--backend", "torch"],
        input="\n".join(json.dumps(r) for r in script) + "\n",
        capture_output=True, text=True, timeout=600, cwd=HERE,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serve exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    resps = [json.loads(line) for line in proc.stdout.splitlines()]
    if [r.get("id") for r in resps] != [1, 2, 3, 4, 5, 6] or not all(
            r["ok"] for r in resps):
        raise AssertionError(f"serve responses: {resps}")
    if resps[2]["result"]["mode"] != "delta":
        raise AssertionError("serve's update did not patch")
    print(f"dpathsim-torch serve --platform cuda on {N_AUTHORS_ALL_PAIRS} "
          f"authors: exit 0, all 6 responses ok in {wall:.1f} s (startup "
          f"included); topk {resps[0]['latency_ms']} ms cold, "
          f"{resps[1]['latency_ms']} ms cached; update "
          f"{resps[2]['result']['ms']} ms; compiles in the process: "
          f"{resps[4]['result']['compiles']} ({card})")


# -- the router fleet on the card ---------------------------------------------


def router_histogram(router, card, label, n_requests, wall):
    """QPS and p50/p95/p99 by outcome from the router's own
    ``dpathsim_router_request_seconds`` histogram (reset before each
    load)."""
    parts = []
    for key, cell in router._m_latency.cells():
        if cell.count:
            outcome = dict(key).get("outcome", "?")
            parts.append(
                f"{outcome} n={cell.count} p50 {cell.quantile(0.5) * 1e3:.3f}"
                f" p95 {cell.quantile(0.95) * 1e3:.3f} p99 "
                f"{cell.quantile(0.99) * 1e3:.3f} ms")
    print(f"{label}: {n_requests} requests in {wall:.3f} s -> "
          f"{n_requests / wall:.1f} QPS; " + "; ".join(parts)
          + f" ({card})")
    return n_requests / wall


def router_counts(router):
    """Hedges, failovers, sheds, heartbeat suspicions and per-worker
    dispatches from the router's counters (reset before each load)."""
    from distributed_pathsim_tpu_torch.obs.metrics import get_registry

    reg = get_registry()

    def total(name, **labels):
        fam = reg.counter(name)
        return int(sum(c.get() for k, c in fam.cells()
                       if labels.items() <= dict(k).items()))

    return {
        "hedges": int(router._m_hedges.get()),
        "failovers": total("dpathsim_router_failovers_total"),
        "sheds": total("dpathsim_router_requests_total", outcome="shed"),
        "suspicions": total("dpathsim_router_worker_down_total",
                            status="suspect"),
        "downs": total("dpathsim_router_worker_down_total", status="down"),
        "dispatches": {dict(k)["worker"]: int(c.get()) for k, c in
                       reg.counter("dpathsim_router_dispatches_total")
                       .cells()},
    }


def reset_router_metrics(router):
    from distributed_pathsim_tpu_torch.obs.metrics import get_registry

    reg = get_registry()
    router._m_latency.reset()
    for name in ("dpathsim_router_requests_total",
                 "dpathsim_router_failovers_total",
                 "dpathsim_router_hedges_total",
                 "dpathsim_router_worker_down_total",
                 "dpathsim_router_dispatches_total"):
        reg.counter(name).reset()


def check_routed(np, answers, oracle, hin, k, label):
    """Every routed answer (author ids, f64 scores) equals the host f64
    oracle's top-k over ``hin``, bit for bit."""
    index_of = hin.indices["author"].index_of
    rows = np.asarray([r for r, _ in answers], dtype=np.int64)
    uniq, inv = np.unique(rows, return_inverse=True)
    ov, oi = oracle(uniq, k)
    for j, (row, resp) in enumerate(answers):
        hits = resp["result"]["topk"]
        got_i = [index_of[h["id"]] for h in hits]
        got_v = [h["score"] for h in hits]
        u = inv[j]
        if got_i != oi[u].tolist() or got_v != ov[u].tolist():
            raise AssertionError(f"{label}: row {row} differs from the f64 "
                                 "oracle")
    print(f"{label}: {len(answers)} answers ({uniq.shape[0]} distinct rows) "
          "bit-identical to the host f64 oracle")


def router_fleet(np, workdir, card, serve_cold_qps):
    """Two ``dpathsim-torch worker --platform cuda`` processes on the one
    card behind an in-process port Router (RouterConfig defaults: hedge
    100 ms, heartbeat 0.25 s) over the bench graph: cold load with one
    worker SIGKILLed partway, the respawn, warm load, one broadcast
    update, the compile counts, then ``dpathsim-torch router`` as a
    subprocess."""
    import threading

    from distributed_pathsim_tpu_torch.data import delta as tdl
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.router import (
        Router,
        RouterConfig,
        SubprocessTransport,
    )
    from distributed_pathsim_tpu_torch.router.cli import (
        _worker_argv,
        build_worker_hin,
        parse_router_args,
    )
    from distributed_pathsim_tpu_torch.router.loadgen import (
        run_router_clients,
    )

    phase(f"router fleet on the card: 2 workers, {ROUTER_SPEC}, headroom "
          f"{SERVE_HEADROOM}, {SERVE_CLIENTS} clients x {SERVE_PER_CLIENT} "
          f"topk k={TOP_K}")
    args = parse_router_args([
        "--dataset", ROUTER_SPEC, "--platform", "cuda", "--backend", "torch",
        "--headroom", str(SERVE_HEADROOM), "--k", str(TOP_K)])
    transports = {f"w{i}": SubprocessTransport(f"w{i}", _worker_argv(args, i))
                  for i in range(2)}
    router = Router(transports, RouterConfig())
    try:
        t0 = time.perf_counter()
        router.start(ready_timeout=600)
        print(f"worker start (2 processes at once: graph build, backend "
              f"init, bucket warmup): {time.perf_counter() - t0:.3f} s "
              f"({card})")
        compiles0 = {wid: router.worker_health(wid)["compiles"]
                     for wid in transports}
        hin = build_worker_hin(ROUTER_SPEC, SERVE_HEADROOM)
        mp = compile_metapath("APVPA", hin.schema)
        oracle, _ = f64_topk(np, hin, mp)
        n = hin.type_size("author")
        rng = np.random.default_rng(SEED + 3)
        cold_rows = rng.integers(0, n, (SERVE_CLIENTS, SERVE_PER_CLIENT))

        # cold load; w0 is SIGKILLed once a quarter of it is answered
        reset_router_metrics(router)
        ok_cell = router._m_requests.labels(outcome="ok")
        started, killed = threading.Event(), {}

        def killer():
            started.wait()
            while ok_cell.get() < cold_rows.size // 4:
                time.sleep(0.001)
            killed["at"] = int(ok_cell.get())
            killed["s"] = time.perf_counter() - t_load
            transports["w0"].kill()

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        t_load = time.perf_counter()
        started.set()
        res = run_router_clients(router, cold_rows.tolist(), TOP_K)
        t_end = time.perf_counter() - t_load
        kt.join(timeout=60)
        if "at" not in killed:
            raise AssertionError("the kill never happened")
        fleet_qps = router_histogram(router, card, "fleet cold load, w0 "
                                     f"SIGKILLed after {killed['at']} answers",
                                     res["queries"], res["wall_s"])
        counts = router_counts(router)
        if res["lost"] or res["queries"] != cold_rows.size:
            raise AssertionError(f"fleet cold load lost {res['lost']} "
                                 f"requests: {res['errors']}")
        check_routed(np, res["answers"], oracle, hin, TOP_K,
                     "fleet cold load")
        status = {wid: w.status for wid, w in router.workers.items()}
        if status != {"w0": "down", "w1": "up"} or counts["downs"] != 1:
            raise AssertionError(f"worker states after the kill: {status}, "
                                 f"{counts['downs']} marked down")
        if counts["failovers"] < 1:
            raise AssertionError("the kill caused no failover")
        print(f"fleet cold load by stage: {killed['at'] / killed['s']:.1f}"
              f" QPS with both workers up ({killed['at']} answers in "
              f"{killed['s']:.3f} s), "
              f"{(res['queries'] - killed['at']) / (t_end - killed['s']):.1f}"
              f" QPS on w1 alone after the kill ({card})")
        print(f"fleet cold load: 0 lost, {counts['failovers']} failovers "
              f"({res['failover_affected']} answers re-dispatched), "
              f"{counts['hedges']} hedges, {counts['sheds']} sheds, "
              f"{counts['suspicions']} heartbeat suspicions, dispatches "
              f"{counts['dispatches']}; fleet {fleet_qps:.1f} QPS beside "
              f"one service's {serve_cold_qps:.1f} QPS in the serving "
              f"phase ({card})")

        t0 = time.perf_counter()
        router.reap_workers()
        router.add_worker("w0", SubprocessTransport("w0",
                                                    _worker_argv(args, 0)),
                          ready_timeout=600)
        print(f"respawn of w0 (one process): {time.perf_counter() - t0:.3f}"
              f" s ({card})")
        compiles0["w0"] = router.worker_health("w0")["compiles"]

        reset_router_metrics(router)
        res = run_router_clients(router, cold_rows.tolist(), TOP_K)
        router_histogram(router, card, "fleet warm load (same rows)",
                         res["queries"], res["wall_s"])
        counts = router_counts(router)
        if res["lost"]:
            raise AssertionError(f"fleet warm load lost {res['lost']}")
        check_routed(np, res["answers"], oracle, hin, TOP_K,
                     "fleet warm load")
        print(f"fleet warm load: {counts['hedges']} hedges, "
              f"{counts['failovers']} failovers, {counts['sheds']} sheds, "
              f"{counts['suspicions']} heartbeat suspicions, dispatches "
              f"{counts['dispatches']} ({card})")

        recs = update_records(np, hin, np.random.default_rng(SEED + 1),
                              "fleet_new")
        t0 = time.perf_counter()
        resp = router.request({"id": 1, "op": "update", **recs}, timeout=600)
        update_ms = (time.perf_counter() - t0) * 1e3
        if not resp["ok"] or resp["result"]["applied"] != ["w0", "w1"] or (
                resp["result"]["mode"] != "delta"):
            raise AssertionError(f"fleet update: {resp}")
        res_u = resp["result"]
        print(f"fleet update: applied on {res_u['applied']}, mode "
              f"{res_u['mode']}, {res_u['affected_rows']} affected rows, "
              f"{update_ms:.3f} ms from submit to the last ack ({card})")
        plan = tdl.plan_delta(hin, tdl.delta_from_records(hin, **recs), mp)
        new_oracle, _ = f64_topk(np, plan.hin_new, mp)
        probe = np.unique(np.concatenate([
            plan.affected_rows[:512], np.arange(n, plan.hin_new.type_size(
                "author"))]))
        owners = {wid: int(sum(router.policy.owner(int(r)) == wid
                               for r in probe)) for wid in transports}
        if min(owners.values()) == 0:
            raise AssertionError(f"probe rows owned by one replica: {owners}")
        res = run_router_clients(
            router, [p.tolist() for p in np.array_split(probe,
                                                        SERVE_CLIENTS)],
            TOP_K)
        if res["lost"]:
            raise AssertionError(f"affected rows lost {res['lost']}")
        check_routed(np, res["answers"], new_oracle, plan.hin_new, TOP_K,
                     f"affected and appended rows after the update (owners "
                     f"{owners})")
        compiles1 = {wid: router.worker_health(wid)["compiles"]
                     for wid in transports}
        if compiles1 != compiles0:
            raise AssertionError(f"worker compiles moved: {compiles0} -> "
                                 f"{compiles1}")
        print(f"worker compiles: {compiles1}, unchanged from the end of each "
              "worker's warmup to the end of the phase")
    finally:
        router.close()
    router_subprocess(workdir, card)


def router_subprocess(workdir, card):
    """``dpathsim-torch router --workers 2 --platform cuda`` on the
    all-pairs GEXF with a short JSONL script: exit 0, every response
    ok."""
    script = [
        {"id": 1, "op": "topk", "row": 7, "k": TOP_K},
        {"id": 2, "op": "update", "add_edges": [
            {"rel": "author_of", "src_row": 7, "dst_row": 11}]},
        {"id": 3, "op": "health"},
        {"id": 4, "op": "shutdown"},
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", "router",
         "--workers", "2", "--platform", "cuda", "--backend", "torch",
         "--dataset", str(workdir / "allpairs.gexf")],
        input="\n".join(json.dumps(r) for r in script) + "\n",
        capture_output=True, text=True, timeout=600, cwd=HERE,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"router exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    resps = {r["id"]: r for r in map(json.loads, proc.stdout.splitlines())}
    if sorted(resps) != [1, 2, 3, 4] or not all(r["ok"]
                                                for r in resps.values()):
        raise AssertionError(f"router responses: {resps}")
    if resps[2]["result"]["applied"] != ["w0", "w1"]:
        raise AssertionError(f"router update: {resps[2]}")
    print(f"dpathsim-torch router --workers 2 --platform cuda on "
          f"{N_AUTHORS_ALL_PAIRS} authors: exit 0, all 4 responses ok in "
          f"{wall:.1f} s (2 worker startups included); update applied on "
          f"{resps[2]['result']['applied']} ({card})")


def sparse_f64_oracle(np, hin, mp):
    """The host f64 oracle of one metapath on one graph, row by row: the
    folded COO factor C in f64, M[r, :] = C[r] · Cᵀ from its entries
    (exact integers), the row sums C · (Cᵀ · 1), the repo's f64 normalize
    and (descending score, ascending column) top-k. No dense factor: APA's
    is 32768 x 45000. Returns ``topk(row, k) -> (values, indices)`` and
    the row sums."""
    from distributed_pathsim_tpu_torch.ops import pathsim, planner

    coo = planner.fold_half(hin, mp).summed()
    n = hin.type_size(mp.source_type)
    rows = np.asarray(coo.rows, dtype=np.int64)
    cols = np.asarray(coo.cols, dtype=np.int64)
    w = np.asarray(coo.weights, dtype=np.float64)
    n_rows, n_cols = coo.shape
    colsum = np.bincount(cols, weights=w, minlength=n_cols)
    d = np.bincount(rows, weights=w * colsum[cols], minlength=n_rows)[:n]
    by_row = np.argsort(rows, kind="stable")
    row_ptr = np.searchsorted(rows[by_row], np.arange(n_rows + 1))
    by_col = np.argsort(cols, kind="stable")
    col_ptr = np.searchsorted(cols[by_col], np.arange(n_cols + 1))

    def topk(row, k):
        m = np.zeros(n)
        for e in by_row[row_ptr[row]:row_ptr[row + 1]]:
            seg = by_col[col_ptr[cols[e]]:col_ptr[cols[e] + 1]]
            np.add.at(m, rows[seg], w[e] * w[seg])
        sc = pathsim.score_rows(m[None, :], d[row:row + 1], d, xp=np)
        sc[0, row] = -np.inf
        v, i = pathsim.topk_from_score_rows(sc, min(k, n - 1))
        return v[0], i[0]

    return topk, d


def firehose_records(np, hin, rng, tag):
    """One small update of the firehose: SR_APPENDS authors appended,
    each wired to 3 papers, SR_ADDS new author_of edges between existing
    nodes and SR_REMOVES existing ones removed (raw rows on the wire)."""
    blk = hin.blocks["author_of"]
    n_a, n_p = hin.type_size("author"), hin.type_size("paper")
    existing = set(zip(blk.rows.tolist(), blk.cols.tolist()))
    rem = rng.choice(blk.nnz, SR_REMOVES, replace=False)
    removes = [{"rel": "author_of", "src_row": int(blk.rows[i]),
                "dst_row": int(blk.cols[i])} for i in rem]
    new_ids = [f"{tag}_{i}" for i in range(SR_APPENDS)]
    adds = [{"rel": "author_of", "src": a, "dst_row": int(p)}
            for a in new_ids for p in rng.choice(n_p, 3, replace=False)]
    while len(adds) < SR_APPENDS * 3 + SR_ADDS:
        e = (int(rng.integers(0, n_a)), int(rng.integers(0, n_p)))
        if e not in existing:
            existing.add(e)
            adds.append({"rel": "author_of", "src_row": e[0],
                         "dst_row": e[1]})
    return {"add_nodes": [{"type": "author", "id": a, "label": a}
                          for a in new_ids],
            "add_edges": adds, "remove_edges": removes}


def pct(values, q):
    """The q-quantile (nearest rank) of ``values`` in ms."""
    v = sorted(values)
    return v[min(len(v) - 1, max(int(round(q * len(v))) - 1, 0))] * 1e3


def serving_rest(torch, ck, np, card):
    """The rest of the serving lanes on the card: per-request secondary
    metapaths (APA, APTPA) beside the served APVPA with the shared
    sub-chain memo, and background compaction with its token-preserving
    hot-swap, under 32 client threads and a firehose of updates; then a
    forced compact op and K1, K4, K2 on the compacted backend and K1 on
    the APTPA engine's factor. Returns this phase's launches per kernel
    (counted apart from the main path's)."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.data import delta as tdl
    from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.serving import (
        PathSimService,
        ServeConfig,
    )
    from distributed_pathsim_tpu_torch.serving.protocol import handle_request
    from distributed_pathsim_tpu_torch.utils.compile_counter import (
        CompileCounter,
    )
    from distributed_pathsim_tpu_torch.utils.logging import set_event_sink

    phase(f"serving lanes, the rest: {N_AUTHORS}x{N_PAPERS}x{N_VENUES} with "
          f"{SR_TOPICS} topics, headroom {SERVE_HEADROOM}, lanes "
          f"{'/'.join(SR_LANES)}, {SR_CLIENTS} clients, {SR_UPDATES} "
          f"updates, compaction chain {SR_CHAIN_LEN}, cooldown 0")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hin = tdl.with_headroom(synthetic_hin(
        N_AUTHORS, N_PAPERS, N_VENUES, n_topics=SR_TOPICS,
        topics_per_paper=SR_TOPICS_PER_PAPER, seed=SEED,
        materialize_ids=True), SERVE_HEADROOM)
    print(f"graph: {time.perf_counter() - t0:.3f} s; capacities "
          f"{ {t: ix.padded_size for t, ix in hin.indices.items()} }")
    mps = {lane: compile_metapath(lane, hin.schema) for lane in SR_LANES}
    versions = {0: hin}
    oracles = {}

    def oracle(seq, lane):
        if (seq, lane) not in oracles:
            oracles[seq, lane] = sparse_f64_oracle(np, versions[seq],
                                                   mps[lane])
        return oracles[seq, lane]

    sums = {lane: float(oracle(0, lane)[1].max()) for lane in SR_LANES}
    if max(sums.values()) >= 2 ** 24:
        raise AssertionError(f"a lane is past the 2^24 guard: {sums}")
    print("largest row sums (host f64): " + ", ".join(
        f"{lane} {v:.6g}" for lane, v in sums.items()))

    events = []

    class Sink:  # the service's structured events, kept for the report
        def metric(self, event, **fields):
            events.append((event, fields))

    set_event_sink(Sink())
    t0 = time.perf_counter()
    svc = PathSimService(
        create_backend("torch", hin, mps["APVPA"], device="cuda"),
        config=ServeConfig(max_batch=SERVE_MAX_BATCH, k_default=TOP_K,
                           compact_chain_len=SR_CHAIN_LEN,
                           compact_cooldown_s=0.0))
    try:
        print(f"service start: {time.perf_counter() - t0:.3f} s")
        c0, rs0 = svc.backend._half()
        lim0 = svc.backend._limbs(c0)
        k1_before = time_ms(torch, lambda: ck.topk_twopass_candidates(
            c0, rs0, TOP_K, True, limbs=lim0))
        shape_before = tuple(c0.shape)
        del c0, rs0, lim0
        first = {}
        for lane in SR_LANES[1:]:
            t0 = time.perf_counter()
            svc.topk_index(0, TOP_K, metapath=lane)
            first[lane] = (time.perf_counter() - t0) * 1e3
        print("first request of each secondary engine (engine build + "
              "bucket warm): " + ", ".join(
                  f"{lane} {ms:.1f} ms" for lane, ms in first.items())
              + f" ({card})")
        comp_compiles0 = svc._compactor._m_compiles.get()
        compiles = CompileCounter().__enter__()  # to the end of the phase
        quiet = [quiet_update(np, svc, versions, handle_request, "q0")]
        records, updates = serving_rest_load(
            np, svc, versions, handle_request, card)
        serving_rest_checks(np, svc, versions, oracle, records, updates,
                            events, handle_request, card)
        # after the swaps: C, its row sums and limbs patched at the
        # compacted size (the kernel checks below rank this backend)
        quiet.append(quiet_update(np, svc, versions, handle_request, "q1"))
        print(f"update with no load (drain empty): {quiet[0][1]:.3f} ms on "
              f"the {quiet[0][0]} factor before compaction, "
              f"{quiet[1][1]:.3f} ms on the {quiet[1][0]} factor after "
              f"(the service's own ms; {card})")
        comp_compiles = svc._compactor._m_compiles.get() - comp_compiles0
        backend = svc.backend
        aptpa = svc._engines.get("APTPA")
        if aptpa is None:
            svc.topk_index(1, TOP_K, metapath="APTPA")
            aptpa = svc._engines["APTPA"]
        aptpa = aptpa.backend
    finally:
        svc.close()
        set_event_sink(None)
    del svc
    gc.collect()  # the service's threads and compactor hold cycles
    torch.cuda.empty_cache()
    try:
        launches = serving_rest_kernels(torch, ck, np, backend, aptpa,
                                        k1_before, shape_before, card)
    finally:
        compiles.__exit__(None, None, None)
    if compiles.count or comp_compiles:
        raise AssertionError(f"{compiles.count} compiles after warmup "
                             f"({compiles.by_kind}), {comp_compiles} in "
                             "compaction builds")
    print("compile counter: 0 kernel builds or loads from the end of warmup "
          "to the end of the phase (dpathsim_compaction_compiles_total "
          "unchanged)")
    print(f"peak device memory of the phase: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated; {card})")
    print(f"serving lanes phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def quiet_update(np, svc, versions, handle_request, tag):
    """One firehose update with no load running: (the factor's shape, the
    service's own ms)."""
    shape = tuple(svc.backend._half()[0].shape)
    recs = firehose_records(np, svc.hin, np.random.default_rng(SEED + 10),
                            f"sr_{tag}")
    resp = handle_request(svc, {"id": tag, "op": "update", **recs})
    if not (resp["ok"] and resp["result"]["mode"] == "delta"):
        raise AssertionError(f"quiet update {tag} did not patch: {resp}")
    versions[resp["result"]["delta_seq"]] = svc.hin
    return shape, resp["result"]["ms"]


def serving_rest_load(np, svc, versions, handle_request, card):
    """32 clients over the three lanes (rows drawn without repeats per
    lane, so every request dispatches) while a firehose thread applies
    SR_UPDATES updates; clients stop once the firehose is done. Returns
    the answers (lane, row, delta_seq before and after, compactions
    before and after, answer, seconds) and the update results."""
    import threading

    stop = threading.Event()
    errors = []
    rng = np.random.default_rng(SEED + 7)
    pools = {lane: rng.permutation(N_AUTHORS) for lane in SR_LANES}
    records = [[] for _ in range(SR_CLIENTS)]
    updates = []

    def client(c):
        try:
            it = {lane: iter(pools[lane][c::SR_CLIENTS]) for lane in SR_LANES}
            i = 0
            while i < SR_MIN_PER_CLIENT or not stop.is_set():
                lane = SR_LANES[(c + i) % len(SR_LANES)]
                row = next(it[lane], None)
                if row is None:
                    break
                seq0, comp0 = svc._delta_seq, svc._compactor.compactions
                t0 = time.perf_counter()
                ans = svc.topk_index(
                    int(row), TOP_K,
                    metapath=None if lane == SR_LANES[0] else lane)
                dt = time.perf_counter() - t0
                records[c].append((lane, int(row), seq0, svc._delta_seq,
                                   comp0, svc._compactor.compactions, ans,
                                   dt))
                i += 1
        except Exception as exc:  # surfaced below, the phase fails
            errors.append(exc)

    def firehose():
        try:
            urng = np.random.default_rng(SEED + 8)
            for i in range(SR_UPDATES):
                time.sleep(SR_UPDATE_GAP_S)
                recs = firehose_records(np, svc.hin, urng, f"sr_new_{i}")
                comp = svc._compactor.compactions
                resp = handle_request(svc, {"id": i, "op": "update", **recs})
                if not resp["ok"]:
                    raise AssertionError(f"update {i} failed: {resp}")
                res = resp["result"]
                versions[res["delta_seq"]] = svc.hin
                updates.append((res["mode"], res["ms"], comp,
                                res["engines_dropped"],
                                res["memo_invalidated"]))
        except Exception as exc:
            errors.append(exc)
        finally:
            stop.set()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SR_CLIENTS)]
    threads.append(threading.Thread(target=firehose))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"load or firehose failed: {errors[:1]}")
    if not svc._compactor._done.wait(300):
        raise AssertionError("a background compaction did not finish")
    flat = [r for per in records for r in per]
    print(f"load: {len(flat)} topk in {wall:.3f} s -> "
          f"{len(flat) / wall:.1f} QPS beside {len(updates)} updates; "
          "request p50/p99 by lane (client clock, every request a "
          "dispatch): " + "; ".join(
              f"{lane} n={len(ts)} {pct(ts, 0.5):.3f}/{pct(ts, 0.99):.3f} ms"
              for lane in SR_LANES
              for ts in [[r[7] for r in flat if r[0] == lane]])
          + f" ({card})")
    return flat, updates


def serving_rest_checks(np, svc, versions, oracle, records, updates, events,
                        handle_request, card):
    """The phase's gates on the load (sampled answers of every lane
    against the oracle of the graph they were admitted on, before and
    after the background swaps), then the forced compact op (token,
    fingerprint and result-cache entries kept; answers after it against
    the oracle) and the compaction accounting."""
    if any(mode != "delta" for mode, *_ in updates):
        raise AssertionError(f"an update did not patch: {updates}")
    bg = [f for e, f in events if e == "serve_compact"]
    if not any(str(f.get("reason", "")).startswith("delta chain")
               for f in bg):
        raise AssertionError(f"no chain-triggered compaction mid-load: {bg}")
    picked = collections.defaultdict(list)
    for lane, row, seq0, seq1, comp0, comp1, ans, _ in records:
        if seq0 == seq1 and len(picked[lane, seq0]) < SR_SAMPLES_PER_VERSION:
            picked[lane, seq0].append((row, comp0, comp1, ans))
    for lane in SR_LANES:
        n_before = n_after = n = 0
        for (ln, seq), items in sorted(picked.items()):
            if ln != lane:
                continue
            topk, _ = oracle(seq, lane)
            for row, comp0, comp1, (v, i) in items:
                ov, oi = topk(row, TOP_K)
                if not (np.array_equal(v, ov) and np.array_equal(i, oi)):
                    raise AssertionError(
                        f"{lane} row {row} at delta_seq {seq} differs "
                        "from the host f64 oracle")
                n += 1
                n_before += comp1 == 0
                n_after += comp0 >= 1
        if not (n_before and n_after):
            raise AssertionError(f"{lane}: no sampled answer before "
                                 f"({n_before}) or after ({n_after}) a swap")
        print(f"{lane}: {n} sampled answers over "
              f"{len({s for (ln, s) in picked if ln == lane})} graph versions "
              f"({n_before} before the first swap, {n_after} after one) "
              "equal to the host f64 oracle")

    seq = svc._delta_seq
    tok, fp, entries = svc.consistency_token, svc._fp, len(svc.result_cache)
    resp = handle_request(svc, {"id": "compact", "op": "compact"})
    res = resp.get("result") or {}
    if not (resp["ok"] and res.get("swapped")):
        raise AssertionError(f"forced compaction failed: {resp}")
    if (svc.consistency_token, svc._fp, len(svc.result_cache)) != (
            tok, fp, entries):
        raise AssertionError("the forced compaction moved the token, the "
                             "fingerprint or the result-cache entries")
    print(f"forced compact op: swapped, capacity {res['capacity']}, token "
          f"{list(tok)}, fingerprint and {entries} result-cache entries "
          "unchanged")
    rng = np.random.default_rng(SEED + 9)
    for lane in SR_LANES:
        topk, _ = oracle(seq, lane)
        for row in rng.choice(svc.n, 6, replace=False):
            v, i = svc.topk_index(int(row), TOP_K,
                                  metapath=None if lane == SR_LANES[0]
                                  else lane)
            ov, oi = topk(int(row), TOP_K)
            if not (np.array_equal(v, ov) and np.array_equal(i, oi)):
                raise AssertionError(f"{lane} row {row} after the forced "
                                     "compaction differs from the oracle")
    print("after the forced compaction: 6 rows of every lane (appended "
          "authors among the candidates) equal to the host f64 oracle")
    st = svc.stats()
    comp = st["compaction"]
    if comp["compactions"] < 2 or comp["failures"]:
        raise AssertionError(f"compaction accounting: {comp}")
    swaps = [f for e, f in events if e == "serve_compact"]
    print(f"compactions: {comp['compactions']} ({comp['abandoned']} "
          f"abandoned, {comp['failures']} failed); per swap: " + "; ".join(
              f"{f['reason'].split(' ')[0]} build {f['build_ms']:.1f} ms, "
              f"pause {f['pause_ms']:.3f} ms, {f['replayed_deltas']} "
              "replayed" for f in swaps) + f" ({card})")
    first_swap = min((i for i, u in enumerate(updates) if u[2] >= 1),
                     default=len(updates))
    before = [u[1] for u in updates[:first_swap]]
    after = [u[1] for u in updates[first_swap:]]
    print(f"update ms (service's own): before the first swap median "
          f"{statistics.median(before) if before else float('nan'):.3f} "
          f"(n={len(before)}), after it median "
          f"{statistics.median(after) if after else float('nan'):.3f} "
          f"(n={len(after)}); engines dropped per update "
          f"{sorted({u[3] for u in updates})}, memo entries invalidated "
          f"{sorted({u[4] for u in updates})} ({card})")
    builds = [f for e, f in events if e == "metapath_engine_ready"]
    memo = st["plan"]["memo"]
    print(f"engines built: {len(builds)} (rebuilt after each update), "
          "startup s median by lane: " + ", ".join(
              f"{lane} {statistics.median(ts):.3f}" for lane in SR_LANES[1:]
              for ts in [[f['startup_s'] for f in builds
                          if f['metapath'] == lane] or [float('nan')]])
          + f"; memo hits {memo['hits']}, misses {memo['misses']}, "
          f"evictions {memo['evictions']}, {memo['entries']} entries, "
          f"{memo['bytes']} bytes ({card})")


def serving_rest_kernels(torch, ck, np, backend, aptpa, k1_before,
                         shape_before, card):
    """K1 (k = 10), K4 (k = 20) and K2 on the compacted backend against a
    backend freshly built for the compacted graph and the plain versions
    on its logical rows (the padded rows carry no edges), and K1 on the
    APTPA engine's factor against its plain version. Returns the
    launches per kernel of the compacted and the APTPA backends' calls."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend

    launches = collections.Counter()
    fresh = create_backend("torch", backend.hin, backend.metapath,
                           device="cuda")
    n = backend.n_sources
    c, rs = backend._half()
    lim = backend._limbs(c)
    for k, kernel, plain, label in (
            (TOP_K, "topk_twopass_candidates", ck.fused_topk_twopass_plain,
             "K1"),
            (TOP_K_FOLD, "topk_fold", ck.fused_topk_plain, "K4")):
        got, counts, _ = counted(
            torch, ck, launches, lambda: backend.topk(k=k),
            f"rank-all k={k} on the compacted backend")
        if counts[kernel] < 1:
            raise AssertionError(f"rank-all k={k} did not launch {label}")
        want = fresh.topk(k=k)  # a comparison: not counted
        pv, pi = plain(c[:n], rs[:n], k=k)
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])
                and np.array_equal(got[0], pv.cpu().numpy())
                and np.array_equal(got[1], pi.cpu().numpy())):
            raise AssertionError(f"{label} on the compacted backend differs "
                                 "from the fresh backend or the plain "
                                 "version")
        del pv, pi
        print(f"{label} (k={k}) on the compacted {tuple(c.shape)} factor "
              "(patched once since its swap, limbs split anew): "
              "bit-identical to the fresh backend and to the plain version "
              f"on its {n} logical rows")
    ce, rse = aptpa._half()
    ne = aptpa.n_sources
    got, counts, _ = counted(
        torch, ck, launches, lambda: aptpa.topk(k=TOP_K),
        f"rank-all k={TOP_K} on the APTPA engine's {tuple(ce.shape)} factor")
    if counts["topk_twopass_candidates"] < 1:
        raise AssertionError("the APTPA engine's rank-all did not launch K1")
    pv, pi = ck.fused_topk_twopass_plain(ce[:ne], rse[:ne], k=TOP_K)
    err = max_abs_err(torch, torch.as_tensor(got[0]), pv.cpu())
    if not (np.array_equal(got[0], pv.cpu().numpy())
            and np.array_equal(got[1], pi.cpu().numpy())):
        raise AssertionError("K1 on the APTPA factor differs from the plain "
                             "version")
    lim_e = aptpa._limbs(ce)
    print(f"K1 on the APTPA engine's {tuple(ce.shape)} factor (max count "
          f"{float(ce.max()):.0f}, {lim_e.planes.shape[0]} limb planes): "
          f"equal to the plain version (max abs err {err})")
    del pv, pi, ce, rse, lim_e
    torch.cuda.empty_cache()
    got, counts, _ = counted(
        torch, ck, launches, backend.all_pairs_scores,
        "all-pairs scores on the compacted backend (host copy)")
    if counts["fused_scores"] < 1:
        raise AssertionError("all-pairs did not launch K2")
    fc, frs = fresh._half()
    want = ck.fused_scores(fc, frs, limbs=fresh._limbs(fc))[:n, :n].cpu()
    del fc, frs, fresh
    if not np.array_equal(got, want.numpy()):
        raise AssertionError("K2 on the compacted backend differs from the "
                             "fresh backend")
    del want
    plain = ck.fused_scores_plain(c[:n], rs[:n]).cpu()
    if not np.array_equal(got, plain.numpy()):
        raise AssertionError("K2 on the compacted backend differs from the "
                             "plain version")
    del got, plain
    torch.cuda.empty_cache()
    print(f"K2 on the compacted factor ({n}x{n} of the {c.shape[0]}-row "
          "scores): equal to the fresh backend's and to the plain version")
    k1_after = time_ms(torch, lambda: ck.topk_twopass_candidates(
        c, rs, TOP_K, True, limbs=lim))
    print(f"K1 topk_twopass_candidates k={TOP_K}: {k1_before:.3f} ms on the "
          f"{shape_before} factor before compaction, {k1_after:.3f} ms on the "
          f"compacted {tuple(c.shape)} factor (stripes of "
          f"{ck.twopass_stripe_tiles(*shape_before, TOP_K, c.device)} and "
          f"{ck.twopass_stripe_tiles(*c.shape, TOP_K, c.device)} column "
          f"tiles of {ck.TILE}; CUDA "
          f"events, median of {REPS}; {card})")
    return launches


def serve_config5(np, backend, c64, d64, card):
    """The config 5 torch-sparse backend behind a service: 64 requests,
    3 seeded rows within C5_ATOL of host f64 arithmetic."""
    from distributed_pathsim_tpu_torch.serving import (
        PathSimService,
        ServeConfig,
    )

    n = backend.n
    svc = PathSimService(backend, config=ServeConfig(
        max_batch=SERVE_MAX_BATCH, k_default=TOP_K, warm=False))
    try:
        rng = np.random.default_rng(C5_SPOT_SEED + 1)
        rows = rng.integers(0, n, C5_SERVE_REQUESTS)
        t0 = time.perf_counter()
        futs = [svc.submit_topk(int(r), TOP_K) for r in rows]
        answers = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        for j in range(C5_SPOT_ROWS):
            r = int(rows[j])
            m = c64 @ c64[r]
            den = d64[r] + d64
            s64 = np.where(den > 0, 2.0 * m / np.where(den > 0, den, 1.0),
                           0.0)
            s64[r] = -np.inf
            expect = np.sort(s64)[::-1][:TOP_K]
            vals, idxs = answers[j]
            np.testing.assert_allclose(vals, expect, atol=C5_ATOL,
                                       err_msg=f"served config 5 row {r}")
            np.testing.assert_allclose(s64[idxs], expect, atol=C5_ATOL,
                                       err_msg=f"served config 5 row {r} "
                                       "columns")
        lat = svc._m_latency["dispatch"]
        print(f"config 5 served: {C5_SERVE_REQUESTS} topk requests in "
              f"{wall:.3f} s ({svc.stats()['dispatch']['batches']} batches; "
              f"dispatch p50 {lat.quantile(0.5) * 1e3:.1f} ms, p99 "
              f"{lat.quantile(0.99) * 1e3:.1f} ms); rows "
              f"{[int(r) for r in rows[:C5_SPOT_ROWS]]} within {C5_ATOL} of "
              f"host f64 arithmetic ({card})")
    finally:
        svc.close()


# -- compressed factors, the symmetric half-sweep, the batch tier -------------


def sha256_file(path) -> str:
    import hashlib

    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def packed_sym_batch(torch, ck, np, workdir, card, hin, hin_ap, c5):
    """Phase 6b: the packed arms of torch-sparse at config 5 against its
    COO run, a bitpacked service and router under the serving phase's
    update, the symmetric half-sweep against the full sweep (K3) with a
    SIGTERM and a resume, and the batch tier's campaigns on the
    8192-author graph. Returns the phase's launches per kernel."""
    from distributed_pathsim_tpu_torch.utils.compile_counter import (
        CompileCounter,
    )

    phase("compressed factors, symmetric half-sweep, batch tier")
    launches = {name: 0 for name in ck.LAUNCHES}
    t0 = time.perf_counter()
    with CompileCounter() as compiles:
        packed_config5(torch, ck, np, launches, card, c5)
        packed_serving(torch, ck, np, launches, workdir, card, hin)
        symmetric_sweep(torch, ck, np, launches, workdir, card)
        batch_tier(torch, ck, np, workdir, card, hin_ap)
    if compiles.count:
        raise AssertionError(
            f"{compiles.count} compiles in the phase: {compiles.by_kind}")
    print(f"phase: {time.perf_counter() - t0:.1f} s, 0 compiles, launches "
          f"{launches}")
    return launches


def packed_config5(torch, ck, np, launches, card, c5):
    """torch-sparse with the blocked and bitpacked layouts on config 5's
    graph: rank-all element for element equal to the COO run, K3 once
    per row tile."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.driver import PathSimDriver

    coo = c5["factor"]
    print(f"config 5 coo: {coo['bytes']} B for {coo['nnz']} nnz "
          f"({coo['bytes'] / coo['nnz']:.3f} B/nnz), backend init "
          f"{c5['init_s']:.3f} s, rank-all {c5['rank_s']:.3f} s")
    for fmt in PACKED_FORMATS:
        t0 = time.perf_counter()
        b = create_backend("torch-sparse", c5["hin"], c5["mp"],
                           tile_rows=C5_TILE_ROWS, exact_counts=False,
                           factor_format=fmt)
        init_s = time.perf_counter() - t0
        (vals, idxs), counts, rank_s = counted(
            torch, ck, launches,
            lambda: PathSimDriver(b).rank_all(k=TOP_K),
            f"config 5 rank_all k={TOP_K} {fmt}")
        if counts["topk_rect_candidates"] != c5["tiles"]:
            raise AssertionError(
                f"{fmt}: K3 launched {counts['topk_rect_candidates']} times "
                f"for {c5['tiles']} row tiles")
        if not (np.array_equal(vals, c5["vals"])
                and np.array_equal(idxs, c5["idxs"])):
            raise AssertionError(f"config 5 {fmt} rank-all differs from coo")
        info = b.factor_info()
        if info["nnz"] != coo["nnz"] or info["bytes"] >= coo["bytes"]:
            raise AssertionError(f"config 5 {fmt} factor: {info}")
        print(f"config 5 {fmt}: {info['bytes']} B ({info['bytes'] / info['nnz']:.3f}"
              f" B/nnz, {coo['bytes'] / info['bytes']:.2f}x less than coo), "
              f"backend init {init_s:.3f} s (fold + pack; K3's dense copy "
              f"decoded in the rank-all), rank-all {rank_s:.3f} s, K3 "
              f"launches {counts['topk_rect_candidates']}: values and "
              f"indices equal to the coo run's ({card})")
        del b
        gc.collect()
        torch.cuda.empty_cache()


def packed_serving(torch, ck, np, launches, workdir, card, hin):
    """A bitpacked torch-sparse service beside a coo one at the bench
    shape (headroom 0.25): sampled answers equal to the host f64 oracle
    and to each other before and after the serving phase's update; K3 on
    both patched backends equal; then ``dpathsim-torch router --workers
    1 --backend torch-sparse --factor-format bitpacked`` as a subprocess
    answering the same."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.data import delta as tdl
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.serving import (
        PathSimService,
        ServeConfig,
    )
    from distributed_pathsim_tpu_torch.serving.protocol import handle_request

    hin_h = tdl.with_headroom(hin, SERVE_HEADROOM)
    mp = compile_metapath("APVPA", hin_h.schema)
    svcs = {}
    for fmt in ("bitpacked", "coo"):
        t0 = time.perf_counter()
        svcs[fmt] = PathSimService(
            create_backend("torch-sparse", hin_h, mp, device="cuda",
                           factor_format=fmt),
            config=ServeConfig(max_batch=SERVE_MAX_BATCH, k_default=TOP_K))
        print(f"torch-sparse {fmt} service start: "
              f"{time.perf_counter() - t0:.3f} s, factor "
              f"{svcs[fmt].stats()['factor']}")
    try:
        svc, ref = svcs["bitpacked"], svcs["coo"]
        if svc.memo is not None and svc.memo.factor_format != "bitpacked":
            raise AssertionError("the service's memo does not follow the "
                                 "backend's factor format")
        rng = np.random.default_rng(SEED + 3)
        rows = rng.integers(0, svc.n, PK_SERVE_SAMPLES)

        def sample(rows, oracle, label):
            got = [svc.topk_index(int(r), TOP_K) for r in rows]
            want = [ref.topk_index(int(r), TOP_K) for r in rows]
            check_served(np, got, rows, oracle, TOP_K, f"bitpacked {label}")
            if any(not (np.array_equal(a[0], b[0])
                        and np.array_equal(a[1], b[1]))
                   for a, b in zip(got, want)):
                raise AssertionError(f"bitpacked {label}: differs from coo")
            return got

        oracle, _ = f64_topk(np, svc.hin, mp)
        before = sample(rows, oracle, "before the update")
        recs = update_records(np, svc.hin, np.random.default_rng(SEED + 1),
                              "packed_new")
        res = {}
        for fmt, s in svcs.items():
            resp = handle_request(s, {"id": 1, "op": "update", **recs,
                                      "want_rows": True})
            if not resp["ok"] or resp["result"]["mode"] != "delta":
                raise AssertionError(f"{fmt} update did not patch: {resp}")
            res[fmt] = resp["result"]
        r = res["bitpacked"]
        print(f"bitpacked update: {r['edge_changes']} edge changes, "
              f"{r['node_appends']} appended, mode {r['mode']}, "
              f"{r['affected_rows']} affected rows, {r['ms']:.3f} ms "
              f"(coo: {res['coo']['ms']:.3f} ms); factor after "
              f"{svc.stats()['factor']} ({card})")
        n0 = hin_h.type_size("author")
        affected = np.asarray(r["affected_row_list"], dtype=np.int64)
        probe = np.unique(np.concatenate(
            [rows, affected[:PK_SERVE_SAMPLES], np.arange(n0, svc.n)]))
        new_oracle, _ = f64_topk(np, svc.hin, mp)
        after = sample(probe, new_oracle, "after the update")
        (got, want), counts, _ = counted(
            torch, ck, launches,
            lambda: (svc.backend.topk_scores(k=TOP_K),
                     ref.backend.topk_scores(k=TOP_K)),
            "rank-all on the patched bitpacked and coo backends")
        if counts["topk_rect_candidates"] < 2:
            raise AssertionError("the patched backends did not launch K3")
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])):
            raise AssertionError("K3 on the patched bitpacked backend "
                                 "differs from coo")
        print("K3 rank-all on the patched bitpacked backend (u8 limbs "
              "split anew after the patch): equal to the patched coo one")
        packed_router(np, workdir, card, recs, rows, before, probe, after,
                      svc.hin.indices["author"].ids)
    finally:
        for s in svcs.values():
            s.close()
        gc.collect()
        torch.cuda.empty_cache()


def packed_router(np, workdir, card, recs, rows, before, probe, after, ids):
    """The router with one bitpacked torch-sparse worker on the bench
    GEXF: its answers before and after the same update equal the
    in-process bitpacked service's."""
    script = [{"id": 100 + j, "op": "topk", "row": int(r), "k": TOP_K}
              for j, r in enumerate(rows[:8])]
    script.append({"id": 1, "op": "update", **recs})
    script += [{"id": 200 + j, "op": "topk", "row": int(r), "k": TOP_K}
               for j, r in enumerate(probe[-8:])]
    script.append({"id": 2, "op": "shutdown"})
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", "router",
         "--workers", "1", "--platform", "cuda", "--backend", "torch-sparse",
         "--factor-format", "bitpacked", "--headroom", str(SERVE_HEADROOM),
         "--dataset", str(workdir / "bench.gexf")],
        input="\n".join(json.dumps(r) for r in script) + "\n",
        capture_output=True, text=True, timeout=600, cwd=HERE,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"router exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    resps = {r["id"]: r for r in map(json.loads, proc.stdout.splitlines())}
    if not all(r["ok"] for r in resps.values()) or len(resps) != len(script):
        raise AssertionError(f"router responses: {list(resps.values())[:3]}")
    if resps[1]["result"]["applied"] != ["w0"]:
        raise AssertionError(f"router update: {resps[1]}")
    want = [(100 + j, before[j]) for j in range(8)]
    want += [(200 + j, after[len(after) - 8 + j]) for j in range(8)]
    for rid, (v, i) in want:
        got = [(e["id"], e["score"]) for e in resps[rid]["result"]["topk"]]
        if got != [(ids[j], float(x)) for x, j in zip(v, i)]:
            raise AssertionError(f"router answer {rid} differs: {got}")
    print(f"dpathsim-torch router --workers 1 --backend torch-sparse "
          f"--factor-format bitpacked: exit 0 in {wall:.1f} s, 16 answers "
          f"before and after the update equal to the in-process bitpacked "
          f"service's ({card})")


SYM_CHILD = """
import sys
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.ops import cuda_kernels
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.resilience import (
    PREEMPTED_EXIT_CODE, Preempted, preemption_handler)
cuda_kernels.true_f32()
a, p, v, seed, t, k = map(int, sys.argv[2:8])
hin = synthetic_hin(a, p, v, seed=seed)
b = create_backend("torch-sparse", hin, compile_metapath("APVPA", hin.schema),
                   tile_rows=t, exact_counts=False)
preemption_handler.install()
print("sweeping", flush=True)
try:
    b.topk_scores(k=k, checkpoint_dir=sys.argv[1], symmetric=True)
except Preempted:
    sys.exit(PREEMPTED_EXIT_CODE)
"""


def symmetric_sweep(torch, ck, np, launches, workdir, card):
    """torch-sparse's symmetric half-sweep on config 5's shape cut to
    SYM_AUTHORS authors, approx like config 5: against the full sweep
    (K3) by config 5's rule — values within C5_ATOL, the same columns
    wherever the full sweep's k-th and (k+1)-th scores differ by more
    (K3 sums exact integer counts, the sweep's f32 GEMM rounds past
    2^24) — and timed per tile pair; a child process running it with a
    checkpoint directory is sent SIGTERM mid-sweep (exit 75) and the
    resume from its sym_partials snapshot returns the same arrays."""
    import signal

    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    hin = synthetic_hin(SYM_AUTHORS, SYM_PAPERS, C5_VENUES, seed=SEED)
    b = create_backend("torch-sparse", hin,
                       compile_metapath("APVPA", hin.schema),
                       tile_rows=C5_TILE_ROWS, exact_counts=False)
    tiles = b._n_live_tiles
    pairs = tiles * (tiles + 1) // 2
    (fv, fi), counts, full_s = counted(
        torch, ck, launches, lambda: b.topk_scores(k=TOP_K + 1),
        f"full sweep {SYM_AUTHORS} authors, k={TOP_K + 1}")
    if counts["topk_rect_candidates"] != tiles:
        raise AssertionError("the full sweep did not run K3 on every tile")
    (sv, si), counts, sym_s = counted(
        torch, ck, launches, lambda: b.topk_scores(k=TOP_K, symmetric=True),
        f"symmetric half-sweep {SYM_AUTHORS} authors")
    if any(counts.values()):
        raise AssertionError(f"the symmetric sweep launched {counts}")
    err = float(np.abs(sv - fv[:, :TOP_K]).max())
    clear = (fv[:, TOP_K - 1] - fv[:, TOP_K]) > C5_ATOL
    same = (np.sort(si, 1) == np.sort(fi[:, :TOP_K], 1)).all(1)
    exact = ((sv == fv[:, :TOP_K]) & (si == fi[:, :TOP_K])).all(1)
    if err > C5_ATOL or not same[clear].all():
        raise AssertionError(
            f"symmetric vs full sweep: max |diff| {err}, "
            f"{int((~same & clear).sum())} rows with other columns")
    print(f"symmetric half-sweep {SYM_AUTHORS}x{SYM_PAPERS}x{C5_VENUES}, "
          f"tile_rows {C5_TILE_ROWS}: {sym_s:.3f} s for {pairs} tile pairs "
          f"({sym_s / pairs * 1e3:.2f} ms a pair) against the full sweep's "
          f"{full_s:.3f} s (K3, {tiles} row tiles); max |diff| {err:.3g}, "
          f"columns equal in all {int(clear.sum())} rows whose k-th and "
          f"(k+1)-th full-sweep scores differ by more than {C5_ATOL}; "
          f"{int(exact.sum())} of {exact.shape[0]} rows bit-identical "
          f"({card})")

    ckdir = workdir / "sym_ckpt"
    child = subprocess.Popen(
        [sys.executable, "-c", SYM_CHILD, str(ckdir), str(SYM_AUTHORS),
         str(SYM_PAPERS), str(C5_VENUES), str(SEED), str(C5_TILE_ROWS),
         str(TOP_K)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE)
    try:
        if child.stdout.readline().strip() != "sweeping":
            raise AssertionError(f"sweep child: {child.stderr.read()[-2000:]}")
        manifest = ckdir / "manifest.json"
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline and child.poll() is None:
            done = (json.loads(manifest.read_text())
                    if manifest.exists() else {})
            if sum(key.startswith("topk") for key in done) >= SYM_KILL_AFTER:
                break
            time.sleep(0.05)
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if rc != 75:
        raise AssertionError(f"sweep child exited {rc}, want 75: "
                             f"{child.stderr.read()[-2000:]}")
    keys = CheckpointManager(ckdir).done_keys()
    snaps = [key for key in keys if key.startswith("sym_partials_after_")]
    if len(snaps) != 1:
        raise AssertionError(f"after SIGTERM the checkpoint holds {snaps}")
    t0 = time.perf_counter()
    rv, ri = b.topk_scores(k=TOP_K, checkpoint_dir=str(ckdir), symmetric=True)
    resume_s = time.perf_counter() - t0
    if not (np.array_equal(rv, sv) and np.array_equal(ri, si)):
        raise AssertionError("the resumed symmetric sweep differs")
    print(f"symmetric sweep SIGTERM: exit 75 with {snaps[0]} and "
          f"{len(keys) - 1} row units; the resume ({resume_s:.3f} s) returns "
          "the same arrays")
    del b
    gc.collect()
    torch.cuda.empty_cache()


def batch_argv(gexf, *extra):
    return ["batch", *extra, "--dataset", str(gexf), "--platform", "cuda"]


def batch_tier(torch, ck, np, workdir, card, hin_small):
    """``dpathsim-torch batch`` on the 8192-author all-pairs graph (the
    campaign is host-bound; its bench-shape run, 49 s at a card share of
    0.023, made room for phase 6h): topk-all bit-identical to the host
    f64 oracle for every row (K1's f32 scores are no yardstick here: the
    head authors' d_i + d_j passes 2^24, so K1's f32 denominator rounds;
    K1 is held against the oracle on the main path); a SIGTERM
    mid-campaign (exit 75) and
    ``resume`` giving sha256-identical --out and --emit-pairs; bitpacked
    and --workers 2 the same bytes as coo; simjoin with degree and
    natural grouping the same pair set. Every GEMM on the card."""
    import signal

    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.cli import main as cli_main
    from distributed_pathsim_tpu_torch.obs.metrics import get_registry
    from distributed_pathsim_tpu_torch.ops import pathsim
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    small = workdir / "allpairs.gexf"
    gemm_ms = []
    device_counts = pathsim.device_counts

    def timed_counts(a, b_dev):
        """The port's own device arm between CUDA events: the block's
        upload, the f64 GEMM and the fetch, so the share counts the
        copies too."""
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = device_counts(a, b_dev)
        e1.record()
        e1.synchronize()
        gemm_ms.append(e0.elapsed_time(e1))
        return out

    get_registry().enabled = True  # the arms' counter below counts
    backend_total = get_registry().counter(
        "dpathsim_batch_score_backend_total")
    backend_total.reset()

    def run(label, graph, n, *argv):
        t0 = time.perf_counter()
        rc = cli_main(batch_argv(graph, *argv))
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"batch {label}: exit {rc}")
        print(f"batch {label} ({n} authors): {wall:.3f} s -> "
              f"{float(n) * (n - 1) / wall:.4g} author-pairs/s ({card})")
        return wall

    out = {name: workdir / f"batch_{name}" for name in (
        "b.npz", "b.jsonl", "s.npz", "s.jsonl", "p.npz",
        "p.jsonl", "w.npz", "w.jsonl", "deg.jsonl", "nat.jsonl")}
    n_small = N_AUTHORS_ALL_PAIRS
    pathsim.device_counts = timed_counts
    try:
        wall = run(f"topk-all k={TOP_K}", small, n_small, "topk-all", "--k",
                   str(TOP_K), "--out", str(out["s.npz"]), "--emit-pairs",
                   str(out["s.jsonl"]))
    finally:
        pathsim.device_counts = device_counts
    share = sum(gemm_ms) / 1e3 / wall
    print(f"batch topk-all: {len(gemm_ms)} blocks through the card's "
          f"arm (upload, f64 GEMM, fetch), {sum(gemm_ms):.1f} ms of "
          f"CUDA-event time: a device share of {share:.4f} of the "
          "campaign's wall time")
    res = np.load(out["s.npz"])
    oracle = create_backend("numpy", hin_small,
                            compile_metapath("APVPA", hin_small.schema))
    want_v, want_i = oracle.topk_rows(np.arange(n_small), k=TOP_K)
    if not (np.array_equal(res["vals"], want_v)
            and np.array_equal(res["idxs"], want_i)):
        raise AssertionError("batch topk-all differs from the host f64 "
                             "oracle")
    print(f"batch topk-all vs the host f64 oracle: all {n_small} rows' "
          "values and indices bit-identical")
    del oracle

    for name, extra in (("p", ("--factor-format", "bitpacked")),
                        ("w", ("--workers", "2"))):
        run(f"topk-all k={TOP_K} {' '.join(extra)}".rstrip(), small, n_small,
            "topk-all", "--k", str(TOP_K), *extra, "--out",
            str(out[f"{name}.npz"]), "--emit-pairs",
            str(out[f"{name}.jsonl"]))

    # SIGTERM mid-campaign (a child process; 32-row blocks, so the signal
    # lands well before the last of them), then resume
    ckdir = workdir / "batch_ckpt"
    child = subprocess.Popen(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli",
         *batch_argv(small, "topk-all"), "--k", str(TOP_K), "--block-rows",
         str(BATCH_KILL_BLOCK_ROWS), "--checkpoint-dir", str(ckdir), "--out",
         str(out["b.npz"]), "--emit-pairs", str(out["b.jsonl"])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE)
    try:
        manifest = ckdir / "manifest.json"
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline and child.poll() is None:
            done = (json.loads(manifest.read_text())
                    if manifest.exists() else {})
            if sum(key.startswith("b") for key in done) >= BATCH_KILL_AFTER:
                break
            time.sleep(0.02)
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if rc != 75:
        raise AssertionError(f"batch child exited {rc}, want 75: "
                             f"{child.stderr.read()[-2000:]}")
    done = sum(key.startswith("b") for key in
               json.loads((ckdir / "manifest.json").read_text()))
    run("resume", small, n_small, "resume", "--checkpoint-dir", str(ckdir),
        "--out", str(out["b.npz"]), "--emit-pairs", str(out["b.jsonl"]))
    for x, y in (("s.npz", "b.npz"), ("s.jsonl", "b.jsonl")):
        if sha256_file(out[x]) != sha256_file(out[y]):
            raise AssertionError(f"resumed {y} differs from {x}")
    print(f"batch SIGTERM mid-campaign: exit 75 after {done} of "
          f"{-(-n_small // BATCH_KILL_BLOCK_ROWS)} blocks; resume gives "
          "sha256-identical --out and --emit-pairs")
    for x in ("p", "w"):
        for ext in ("npz", "jsonl"):
            if sha256_file(out[f"s.{ext}"]) != sha256_file(out[f"{x}.{ext}"]):
                raise AssertionError(f"batch {x}.{ext} differs from s.{ext}")
    print("batch bitpacked and --workers 2: sha256-identical to the coo "
          "single-host run")

    for tau in BATCH_TAUS:
        for grouping in ("degree", "natural"):
            run(f"simjoin --tau {tau} --grouping {grouping}", small,
                n_small, "simjoin", "--tau", str(tau), "--grouping",
                grouping, "--out", str(out[f"{grouping[:3]}.jsonl"]))
        sets = [sorted(out[f].read_text().splitlines())
                for f in ("deg.jsonl", "nat.jsonl")]
        if sets[0] != sets[1]:
            raise AssertionError(f"simjoin tau {tau}: degree and natural "
                                 "pair sets differ")
        print(f"batch simjoin tau {tau}: {len(sets[0])} pairs, the same set "
              "with degree and natural grouping")
    arms = {dict(key).get("backend"): cell.value
            for key, cell in backend_total.cells() if cell.value}
    if set(arms) != {"cuda"}:
        raise AssertionError(f"batch GEMM arms: {arms}")
    print(f"dpathsim_batch_score_backend_total: {arms} (the card only)")


# -- multi-device and partition mode -------------------------------------------


# The ring: torch-sharded with D shards, all on the one card; the CLI runs
# use SHARD_CLI_DEVICES of them; the partition fleet is PART_WORKERS port
# partition workers on the card (replication PART_REPLICATION) over the
# bench graph without headroom (partition mode routes edge deltas only).
SHARD_COUNTS = (1, 2, 4, 8)
SHARD_CLI_DEVICES = 4
PART_WORKERS, PART_REPLICATION = 4, 2
PART_SPEC = ROUTER_SPEC


def sharded_partition(torch, ck, np, workdir, card, hin, hin_ap, dense):
    """Multi-device and partition mode on the card: the ring at the bench
    shape with D = 1, 2, 4, 8 shards against K1, the two all-pairs
    strategies against K2, the CLI (logs, SIGTERM resume, the ensemble, a
    one-process rendezvous) and a partition fleet. Returns the launches
    of its runs per kernel."""
    from distributed_pathsim_tpu_torch.utils.compile_counter import (
        compiles_total,
    )

    launches = {name: 0 for name in ck.LAUNCHES}
    compiles0 = compiles_total()
    sharded_ring(torch, ck, np, launches, card, hin, dense)
    sharded_allpairs(torch, ck, np, launches, card, hin_ap)
    sharded_cli(torch, ck, np, launches, workdir, card, hin, hin_ap)
    partition_fleet(np, card)
    if compiles_total() != compiles0:
        raise AssertionError(f"the phase compiled or loaded a kernel: "
                             f"{compiles0} -> {compiles_total()}")
    print(f"phase compiles: {compiles0}, unchanged (every kernel was built "
          "and loaded before it)")
    return launches


def sharded_ring(torch, ck, np, launches, card, hin, dense):
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    phase(f"torch-sharded ring at {N_AUTHORS}x{N_PAPERS}x{N_VENUES} "
          f"k={TOP_K}: D = {SHARD_COUNTS} shards on the one card against K1")
    mp = compile_metapath("APVPA", hin.schema)
    want = {var: dense.topk(k=TOP_K, variant=var)
            for var in ("rowsum", "diagonal")}
    for n_dev in SHARD_COUNTS:
        b = create_backend("torch-sharded", hin, mp, device="cuda",
                           n_devices=n_dev)
        for var, (wv, wi) in want.items():
            (gv, gi), counts, dt = counted(
                torch, ck, launches, lambda: b.topk(k=TOP_K, variant=var),
                f"ring D={n_dev} {var}")
            if counts["topk_rect_candidates"] != n_dev * n_dev or sum(
                    counts.values()) != n_dev * n_dev:
                raise AssertionError(f"ring D={n_dev}: launches {counts}, "
                                     f"want {n_dev * n_dev} of K3 alone")
            if not (np.array_equal(gv, wv) and np.array_equal(gi, wi)):
                raise AssertionError(f"ring D={n_dev} {var} differs from K1")
        walls = wall_s(torch, lambda: b.topk(k=TOP_K), reps=3)
        k3 = ring_k3_ms(torch, ck, b)
        print(f"ring D={n_dev}: values and indices equal to K1's on both "
              f"variants; {n_dev * n_dev} K3 launches a run; wall "
              f"{statistics.median(walls) * 1e3:.3f} ms median of 3 (min "
              f"{min(walls) * 1e3:.3f}); K3 over its {n_dev * n_dev} steps "
              f"{k3:.3f} ms (CUDA events, median of 7); one card, so the "
              f"rotation moves no bytes: nothing here measures NVLink "
              f"({card})")
        del b
    gc.collect()
    torch.cuda.empty_cache()


def ring_k3_ms(torch, ck, b):
    """K3 alone over the D² (shard, step) tiles of ``b``'s ring: the
    launches the ring makes, timed between CUDA events (not counted)."""
    from distributed_pathsim_tpu_torch.parallel.sharded import (
        sharded_ring_state,
    )

    c, d = sharded_ring_state(b._first, (), mesh=b.mesh)
    lim = b._shard_limbs(True)
    n_loc = c[0].shape[0]
    own = torch.arange(n_loc, dtype=torch.int32, device="cuda")
    peer = torch.full((n_loc,), -1, dtype=torch.int32, device="cuda")
    n_dev = len(c)

    def run():
        for s in range(n_dev):
            for o in range(n_dev):
                ck.topk_rect_candidates(
                    c[s], c[o], d[s], d[o], own if o == s else peer, TOP_K,
                    n_true_cols=n_loc, limbs=(lim[s], lim[o]))

    return time_ms(torch, run)


def sharded_allpairs(torch, ck, np, launches, card, hin_ap):
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    phase(f"torch-sharded all-pairs at {N_AUTHORS_ALL_PAIRS} authors: "
          "allgather and ring against K2")
    mp = compile_metapath("APVPA", hin_ap.schema)
    c, d = factor(hin_ap, "APVPA", torch.device("cuda"))
    k2 = ck.fused_scores(c, d)
    m_exact = c.double() @ c.double().T
    for strategy in ("allgather", "ring"):
        b = create_backend("torch-sharded", hin_ap, mp, device="cuda",
                           n_devices=SHARD_CLI_DEVICES,
                           allpairs_strategy=strategy)
        (m, gw), counts, dt = counted(
            torch, ck, launches,
            lambda: (b.commuting_matrix(), b.global_walks()),
            f"all-pairs {strategy}")
        mt = torch.as_tensor(m, device="cuda")
        if not torch.equal(mt, m_exact) or not np.array_equal(
                gw, d.double().cpu().numpy()):
            raise AssertionError(f"all-pairs {strategy}: M or row sums "
                                 "differ from the exact product")
        den = d[:, None] + d[None, :]
        s = torch.where(den > 0, (2.0 * mt.float()) / den, 0.0)
        if not torch.equal(s, k2):
            raise AssertionError(f"all-pairs {strategy}: scores differ "
                                 "from K2's")
        print(f"all-pairs {strategy} over {SHARD_CLI_DEVICES} shards: M "
              f"exact, its f32 scores equal to K2's; {dt:.3f} s with the "
              f"host fetch of M ({card})")
        del b, mt, s
    gc.collect()
    torch.cuda.empty_cache()


def sharded_cli(torch, ck, np, launches, workdir, card, hin, hin_ap):
    import os
    import signal
    import socket

    from distributed_pathsim_tpu_torch.cli import main as cli_main
    from distributed_pathsim_tpu_torch.models.multipath import (
        MultiMetapathScorer,
    )

    phase(f"torch-sharded through the CLI (--n-devices "
          f"{SHARD_CLI_DEVICES}): logs, SIGTERM resume, the ensemble, a "
          "one-process rendezvous")

    def run_cli(argv, label):
        rc, counts, dt = counted(torch, ck, launches,
                                 lambda: cli_main(argv), label)
        if rc != 0:
            raise AssertionError(f"{label}: CLI exited {rc}")
        return counts, dt

    gexf = str(workdir / "bench.gexf")
    sharded = ["--dataset", gexf, "--platform", "cuda", "--quiet",
               "--backend", "torch-sharded", "--n-devices",
               str(SHARD_CLI_DEVICES)]
    ids = hin.indices["author"].ids
    log = workdir / "sharded.log"
    run_cli(sharded + ["--source", ids[7], "--output", str(log)],
            "single source, torch-sharded")
    if grammar(log) != grammar(workdir / "single.log"):
        raise AssertionError("the torch-sharded log differs from torch's")
    ranking = workdir / "ranking_sharded.tsv"
    counts, dt = run_cli(sharded + ["--top-k", str(TOP_K), "--ranking-out",
                                    str(ranking)], "rank-all torch-sharded")
    if counts["topk_rect_candidates"] != SHARD_CLI_DEVICES ** 2:
        raise AssertionError(f"rank-all torch-sharded launches {counts}")
    if not filecmp.cmp(ranking, workdir / "ranking.tsv", shallow=False):
        raise AssertionError("the torch-sharded ranking differs from "
                             "torch's")
    print("torch-sharded CLI: the single-source log equal to --backend "
          "torch's outside the *** lines, the rank-all TSV cmp-identical, "
          f"{SHARD_CLI_DEVICES ** 2} K3 launches ({dt:.2f} s)")

    # SIGTERM mid-ring (half a second of injected delay a step), exit 75,
    # resume from the last ring step's snapshot
    ck_dir = workdir / "ring_ckpt"
    resumed = workdir / "ring_resumed.tsv"
    sweep = sharded + ["--top-k", str(TOP_K), "--checkpoint-dir",
                       str(ck_dir), "--ranking-out", str(resumed)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", *sweep],
        cwd=str(HERE), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, env={**os.environ,
                        "PATHSIM_FAULT_PLAN": "tile_execute:delay:100:0.5"})
    manifest = ck_dir / "manifest.json"
    try:
        deadline = time.time() + 240
        while time.time() < deadline and proc.poll() is None:
            if manifest.exists() and "ring_bests_after_1" in json.loads(
                    manifest.read_text()):
                break
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    snaps = [k for k in json.loads(manifest.read_text())
             if k.startswith("ring_bests_after_")]
    if proc.returncode != 75 or len(snaps) != 1:
        raise AssertionError(f"SIGTERM mid-ring: rc {proc.returncode}, "
                             f"snapshots {snaps}; {err[-600:]}")
    after = int(snaps[0].rsplit("_", 1)[1])
    if after >= SHARD_CLI_DEVICES - 1:
        raise AssertionError(f"the ring finished before the signal: {snaps}")
    counts, _ = run_cli(sweep, "resume after SIGTERM")
    want = (SHARD_CLI_DEVICES - 1 - after) * SHARD_CLI_DEVICES
    if counts["topk_rect_candidates"] != want:
        raise AssertionError(f"the resumed ring launched K3 "
                             f"{counts['topk_rect_candidates']} times, want "
                             f"{want}")
    if not filecmp.cmp(resumed, workdir / "ranking.tsv", shallow=False):
        raise AssertionError("the resumed ring's ranking differs")
    print(f"SIGTERM mid-ring: exit 75 with {snaps[0]}; the resume ran "
          f"{want} K3 launches (steps {after + 1}..{SHARD_CLI_DEVICES - 1}) "
          "and wrote a TSV cmp-identical to --backend torch's")

    # the ensemble's all-sources ranking, sharded and not
    gexf_ap = str(workdir / "allpairs.gexf")
    ens = ["--dataset", gexf_ap, "--platform", "cuda", "--metapath",
           "APVPA,APA", "--weights", "0.7,0.3", "--top-k", str(TOP_K),
           "--quiet"]
    _, dt_sh = run_cli(ens + ["--n-devices", str(SHARD_CLI_DEVICES)],
                       "ensemble --n-devices")
    _, dt_host = run_cli(ens, "ensemble (host top-k)")
    scorer = MultiMetapathScorer(hin_ap, ["APVPA", "APA"], device="cuda")
    w = [0.7, 0.3]
    sv, si = scorer.topk_sharded(k=TOP_K, weights=w,
                                 n_devices=SHARD_CLI_DEVICES)
    hv, hi = scorer.topk(k=TOP_K, weights=w)
    comb = torch.as_tensor(scorer.combined_scores(w), device="cuda")
    comb.fill_diagonal_(float("-inf"))
    ov, oi = torch.sort(comb, dim=1, descending=True, stable=True)
    ov = ov[:, :TOP_K].double().cpu().numpy()
    oi = oi[:, :TOP_K].cpu().numpy()
    if not (np.array_equal(sv, hv) and np.array_equal(sv, ov)
            and np.array_equal(si, oi)):
        raise AssertionError("the sharded ensemble ranking differs")
    del comb, scorer
    print(f"ensemble --n-devices {SHARD_CLI_DEVICES} ({dt_sh:.2f} s) and "
          f"host top-k ({dt_host:.2f} s) at {N_AUTHORS_ALL_PAIRS} authors: "
          "equal values; the sharded indices equal a stable sort of the "
          f"combined scores ({int((si != hi).sum())} index slots where the "
          "host argpartition breaks a tie otherwise)")

    # one-process rendezvous (NCCL and gloo, world size 1)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    rz = workdir / "ranking_rendezvous.tsv"
    run_cli(["--dataset", gexf, "--platform", "cuda", "--quiet",
             "--backend", "torch-sharded", "--coordinator-address",
             f"127.0.0.1:{port}", "--num-processes", "1", "--process-id",
             "0", "--top-k", str(TOP_K), "--ranking-out", str(rz)],
            "one-process rendezvous")
    if not filecmp.cmp(rz, workdir / "ranking.tsv", shallow=False):
        raise AssertionError("the rendezvous run's ranking differs")
    print("one-process rendezvous (--coordinator-address, --num-processes "
          "1, --process-id 0): ranking cmp-identical")
    gc.collect()
    torch.cuda.empty_cache()


def edge_records(np, hin, rng):
    """A routed edge delta: UPDATE_ADDS new author_of edges between
    existing authors and papers, UPDATE_REMOVES existing ones removed."""
    blk = hin.blocks["author_of"]
    a_ids = hin.indices["author"].ids
    p_ids = hin.indices["paper"].ids
    n_a, n_p = hin.type_size("author"), hin.type_size("paper")
    existing = set(zip(blk.rows.tolist(), blk.cols.tolist()))
    rem = rng.choice(blk.nnz, UPDATE_REMOVES, replace=False)
    adds = []
    while len(adds) < UPDATE_ADDS:
        e = (int(rng.integers(0, n_a)), int(rng.integers(0, n_p)))
        if e not in existing:
            existing.add(e)
            adds.append({"rel": "author_of", "src": a_ids[e[0]],
                         "dst": p_ids[e[1]]})
    return {"add_edges": adds,
            "remove_edges": [{"rel": "author_of", "src_row": int(blk.rows[i]),
                              "dst_row": int(blk.cols[i])} for i in rem]}


def partition_fleet(np, card):
    """PART_WORKERS port partition workers on the card behind an
    in-process PartitionRouter: a load with one worker SIGKILLed, one
    routed edge delta, the refusal of node appends, compile counts."""
    import threading

    from distributed_pathsim_tpu_torch.data import delta as tdl
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.router import (
        PartitionRouter,
        PartitionRouterConfig,
        SubprocessTransport,
    )
    from distributed_pathsim_tpu_torch.router.cli import (
        _worker_argv,
        build_worker_hin,
        parse_router_args,
    )
    from distributed_pathsim_tpu_torch.router.loadgen import (
        run_router_clients,
    )

    phase(f"partition fleet on the card: {PART_WORKERS} workers, "
          f"replication {PART_REPLICATION}, {PART_SPEC}, {SERVE_CLIENTS} "
          f"clients x {SERVE_PER_CLIENT} topk k={TOP_K}")
    args = parse_router_args([
        "--mode", "partition", "--workers", str(PART_WORKERS),
        "--replication", str(PART_REPLICATION), "--dataset", PART_SPEC,
        "--platform", "cuda", "--headroom", "0", "--k", str(TOP_K)])
    transports = {
        f"w{i}": SubprocessTransport(f"w{i}",
                                     _worker_argv(args, i, partition=True))
        for i in range(PART_WORKERS)}
    router = PartitionRouter(transports, PartitionRouterConfig(
        partitions=PART_WORKERS, replication=PART_REPLICATION,
        ready_timeout_s=600))
    try:
        t0 = time.perf_counter()
        router.start()
        print(f"partition worker start ({PART_WORKERS} processes at once, "
              f"graph build, slice, colsum exchange): "
              f"{time.perf_counter() - t0:.3f} s ({card})")
        compiles0 = {wid: router.worker_health(wid)["compiles"]
                     for wid in transports}
        hin = build_worker_hin(PART_SPEC, 0.0)
        mp = compile_metapath("APVPA", hin.schema)
        oracle, _ = f64_topk(np, hin, mp)
        n = hin.type_size("author")
        rng = np.random.default_rng(SEED + 5)
        rows = rng.integers(0, n, (SERVE_CLIENTS, SERVE_PER_CLIENT))

        reset_router_metrics(router)
        ok_cell = router._m_requests.labels(outcome="ok")
        started, killed = threading.Event(), {}

        def killer():
            started.wait()
            while ok_cell.get() < rows.size // 4:
                time.sleep(0.001)
            killed["at"] = int(ok_cell.get())
            transports["w1"].kill()

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        started.set()
        res = run_router_clients(router, rows.tolist(), TOP_K)
        kt.join(timeout=60)
        if "at" not in killed:
            raise AssertionError("the kill never happened")
        qps = router_histogram(router, card, f"partition fleet load, w1 "
                               f"SIGKILLed after {killed['at']} answers",
                               res["queries"], res["wall_s"])
        if res["lost"] or res["queries"] != rows.size:
            raise AssertionError(f"partition fleet lost {res['lost']}: "
                                 f"{res['errors']}")
        check_routed(np, res["answers"], oracle, hin, TOP_K,
                     "partition fleet load")
        status = {wid: w.status for wid, w in router.workers.items()}
        if status.get("w1") != "down" or list(status.values()).count(
                "up") != PART_WORKERS - 1:
            raise AssertionError(f"worker states after the kill: {status}")
        print(f"partition fleet: 0 lost, {res['failover_affected']} answers "
              f"re-dispatched after the kill, {qps:.1f} QPS ({card})")

        recs = update_records(np, hin, np.random.default_rng(SEED + 7),
                              "part_new")
        refused = router.request({"id": 1, "op": "update", **recs},
                                 timeout=600)
        if refused["ok"] or "edge deltas only" not in refused["error"]:
            raise AssertionError(f"node appends: {refused}")
        edges = edge_records(np, hin, np.random.default_rng(SEED + 7))
        t0 = time.perf_counter()
        resp = router.request({"id": 2, "op": "update", **edges},
                              timeout=600)
        update_ms = (time.perf_counter() - t0) * 1e3
        if not resp["ok"] or "w1" in resp["result"]["sealed"]:
            raise AssertionError(f"partition update: {resp}")
        print(f"routed update ({len(edges['add_edges'])} edges added, "
              f"{len(edges['remove_edges'])} removed; the "
              f"{UPDATE_APPENDS} appended authors refused as the JAX "
              f"package refuses them): sealed on "
              f"{resp['result']['sealed']}, "
              f"{resp['result']['re_encoded_rows']} rows re-encoded, "
              f"{update_ms:.3f} ms from submit to the last ack ({card})")
        plan = tdl.plan_delta(hin, tdl.delta_from_records(hin, **edges), mp)
        new_oracle, _ = f64_topk(np, plan.hin_new, mp)
        probe = np.unique(np.concatenate([
            plan.affected_rows[:512], rows[0, :64]]))
        res = run_router_clients(
            router, [p.tolist() for p in np.array_split(probe,
                                                        SERVE_CLIENTS)],
            TOP_K)
        if res["lost"]:
            raise AssertionError(f"after the update lost {res['lost']}")
        check_routed(np, res["answers"], new_oracle, plan.hin_new, TOP_K,
                     "affected rows after the routed update")
        live = [wid for wid in transports if wid != "w1"]
        compiles1 = {wid: router.worker_health(wid)["compiles"]
                     for wid in live}
        if any(compiles1[wid] != compiles0[wid] for wid in live):
            raise AssertionError(f"worker compiles moved: {compiles0} -> "
                                 f"{compiles1}")
        print(f"partition worker compiles {compiles1}: unchanged")
    finally:
        router.close()


def square_bounds(lim, n, v, out_bytes):
    """A square kernel's least times on this factor: at the int8 tensor
    cores, the limb products of the N(N+1)/2 pairs of the symmetric S (2 v
    u8 operations each) against the limb planes and denominators read once
    and ``out_bytes`` written; beside it, the f32 CUDA-core bound of the
    N(N+1)V FLOP against the f32 factor read once."""
    int8 = bound(u8_square_ops(lim.counts.long(), v),
                 lim.planes.numel() + 4.0 * n + out_bytes, PEAK_INT8_OPS)
    f32 = bound(scores_flops(n, v), 4.0 * (n * v + n) + out_bytes)
    return int8, f32


# -- the ANN tier --------------------------------------------------------------


def ann_clients(svc, rows_by_client, k, mode):
    """``run_clients`` with an explicit answer mode per request."""
    import threading

    results = [[None] * len(r) for r in rows_by_client]
    errors = []

    def client(c):
        try:
            for j, r in enumerate(rows_by_client[c]):
                results[c][j] = svc.topk_index(int(r), k, mode=mode)
        except Exception as exc:  # surfaced below, the phase fails
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(rows_by_client))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"ann load clients failed: {errors[:1]}")
    return [a for per in results for a in per], wall


def ann_check(np, answers, rows, oracle, c64, k, label):
    """ANN answers against the host f64 oracle. The contract of the exact
    rerank, for every answer: each returned score is the exact f64 score
    of its (row, target) pair, bit for bit, the order is (descending
    score, ascending id), and no rank scores above the oracle's; an
    answer whose index set equals the oracle's is bit-identical to it.
    Prints the mean score recall@k; returns (the rows whose answers
    covered the oracle's set, that recall)."""
    from distributed_pathsim_tpu_torch.ops import pathsim

    rows = np.asarray(rows, dtype=np.int64)
    uniq, inv = np.unique(rows, return_inverse=True)
    ov, oi = oracle(uniq, k)
    d64 = c64 @ c64.sum(0)
    covered, recall = [], []
    for j, (v, i) in enumerate(answers):
        u, row = inv[j], int(rows[j])
        fin = np.isfinite(v)
        ids = i[fin]
        exact = pathsim.score_candidates(
            (c64[ids] @ c64[row])[None, :], d64[[row]], d64[ids][None, :])[0]
        order = np.lexsort((ids, -v[fin]))
        if (not np.array_equal(v[fin], exact)
                or not np.array_equal(order, np.arange(ids.shape[0]))
                or np.unique(ids).shape[0] != ids.shape[0]
                or (ids == row).any()
                or (v[fin] > ov[u][: ids.shape[0]]).any()):
            raise AssertionError(f"{label}: row {row}: an answer that is not "
                                 "the exact rerank of its candidates")
        want = ov[u][np.isfinite(ov[u])]
        if set(ids.tolist()) == set(oi[u][np.isfinite(ov[u])].tolist()):
            covered.append(row)
            if not (np.array_equal(v, ov[u]) and np.array_equal(i, oi[u])):
                raise AssertionError(f"{label}: row {row} covers the "
                                     "oracle's set but differs from it")
        if want.size:
            recall.append(min(float((v[fin] >= want.min()).sum())
                              / want.size, 1.0))
    mean = float(np.mean(recall)) if recall else 1.0
    print(f"{label}: {len(answers)} answers, every one the exact rerank of "
          f"its candidates; {len(covered)} cover the oracle's set and are "
          f"bit-identical to the host f64 oracle; mean score recall@{k} "
          f"{mean:.5f}")
    return covered, mean


def fallbacks(arm, reason):
    """The count of ``arm``'s (ann, learned) fallbacks for ``reason``."""
    from distributed_pathsim_tpu_torch.obs.metrics import get_registry

    return get_registry().counter(
        f"dpathsim_{arm}_fallbacks_total").labels(reason=reason).value


def ann_route_sets(np, index, rows, nprobe):
    """The device route's cluster sets against ``route_batch_host``'s,
    row for row, wherever the host's nprobe-th and (nprobe+1)-th
    similarities differ by more than 1e-6 relative. Returns how many
    rows fell under that tie rule."""
    ties = 0
    for lo in range(0, rows.shape[0], SERVE_MAX_BATCH):
        r = rows[lo:lo + SERVE_MAX_BATCH]
        _, dev = index.route_batch(r, nprobe)
        _, host = index.route_batch_host(r, nprobe)
        q = index.embedding_of(r)
        sims = -np.sort(-(q @ index.centroids.T), axis=1)
        for b in range(r.shape[0]):
            if nprobe < index.n_centroids:
                hi, nxt = float(sims[b, nprobe - 1]), float(sims[b, nprobe])
                if hi - nxt <= 1e-6 * max(abs(hi), 1e-30):
                    ties += 1
                    continue
            if set(dev[b].tolist()) != set(host[b].tolist()):
                raise AssertionError(f"row {r[b]}: the device route's "
                                     "clusters differ from the host route's")
    return ties


def ann_tier(torch, ck, np, workdir, card, hin):
    """Phase 6d: the ANN tier at the bench shape. Returns the launches of
    the phase per kernel (the exact lane's own; the probe is torch ops)."""
    from distributed_pathsim_tpu_torch.data import delta as tdl
    from distributed_pathsim_tpu_torch.index import CentroidIndex, build_index
    from distributed_pathsim_tpu_torch.index.build import (
        half_chain_and_denominators,
    )
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.serving.cache import graph_fingerprint
    from distributed_pathsim_tpu_torch.utils.compile_counter import (
        compiles_total,
    )

    phase(f"the ANN tier: {N_AUTHORS}x{N_PAPERS}x{N_VENUES}, headroom "
          f"{SERVE_HEADROOM}, {SERVE_CLIENTS} clients x {SERVE_PER_CLIENT} "
          f"topk k={TOP_K} per variant")
    t_phase = time.perf_counter()
    ck.reset_launches()
    hin_h = tdl.with_headroom(hin, SERVE_HEADROOM)
    mp = compile_metapath("APVPA", hin_h.schema)
    t0 = time.perf_counter()
    c, d = half_chain_and_denominators(hin_h, mp)
    fold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = build_index(c=c, d=d, metapath=mp, device="cuda",
                        token=(graph_fingerprint(hin_h), 0))
    build_s = time.perf_counter() - t0
    print(f"index build in-process: half chain {fold_s:.2f} s, build "
          f"{build_s:.2f} s; n {index.n} (the graph's capacity rows), K "
          f"{index.n_centroids}, cap {index.cluster_cap}, dim {index.dim} "
          f"(struct map 12 x {c.shape[1]} wide), packed "
          f"{index.packed.nbytes} bytes f32")
    # The artifact the services, the probe CLI and the router load: the
    # in-process build saved (the CLI's own build, a copy of this one at
    # 18.7-22 s, is not run here since phase 6h took its time).
    art = workdir / "ann_index.npz"
    index.save(str(art))
    cli = CentroidIndex.load(str(art), device="cuda")
    for name in ("centroids", "members", "packed", "cluster_of", "slot_of",
                 "stale"):
        if not np.array_equal(getattr(cli, name), getattr(index, name)):
            raise AssertionError(f"the saved index differs in {name}")
    if tuple(cli.token) != tuple(index.token):
        raise AssertionError("the saved index has another fingerprint")
    print("index saved and loaded: arrays and fingerprint equal to the "
          "in-process build")
    del cli, index
    probe_row = N_AUTHORS // 2 + 57
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", "index",
         "probe", "--index", str(art), "--row", str(probe_row), "--k",
         str(TOP_K), "--dataset", str(workdir / "bench.gexf"), "--platform",
         "cuda"],
        capture_output=True, text=True, timeout=600, cwd=HERE)
    if proc.returncode != 0:
        raise AssertionError(f"index probe exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    probed = json.loads(proc.stdout)
    if not probed["topk"] or probed["n_candidates"] < TOP_K:
        raise AssertionError(f"index probe: {probed}")
    print(f"dpathsim-torch index probe --row {probe_row} --platform cuda: "
          f"nprobe {probed['nprobe']}, {probed['n_candidates']} candidates, "
          f"{len(probed['topk'])} reranked")
    ann_full_width(np, card, hin_h, mp, c, d)
    del c, d

    compiles0 = compiles_total()
    covered = {}
    for variant in ANN_VARIANTS:
        covered[variant] = ann_service(torch, np, card, hin_h, mp, art,
                                       variant, probe_row, probed)
    router_ann(np, workdir, card, hin, art, covered["rerank-all"])
    if compiles_total() != compiles0:
        raise AssertionError(f"the phase compiled or loaded a kernel: "
                             f"{compiles0} -> {compiles_total()}")
    launches = dict(ck.LAUNCHES)
    print(f"phase compiles: unchanged from the end of warmup ({compiles0}); "
          f"launches {launches} (the exact lane's; the probe is torch ops)")
    print(f"ANN phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def ann_full_width(np, card, hin_h, mp, c, d):
    """The recall gate: the struct map unprojected (``max_dim`` of its
    full width 12 x V; the default 1024 projects the bench graph's map),
    ANN_FULL_ROWS rows through the rerank-all lane's state with the
    default nprobe and the route on the card, their mean score recall@k
    against ANN_RECALL_FLOOR."""
    from distributed_pathsim_tpu_torch.index import build_index
    from distributed_pathsim_tpu_torch.ops import pathsim
    from distributed_pathsim_tpu_torch.serving.ann import AnnState

    t0 = time.perf_counter()
    index = build_index(c=c, d=d, metapath=mp, device="cuda",
                        max_dim=12 * c.shape[1])
    build_s = time.perf_counter() - t0
    n = hin_h.type_size(mp.source_type)
    rows = np.random.default_rng(SEED + 13).choice(
        np.flatnonzero(d[:n] > 0), ANN_FULL_ROWS, replace=False)
    s = pathsim.score_rows(c[rows] @ c[:n].T, d[rows], d[:n], xp=np)
    s[np.arange(rows.shape[0]), rows] = -np.inf
    ov, _ = pathsim.topk_from_score_rows(s, TOP_K)
    nprobe = min(max(16, index.n_centroids // 3), 96)
    state = AnnState(index, c, d, nprobe, 16, "rerank-all")
    recall = []
    try:
        for lo in range(0, rows.shape[0], SERVE_MAX_BATCH):
            r = rows[lo:lo + SERVE_MAX_BATCH]
            mem, top = index.route_batch(r, nprobe)
            for b in range(r.shape[0]):
                v, _ = state.rerank_all(int(r[b]), mem[b], top[b], TOP_K, n)
                want = ov[lo + b][np.isfinite(ov[lo + b])]
                got = v[np.isfinite(v)]
                recall.append(min(float((got >= want.min()).sum())
                                  / want.size, 1.0))
    finally:
        state.close()
    mean = float(np.mean(recall))
    print(f"full-width struct map (dim {index.dim}, K {index.n_centroids}, "
          f"cap {index.cluster_cap}, build {build_s:.2f} s): rerank-all "
          f"nprobe {nprobe}, mean score recall@{TOP_K} {mean:.5f} over "
          f"{rows.shape[0]} rows ({card})")
    if mean < ANN_RECALL_FLOOR:
        raise AssertionError(f"full-width map: score recall@{TOP_K} "
                             f"{mean:.5f} < {ANN_RECALL_FLOOR}")


def ann_service(torch, np, card, hin_h, mp, art, variant, probe_row, probed):
    """One ``topk_mode="ann"`` service on the card loading the CLI's
    artifact: load against the f64 oracle beside the exact lane, the
    route against the host route, the probe's CUDA-event time, the
    update's staleness and ``refresh_index``, the shadow gate tripped.
    Returns the rows whose first-load answers covered the oracle's."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.serving import (
        PathSimService,
        ServeConfig,
    )
    from distributed_pathsim_tpu_torch.serving.protocol import handle_request
    from distributed_pathsim_tpu_torch.utils.compile_counter import (
        CompileCounter,
    )

    t0 = time.perf_counter()
    svc = PathSimService(
        create_backend("torch", hin_h, mp, device="cuda"),
        config=ServeConfig(max_batch=SERVE_MAX_BATCH, k_default=TOP_K,
                           topk_mode="ann", index_path=str(art),
                           ann_variant=variant, ann_auto_refresh=False,
                           ann_shadow_every=0))
    try:
        ann = svc._ann
        if ann is None or ann.route_on_host:
            raise AssertionError(f"{variant}: no ANN state on the card")
        print(f"{variant}: service start (backend, bucket warmup, index "
              f"load and probe warmup) {time.perf_counter() - t0:.2f} s; "
              f"nprobe {ann.nprobe}, cand_mult {ann.cand_mult}")
        with CompileCounter() as compiles:
            covered = ann_service_checks(torch, np, card, svc, mp, variant,
                                         probe_row, probed, handle_request)
        if compiles.count:
            raise AssertionError(f"{variant}: {compiles.count} compiles "
                                 f"after warmup: {compiles.by_kind}")
        print(f"{variant}: compile counter 0 from the end of warmup to the "
              "end of its checks")
        return covered
    finally:
        svc.close()


def ann_service_checks(torch, np, card, svc, mp, variant, probe_row, probed,
                       handle_request):
    ann = svc._ann
    index = ann.index
    rng = np.random.default_rng(SEED + 11)
    d = ann.d[: svc.n]
    eligible = np.flatnonzero(d > 0)
    rows = rng.choice(eligible, (SERVE_CLIENTS, SERVE_PER_CLIENT))
    oracle, c64 = f64_topk(np, svc.hin, mp)
    # the probe CLI reranks a shortlist of the same index: it covers the
    # oracle's answer for its row or falls short of it, never past it
    ov, _ = oracle(np.asarray([probe_row]), TOP_K)
    top = [h["score"] for h in probed["topk"]]
    if top[0] > float(ov[0][0]):
        raise AssertionError("index probe scored past the oracle")

    for cell in svc._m_latency.values():
        cell.reset()
    ann._m_probe.reset()
    ann._m_rerank.reset()
    through0 = ann._m_requests.value
    answers, wall = ann_clients(svc, rows, TOP_K, "ann")
    regime_latencies(svc, len(answers), wall, f"{variant}: ann load", card)
    probe, rerank = ann._m_probe, ann._m_rerank
    print(f"{variant}: dpathsim_ann_probe_seconds per batch n={probe.count} "
          f"p50 {probe.quantile(0.5) * 1e3:.3f} ms mean "
          f"{probe.sum / max(probe.count, 1) * 1e3:.3f} ms (fetch of the "
          f"probe, host clock); dpathsim_ann_rerank_seconds per request "
          f"n={rerank.count} p50 {rerank.quantile(0.5) * 1e3:.3f} ms mean "
          f"{rerank.sum / max(rerank.count, 1) * 1e3:.3f} ms ({card})")
    covered, _ = ann_check(np, answers, rows.ravel(), oracle, c64, TOP_K,
                           f"{variant}: ann load")
    print(f"{variant}: {int(ann._m_requests.value - through0)} of the "
          "load's requests answered through the index (shadow sampling off "
          "for the load)")
    exact, wall = ann_clients(svc, rows, TOP_K, "exact")
    regime_latencies(svc, len(exact), wall, f"{variant}: the same rows "
                     "through the exact lane", card)
    check_served(np, exact, rows.ravel(), oracle, TOP_K,
                 f"{variant}: exact lane")

    uniq = np.unique(rows.ravel())
    ties = ann_route_sets(np, index, uniq, ann.nprobe)
    print(f"{variant}: device route's cluster sets equal route_batch_host's "
          f"on {uniq.shape[0] - ties} of {uniq.shape[0]} rows; {ties} under "
          "the 1e-6 tie rule")
    batch = uniq[:SERVE_MAX_BATCH]
    if variant == "rerank-all":
        probe_ms = time_ms(torch, lambda: index.route_batch_device(
            batch, ann.nprobe))
    else:
        probe_ms = time_ms(torch, lambda: index.probe_batch_device(
            batch, ann.nprobe))
    print(f"{variant}: probe of {SERVE_MAX_BATCH} rows on the card "
          f"{probe_ms:.4f} ms (CUDA events, median of {REPS}; {card})")

    # the serving phase's update: affected rows fall back to the exact
    # lane (stale), refresh_index re-embeds them
    recs = update_records(np, svc.hin, np.random.default_rng(SEED + 1),
                          f"ann_{variant}")
    n_before = svc.n
    resp = handle_request(svc, {"id": 1, "op": "update", **recs,
                                "want_rows": True})
    if not resp["ok"] or resp["result"]["mode"] != "delta":
        raise AssertionError(f"{variant}: update did not patch: {resp}")
    res = resp["result"]
    affected = np.asarray(res["affected_row_list"], dtype=np.int64)
    appended = np.arange(n_before, svc.n)
    new_oracle, new_c64 = f64_topk(np, svc.hin, mp)
    reasons = {int(r): svc.ann_fallback_reason(int(r)) for r in appended}
    if any(x not in ("stale", "uncovered") for x in reasons.values()):
        raise AssertionError(f"{variant}: appended rows {reasons}")
    probe_rows = np.unique(np.concatenate([affected[:256], appended]))
    stale0, unc0 = fallbacks("ann", "stale"), fallbacks("ann", "uncovered")
    got, _ = ann_clients(svc, np.array_split(probe_rows, SERVE_CLIENTS),
                         TOP_K, "ann")
    check_served(np, got, probe_rows, new_oracle, TOP_K,
                 f"{variant}: affected and appended rows after the update "
                 "(exact fallback)")
    n_stale = fallbacks("ann", "stale") - stale0
    n_unc = fallbacks("ann", "uncovered") - unc0
    if n_stale + n_unc != probe_rows.shape[0]:
        raise AssertionError(f"{variant}: {n_stale} stale + {n_unc} "
                             f"uncovered for {probe_rows.shape[0]} rows")
    print(f"{variant}: update {res['ms']} ms, {res['affected_rows']} "
          f"affected rows, ann_stale_rows {res['ann_stale_rows']}; the "
          f"{probe_rows.shape[0]} rows asked counted {int(n_stale)} stale, "
          f"{int(n_unc)} uncovered (appended rows: "
          f"{sorted(set(reasons.values()))})")
    resp = handle_request(svc, {"id": 2, "op": "refresh_index"})
    if not resp["ok"] or resp["result"]["stale_remaining"] != 0:
        raise AssertionError(f"{variant}: refresh_index: {resp}")
    if tuple(index.token) != tuple(svc.consistency_token):
        raise AssertionError(f"{variant}: index token {index.token} != "
                             f"service token {svc.consistency_token}")
    print(f"{variant}: refresh_index {resp['result']['refreshed']} rows in "
          f"{resp['result']['ms']} ms, stale_remaining 0, index token = "
          "service token")
    fresh = rng.choice(np.flatnonzero(svc._d[: svc.n] > 0),
                       (SERVE_CLIENTS, 8))
    fresh[:, 0] = probe_rows[np.arange(SERVE_CLIENTS) % probe_rows.shape[0]]
    got, _ = ann_clients(svc, fresh, TOP_K, "ann")
    ann_check(np, got, fresh.ravel(), new_oracle, new_c64, TOP_K,
              f"{variant}: after the refresh (affected rows included)")

    # the shadow gate: every request sampled at the default floor, then
    # tripped on purpose (a floor above 1): every query answers exactly
    ann.shadow_every = 1
    ann_clients(svc, [rng.choice(eligible, 64, replace=False)], TOP_K, "ann")
    snap = svc.stats()["ann"]
    print(f"{variant}: every request shadowed at the default floor "
          f"{ann.recall_floor}: shadow recall {snap['shadow_recall']} over "
          f"{snap['shadow_samples']} samples, gate "
          f"{'on' if snap['enabled'] else 'tripped'}")
    ann.reset_confidence()
    ann.recall_floor, ann.min_shadow = 1.01, 2
    trip = rng.choice(eligible, 16, replace=False)
    ann_clients(svc, [trip], TOP_K, "ann")
    if ann.enabled:
        raise AssertionError(f"{variant}: the shadow gate did not trip")
    low0 = fallbacks("ann", "low_confidence")
    after_trip = rng.choice(eligible, (SERVE_CLIENTS, 2))
    got, _ = ann_clients(svc, after_trip, TOP_K, "ann")
    check_served(np, got, after_trip.ravel(), new_oracle, TOP_K,
                 f"{variant}: every query after the gate tripped (exact)")
    if fallbacks("ann", "low_confidence") - low0 != after_trip.size:
        raise AssertionError(f"{variant}: low_confidence not counted")
    print(f"{variant}: shadow gate tripped after "
          f"{svc.stats()['ann']['shadow_samples']} samples; "
          f"{after_trip.size} queries counted low_confidence and exact")
    return covered


def router_ann(np, workdir, card, hin, art, covered):
    """``dpathsim-torch router --workers 2 --topk-mode ann --platform
    cuda`` with the CLI's artifact and a short JSONL script over rows
    whose in-process answers covered the oracle's set: the routed
    answers equal the host f64 oracle's."""
    from distributed_pathsim_tpu_torch.data import delta as tdl
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    hin_h = tdl.with_headroom(hin, SERVE_HEADROOM)
    mp = compile_metapath("APVPA", hin_h.schema)
    rows = sorted(set(covered))[:: max(len(set(covered)) // 4, 1)][:4]
    script = [{"id": i, "op": "topk", "row": r, "k": TOP_K}
              for i, r in enumerate(rows)]
    script += [{"id": 10, "op": "health"}, {"id": 11, "op": "shutdown"}]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", "router",
         "--workers", "2", "--topk-mode", "ann", "--index", str(art),
         "--platform", "cuda", "--backend", "torch", "--dataset",
         str(workdir / "bench.gexf")],
        input="\n".join(json.dumps(r) for r in script) + "\n",
        capture_output=True, text=True, timeout=600, cwd=HERE,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"router exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    resps = {r["id"]: r for r in map(json.loads, proc.stdout.splitlines())}
    if sorted(resps) != [0, 1, 2, 3, 10, 11] or not all(
            r["ok"] for r in resps.values()):
        raise AssertionError(f"router responses: {resps}")
    oracle, _ = f64_topk(np, hin_h, mp)
    ov, oi = oracle(np.asarray(rows), TOP_K)
    ids = hin.indices["author"].ids
    for j, r in enumerate(rows):
        want = [(ids[int(i)], float(v)) for v, i in zip(ov[j], oi[j])
                if np.isfinite(v)]
        got = [(h["id"], h["score"]) for h in resps[j]["result"]["topk"]]
        if got != want:
            raise AssertionError(f"routed ann row {r} differs from the "
                                 "oracle")
    fb = [resps[j]["result"].get("ann_fallback") for j in range(len(rows))]
    print(f"dpathsim-torch router --workers 2 --topk-mode ann --platform "
          f"cuda: exit 0 in {wall:.1f} s (2 worker startups, each loading "
          f"the artifact); {len(rows)} answers equal to the host f64 oracle, "
          f"ann_fallback {fb} ({card})")


# -- the learned tier -----------------------------------------------------------


def learned_tier(torch, ck, np, workdir, card, hin):
    """Phase 6e: the learned tier at the bench shape, served from the
    committed JAX-written towers. Returns the launches of the phase per
    kernel (K1 once, for the rank-all the answers are held against; the
    learned probe is torch ops)."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.data import delta as tdl
    from distributed_pathsim_tpu_torch.learned import load_towers
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.serving import (
        PathSimService,
        ServeConfig,
    )
    from distributed_pathsim_tpu_torch.serving.cache import graph_fingerprint
    from distributed_pathsim_tpu_torch.utils.compile_counter import (
        compiles_total,
    )

    phase(f"the learned tier: {N_AUTHORS}x{N_PAPERS}x{N_VENUES}, headroom "
          f"{SERVE_HEADROOM}, towers {LEARNED_ARTIFACT.name}, "
          f"{SERVE_CLIENTS} clients x {SERVE_PER_CLIENT} topk k={TOP_K}")
    t_phase = time.perf_counter()
    ck.reset_launches()
    hin_h = tdl.with_headroom(hin, SERVE_HEADROOM)
    mp = compile_metapath("APVPA", hin_h.schema)
    enc, token = load_towers(str(LEARNED_ARTIFACT),
                             expect_base_fp=graph_fingerprint(hin_h))
    print(f"towers: {LEARNED_ARTIFACT.stat().st_size} bytes, dim {enc.dim}, "
          f"hidden {enc.hidden}, V {enc.v}, token {list(token)} (the "
          f"graph's fingerprint), trained {enc.meta}")
    t0 = time.perf_counter()
    svc = PathSimService(
        create_backend("torch", hin_h, mp, device="cuda"),
        config=ServeConfig(max_batch=SERVE_MAX_BATCH, k_default=TOP_K,
                           topk_mode="learned",
                           learned_checkpoint=str(LEARNED_ARTIFACT),
                           learned_shadow_every=0,
                           learned_auto_refresh=False))
    try:
        lr = svc._learned
        if lr is None or lr._emb.device.type != "cuda":
            raise AssertionError("no learned state with its embeddings on "
                                 "the card")
        print(f"service start (backend, bucket warmup, towers, corpus embed "
              f"of {lr.n} rows on the card and probe warmup) "
              f"{time.perf_counter() - t0:.2f} s; cand_mult {lr.cand_mult}, "
              f"embeddings {tuple(lr._emb.shape)} {lr._emb.dtype} on "
              f"{lr._emb.device}")
        compiles0 = compiles_total()
        learned_load(torch, np, card, svc, mp)
        learned_fallback_checks(np, svc, mp)
        learned_cold_start(np, svc, mp)
        if compiles_total() != compiles0:
            raise AssertionError(f"the phase compiled or loaded a kernel: "
                                 f"{compiles0} -> {compiles_total()}")
        # after the count: the retraining captures its train step
        learned_refusals(np, workdir, svc, enc)
    finally:
        svc.close()
    launches = dict(ck.LAUNCHES)
    learned_subprocesses(np, workdir, card, hin)
    print(f"phase compiles: unchanged from the end of warmup; launches "
          f"{launches} (K1: the rank-all the answers are held against)")
    print(f"learned phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def learned_load(torch, np, card, svc, mp, trained_steps=None):
    """(b) and (g): the load through the learned lane, every answer held
    against the host f64 oracle and the exact lane on the same rows,
    every answer whose candidate set covers the oracle's top-k
    bit-identical to the exact lane's, score recall@k beside the JAX
    package's (within LEARNED_RECALL_TOL of it on the JAX towers; on
    towers the card trained ``trained_steps`` steps, printed beside the
    full recipe's), K1's rank-all sets against the oracle's, zero
    compiles. Returns the recall."""
    from distributed_pathsim_tpu_torch.utils.compile_counter import (
        CompileCounter,
    )

    lr = svc._learned
    rng = np.random.default_rng(SEED + 11)
    rows = rng.choice(np.flatnonzero(lr.d[: svc.n] > 0),
                      (SERVE_CLIENTS, SERVE_PER_CLIENT))
    oracle, c64 = f64_topk(np, svc.hin, mp)
    for cell in svc._m_latency.values():
        cell.reset()
    lr._m_probe.reset()
    lr._m_rerank.reset()
    through0 = lr._m_requests.value
    with CompileCounter() as compiles:
        answers, wall = ann_clients(svc, rows, TOP_K, "learned")
    if compiles.count:
        raise AssertionError(f"{compiles.count} compiles in the learned "
                             f"load: {compiles.by_kind}")
    # every request answered through the towers or, a row asked again,
    # from the learned tier of the result cache
    through = int(lr._m_requests.value - through0)
    hits = svc._m_latency["hit_result"].count
    if through + hits != rows.size:
        raise AssertionError(f"{through} through the towers + {hits} cache "
                             f"hits of {rows.size} requests")
    regime_latencies(svc, len(answers), wall, "learned load", card)
    probe, rerank = lr._m_probe, lr._m_rerank
    fetch_p50 = probe.quantile(0.5) * 1e3
    rerank_p50 = rerank.quantile(0.5) * 1e3
    print(f"learned: dpathsim_learned_probe_seconds (the fetch of a batch's "
          f"candidate ids, host clock) n={probe.count} p50 {fetch_p50:.3f} ms;"
          f" dpathsim_learned_rerank_seconds per request n={rerank.count} p50"
          f" {rerank_p50:.3f} ms ({card})")
    _, recall = ann_check(np, answers, rows.ravel(), oracle, c64, TOP_K,
                          "learned load")
    if trained_steps is None:
        print(f"learned: score recall@{TOP_K} {recall:.5f} against the JAX "
              f"package's {LEARNED_JAX_RECALL:.5f} on the same rows and "
              f"towers (tolerance {LEARNED_RECALL_TOL})")
        if abs(recall - LEARNED_JAX_RECALL) > LEARNED_RECALL_TOL:
            raise AssertionError(f"learned recall {recall:.5f} is not within "
                                 f"{LEARNED_RECALL_TOL} of the JAX package's "
                                 f"{LEARNED_JAX_RECALL:.5f}")
    else:
        print(f"learned: score recall@{TOP_K} {recall:.5f} of the towers the "
              f"card trained {trained_steps} steps, beside "
              f"{TRAINED_FULL_RECIPE_RECALL} of towers trained at the full "
              f"{TRAIN_RECIPE['steps']}-step recipe and the JAX artifact's "
              f"{LEARNED_JAX_RECALL:.5f} on the same rows")
    exact, wall = ann_clients(svc, rows, TOP_K, "exact")
    regime_latencies(svc, len(exact), wall, "learned: the same rows through "
                     "the exact lane", card)
    check_served(np, exact, rows.ravel(), oracle, TOP_K, "exact lane")

    # the candidate sets the probe picks, row by row: where one covers the
    # oracle's top-k, the learned answer is the exact lane's, bit for bit
    flat = rows.ravel()
    uniq = np.unique(flat)
    n_cand = min(max(TOP_K, min(lr.cand_mult * TOP_K, lr.n - 1)), lr.n)
    ov, oi = oracle(uniq, TOP_K + 1)
    covers = {}
    for lo in range(0, uniq.shape[0], SERVE_MAX_BATCH):
        r = uniq[lo:lo + SERVE_MAX_BATCH]
        cand = lr.probe_batch(r, TOP_K).fetch()[:, :n_cand]
        for b, row in enumerate(r):
            want = oi[lo + b][:TOP_K][np.isfinite(ov[lo + b][:TOP_K])]
            covers[int(row)] = set(want.tolist()) <= set(cand[b].tolist())
    n_cov = 0
    for j, row in enumerate(flat):
        if covers[int(row)]:
            n_cov += 1
            if not (np.array_equal(answers[j][0], exact[j][0])
                    and np.array_equal(answers[j][1], exact[j][1])):
                raise AssertionError(f"learned row {row}: candidates cover "
                                     "the oracle's top-k, answer differs "
                                     "from the exact lane's")
    print(f"learned: {n_cov} of {flat.shape[0]} answers ({sum(covers.values())}"
          f" of {uniq.shape[0]} rows) have candidate sets covering the "
          f"oracle's top-{TOP_K}; each is bit-identical to the exact lane's")

    # the exact rank-all of the served graph on K1: its top-k sets equal
    # the oracle's wherever the k-th and (k+1)-th scores are apart
    kv, ki = svc.backend.topk(k=TOP_K)
    ties = 0
    for u, row in enumerate(uniq):
        hi, nxt = float(ov[u][TOP_K - 1]), float(ov[u][TOP_K])
        if np.isfinite(hi) and hi - nxt <= 1e-6 * max(abs(hi), 1e-30):
            ties += 1
            continue
        want = set(oi[u][:TOP_K][np.isfinite(ov[u][:TOP_K])].tolist())
        if set(ki[row][np.isfinite(kv[row])].tolist()) != want:
            raise AssertionError(f"K1 rank-all row {row}: its top-{TOP_K} "
                                 "set differs from the oracle's")
    print(f"K1 rank-all of the served graph: top-{TOP_K} sets equal to the "
          f"oracle's on {uniq.shape[0] - ties} of {uniq.shape[0]} rows "
          f"({ties} under the 1e-6 tie rule)")

    batch = uniq[:SERVE_MAX_BATCH]
    probe_ms = time_ms(torch, lambda: lr._top_c(batch, n_cand))
    c, _ = svc.backend._half()
    idx = torch.as_tensor(batch, device=c.device)
    gemm_ms = time_ms(torch, lambda: c[idx] @ c.T)
    print(f"learned: probe (tower product, self mask, stable sort, top "
          f"{n_cand}) of {batch.shape[0]} rows on the card {probe_ms:.4f} ms; "
          f"the exact lane's gather + GEMM of the same rows {gemm_ms:.4f} ms "
          f"(CUDA events, median of {REPS}; {card})")
    return recall


def learned_fallback_checks(np, svc, mp):
    """(c): each fallback reason counted — degenerate (a zero-denominator
    row), uncovered (a row past the towers' rows), metapath (another
    closed metapath), low_confidence (the floor forced above 1) — each
    answered as the exact lane answers; refresh_towers re-arms the gate."""
    lr = svc._learned
    d = lr.d[: svc.n]
    dead = int(np.flatnonzero(d <= 0)[0])
    live = np.flatnonzero(d > 0)
    n0 = fallbacks("learned", "degenerate")
    got = svc.topk_index(dead, TOP_K, mode="learned")
    want = svc.topk_index(dead, TOP_K, mode="exact")
    if fallbacks("learned", "degenerate") - n0 != 1 or not (
            np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])):
        raise AssertionError("degenerate row: not counted or not exact")
    headroom_row = svc.index.padded_size - 1
    if lr.peek(headroom_row) != "degenerate":
        raise AssertionError(f"headroom row {headroom_row}: "
                             f"{lr.peek(headroom_row)}")
    n0 = fallbacks("learned", "uncovered")
    if lr.eligible(lr.n) != "uncovered" or \
            fallbacks("learned", "uncovered") - n0 != 1:
        raise AssertionError("a row past the towers: not uncovered")
    row = int(live[3])
    n0 = fallbacks("learned", "metapath")
    got = svc.topk_index(row, TOP_K, mode="learned",
                         metapath=LEARNED_OTHER_METAPATH)
    want = svc.topk_index(row, TOP_K, mode="exact",
                          metapath=LEARNED_OTHER_METAPATH)
    if fallbacks("learned", "metapath") - n0 != 1 or not (
            np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])):
        raise AssertionError("metapath fallback: not counted or not exact")
    lr.shadow_every, lr.min_shadow, lr.recall_floor = 1, 2, 1.01
    ann_clients(svc, [live[10:26]], TOP_K, "learned")
    if lr.enabled:
        raise AssertionError("the shadow gate did not trip")
    n0 = fallbacks("learned", "low_confidence")
    got = svc.topk_index(int(live[40]), TOP_K, mode="learned")
    want = svc.topk_index(int(live[40]), TOP_K, mode="exact")
    if fallbacks("learned", "low_confidence") - n0 != 1 or not (
            np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])):
        raise AssertionError("low_confidence: not counted or not exact")
    samples = svc.stats()["learned"]["shadow_samples"]
    res = svc.refresh_towers()
    lr.shadow_every = 0
    if not lr.enabled or svc.learned_fallback_reason(int(live[40])):
        raise AssertionError(f"refresh_towers did not re-arm: {res}")
    print(f"learned fallbacks counted: degenerate (row {dead}; headroom row "
          f"{headroom_row} degenerate too), uncovered (row {lr.n}), metapath "
          f"({LEARNED_OTHER_METAPATH}), low_confidence (floor 1.01, tripped "
          f"after {samples} shadow samples), each answered as the exact lane "
          f"answers; refresh_towers re-armed the gate ({res['ms']} ms)")


def learned_cold_start(np, svc, mp):
    """(d): a delta appends a never-seen author: answered through 'stale'
    before the refresh, bit-identical to the host f64 oracle; through the
    towers after it — at the default knobs the exact rerank of its
    candidates, and with every row a candidate bit-identical to the
    oracle (at the default knobs that holds where the candidates cover,
    which the load's recall measures); refresh_towers re-embeds only the
    stale and appended rows."""
    from distributed_pathsim_tpu_torch.serving.protocol import handle_request

    p_ids = svc.hin.indices["paper"].ids
    papers = np.random.default_rng(SEED + 21).choice(len(p_ids), 5,
                                                     replace=False)
    n0 = svc.n
    resp = handle_request(svc, {
        "id": 1, "op": "update",
        "add_nodes": [{"type": "author", "id": "cold_author",
                       "label": "cold_author"}],
        "add_edges": [{"rel": "author_of", "src": "cold_author",
                       "dst": p_ids[int(p)]} for p in papers]})
    if not resp["ok"] or resp["result"]["mode"] != "delta":
        raise AssertionError(f"cold-start update did not patch: {resp}")
    res = resp["result"]
    lr = svc._learned
    if res["learned_pending_appends"] != 1 or \
            svc.learned_fallback_reason(n0, "learned") != "stale":
        raise AssertionError(f"cold author before the refresh: {res}")
    oracle, c64 = f64_topk(np, svc.hin, mp)
    ov, oi = oracle(np.asarray([n0]), TOP_K)
    n_stale = fallbacks("learned", "stale")
    before = svc.topk_index(n0, TOP_K, mode="learned")
    if fallbacks("learned", "stale") - n_stale != 1 or not (
            np.array_equal(before[0], ov[0])
            and np.array_equal(before[1], oi[0])):
        raise AssertionError("cold author before the refresh: not counted "
                             "stale or not the oracle's answer")
    stale = lr.stale_count
    resp = handle_request(svc, {"id": 2, "op": "refresh_towers"})
    ref = resp["result"] if resp["ok"] else resp
    if (not resp["ok"] or ref["refreshed"] != stale or ref["appended"] != 1
            or ref["stale_remaining"] != 0):
        raise AssertionError(f"refresh_towers: {ref}")
    if svc.learned_fallback_reason(n0, "learned") is not None:
        raise AssertionError("cold author still falls back after the "
                             "refresh")
    through = lr._m_requests.value
    after = svc.topk_index(n0, TOP_K, mode="learned")
    ann_check(np, [after], [n0], oracle, c64, TOP_K,
              "cold author after the refresh (default knobs)")
    mult, lr.cand_mult = lr.cand_mult, lr.n  # every row a candidate
    try:
        full = svc.topk_index(n0, TOP_K, mode="learned")
    finally:
        lr.cand_mult = mult
    snap = svc.stats()["learned"]
    if (lr._m_requests.value - through != 2
            or not (np.array_equal(full[0], ov[0])
                    and np.array_equal(full[1], oi[0]))
            or snap["cold_start_ratio"] != 1.0):
        raise AssertionError(f"cold author after the refresh: {snap}")
    print(f"cold start: author row {n0} appended with {len(papers)} papers "
          f"({res['affected_rows']} affected rows, update {res['ms']} ms); "
          f"before the refresh 'stale' and bit-identical to the oracle; "
          f"refresh_towers re-embedded {ref['refreshed']} rows (the stale "
          f"ones, the appended author among them) of {lr.n} in {ref['ms']} "
          f"ms; after it answered through the towers (every row a "
          f"candidate: bit-identical), cold_start_ratio "
          f"{snap['cold_start_ratio']}")


def learned_refusals(np, workdir, svc, enc):
    """(e): a foreign artifact raises TowerMismatch; a learned-mode service
    given it distills its own towers instead (``source="trained"``), as the
    JAX service does."""
    from distributed_pathsim_tpu_torch.learned import (
        TowerMismatch,
        load_towers,
        save_towers,
    )
    from distributed_pathsim_tpu_torch.serving import (
        PathSimService,
        ServeConfig,
    )

    foreign = workdir / "towers_foreign.npz"
    save_towers(str(foreign), enc, ("0123456789abcdef", 0))
    try:
        load_towers(str(foreign), expect_base_fp=svc._base_fp)
    except TowerMismatch as exc:
        mismatch = str(exc)
    else:
        raise AssertionError("a foreign artifact loaded")
    t0 = time.perf_counter()
    retrained = PathSimService(svc.backend, config=ServeConfig(
        warm=False, topk_mode="learned", learned_checkpoint=str(foreign),
        learned_steps=LEARNED_RETRAIN_STEPS, learned_shadow_every=0))
    try:
        lr = retrained._learned
        if lr is None or lr.encoder.meta != {"steps": LEARNED_RETRAIN_STEPS,
                                             "seed": 0} or \
                lr.token != retrained.consistency_token:
            raise AssertionError("learned mode with a foreign artifact did "
                                 "not distill its own towers")
    finally:
        retrained.close()
    print(f"refusals: TowerMismatch for a foreign artifact ({mismatch[:70]}"
          f"...); learned mode with it distilled its own towers "
          f"({LEARNED_RETRAIN_STEPS} steps) in {time.perf_counter() - t0:.2f}"
          f" s, keyed to the service's token")


def learned_subprocesses(np, workdir, card, hin):
    """(f): ``dpathsim-torch serve --topk-mode learned`` answering a learned
    topk, refresh_towers and stats over JSONL, and a two-worker router
    forwarding --learned-checkpoint answering learned requests; answers
    equal to the host f64 oracle."""
    from distributed_pathsim_tpu_torch.data import delta as tdl
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    hin_h = tdl.with_headroom(hin, SERVE_HEADROOM)
    mp = compile_metapath("APVPA", hin_h.schema)
    oracle, c64 = f64_topk(np, hin_h, mp)
    d = c64 @ c64.sum(0)
    live = np.flatnonzero(d > 0)
    rows = [int(r) for r in live[np.linspace(0, live.size - 1, 4).astype(int)]]
    ov, oi = oracle(np.asarray(rows), TOP_K)
    ids = hin.indices["author"].ids
    want = [[(ids[int(i)], float(v)) for v, i in zip(ov[j], oi[j])
             if np.isfinite(v)] for j in range(len(rows))]
    common = ["--topk-mode", "learned", "--learned-checkpoint",
              str(LEARNED_ARTIFACT), "--learned-cand-mult", "4096",
              "--platform", "cuda", "--backend", "torch", "--dataset",
              str(workdir / "bench.gexf")]
    for cmd, extra in (("serve", []), ("router", ["--workers", "2"])):
        script = [{"id": i, "op": "topk", "row": r, "k": TOP_K,
                   "mode": "learned"} for i, r in enumerate(rows)]
        if cmd == "serve":
            script += [{"id": 10, "op": "refresh_towers"},
                       {"id": 11, "op": "stats"}]
        script += [{"id": 12, "op": "shutdown"}]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", cmd,
             *extra, *common],
            input="\n".join(json.dumps(r) for r in script) + "\n",
            capture_output=True, text=True, timeout=600, cwd=HERE)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{cmd} exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        resps = {r["id"]: r for r in map(json.loads,
                                         proc.stdout.splitlines())}
        if sorted(resps) != sorted(r["id"] for r in script) or not all(
                r["ok"] for r in resps.values()):
            raise AssertionError(f"{cmd} responses: {resps}")
        for j in range(len(rows)):
            got = [(h["id"], h["score"])
                   for h in resps[j]["result"]["topk"]]
            if got != want[j]:
                raise AssertionError(f"{cmd}: learned row {rows[j]} differs "
                                     "from the oracle")
        extra_note = ""
        if cmd == "serve":
            st = resps[11]["result"]["learned"]
            if not st or not st["enabled"] or st["dim"] != 32:
                raise AssertionError(f"serve stats: {st}")
            extra_note = (f"; refresh_towers {resps[10]['result']}, stats "
                          f"learned enabled, {st['embedded_rows']} rows")
        print(f"dpathsim-torch {cmd} {' '.join(extra)} --topk-mode learned "
              f"--learned-checkpoint (subprocess): exit 0 in {wall:.1f} s; "
              f"{len(rows)} learned answers equal to the host f64 oracle"
              f"{extra_note} ({card})")


# -- the learned tier's training -------------------------------------------------


def learned_training(torch, ck, np, workdir, card, hin):
    """Phase 6f: the learned tier's training on the card. Returns the
    launches of the phase per kernel (K1 once, for the rank-all the
    card-trained towers' answers are held against; the train step and
    mining are torch ops)."""
    from distributed_pathsim_tpu_torch.data import delta as tdl

    phase(f"the learned tier's training: card against CPU on "
          f"{TRAIN_SMALL}, mining and `learned train` at "
          f"{N_AUTHORS}x{N_PAPERS}x{N_VENUES} headroom {SERVE_HEADROOM} "
          f"({dict(TRAIN_RECIPE, steps=TRAIN_CLI_STEPS)}: the recipe cut to "
          f"{TRAIN_CLI_STEPS} of its {TRAIN_RECIPE['steps']} steps), the "
          f"card-trained towers served, in-service "
          f"distillation, neural_cli and index build --embedding learned")
    t_phase = time.perf_counter()
    ck.reset_launches()
    train_card_vs_cpu(torch, np, card)
    hin_h = tdl.with_headroom(hin, SERVE_HEADROOM)
    mine_ms = train_bench_window(torch, np, card, hin_h)
    towers = learned_train_cli(np, workdir, card, hin_h, mine_ms)
    serve_trained_towers(torch, np, card, hin_h, towers)
    in_service_distillation(np, workdir, card, hin_h)
    neural_cli_checkpoint(np, workdir, card)
    launches = dict(ck.LAUNCHES)
    print(f"launches {launches} (K1: the rank-all the card-trained towers' "
          f"answers are held against)")
    print(f"learned training phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def train_card_vs_cpu(torch, np, card):
    """(a): two models with one seed, on the CPU and on the card, start
    from equal weights; with the same mined pool, 5 steps agree to
    rtol 1e-4 (losses) and atol 1e-5 (embeddings); two 200-step card
    runs from one seed give bit-identical losses and embeddings."""
    from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
    from distributed_pathsim_tpu_torch.models.neural import NeuralPathSim

    hin = synthetic_hin(**TRAIN_SMALL)
    cpu = NeuralPathSim(hin, "APVPA", device="cpu", **TRAIN_SMALL_MODEL)
    gpu = NeuralPathSim(hin, "APVPA", device="cuda", **TRAIN_SMALL_MODEL)
    for (name, a), (_, b) in zip(cpu.model.named_parameters(),
                                 gpu.model.named_parameters()):
        if not torch.equal(a, b.cpu()):
            raise AssertionError(f"initial {name} differs card vs CPU")
    pool = cpu.mine_hard_candidates(256, k=32, seed=0)
    for a, b in zip(gpu.mine_hard_candidates(256, k=32, seed=0), pool):
        if not np.array_equal(a, b):
            raise AssertionError("mined lists differ card vs CPU")
    for m in (cpu, gpu):
        m.set_hard_pool(*pool)
    lc = cpu.train(steps=5, batch_size=256, seed=7)
    lg = gpu.train(steps=5, batch_size=256, seed=7)
    loss_rel = float(np.max(np.abs(np.asarray(lg) / np.asarray(lc) - 1)))
    emb_err = float(np.abs(gpu.embeddings() - cpu.embeddings()).max())
    if loss_rel > 1e-4 or emb_err > 1e-5:
        raise AssertionError(f"card vs CPU: losses rel {loss_rel:.3g}, "
                             f"embeddings {emb_err:.3g}")
    runs = []
    for _ in range(2):
        m = NeuralPathSim(hin, "APVPA", device="cuda", **TRAIN_SMALL_MODEL)
        m.set_hard_pool(*pool)
        runs.append((m.train(steps=TRAIN_REPEAT_STEPS, batch_size=512,
                             seed=0), m.embeddings()))
    if runs[0][0] != runs[1][0] or not np.array_equal(runs[0][1],
                                                      runs[1][1]):
        raise AssertionError("two card runs from one seed differ")
    print(f"card against CPU ({cpu.n} authors, V {cpu.v}): equal initial "
          f"weights, equal mined lists, 5 steps: losses within "
          f"{loss_rel:.3g} (rtol 1e-4), embeddings within {emb_err:.3g} "
          f"(atol 1e-5); two {TRAIN_REPEAT_STEPS}-step card runs "
          f"bit-identical (loss {runs[0][0][0]:.4f} -> {runs[0][0][-1]:.4f})")


def train_bench_window(torch, np, card, hin_h):
    """(b) and (g), with the busy share of (c): mining 512 sources at the
    bench shape on the card equal to the CPU port's lists bit for bit;
    then the artifact's recipe on the card for a window of steps after the
    first (captured) ones: ms per step, the card's busy share over the
    window and 0 compiles in it. Returns the card's mining ms."""
    from distributed_pathsim_tpu_torch.models.neural import NeuralPathSim
    from distributed_pathsim_tpu_torch.utils.compile_counter import (
        CompileCounter,
    )

    kw = {k: TRAIN_RECIPE[k] for k in ("dim", "hidden", "seed")}
    gpu = NeuralPathSim(hin_h, "APVPA", device="cuda", **kw)
    cpu = NeuralPathSim(hin_h, "APVPA", device="cpu", **kw)
    n_src, k = TRAIN_RECIPE["hard_sources"], TRAIN_RECIPE["hard_k"]
    gpu.mine_hard_candidates(n_src, k=k, seed=0)  # first call: set-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pool = gpu.mine_hard_candidates(n_src, k=k, seed=0)
    mine_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = cpu.mine_hard_candidates(n_src, k=k, seed=0)
    cpu_s = time.perf_counter() - t0
    for a, b in zip(pool, want):
        if not np.array_equal(a, b):
            raise AssertionError("bench-shape mining differs card vs CPU")
    print(f"mining {n_src} sources, k {k}, at {gpu.n}x{gpu.v} on the card: "
          f"{mine_ms:.3f} ms (a [{n_src}, {gpu.v}] x [{gpu.v}, {gpu.n}] "
          f"true-f32 product, the division and a stable sort, host clock "
          f"with the fetch); equal to the CPU port's lists bit for bit (CPU "
          f"{cpu_s:.2f} s) ({card})")
    gpu.set_hard_pool(*pool)
    gpu.train(steps=10, batch_size=TRAIN_BATCH, seed=0)
    with CompileCounter() as compiles:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu.train(steps=TRAIN_WINDOW, batch_size=TRAIN_BATCH, seed=1)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / TRAIN_WINDOW * 1e3
        busy = device_busy_share(torch, lambda: gpu.train(
            steps=TRAIN_WINDOW // 4, batch_size=TRAIN_BATCH, seed=2), reps=1)
    if compiles.count:
        raise AssertionError(f"{compiles.count} compiles after the first "
                             f"train steps: {compiles.by_kind}")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(TRAIN_WINDOW):
        gpu.sample_batch(TRAIN_BATCH, rng)
    sample_ms = (time.perf_counter() - t0) / TRAIN_WINDOW * 1e3
    print(f"train step at the recipe ({TRAIN_BATCH // gpu.SLATE} sources x "
          f"{gpu.SLATE} slate, F {gpu.features.shape[1]}, hidden "
          f"{kw['hidden']}, dim {kw['dim']}): {step_ms:.4f} ms a step over "
          f"{TRAIN_WINDOW} steps after the captured one (host clock, "
          f"sampler included), the host sampler alone {sample_ms:.4f} ms; "
          "card busy share over a window "
          + ("not measured (no device time in the profile)" if busy is None
             else f"{busy:.4f}")
          + f"; 0 compiles after the first steps ({card})")
    return mine_ms


def learned_train_cli(np, workdir, card, hin_h, mine_ms):
    """(c): ``dpathsim-torch learned train`` as a subprocess on the card at
    the committed artifact's recipe cut to TRAIN_CLI_STEPS steps; its
    token is the graph's fingerprint. Returns the checkpoint's path."""
    from distributed_pathsim_tpu_torch.serving.cache import graph_fingerprint

    out = workdir / "towers_card.npz"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", "learned",
         "train", "--dataset", ROUTER_SPEC, "--headroom",
         str(SERVE_HEADROOM), "--out", str(out), "--platform", "cuda",
         *[f"--{k.replace('_', '-')}={v}" for k, v in
           dict(TRAIN_RECIPE, steps=TRAIN_CLI_STEPS).items()]],
        capture_output=True, text=True, timeout=900, cwd=HERE)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"learned train exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    info = json.loads(proc.stdout)
    fp = graph_fingerprint(hin_h)
    if info["token"] != [fp, 0] or info["hard_pool"] != \
            TRAIN_RECIPE["hard_sources"] or not np.isfinite(
                info["final_loss"]):
        raise AssertionError(f"learned train: {info}")
    steps = TRAIN_CLI_STEPS
    print(f"dpathsim-torch learned train (subprocess, --platform cuda): exit "
          f"0 in {wall:.1f} s; train_s {info['train_s']} (set-up, mining and "
          f"{steps} steps) -> {steps / info['train_s']:.1f} steps/s; mining "
          f"{mine_ms:.3f} ms (in-process, above); final_loss "
          f"{info['final_loss']}; token {info['token']} (the graph's "
          f"fingerprint) ({card})")
    return out


def serve_trained_towers(torch, np, card, hin_h, towers):
    """(d): a learned service on the card-trained towers, the learned
    phase's rows and load at k = 10: every covering answer bit-identical
    to the exact lane's, score recall@10 printed beside the full recipe's
    (no floor: the towers trained TRAIN_CLI_STEPS steps), QPS, 0 compiles
    in the load, K1's rank-all of the served graph against the oracle's
    sets."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.serving import (
        PathSimService,
        ServeConfig,
    )

    mp = compile_metapath("APVPA", hin_h.schema)
    t0 = time.perf_counter()
    svc = PathSimService(
        create_backend("torch", hin_h, mp, device="cuda"),
        config=ServeConfig(max_batch=SERVE_MAX_BATCH, k_default=TOP_K,
                           topk_mode="learned",
                           learned_checkpoint=str(towers),
                           learned_shadow_every=0,
                           learned_auto_refresh=False))
    try:
        lr = svc._learned
        if lr is None or lr.encoder.meta.get("steps") != \
                TRAIN_CLI_STEPS:
            raise AssertionError("the card-trained towers did not load")
        print(f"service on the card-trained towers: start "
              f"{time.perf_counter() - t0:.2f} s")
        learned_load(torch, np, card, svc, mp, trained_steps=TRAIN_CLI_STEPS)
    finally:
        svc.close()


def in_service_distillation(np, workdir, card, hin_h):
    """(e): a learned-mode service with no checkpoint at the bench shape
    and the default learned_steps distills its towers at install
    (source "trained"); DISTILL_QUERIES learned queries, every covering
    answer bit-identical to the host f64 oracle; then ``dpathsim-torch
    serve --topk-mode learned --learned-steps 200`` as a subprocess
    answering a learned topk and stats with no checkpoint."""
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.serving import (
        PathSimService,
        ServeConfig,
    )

    mp = compile_metapath("APVPA", hin_h.schema)
    cfg = ServeConfig(max_batch=SERVE_MAX_BATCH, k_default=TOP_K,
                      topk_mode="learned", learned_shadow_every=0,
                      learned_auto_refresh=False)
    t0 = time.perf_counter()
    svc = PathSimService(create_backend("torch", hin_h, mp, device="cuda"),
                         config=cfg)
    startup = time.perf_counter() - t0
    try:
        lr = svc._learned
        if lr is None or lr.encoder.meta != {"steps": cfg.learned_steps,
                                             "seed": 0} or \
                lr.token != svc.consistency_token:
            raise AssertionError("learned mode with no checkpoint did not "
                                 "distill its towers")
        oracle, c64 = f64_topk(np, svc.hin, mp)
        rng = np.random.default_rng(SEED + 11)
        rows = rng.choice(np.flatnonzero(lr.d[: svc.n] > 0),
                          (SERVE_CLIENTS, DISTILL_QUERIES // SERVE_CLIENTS))
        answers, wall = ann_clients(svc, rows, TOP_K, "learned")
        covered, recall = ann_check(np, answers, rows.ravel(), oracle, c64,
                                    TOP_K, "in-service distillation")
        print(f"in-service distillation: service start {startup:.2f} s "
              f"(backend, warmup, mining, {cfg.learned_steps} steps, corpus "
              f"embed); {rows.size} learned queries in {wall:.3f} s, "
              f"{len(covered)} covering answers bit-identical, recall@{TOP_K}"
              f" {recall:.5f} ({card})")
    finally:
        svc.close()
    ids = hin_h.indices["author"].ids
    oracle, _ = f64_topk(np, hin_h, mp)
    row = int(rows.ravel()[0])
    ov, oi = oracle(np.asarray([row]), TOP_K)
    want = [(ids[int(i)], float(v)) for v, i in zip(ov[0], oi[0])
            if np.isfinite(v)]
    script = [{"id": 1, "op": "topk", "row": row, "k": TOP_K,
               "mode": "learned"}, {"id": 2, "op": "stats"},
              {"id": 3, "op": "shutdown"}]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", "serve",
         "--dataset", str(workdir / "bench.gexf"), "--backend", "torch",
         "--platform", "cuda", "--topk-mode", "learned", "--learned-steps",
         str(cfg.learned_steps), "--learned-cand-mult", "4096"],
        input="\n".join(json.dumps(r) for r in script) + "\n",
        capture_output=True, text=True, timeout=600, cwd=HERE)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serve --topk-mode learned exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    resps = {r["id"]: r for r in map(json.loads, proc.stdout.splitlines())}
    got = [(h["id"], h["score"]) for h in resps[1]["result"]["topk"]]
    st = resps[2]["result"]["learned"]
    if got != want or not st or not st["enabled"]:
        raise AssertionError(f"serve --topk-mode learned: {resps}")
    print(f"dpathsim-torch serve --topk-mode learned --learned-steps "
          f"{cfg.learned_steps} (subprocess, no checkpoint): exit 0 in "
          f"{wall:.1f} s; the learned answer equal to the host f64 oracle, "
          f"stats learned enabled ({card})")


def neural_cli_checkpoint(np, workdir, card):
    """(f): ``neural_cli train --mine 64`` on the card on a written GEXF,
    ``neural_cli query --index rerank`` answers equal to the host f64
    oracle wherever they cover its set, and ``dpathsim-torch index build
    --embedding learned --model`` building from that checkpoint and
    ``index probe`` probing it on the card."""
    from distributed_pathsim_tpu_torch.data.synthetic import (
        synthetic_hin,
        write_gexf,
    )
    from distributed_pathsim_tpu_torch.ops import planner
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    hin = synthetic_hin(**TRAIN_SMALL, materialize_ids=True)
    gexf, model = workdir / "neural.gexf", workdir / "neural.npz"
    write_gexf(hin, str(gexf))

    def run(module, *argv):
        proc = subprocess.run([sys.executable, "-m", module, *argv],
                              capture_output=True, text=True, timeout=600,
                              cwd=HERE)
        if proc.returncode != 0:
            raise AssertionError(f"{module} {argv[:2]} exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        return proc.stdout

    t0 = time.perf_counter()
    out = run("distributed_pathsim_tpu_torch.neural_cli", "train",
              "--dataset", str(gexf), "--out", str(model), "--steps", "600",
              "--mine", "64", "--platform", "cuda")
    train_s = time.perf_counter() - t0
    mp = compile_metapath("APVPA", hin.schema)
    oracle, _ = f64_topk(np, hin, mp)
    ids, labels = hin.indices["author"].ids, hin.indices["author"].labels
    c64 = planner.dense_half(hin, mp, dtype=np.float64)
    live = np.flatnonzero(c64 @ c64.sum(0) > 0)
    rows = live[np.linspace(0, live.size - 1, NEURAL_CLI_ROWS).astype(int)]
    ov, oi = oracle(rows, TOP_K)
    covered = 0
    for j, row in enumerate(rows):
        text = run("distributed_pathsim_tpu_torch.neural_cli", "query",
                   "--model", str(model), "--dataset", str(gexf),
                   "--source-id", ids[int(row)], "--index", "rerank",
                   "--top-k", str(TOP_K), "--platform", "cuda")
        got = [line.split(None, 1) for line in text.splitlines()[1:]]
        want = [(f"{v:.6f}", f"{labels[int(i)]} ({ids[int(i)]})")
                for v, i in zip(ov[j], oi[j]) if np.isfinite(v)]
        if {g[1] for g in got} == {w[1] for w in want}:
            covered += 1
            if [tuple(g) for g in got] != want:
                raise AssertionError(f"neural_cli rerank row {row} covers "
                                     "the oracle's set but differs from it")
    if not covered:
        raise AssertionError("no neural_cli rerank answer covered the oracle")
    idx = workdir / "neural_idx.npz"
    built = json.loads(run(
        "distributed_pathsim_tpu_torch.cli", "index", "build", "--dataset",
        str(gexf), "--out", str(idx), "--embedding", "learned", "--model",
        str(model), "--headroom", "0", "--platform", "cuda"))
    probed = json.loads(run(
        "distributed_pathsim_tpu_torch.cli", "index", "probe", "--index",
        str(idx), "--row", str(int(rows[1])), "--dataset", str(gexf),
        "--platform", "cuda"))
    if built["embedding"] != "learned" or not probed["topk"]:
        raise AssertionError(f"index build/probe learned: {built} {probed}")
    print(f"neural_cli train --mine 64 --platform cuda: {out.strip()} "
          f"({train_s:.1f} s); query --index rerank on {len(rows)} rows: "
          f"{covered} cover the host f64 oracle's set and equal it; index "
          f"build --embedding learned: {built['n']} rows, dim {built['dim']}, "
          f"{built['centroids']} centroids; index probe on the card: "
          f"{len(probed['topk'])} reranked hits ({card})")


# -- tuning on the card --------------------------------------------------------

# The tuning phase: K1 and K3 against their plain versions at every width
# the two kernel knobs can hand them, on a multi-limb factor of
# TUNE_CHECK_ROWS rows (wide enough that every rect_target_units
# candidate gives K3 its own stripe width); `dpathsim-torch tune` in a
# child process over TUNE_KNOBS at TUNE_SHAPES (the bench shape, and a
# sparse point of config 5's width whose K3 sweep spans 32 row tiles)
# with TUNE_REPS rounds; the main path's rank-all under the table it
# wrote; a service over TUNE_SERVE_AUTHORS authors (the serve_buckets
# key the table holds at the default max_batch of 32) under
# TUNE_SERVE_CLIENTS x TUNE_SERVE_PER_CLIENT topk requests; K1 at the
# bench shape and K3's sweep at the sparse point at the tuned setting
# against the default.
TUNE_CHECK_ROWS = 6000
TUNE_KNOBS = ("twopass_stripe_tiles,rect_target_units,sparse_tile_rows,"
              "ring_kernel,serve_buckets")
TUNE_SPARSE = (131_072, 64, 655_360)
TUNE_SHAPES = (f"{N_AUTHORS}x{N_VENUES},"
               f"{TUNE_SPARSE[0]}x{TUNE_SPARSE[1]}x{TUNE_SPARSE[2]}")
TUNE_REPS = 2
TUNE_SERVE_AUTHORS, TUNE_SERVE_CLIENTS, TUNE_SERVE_PER_CLIENT = 512, 8, 32
# The kernels' plain versions (ops/cuda_kernels.py), the ring's torch
# fold and torch-sparse's torch folds beside K3 (ops/sparse.py's scanned
# and per-tile folds): none may run on the card on the paths the tuning
# phase drives.
PLAIN_VERSIONS = ("fused_scores_plain", "fused_topk_twopass_plain",
                  "topk_twopass_candidates_plain", "fused_topk_plain",
                  "topk_rect_candidates_plain",
                  "fused_topk_twopass_rect_plain")
SPARSE_FOLDS = ("stream_row_tile_topk", "stream_merge_topk")

TUNE_CHILD = """
import json, sys
import torch
import chip_smoke
from distributed_pathsim_tpu_torch.cli import main
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
counts, _ = chip_smoke.count_plain_on_card(torch, ck)
rc = main(["tune", *sys.argv[1:]])
print(json.dumps({"rc": rc, "launches": dict(ck.LAUNCHES),
                  "plain_on_card": counts}))
sys.exit(rc)
"""


def count_plain_on_card(torch, ck):
    """Wrap every plain version (and the ring's and torch-sparse's torch
    folds) so that each call holding a CUDA tensor is counted. Returns
    the counts (by name) and a function that puts the originals back."""
    from distributed_pathsim_tpu_torch.ops import sparse as sp
    from distributed_pathsim_tpu_torch.parallel import ring

    counts: dict[str, int] = {}
    originals = []

    def wrap(mod, name):
        fn = getattr(mod, name)

        def counted_fn(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in (*args, *kwargs.values())):
                counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)

        originals.append((mod, name, fn))
        setattr(mod, name, counted_fn)

    for name in PLAIN_VERSIONS:
        wrap(ck, name)
    wrap(ring, "_fold_tile")
    for name in SPARSE_FOLDS:
        wrap(sp, name)

    def restore():
        for mod, name, fn in originals:
            setattr(mod, name, fn)

    return counts, restore


def tuning_phase(torch, ck, np, workdir, card, hin, ranking):
    """The autotuner on the card (see TUNE_* above). Returns the launches
    of the phase's own runs (the tune child's, the tuned rank-all's and
    the service's) and the tuned-against-default numbers for the kernels
    line."""
    from distributed_pathsim_tpu_torch import tuning
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.cli import main as cli_main
    from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
    from distributed_pathsim_tpu_torch.ops import sparse as sp
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.serving import (
        PathSimService,
        ServeConfig,
    )
    from distributed_pathsim_tpu_torch.tuning import autotuner as at
    from distributed_pathsim_tpu_torch.tuning.table import normalize_device
    from distributed_pathsim_tpu_torch.utils.compile_counter import (
        CompileCounter,
    )

    phase("tuning on the card")
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(dev)
    tuning.reset()

    # 1. K1 and K3 against their plain versions at every candidate width
    cm, dm = multilimb_factor(torch, np, dev, n=TUNE_CHECK_ROWS)
    lim = ck.split_limbs(cm)
    n = cm.shape[0]
    k1_widths = tuning.KNOBS["twopass_stripe_tiles"].candidates({})
    for w in k1_widths:
        check_topk(torch, ck, cm, dm, TOP_K, True, "tuning, multi-limb",
                   stripe_tiles=w, limbs=lim)
    units = tuning.KNOBS["rect_target_units"].candidates({})
    k3_widths = {u: ck._stripe_tiles_for_units(n, n, u) for u in units}
    for w in sorted(set(k3_widths.values())):
        check_rect(torch, ck, cm, dm, 0, n, TOP_K, "tuning, multi-limb",
                   stripe_tiles=w)
    print(f"K1 at every twopass_stripe_tiles candidate {k1_widths} and K3 "
          f"at every rect_target_units candidate (units: stripe tiles "
          f"{k3_widths}) on the multi-limb factor {n}x{cm.shape[1]} "
          f"(k={TOP_K}): equal to the plain versions")
    del cm, dm, lim

    # 2-3. `dpathsim-torch tune` in a child, its plain versions counted
    table_path = workdir / "tuning_table.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", TUNE_CHILD, "--platform", "cuda",
         "--out", str(table_path), "--knobs", TUNE_KNOBS,
         "--shapes", TUNE_SHAPES, "--reps", str(TUNE_REPS)],
        capture_output=True, text=True, cwd=HERE, timeout=900)
    tune_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"dpathsim-torch tune exited {proc.returncode}:"
                             f" {proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    launches = {kname: child["launches"][kname] for kname in ck.LAUNCHES}
    if child["plain_on_card"]:
        raise AssertionError(f"tune ran plain versions on the card: "
                             f"{child['plain_on_card']}")
    for kname in ("topk_twopass_candidates", "topk_rect_candidates"):
        if not launches[kname]:
            raise AssertionError(f"tune never launched {kname}")
    doc = json.loads(table_path.read_text())
    want_dev = normalize_device(name)
    keyed = {key.split("|")[1] for key in doc["entries"]}
    if doc["device_kind"] != want_dev or keyed != {want_dev}:
        raise AssertionError(f"table keyed {keyed} / {doc['device_kind']}, "
                             f"not {want_dev}")
    knobs = {key.split("|")[0] for key in doc["entries"]}
    if knobs != set(TUNE_KNOBS.split(",")):
        raise AssertionError(f"table knobs {sorted(knobs)}")
    print(f"dpathsim-torch tune --shapes {TUNE_SHAPES} --reps {TUNE_REPS}: "
          f"{tune_s:.1f} s, {len(doc['entries'])} entries keyed {want_dev!r}, "
          f"launches {launches}, plain versions on the card: 0")
    for key, ent in sorted(doc["entries"].items()):
        print(f"  {key}: {ent['choice']} (arms ms {ent['arms']})")

    # 3-4. the main path's rank-all under the table; plain versions counted
    plain, restore = count_plain_on_card(torch, ck)
    try:
        gexf = workdir / "bench.gexf"
        tuned_ranking = workdir / "ranking_tuned.tsv"
        before = tuning.lookup_stats()
        ck.reset_launches()
        rc = cli_main(["--dataset", str(gexf), "--platform", "cuda",
                       "--backend", "torch", "--quiet", "--top-k",
                       str(TOP_K), "--ranking-out", str(tuned_ranking),
                       "--tuning-table", str(table_path)])
        torch.cuda.synchronize()
        rank_launches = dict(ck.LAUNCHES)
        # the rank-all's own lookups (the counters are process-wide)
        stats = {r: c - before.get(r, 0)
                 for r, c in tuning.lookup_stats().items()
                 if c > before.get(r, 0)}
        if rc != 0:
            raise AssertionError(f"tuned rank-all exited {rc}")
        if not filecmp.cmp(ranking, tuned_ranking, shallow=False):
            raise AssertionError("the tuned rank-all differs from the "
                                 "main path's")
        if not rank_launches["topk_twopass_candidates"]:
            raise AssertionError("the tuned rank-all did not launch K1")
        key = tuning.make_key("twopass_stripe_tiles", name, n=N_AUTHORS,
                              v=N_VENUES)
        tuned_w = doc["entries"][key]["choice"]
        ran_w = ck.twopass_stripe_tiles(N_AUTHORS, N_VENUES, TOP_K, dev)
        if ran_w != tuned_w or not stats.get("hit"):
            raise AssertionError(f"K1 ran at {ran_w} tiles, the table holds "
                                 f"{tuned_w}; lookups {stats}")
        print(f"rank-all under the table: cmp-identical to the main path's "
              f"ranking; K1 at the tuned width {tuned_w} tiles "
              f"({tuned_w * ck.TILE} columns; default "
              f"{ck.TWOPASS_STRIPE_TILES}), launches {rank_launches}, "
              f"lookups {stats}")
        for kname, cnt in rank_launches.items():
            launches[kname] += cnt

        # 5. a service under the table: hit lookups, 0 compiles after warmup
        hin_s = synthetic_hin(TUNE_SERVE_AUTHORS, 2 * TUNE_SERVE_AUTHORS, 24,
                              seed=SEED)
        mp = compile_metapath("APVPA", hin_s.schema)
        hits0 = tuning.lookup_stats().get("hit", 0)
        ck.reset_launches()
        svc = PathSimService(create_backend("torch", hin_s, mp, device=dev),
                             config=ServeConfig(max_batch=32))
        try:
            hits = tuning.lookup_stats().get("hit", 0) - hits0
            rng = np.random.default_rng(SEED)
            rows = rng.integers(0, TUNE_SERVE_AUTHORS, size=(
                TUNE_SERVE_CLIENTS, TUNE_SERVE_PER_CLIENT))
            with CompileCounter() as cc:
                answers, wall = run_clients(svc, rows, TOP_K)
            buckets = svc.stats()["obs"]["tuning"]["buckets"]
        finally:
            svc.close()
        oracle, _ = f64_topk(np, hin_s, mp)
        check_served(np, answers, rows.reshape(-1), oracle, TOP_K,
                     "service under the table")
        if hits < 1 or cc.count:
            raise AssertionError(f"service under the table: {hits} hit "
                                 f"lookups, {cc.count} compiles")
        print(f"service under the table ({TUNE_SERVE_AUTHORS} authors): "
              f"{hits} hit lookups at startup (ladder {buckets}), "
              f"{rows.size} answers in {wall:.2f} s, 0 compiles after "
              "warmup")
        for kname, cnt in ck.LAUNCHES.items():
            launches[kname] += cnt
        if plain:
            raise AssertionError(f"plain versions ran on the card: {plain}")
    finally:
        restore()
        tuning.reset()

    # 6. K1 at the bench shape, K3's sweep over the bench factor in tiles
    # of 4096 rows and over the sparse point: the tuned setting against
    # the default, timed in turns (tuned, default, default, tuned; CUDA
    # events, median of 7 each, the two medians averaged)
    def abba(fns):
        ms = {label: [] for label in fns}
        for label in (*fns, *reversed(fns)):
            ms[label].append(time_ms(torch, fns[label]))
        return {label: sum(v) / len(v) for label, v in ms.items()}

    c, d = factor(hin, "APVPA", dev)
    lim = ck.split_limbs(c)
    default_w = ck.default_twopass_stripe_tiles(N_AUTHORS)
    widths = {"tuned": tuned_w, "default": default_w}
    k1 = {f"{label}_ms": ms for label, ms in abba({
        label: (lambda w=w: ck.topk_twopass_candidates(
            c, d, TOP_K, True, limbs=lim, stripe_tiles=w))
        for label, w in widths.items()}).items()}
    k1.update({f"{label}_with_pass2_ms": ms for label, ms in abba({
        label: (lambda w=w: ck.fused_topk_twopass(
            c, d, TOP_K, limbs=lim, stripe_tiles=w))
        for label, w in widths.items()}).items()})
    k1.update(stripe_tiles=tuned_w, default_stripe_tiles=default_w)
    n_s, v_s, nnz_s = TUNE_SPARSE
    key = tuning.make_key("rect_target_units", name, n=n_s, v=v_s)
    tuned_u = doc["entries"][key]["choice"]
    units = {"tuned": tuned_u, "default": ck.RECT_TARGET_UNITS}
    k3 = {"units": tuned_u, "default_units": ck.RECT_TARGET_UNITS}
    ids = torch.arange(N_AUTHORS, dtype=torch.int32, device=dev)
    t = sp.TiledHalfChain(at._sparse_coo(n_s, v_s, nnz_s), tile_rows=4096,
                          device=dev)
    for where, prep, n_rows, n_cols in (
            ("bench", (*ck.rect_pad_factor(c, d, lim), ids), N_AUTHORS,
             N_AUTHORS),
            ("sparse", at._tiled_rect_factor(t, dev), n_s,
             t.n_tiles * 4096)):
        w = {label: ck._stripe_tiles_for_units(4096, n_cols, u)
             for label, u in units.items()}
        k3.update({f"{where}_{label}_stripe_tiles": w[label]
                   for label in w})
        k3.update({f"{where}_{label}_sweep_ms": ms for label, ms in abba({
            label: (lambda w=w[label], prep=prep, n_rows=n_rows:
                    at._rect_sweep(prep, n_rows, 4096, TOP_K, w))
            for label in units}).items()})
    del c, d, lim, prep, t
    print(f"K1 at {N_AUTHORS}x{N_VENUES} k={TOP_K} on the bench factor: "
          f"tuned {tuned_w} tiles {k1['tuned_ms']:.3f} ms (with pass 2 "
          f"{k1['tuned_with_pass2_ms']:.3f}), default {default_w} tiles "
          f"{k1['default_ms']:.3f} ms (with pass 2 "
          f"{k1['default_with_pass2_ms']:.3f}); K3 sweeps in tiles of 4096 "
          f"rows at {tuned_u} (tuned) and {ck.RECT_TARGET_UNITS} (default) "
          f"units: the bench factor {k3['bench_tuned_sweep_ms']:.3f} / "
          f"{k3['bench_default_sweep_ms']:.3f} ms ({N_AUTHORS // 4096} "
          f"tiles, stripes of {k3['bench_tuned_stripe_tiles']} / "
          f"{k3['bench_default_stripe_tiles']} tiles), the sparse point "
          f"{n_s}x{v_s}x{nnz_s} {k3['sparse_tuned_sweep_ms']:.3f} / "
          f"{k3['sparse_default_sweep_ms']:.3f} ms ({n_s // 4096} tiles, "
          f"stripes of {k3['sparse_tuned_stripe_tiles']} / "
          f"{k3['sparse_default_stripe_tiles']}) ({card})")
    print(f"tuning phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, {"topk_twopass_candidates": k1,
                      "topk_rect_candidates": k3}


# -- the bench twins ------------------------------------------------------------

# Phase 6h: the port's load generators (bench_serving's six regimes, the
# per-tier bench_backends) on the card, at their own defaults: the smokes'
# fixed runs, run_bench at 2048 x 4096 x 48 (32 clients x 64 queries,
# max_batch 32), the update smoke at edge_frac 0.01 and 5 reps, and the
# tiers at the bench shape with torch-sharded at D = 2 on the one card.
TWIN_TIERS, TWIN_SHARDS, TWIN_REPS = (
    ("torch", "torch-sparse", "torch-sharded"), 2, 5)


def fmt_lat(res):
    return (f"{res['qps']} QPS, p50/p95/p99 {res['p50_ms']}/"
            f"{res['p95_ms']}/{res['p99_ms']} ms")


def bench_twins(torch, ck, np, card, hin, dense):
    """Phase 6h: the six ``run_*_smoke``s of the port's
    ``bench_serving`` on the card, every check true (the clock's three
    included: each smoke raises if one fails), ``run_bench`` at its
    defaults, and ``bench_backends``' three tiers at the bench shape
    with rankings equal to K1's. Returns the launches of the phase per
    kernel (this process's: the workers' own launches are theirs)."""
    from distributed_pathsim_tpu_torch import bench_backends as tbb
    from distributed_pathsim_tpu_torch import bench_serving as bs
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    phase("the bench twins on the card: bench_serving's load, update, obs, "
          "router, fleet-obs and partition smokes, run_bench, "
          "bench_backends")
    t_phase = time.perf_counter()
    ck.reset_launches()
    walls = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[label] = time.perf_counter() - t0
        return out

    smokes = {
        "load": bs.run_smoke, "update": bs.run_update_smoke,
        "obs": bs.run_obs_smoke, "router": bs.run_router_smoke,
        "fleet-obs": bs.run_fleet_obs_smoke,
        "partition": bs.run_partition_smoke,
    }
    res = {}
    for regime, smoke in smokes.items():
        res[regime] = timed(regime, lambda s=smoke: s(platform="cuda"))
        checks = res[regime]["smoke_checks"]
        if not checks or not all(checks.values()):
            raise AssertionError(f"{regime} smoke: {checks}")
        print(f"{regime} smoke: {walls[regime]:.1f} s, all "
              f"{len(checks)} checks true ({', '.join(checks)})")
    r = res["load"]["regimes"]
    print("load smoke (384 x 640 x 12, 8 clients x 24): "
          + "; ".join(f"{name} {fmt_lat(r[name])}" for name in r)
          + f" ({card})")
    u = res["update"]
    print(f"update (2048 x 4096 x 48, edge_frac 0.01, 5 reps): update "
          f"{u['update_ms']} ms against reload {u['reload_ms']} ms, speedup "
          f"{u['speedup_vs_reload']}; compiles {u['steady_state_compiles']}; "
          f"retention {u['cache_retention']} ({card})")
    arms = res["obs"]["arms"]
    print("obs smoke: " + "; ".join(
        f"{name} {arm['qps_median']} QPS median, best {arm['qps_best']}"
        + (f", added {arm['added_us_per_request_best']} us/request (best "
           f"window), {arm['added_us_per_request']} (medians)"
           if name != "off" else "") for name, arm in arms.items())
        + f" ({card})")
    ro = res["router"]
    print("router smoke: " + "; ".join(
        f"{n} replicas {fmt_lat(x)}" for n, x in ro["replicas"].items())
        + f"; kill: {fmt_lat(ro['failover'])}, detect "
        f"{ro['failover'].get('detect_ms')} ms, failovers "
        f"{ro['failover']['failover_affected']}, recovery "
        f"{ro['failover'].get('failover_recovery')} ({card})")
    fo = res["fleet-obs"]
    print(f"fleet-obs smoke: kill load {fmt_lat(fo['load'])}, lost "
          f"{fo['load']['lost']}; merged requests "
          f"{fo['merged_request_count']} = "
          f"{fo['per_worker_request_counts']}; stitched traces "
          f"{fo['trace_audit']['stitched_cross_process']} ({card})")
    pa = res["partition"]
    for p, x in pa["partitions"].items():
        print(f"partition smoke P={p}: {fmt_lat(x)}; factor bytes "
              f"{x['resident']['factor_bytes']}, worker VmRSS (host) "
              f"{x['resident']['worker_vm_rss_kb']} kB, max_n at 8 GiB "
              f"{x['max_n_at_budget']}"
              + (f"; routed deltas p50 "
                 f"{x['routed_deltas']['update_visible']['p50_ms']} ms"
                 if "routed_deltas" in x else "") + f" ({card})")
    print(f"partition smoke: replica baseline "
          f"{fmt_lat(pa['replica_baseline'])}; tile exchange overhead p50 "
          f"{pa.get('tile_exchange_overhead_p50')}; kill: "
          f"{fmt_lat(pa['failover'])}, lost {pa['failover']['lost']}")

    full = timed("run_bench", lambda: bs.run_bench(platform="cuda"))
    if any(x["shed"] for x in full["regimes"].values()):
        raise AssertionError(f"run_bench shed: {full['regimes']}")
    print("run_bench (2048 x 4096 x 48, 32 clients x 64, max_batch 32): "
          + "; ".join(f"{name} {fmt_lat(x)}"
                      for name, x in full["regimes"].items())
          + f"; speedups {full['speedups']} ({card})")

    mp = compile_metapath("APVPA", hin.schema)
    want = dense.topk(k=TOP_K)
    tiers = timed("bench_backends", lambda: tbb.measure_tiers(
        hin, mp, TWIN_TIERS, TOP_K, TWIN_REPS, TWIN_SHARDS, "cuda"))
    for record, ranking in tiers:
        if not all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(ranking, want)):
            raise AssertionError(f"{record['metric']}: ranking differs "
                                 "from K1's")
        if not record["value"] > 0:
            raise AssertionError(f"{record['metric']}: {record['value']}")
        print(json.dumps(record))
    print(f"bench_backends at {N_AUTHORS}x{N_PAPERS}x{N_VENUES} k={TOP_K}: "
          f"three tiers, rankings equal to K1's ({card})")
    launches = dict(ck.LAUNCHES)
    print(f"bench twins: launches in this process {launches}; walls "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    print(f"bench twins phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# Phase 6i: the tier twins. The JAX package's learned smoke reads score
# recall@10 0.972917 on the smoke graph (its run_learned_bench with the
# smoke's arguments on the CPU); the card's recall is printed beside it.
LEARNED_SMOKE_JAX_RECALL = 0.972917
TIER_SMOKES = ("ann", "firehose", "metapath", "compress", "batch")


def batch_score_counts():
    """Block GEMMs counted by the batch engine, by where they ran."""
    from distributed_pathsim_tpu_torch.obs.metrics import get_registry

    fam = get_registry().counter("dpathsim_batch_score_backend_total")
    return {b: fam.labels(backend=b).value for b in ("cuda", "numpy")}


def compress_card_bytes(torch, np, bs):
    """``torch.cuda.memory_allocated`` held by each compress arm's
    ``torch-sparse`` backend on the smoke graph (headroom 0.25, as the
    arm builds it), after one served batch; the bench's own keys keep
    host VmRSS only."""
    from distributed_pathsim_tpu_torch.data import delta as tdl
    from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    c = bs.COMPRESS_SMOKE
    hin = tdl.with_headroom(synthetic_hin(
        c["n_authors"], c["n_papers"], c["n_venues"], seed=c["seed"]), 0.25)
    mp = compile_metapath("APVPA", hin.schema)
    rows = np.arange(c["batch_rows"])
    out = {}
    for fmt in ("coo", "blocked", "bitpacked"):
        gc.collect()
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        sparse = bs._create_backend("torch-sparse", hin, mp, "cuda",
                                    factor_format=fmt)
        sparse.topk_rows(rows, k=c["k"])
        torch.cuda.synchronize()
        out[fmt] = torch.cuda.memory_allocated() - m0
        del sparse
    return out


def bench_tiers(torch, ck, np, card):
    """Phase 6i: the tier twins of the port's ``bench_serving`` on the
    card. The ann, firehose, metapath, compress and batch smokes with
    every check true, the clock's included (each smoke raises if one
    fails); the learned bench at the smoke's arguments with every check
    true but ``recall_ge_0_99`` (``CARD_EXEMPT_CHECKS``), its recall
    printed beside the JAX run's. Returns the launches of the phase per
    kernel."""
    from distributed_pathsim_tpu_torch import bench_serving as bs

    phase("the tier twins on the card: bench_serving's ann, firehose, "
          "metapath, compress and batch smokes, the learned bench")
    t_phase = time.perf_counter()
    ck.reset_launches()
    walls = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[label] = time.perf_counter() - t0
        return out

    batch0 = batch_score_counts()
    res = {}
    for regime in TIER_SMOKES:
        smoke = getattr(bs, f"run_{regime}_smoke")
        res[regime] = timed(regime, lambda s=smoke: s(platform="cuda"))
        checks = res[regime].get("smoke_checks", res[regime].get("checks"))
        if not checks or not all(checks.values()):
            raise AssertionError(f"{regime} smoke: {checks}")
        print(f"{regime} smoke: {walls[regime]:.1f} s, all {len(checks)} "
              f"checks true ({', '.join(checks)})")
    batch1 = batch_score_counts()
    lr = timed("learned", lambda: bs.run_learned_bench(
        **bs.LEARNED_SMOKE, platform="cuda"))
    checks = bs.learned_checks(lr)
    exempt = bs.CARD_EXEMPT_CHECKS["learned"]
    failed = [n for n, ok in checks.items() if n not in exempt and not ok]
    if failed:
        raise AssertionError(f"learned bench: {checks}")
    print(f"learned bench: {walls['learned']:.1f} s, "
          f"{len(checks) - len(exempt)} checks true "
          f"({', '.join(n for n in checks if n not in exempt)}); "
          f"{', '.join(exempt)} {checks[exempt[0]]} (exempt on the card)")

    a = res["ann"]
    st = a["staleness_exercise"]
    print(f"ann smoke (768 x 1280 x 16, 8 clients x 24): recall@10 "
          f"{a['recall']['recall_at_k']} (id {a['recall']['id_recall_at_k']},"
          f" bit-identical {a['recall']['bit_identical']}/"
          f"{a['recall']['samples']}); " + "; ".join(
              f"{name} {x['qps_median']} QPS p99 {x['p99_ms_median']} ms"
              for name, x in a["arms"].items())
          + f"; speedups {a['speedups']}; staleness: update "
          f"{st['update_mode']}, {st['stale_rows_after_update']} stale rows, "
          f"answered exactly {st['stale_row_answered_exactly']}, after "
          f"refresh {st['stale_rows_after_refresh']} stale, ann matches "
          f"{st['post_refresh_ann_matches']}; compiles "
          f"{a['steady_state_compiles']} ({card})")
    cs = lr["cold_start"]
    print(f"learned bench (768 x 1280 x 16, 120 distillation steps, "
          f"cand_mult 16): recall@10 {lr['recall']['recall_at_k']} against "
          f"the JAX run's {LEARNED_SMOKE_JAX_RECALL} (the packages' towers "
          f"differ by design), ann recall {lr['ann_recall']['recall_at_k']}; "
          f"distillation at start {lr['train_startup_s']} s; " + "; ".join(
              f"{name} {x['qps_median']} QPS p99 {x['p99_ms_median']} ms"
              for name, x in lr["arms"].items())
          + f"; cold start: first answer {cs['cold_first_answer_ms']} ms "
          f"({cs['pre_refresh_fallback_reason']}), refresh "
          f"{cs['refresh_ms']} ms, cold-start ratio "
          f"{cs['cold_start_ratio_before_refresh']} -> "
          f"{cs['cold_start_ratio_after_refresh']} ({card})")
    f = res["firehose"]
    s, fl, au = f["sustained"], f["fleet"], f["autoscale"]
    print(f"firehose smoke (256 x 448 x 10, 260 deltas, 4 clients): "
          f"{s['updates_per_s']} updates/s, {s['qps']} QPS; update-visible "
          f"p50/p99 {s['update_visible']['p50_ms']}/"
          f"{s['update_visible']['p99_ms']} ms; compactions "
          f"{s['compaction']['count']}, pause p99 "
          f"{s['compaction']['pause_p99_ms']} ms, compiles "
          f"{s['compaction']['compiles']} (outside compaction "
          f"{s['compiles_outside_compaction']}); fleet broadcasts "
          f"{fl['broadcasts']} for {fl['updates']} updates (coalesced "
          f"{fl['coalesced']}); autoscale spawn tick {au['spawn_tick']}, "
          f"drain tick {au['drain_tick']}, settled at "
          f"{au['workers_after_settle']} ({card})")
    m = res["metapath"]
    o, w = m["ordering"], m["workload"]
    print(f"metapath smoke: {o['metapath']} {o['plan_order']} planner "
          f"{o['measured_ms_planner']} ms against naive "
          f"{o['measured_ms_naive']} ms (host numpy f64; est. FLOPs "
          f"{o['est_flops_planner']:.0f} / {o['est_flops_naive']:.0f}); "
          f"memo on {w['memo_on']['qps']} QPS, off {w['memo_off']['qps']}, "
          f"uplift {w['memo_qps_uplift']}; memo hits "
          f"{w['memo_on']['memo']['hits']}; refold cold/warm "
          f"{w['refold']['cold_ms']}/{w['refold']['warm_ms']} ms ({card})")
    card_bytes = compress_card_bytes(torch, np, bs)
    c = res["compress"]
    print("compress smoke (768 x 1536 x 16): " + "; ".join(
        f"{fmt} factor_bytes {x['factor_bytes']}"
        + (f" (reduction {x['reduction_vs_coo']}x)"
           if "reduction_vs_coo" in x else "")
        + f", serve p50 {x['serve_p50_ms']} ms, max_n at "
        f"{c['budget_gb']} GiB {x['max_n_at_budget_single_chip']}, "
        f"torch.cuda.memory_allocated {card_bytes[fmt]} B"
        for fmt, x in c["formats"].items()) + f" ({card})")
    b = res["batch"]
    scored = {k: batch1[k] - batch0[k] for k in batch0}
    share = scored["cuda"] / max(sum(scored.values()), 1)
    print(f"batch smoke (192 x 384 x 12, block_rows 32): top-k-all "
          f"{b['topk_single_host']['rows_per_s']} rows/s on "
          f"{b['backend_mode']}, fleet {b['topk_fleet']['rows_per_s']} rows/s;"
          f" block GEMMs on the card {scored['cuda']:.0f} of "
          f"{sum(scored.values()):.0f} ({share:.3f}); simjoin prune ratio "
          f"{b['simjoin']['prune_ratio']}, {b['simjoin']['pairs']} pairs "
          f"({card})")
    if b["backend_mode"] != "cuda" or scored["numpy"]:
        raise AssertionError(f"batch smoke scored on the host: {scored}")
    launches = dict(ck.LAUNCHES)
    print(f"tier twins: launches in this process {launches}; walls "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    print(f"tier twins phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def timings(torch, ck, hin, hin_ap, launches, backend, card, k3, instances):
    """Phase 2 at the main path's shapes + phase 6 (times)."""
    from distributed_pathsim_tpu_torch.ops import planner
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

    phase("kernels at the main path's shapes")
    dev = torch.device("cuda")
    c, d = factor(hin, "APVPA", dev)
    n, v = c.shape
    lim = ck.split_limbs(c)
    err_k1 = check_topk(torch, ck, c, d, TOP_K, True, "rank-all shape",
                        limbs=lim)
    ca, da = factor(hin_ap, "APVPA", dev)
    lim_a = ck.split_limbs(ca)
    err_k2 = check_scores(torch, ck, ca, da, "all-pairs shape", limbs=lim_a)
    err_k3 = check_rect(torch, ck, c, d, 0, 4096, TOP_K, "rank-all shape",
                        pad_cols=0)
    err_k4 = check_fold(torch, ck, c, d, TOP_K_FOLD, True, "rank-all shape")
    print(f"K1 at {n}x{v} k={TOP_K}, K2 at {ca.shape[0]}x{ca.shape[1]}, K3 "
          f"at a 4096-row tile of it, K4 at k={TOP_K_FOLD}: equal to the "
          "plain versions")

    phase("times (CUDA events, median of 7; K3's are in the config 5 "
          "phase)")
    # K1 and K2 on the split factor, as the dense backend calls them (it
    # splits C once per graph)
    k1_ms = time_ms(torch, lambda: ck.topk_twopass_candidates(
        c, d, TOP_K, True, limbs=lim))
    cv, cc = ck.topk_twopass_candidates(c, d, TOP_K, True, limbs=lim)
    n_st = cv.shape[1]
    pass2_ms = time_ms(torch, lambda: ck.sparse.chunked_row_topk(
        cv.view(n, -1), cc.view(n, -1), TOP_K))
    k1_total_ms = time_ms(torch, lambda: ck.fused_topk_twopass(
        c, d, TOP_K, limbs=lim))
    k1_plain_ms = time_ms(torch, lambda: ck.fused_topk_twopass_plain(
        c, d, TOP_K), reps=5)
    sweep = {}
    for tiles in STRIPE_SWEEP:
        sv, sc = ck.topk_twopass_candidates(c, d, TOP_K, True, limbs=lim,
                                            stripe_tiles=tiles)
        sweep[tiles * ck.TILE] = (
            time_ms(torch, lambda: ck.topk_twopass_candidates(
                c, d, TOP_K, True, limbs=lim, stripe_tiles=tiles)),
            time_ms(torch, lambda: ck.sparse.chunked_row_topk(
                sv.view(n, -1), sc.view(n, -1), TOP_K)))

    def lib_topk():
        m = torch.matmul(c, c.T)
        den = d[:, None] + d[None, :]
        s = torch.where(den > 0, (2.0 * m) / den, 0.0)
        s.fill_diagonal_(float("-inf"))
        return torch.topk(s, TOP_K, dim=1)

    k1_lib_ms = time_ms(torch, lib_topk, reps=5)
    k1_cand_bytes = 8.0 * n * n_st * TOP_K
    (k1_bound, k1_by), (k1_f32, _) = square_bounds(lim, n, v, k1_cand_bytes)

    na, va = ca.shape
    k2_ms = time_ms(torch, lambda: ck.fused_scores(ca, da, limbs=lim_a))
    k2_plain_ms = time_ms(torch, lambda: ck.fused_scores_plain(ca, da))

    def lib_scores():
        m = torch.matmul(ca, ca.T)
        den = da[:, None] + da[None, :]
        return torch.where(den > 0, (2.0 * m) / den, 0.0)

    k2_lib_ms = time_ms(torch, lib_scores)
    (k2_bound, k2_by), (k2_f32, _) = square_bounds(lim_a, na, va,
                                                   4.0 * na * na)

    # K4 on the split factor, and with the split made in the call
    k4_ms = time_ms(torch, lambda: ck.fused_topk(c, d, TOP_K_FOLD,
                                                  limbs=lim))
    k4_call_ms = time_ms(torch, lambda: ck.fused_topk(c, d, TOP_K_FOLD))
    k4_plain_ms = time_ms(torch, lambda: ck.fused_topk_plain(
        c, d, TOP_K_FOLD), reps=5)

    def lib_fold():
        m = torch.matmul(c, c.T)
        den = d[:, None] + d[None, :]
        s = torch.where(den > 0, (2.0 * m) / den, 0.0)
        s.fill_diagonal_(float("-inf"))
        return torch.topk(s, TOP_K_FOLD, dim=1)

    k4_lib_ms = time_ms(torch, lib_fold, reps=5)
    (k4_bound, k4_by), (k4_f32, _) = square_bounds(lim, n, v,
                                                   8.0 * n * TOP_K_FOLD)
    spill = {name: {inst: sp for inst, (_, sp) in insts.items()}
             for name, insts in instances.items()}
    print(f"K1 topk_twopass_candidates {n}x{v} k={TOP_K} ({n_st} stripes of "
          f"{ck.twopass_stripe_tiles(n, v, TOP_K, dev) * ck.TILE} columns): "
          f"{k1_ms:.3f} ms on "
          f"the split factor (int8 tensor-core bound {k1_bound:.3f} ms by "
          f"{k1_by} with {k1_cand_bytes / 1e6:.1f} MB of candidates; f32 "
          f"CUDA-core bound {k1_f32:.3f} ms); pass 2 {pass2_ms:.3f} ms; "
          f"K1+pass 2 {k1_total_ms:.3f} ms against K4's {k4_ms:.3f} ms at "
          f"k={TOP_K_FOLD}; plain {k1_plain_ms:.3f} ms; library "
          f"(matmul+normalize+topk) {k1_lib_ms:.3f} ms; spill bytes "
          f"{spill.get('topk_twopass_candidates')}")
    print("K1 by stripe width (columns: K1 ms, pass 2 ms): "
          + ", ".join(f"{w}: {a:.3f}, {b:.3f}" for w, (a, b) in sweep.items()))
    print(f"K2 fused_scores {na}x{va}: {k2_ms:.3f} ms on the split factor "
          f"(int8 tensor-core bound {k2_bound:.3f} ms by {k2_by}: "
          f"{4.0 * na * na / 1e6:.0f} MB of scores written; f32 CUDA-core "
          f"bound {k2_f32:.3f} ms); plain {k2_plain_ms:.3f} ms; library "
          f"(matmul+normalize) {k2_lib_ms:.3f} ms; spill bytes "
          f"{spill.get('fused_scores')}")
    print(f"K4 topk_fold {n}x{v} k={TOP_K_FOLD}: {k4_ms:.3f} ms on the "
          f"split factor, {k4_call_ms:.3f} ms with the split (int8 "
          f"tensor-core bound {k4_bound:.3f} ms by {k4_by} for the limb "
          f"products of the N(N+1)/2 pairs; f32 CUDA-core bound "
          f"{k4_f32:.3f} ms; the kernel does every tile, "
          f"{2.0 * n * n * v / k4_ms / 1e12:.1f} TOP/s of one-limb "
          f"products); plain {k4_plain_ms:.3f} ms; library "
          f"(matmul+normalize+topk) {k4_lib_ms:.3f} ms")

    # Rank-all end to end on a built backend (bench.py's measurement:
    # backend.topk including the host fetch), plus its layers.
    mp = compile_metapath("APVPA", hin.schema)
    t0 = time.perf_counter()
    coo = planner.fold_half(hin, mp)
    fold_s = time.perf_counter() - t0
    backend._half_cache = None  # time the scatter-build of C alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cb, rb = backend._half()
    torch.cuda.synchronize()
    scatter_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lb = backend._limbs(cb)
    torch.cuda.synchronize()
    split_ms = (time.perf_counter() - t0) * 1e3
    rank_times = wall_s(torch, lambda: backend.topk(k=TOP_K))
    rank_s = statistics.median(rank_times)
    busy = device_busy_share(torch, lambda: backend.topk(k=TOP_K))
    fv, fi = ck.fused_topk_twopass(cb, rb, TOP_K, limbs=lb)
    fetch_ms = time_ms(torch, lambda: (fv.cpu(), fi.cpu()))
    pairs = float(n) * (n - 1)
    print(f"rank-all backend.topk: {rank_s * 1e3:.3f} ms median of 5 "
          f"(min {min(rank_times) * 1e3:.3f}, max "
          f"{max(rank_times) * 1e3:.3f}) -> {pairs / rank_s:.4g} "
          f"author-pairs/s on {card}; device busy share "
          + ("not measured (no device time in the profile)" if busy is None
             else f"{busy:.3f}"))
    print(f"layers: host fold {fold_s * 1e3:.1f} ms (nnz {coo.rows.size}), "
          f"scatter-build of C {scatter_s * 1e3:.2f} ms, limb split (once "
          f"per graph) {split_ms:.2f} ms, K1 {k1_ms:.3f} ms, pass 2 "
          f"{pass2_ms:.3f} ms, fetch {fetch_ms:.3f} ms")

    def entry(name, source, replaces, pallas, ms, plain, bnd, by, lib, err,
              f32, int8):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "replaces_kernels": pallas,
            "launches": launches[name], "ok": True, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib, "bound_f32_ms": f32, "bound_int8_ms": int8,
            "spill_bytes": spill.get(name),
        }

    return [
        {**entry("topk_twopass_candidates",
                 "distributed_pathsim_tpu_torch/csrc/topk_twopass.cu",
                 "distributed_pathsim_tpu/ops/pallas_kernels.py:545",
                 ["_topk2_kernel", "_topk2_kernel_kt"],
                 k1_ms, k1_plain_ms, k1_bound, k1_by, k1_lib_ms, err_k1,
                 k1_f32, k1_bound),
         "pass2_ms": pass2_ms, "with_pass2_ms": k1_total_ms,
         "ms_by_stripe_columns": {w: a for w, (a, _) in sweep.items()}},
        entry("fused_scores",
              "distributed_pathsim_tpu_torch/csrc/fused_scores.cu",
              "distributed_pathsim_tpu/ops/pallas_kernels.py:119",
              ["_scores_kernel", "_scores_kernel_kt"],
              k2_ms, k2_plain_ms, k2_bound, k2_by, k2_lib_ms, err_k2,
              k2_f32, k2_bound),
        {**entry("topk_rect_candidates",
                 "distributed_pathsim_tpu_torch/csrc/topk_rect.cu",
                 "distributed_pathsim_tpu/ops/pallas_kernels.py:707",
                 ["_topk2_rect_kernel", "_topk2_rect_kernel_kt"],
                 k3["ms"], k3["plain_ms"], k3["bound_ms"], k3["bound_by"],
                 k3["library_ms"], err_k3, k3["bound_f32_ms"],
                 k3["bound_int8_ms"]),
         "ms_tile0": k3["ms_tile0"], "config5_max_abs_err": k3["c5_err"]},
        entry("topk_fold",
              "distributed_pathsim_tpu_torch/csrc/topk_fold.cu",
              "distributed_pathsim_tpu/ops/pallas_kernels.py:192",
              ["_topk_kernel", "_topk_kernel_kt"],
              k4_ms, k4_plain_ms, k4_bound, k4_by, k4_lib_ms, err_k4,
              k4_f32, k4_bound),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import numpy as np

        from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
        from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
    except ImportError as exc:
        print(f"error: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2
    ck.true_f32()

    t_start = time.perf_counter()
    lint_launches = lint_phase(torch, ck)
    name, smi, instances = device_and_build(torch, ck)
    kernel_checks(torch, ck, np, synthetic_hin)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        hin, hin_ap, launches, backend = main_path(
            torch, ck, np, pathlib.Path(tmp)
        )
        cli_launches = batch_cli_rest(torch, ck, np, pathlib.Path(tmp), smi,
                                      hin)
        cold_qps = serving(torch, ck, np, launches, pathlib.Path(tmp), smi,
                           hin, hin_ap)
        router_fleet(np, pathlib.Path(tmp), smi, cold_qps)
        sr_launches = serving_rest(torch, ck, np, smi)
        k3, c5 = config5(torch, ck, np, launches, pathlib.Path(tmp), smi)
        pk_launches = packed_sym_batch(torch, ck, np, pathlib.Path(tmp), smi,
                                       hin, hin_ap, c5)
        del c5
        sp_launches = sharded_partition(torch, ck, np, pathlib.Path(tmp),
                                        smi, hin, hin_ap, backend)
        ann_launches = ann_tier(torch, ck, np, pathlib.Path(tmp), smi, hin)
        learned_launches = learned_tier(torch, ck, np, pathlib.Path(tmp),
                                        smi, hin)
        train_launches = learned_training(torch, ck, np, pathlib.Path(tmp),
                                          smi, hin)
        tune_launches, tuned = tuning_phase(torch, ck, np, pathlib.Path(tmp),
                                            smi, hin,
                                            pathlib.Path(tmp) / "ranking.tsv")
        bench_launches = bench_twins(torch, ck, np, smi, hin, backend)
        tier_launches = bench_tiers(torch, ck, np, smi)
    kernels = timings(torch, ck, hin, hin_ap, launches, backend, smi, k3,
                      instances)
    for kern in kernels:  # later phases' own runs, counted apart
        kern["launches_batch_cli"] = cli_launches[kern["name"]]
        kern["launches_serving_rest"] = sr_launches[kern["name"]]
        kern["launches_packed_sym_batch"] = pk_launches[kern["name"]]
        kern["launches_sharded_partition"] = sp_launches[kern["name"]]
        kern["launches_ann"] = ann_launches[kern["name"]]
        kern["launches_learned"] = learned_launches[kern["name"]]
        kern["launches_train"] = train_launches[kern["name"]]
        kern["launches_tune"] = tune_launches[kern["name"]]
        kern["launches_lint"] = lint_launches[kern["name"]]
        kern["launches_bench"] = bench_launches[kern["name"]]
        kern["launches_bench_tiers"] = tier_launches[kern["name"]]
        if kern["name"] in tuned:
            kern["tuned"] = tuned[kern["name"]]
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "distributed_pathsim_tpu")]
    if leaked:
        raise AssertionError(f"JAX-side modules imported: {leaked[:5]}")
    print(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s from the "
          f"lint phase to the last phase on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
