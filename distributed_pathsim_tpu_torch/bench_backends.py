"""Per-tier benchmark of the port: one JSON line per engine tier.

    python -m distributed_pathsim_tpu_torch.bench_backends [--authors N]
        [--papers P] [--venues V] [--devices D] [--top-k K] [--repeats R]

The twin of the repository's ``bench_backends.py`` for the port. It
measures the tiers that make the system distributed:

- ``torch``          dense rank-all on one card: K1 and pass 2;
- ``torch-sparse``   host-COO fold, then K3 over the row tiles;
- ``torch-sharded``  ``--devices`` shards of the mesh (``parallel/mesh``;
  shards share a card when there are more shards than cards), the ring
  on K3.

All three compute the same product: every ordered author pair's PathSim
score (row-sum semantics) reduced to each author's top-k, and the three
rankings must be equal (the run fails otherwise). ``value`` is
N·(N−1) pairs over the fastest of ``--repeats`` timed calls, each with
the host fetch of the [N, k] winners, after one warm call; median and
max beside it. The sharded tier also times one ring step
(:func:`bench_ring_step`).

The shapes are the port benchmark's (``bench.py``: 45000 papers, 384
venues, top-10, seed 42): 32768 authors on the card, 8192 on the host.
It needs a card unless ``--platform cpu`` is given: without one it
exits 2 and prints no result. On the host every tier runs its kernels'
plain versions, and its numbers say nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

from . import bench as _headline  # the port's canonical shapes

N_AUTHORS_CPU = 8192
TIERS = ("torch", "torch-sparse", "torch-sharded")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m distributed_pathsim_tpu_torch.bench_backends",
        description=__doc__.splitlines()[0],
    )
    p.add_argument("--authors", type=int, default=None,
                   help=f"default {_headline.N_AUTHORS} on the card, "
                   f"{N_AUTHORS_CPU} on the host")
    p.add_argument("--papers", type=int, default=_headline.N_PAPERS)
    p.add_argument("--venues", type=int, default=_headline.N_VENUES)
    p.add_argument("--devices", type=int, default=2,
                   help="torch-sharded: shards of the mesh")
    p.add_argument("--top-k", type=int, default=_headline.TOP_K)
    p.add_argument("--repeats", type=int, default=_headline.REPS)
    p.add_argument("--backends", default=",".join(TIERS),
                   help="comma-separated tiers to measure")
    p.add_argument("--out", default=None,
                   help="also append the JSON lines to this file")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="the card (default; exit 2 without one) or the "
                   "host, where the kernels' plain versions run")
    args = p.parse_args(argv)
    if args.authors is None:
        args.authors = (_headline.N_AUTHORS if args.platform == "cuda"
                        else N_AUTHORS_CPU)
    return args


def bench_backend(name: str, hin, mp, k: int, repeats: int, n_devices: int,
                  platform: str = "cuda"):
    """Fastest, median and slowest of ``repeats`` wall-clock rank-all
    top-k calls, each including the host fetch of the [N, k] winners
    (and, on the card, ending in a synchronize), after one warm call.
    For ``torch-sharded`` also the ring step's timing
    (:func:`bench_ring_step`). Returns ``(median, min, max, ring,
    ranking)``, the ranking being the last call's (values, indices)."""
    import torch

    from .backends.base import create_backend

    options = {"device": platform}
    if name == "torch-sharded":
        options["n_devices"] = n_devices
    backend = create_backend(name, hin, mp, **options)
    on_card = torch.device(platform).type == "cuda"

    def run():
        out = (backend.topk(k=k) if hasattr(backend, "topk")
               else backend.topk_scores(k=k))
        if on_card:
            torch.cuda.synchronize()
        return out

    run()  # warm: kernel builds, the factor on the device
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        ranking = run()
        times.append(time.perf_counter() - t0)
    ring = (bench_ring_step(backend, k, repeats)
            if name == "torch-sharded" else None)
    return (statistics.median(times), min(times), max(times), ring,
            ranking)


def bench_ring_step(backend, k: int, repeats: int) -> dict:
    """One ``sharded_ring_step`` (step 0: every shard folds its own
    block) timed over ``repeats`` interleaved rounds
    (``utils/benchrunner``), host clock, each call ending in a
    synchronize. On the card the step is K3's (``k3_cuda``); on the host
    it is the plain fold (``plain_fold_cpu``), which says nothing of the
    card."""
    import numpy as np
    import torch

    from .parallel.sharded import sharded_ring_state, sharded_ring_step
    from .utils import benchrunner as br

    mesh = backend.mesh
    on_card = backend.device.type == "cuda"
    c, d = sharded_ring_state(backend._first, (), mesh=mesh)
    limbs = backend._shard_limbs(on_card)
    n_loc = int(c[0].shape[0])
    best_v = [torch.full((n_loc, k), -np.inf, dtype=p.dtype,
                         device=p.device) for p in c]
    best_i = [torch.zeros((n_loc, k), dtype=torch.int64, device=p.device)
              for p in c]
    ids: dict = {}

    def run():
        sharded_ring_step(c, d, c, d, best_v, best_i, 0, mesh, k=k,
                          n_true=backend.n, use_kernel=on_card,
                          limbs=limbs, block_limbs=limbs, rotate=False,
                          row_ids_cache=ids)
        if on_card:
            torch.cuda.synchronize()

    label = "k3_cuda" if on_card else "plain_fold_cpu"
    res = br.time_interleaved({label: run}, repeats)
    return {
        name: {k2: v for k2, v in r.items() if k2 != "times_ms"}
        for name, r in res.items()
    }


def measure_tiers(hin, mp, tiers, k: int, repeats: int, n_devices: int,
                  platform: str = "cuda", device: dict | None = None):
    """Each tier's record (the JSON line) and ranking, in ``tiers``
    order; raises if a tier's ranking differs from the first tier's.
    ``device``: the card's name and power limit, added to each record."""
    import numpy as np

    n = hin.type_size("author")
    pairs = float(n) * (n - 1)
    scale = f"{n // 1000}k" if n >= 1000 else str(n)
    out = []
    for name in tiers:
        med, tmin, tmax, ring, ranking = bench_backend(
            name, hin, mp, k=k, repeats=repeats, n_devices=n_devices,
            platform=platform,
        )
        if out and not all(np.array_equal(a, b)
                           for a, b in zip(ranking, out[0][1])):
            raise AssertionError(f"{name}'s ranking differs from "
                                 f"{tiers[0]}'s")
        # only the sharded tier spans the mesh
        n_dev = n_devices if name == "torch-sharded" else 1
        record = {
            "metric": (
                f"author_pairs_per_sec_{name}_{scale}_authors_"
                f"top{k}_{platform}{n_dev}dev"
            ),
            "value": pairs / tmin,
            "unit": "pairs/sec",
            "vs_baseline": None,
            "seconds_min": tmin,
            "seconds_median": med,
            "seconds_max": tmax,
            "reps": repeats,
        }
        if ring is not None:
            record["ring_step_ms"] = ring
        if device is not None:
            record["device"] = device
        out.append((record, ranking))
    return out


def main(argv=None) -> int:
    import torch

    args = parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        from .utils.logging import runtime_event

        runtime_event("bench_refused", reason="no CUDA device available; "
                      "pass --platform cpu to run on the host")
        return 2
    from .data.synthetic import synthetic_hin
    from .ops import cuda_kernels
    from .ops.metapath import compile_metapath

    device = None
    if args.platform == "cuda":
        from .bench_serving import card_device

        cuda_kernels.true_f32()
        device = card_device()
    hin = synthetic_hin(args.authors, args.papers, args.venues,
                        seed=_headline.SEED)
    mp = compile_metapath("APVPA", hin.schema)
    tiers = [b.strip() for b in args.backends.split(",") if b.strip()]
    for record, _ in measure_tiers(hin, mp, tiers, args.top_k, args.repeats,
                                   args.devices, args.platform, device):
        line = json.dumps(record)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
