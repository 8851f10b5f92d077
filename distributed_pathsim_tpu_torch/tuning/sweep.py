"""Tuning sweep driver: the offline sweep, the tuned-serving smoke and
the tuned-vs-default K1 comparison.

Run from the repository root::

    python -m distributed_pathsim_tpu_torch.tuning.sweep [--platform cpu]

Three modes (the port's twin of the JAX package's
``scripts/tune_sweep.py``):

- default     — the full offline sweep: every measurable knob over the
                standard shape set (``autotuner._DEFAULT_POINTS``),
                written to ``--out`` (the bigger sibling of
                ``dpathsim-torch tune``);
- ``--smoke`` — measure a tiny table, serve under it, and hard-assert
                five contracts: the table is written and loaded, the
                hit path is exercised, a corrupt table and a
                fingerprint-mismatched one (its torch version edited)
                degrade without a crash, and a warm service under the
                tuned table makes zero compiles after warmup;
- ``--bench`` — on the card only: K1's dispatch under the tuned table
                (``twopass_stripe_tiles`` measured for exactly the
                swept shapes, or ``--table``) against K1 at the
                default stripe width, at 8192 x 384 and 32768 x 384,
                on a graph the racer never saw (the bench graph's
                seed), compared by paired per-round ratios within the
                measured noise bound.

Every mode runs on the card unless ``--platform cpu`` asks for the host
(``--bench`` refuses the host: it measures the kernel). Timing
discipline throughout is the shared estimator (utils/benchrunner.py):
interleaved arms, median-of-best.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_BENCH_SHAPES = ((8192, 384), (32768, 384))
_BENCH_K = 10
# The bench graph's seed (chip_smoke.py's SEED): the comparison's
# factor is another graph than the racer's (autotuner._hin_factor,
# seeds 0-2), so it checks the choice instead of repeating it.
_BENCH_SEED = 42


def run_bench(table_path: str | None, reps: int, shapes=_BENCH_SHAPES,
              quick: bool = False, device="cuda") -> dict:
    """Tuned K1 dispatch against the default stripe width: at every
    swept shape the tuned dispatch (``fused_topk_twopass`` with its
    width from the table) must be no slower than K1 at the untuned
    heuristic's width beyond the measured noise bound (a paired
    per-round ratio), on the half chain of a synthetic graph at the
    shape made from :data:`_BENCH_SEED` — at 32768 x 384 the bench
    graph itself — which the racer never timed. Both arms are K1 +
    pass 2 on the card; each synchronizes before it returns."""
    import torch

    from .. import tuning
    from ..ops import cuda_kernels as ck
    from ..utils import benchrunner as br
    from ..utils.device import resolve_device
    from .autotuner import SweepPoint, _cycled, _hin_factor, tune

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("--bench measures K1 and needs the card "
                         "(--platform cuda)")
    ck.true_f32()
    tuning.set_device(dev)
    if quick:
        shapes = (shapes[0],)
    if table_path:
        if not tuning.install_table(table_path):
            raise ValueError(f"tuning table {table_path!r} unusable")
        table = tuning.active_table()
    else:
        table = tune([SweepPoint(n, v) for n, v in shapes],
                     knobs=["twopass_stripe_tiles"], reps=reps, device=dev)
        tuning.set_table(table, source="<in-memory sweep>")

    result = {
        "device_kind": torch.cuda.get_device_name(dev),
        "platform": "gpu",
        "table_digest": table.digest,
        "table_entries": len(table.entries),
        "estimator": (
            "interleaved arms, median-of-best for absolute numbers, "
            "paired per-round ratios for the gate (utils/benchrunner.py); "
            "noise bound = max per-arm (median - median_of_best) / "
            "median_of_best, floored at 5%"
        ),
        "shapes": [],
    }
    all_ok = True
    for n, v in shapes:
        bufs = _hin_factor(n, v, dev, seed=_BENCH_SEED, variants=1)
        default_w = ck.default_twopass_stripe_tiles(n)
        tuned_w = ck.twopass_stripe_tiles(n, v, _BENCH_K, dev)

        def tuned(buf):
            c, d, lim = buf
            ck.fused_topk_twopass(c, d, k=_BENCH_K, limbs=lim)
            torch.cuda.synchronize(dev)

        def default(buf):
            c, d, lim = buf
            ck.fused_topk_twopass(c, d, k=_BENCH_K, limbs=lim,
                                  stripe_tiles=default_w)
            torch.cuda.synchronize(dev)

        res = br.time_interleaved({
            "tuned_dispatch": _cycled(tuned, bufs),
            "default_stripe": _cycled(default, bufs),
        }, reps)
        noise = br.noise_bound(res)
        ratio = br.paired_ratio(res, "tuned_dispatch", ["default_stripe"])
        ok = ratio <= 1.0 + noise
        all_ok = all_ok and ok
        result["shapes"].append({
            "n_authors": n,
            "v_width": v,
            "factor": f"APVPA half chain, synthetic_hin seed {_BENCH_SEED}",
            "tuned_stripe_tiles": tuned_w,
            "default_stripe_tiles": default_w,
            "noise_bound": round(noise, 4),
            "tuned_vs_default_paired_ratio": round(ratio, 4),
            "arms": {
                name: {k2: v2 for k2, v2 in r.items() if k2 != "times_ms"}
                for name, r in res.items()
            },
            "no_regression_vs_default": ok,
        })
    result["checks"] = {
        "tuned_no_slower_than_default_at_every_shape": all_ok,
        "shapes_swept": [f"{n}x{v}" for n, v in shapes],
    }
    return result


def run_tune_smoke(out_path: str | None = None, device="cuda") -> dict:
    """The tuning gate: a real (tiny) measured table, served under, with
    five hard checks —

    1. the table is written and loads back (same digest);
    2. the dispatch hit path is exercised (serving's lookups resolve
       from the table, not the heuristics);
    3. a corrupt table degrades to heuristics (no crash; the heuristic
       answers);
    4. a fingerprint-mismatched table (its torch version edited)
       degrades the same way;
    5. a warm service under the tuned table makes ZERO compiles after
       warmup (tuning must never break the shape-bucket contract).
    """
    import tempfile

    from .. import tuning
    from ..backends.base import create_backend
    from ..data.synthetic import synthetic_hin
    from ..ops.metapath import compile_metapath
    from ..serving import PathSimService, ServeConfig
    from ..utils.compile_counter import CompileCounter
    from ..utils.device import resolve_device
    from .autotuner import SweepPoint, tune

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops import cuda_kernels as ck

        ck.true_f32()
    tuning.reset()
    tuning.set_device(dev)
    tmp = tempfile.mkdtemp(prefix="dpathsim_tune_smoke_")
    table_path = f"{tmp}/table.json"
    result: dict = {"table": table_path, "device_kind": tuning.device_kind()}
    try:
        # -- measure a tiny real table (cheap knobs only; the kernel
        # knobs add their card arms on the card) ------------------------
        table = tune(
            [SweepPoint(256, 64), SweepPoint(384, 48, nnz=2048)],
            knobs=["sparse_tile_rows", "serve_buckets",
                   "twopass_stripe_tiles", "rect_target_units"],
            reps=2, max_batch=8, out=table_path, device=dev,
        )
        result["entries"] = len(table.entries)

        # -- corrupt / mismatched tables degrade, never crash ------------
        corrupt_path = f"{tmp}/corrupt.json"
        with open(corrupt_path, "w", encoding="utf-8") as f:
            f.write('{"schema_version": 1, "entries": {')  # truncated
        tuning.reset()
        corrupt_refused = not tuning.install_table(corrupt_path)
        fallback_choice = tuning.choose(
            "serve_buckets", n=384, v=8, default="pow2"
        )
        mismatch_path = f"{tmp}/mismatch.json"
        with open(table_path, encoding="utf-8") as f:
            doc = json.load(f)
        doc["torch_version"] = "0.0"
        with open(mismatch_path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        mismatch_refused = not tuning.install_table(mismatch_path)
        mismatch_choice = tuning.choose(
            "serve_buckets", n=384, v=8, default="pow2"
        )

        # -- serve under the good table ----------------------------------
        tuning.reset()
        if not tuning.install_table(table_path):
            raise AssertionError(f"the measured table {table_path} did "
                                 "not load")
        loaded_digest = tuning.active_table().digest
        lookups0 = tuning.lookup_stats()
        hin = synthetic_hin(384, 640, 12, seed=0)
        mp = compile_metapath("APVPA", hin.schema)
        svc = PathSimService(
            create_backend("torch", hin, mp, device=dev),
            config=ServeConfig(max_batch=8, k_default=5, max_wait_ms=0.5),
        )
        try:
            rng = np.random.default_rng(0)
            rows = rng.integers(0, 384, size=48)
            for r in rows[:16]:  # warmup: buckets driven, caches fill
                svc.topk_index(int(r), k=5)
            with CompileCounter() as cc:
                for r in rows[16:]:
                    svc.topk_index(int(r), k=5)
                steady_compiles = cc.count
            lookups = tuning.lookup_stats()
            stats = svc.stats()
        finally:
            svc.close()

        checks = {
            "table_written_and_loaded": table.digest == loaded_digest,
            "hit_path_exercised": lookups.get("hit", 0)
            > lookups0.get("hit", 0),
            "corrupt_table_degrades": corrupt_refused
            and fallback_choice == "pow2",
            "fingerprint_mismatch_degrades": mismatch_refused
            and mismatch_choice == "pow2",
            "zero_steady_state_compiles": steady_compiles == 0,
        }
        result.update(
            smoke_checks=checks,
            steady_state_compiles=steady_compiles,
            lookups=lookups,
            serving_obs=stats["obs"]["tuning"],
        )
        if out_path:
            with open(out_path, "w", encoding="utf-8") as f:
                json.dump(result, f, indent=2)
        if not all(checks.values()):
            raise AssertionError(f"tune smoke failed: {checks}")
        return result
    finally:
        tuning.reset()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m distributed_pathsim_tpu_torch.tuning.sweep",
        description=__doc__.splitlines()[0],
    )
    p.add_argument("--bench", action="store_true",
                   help="tuned K1 dispatch against the default stripe "
                   "width (card only)")
    p.add_argument("--smoke", action="store_true",
                   help="the five tuned-serving gates")
    p.add_argument("--table", default=None,
                   help="bench: use this table instead of measuring one")
    p.add_argument("--out", default=None, help="write JSON (or, for the "
                   "default sweep, the table) here")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--quick", action="store_true",
                   help="bench: smallest shape only; sweep: the quick set")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="'cuda' (default) fails without a card")
    args = p.parse_args(argv)

    from ..utils.device import DeviceUnavailable

    try:
        if args.smoke:
            result = run_tune_smoke(args.out, device=args.platform)
        elif args.bench:
            result = run_bench(args.table, reps=args.reps, quick=args.quick,
                               device=args.platform)
            ok = result["checks"][
                "tuned_no_slower_than_default_at_every_shape"]
            if args.out:
                with open(args.out, "w", encoding="utf-8") as f:
                    json.dump(result, f, indent=2)
            json.dump(result, sys.stdout, indent=2)
            print()
            return 0 if ok else 1
        else:
            from .autotuner import tune_main

            out = args.out or "tuning_table.json"
            extra = ["--out", out, "--reps", str(args.reps),
                     "--platform", args.platform]
            if args.quick:
                extra.append("--quick")
            return tune_main(extra)
    except (DeviceUnavailable, ValueError) as exc:
        from ..utils.logging import runtime_event

        runtime_event("tune_sweep_error", error=exc)
        return 1
    json.dump(result, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
