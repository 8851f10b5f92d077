"""``dpathsim-torch batch`` — corpus-scale campaigns with checkpointed
resume, the port of the JAX package's ``dpathsim batch``.

::

    dpathsim-torch batch topk-all --dataset dblp/dblp_small.gexf \
        --metapath APVPA --k 10 --checkpoint-dir ck \
        --out topk.npz --emit-pairs pairs.jsonl
    dpathsim-torch batch simjoin --dataset dblp/dblp_small.gexf \
        --tau 0.4 --checkpoint-dir ck2 --out pairs.jsonl
    dpathsim-torch batch resume --dataset dblp/dblp_small.gexf \
        --checkpoint-dir ck --out topk.npz

``topk-all`` computes top-k for EVERY source row; ``simjoin`` emits
every pair scoring ≥ τ. Both checkpoint per row block: SIGTERM →
flush-and-exit-75 (EX_TEMPFAIL, "re-run me"), and ``resume`` — or
simply re-running the original command — skips completed blocks and
produces byte-identical outputs. ``resume`` needs no campaign flags:
it reads the checkpoint manifest's stored identity config and refuses
a directory whose graph/parameters don't match (DESIGN.md §31).

``--workers N`` fans blocks across N subprocess replicas (``dpathsim-torch
worker``, on the same ``--platform``) through the batch block scheduler
(router/batch.py) — same bytes, more processes. ``--platform cuda`` (the
default) runs every block's GEMM on the card and fails without one;
``--platform cpu`` takes the host arm (the JAX package's ``--no-jax``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _parse_dataset(spec: str):
    if spec.startswith("synthetic:"):
        from ..data.synthetic import synthetic_hin
        from ..router.cli import _parse_synthetic

        return synthetic_hin(**_parse_synthetic(spec))
    from ..engine import load_dataset

    return load_dataset(spec)


def build_batch_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dpathsim-torch batch",
        description="corpus-scale top-k / similarity-join campaigns",
    )
    sub = p.add_subparsers(dest="action", required=True)

    def common(sp, mode: str):
        sp.add_argument("--dataset", required=True,
                        help="GEXF path or synthetic:authors=..,"
                        "papers=..,venues=..,seed=..")
        sp.add_argument("--metapath", default="APVPA")
        sp.add_argument("--variant", default="rowsum",
                        choices=("rowsum", "diagonal")
                        if mode == "topk" else ("rowsum",))
        sp.add_argument("--block-rows", type=int, default=None,
                        help="rows per sweep block (default: tuned, "
                        "snapped to the pow-2 ladder)")
        sp.add_argument("--factor-format", default=None,
                        choices=("coo", "blocked", "bitpacked"),
                        help="packed factor format (default: tuned)")
        sp.add_argument("--checkpoint-dir", default=None,
                        help="per-block resume directory; omitting it "
                        "disables resume")
        sp.add_argument("--emit-pairs", default=None,
                        help="write (row, col, score) JSONL training "
                        "pairs here")
        platform_flag(sp)
        sp.add_argument("--workers", type=int, default=0,
                        help="fan blocks across N subprocess replicas "
                        "(0 = single-host)")

    t = sub.add_parser("topk-all", help="top-k for every source row")
    common(t, "topk")
    t.add_argument("--k", type=int, default=10)
    t.add_argument("--out", default=None,
                   help="write vals/idxs arrays to this .npz")

    s = sub.add_parser("simjoin", help="all pairs with PathSim >= tau")
    common(s, "simjoin")
    s.add_argument("--tau", type=float, required=True)
    s.add_argument("--grouping", default="degree",
                   choices=("natural", "degree", "centroid"),
                   help="row-block grouping for the prune bounds "
                   "(fleet runs require 'natural')")
    s.add_argument("--out", default=None,
                   help="write qualifying pairs to this JSONL")

    r = sub.add_parser("resume", help="continue a preempted campaign")
    r.add_argument("--dataset", required=True)
    r.add_argument("--checkpoint-dir", required=True)
    r.add_argument("--emit-pairs", default=None)
    platform_flag(r)
    r.add_argument("--out", default=None)
    return p


def platform_flag(sp) -> None:
    sp.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="'cuda' (default): every block's GEMM on the "
                    "card, failing without one; 'cpu': the host arm")


def _engine(args, *, metapath=None, variant=None,
            block_rows=None, factor_format=None):
    from ..ops.metapath import compile_metapath
    from ..utils.device import resolve_device
    from .campaign import BatchEngine

    device = resolve_device(args.platform)  # before any load
    hin = _parse_dataset(args.dataset)
    mp = compile_metapath(metapath or args.metapath, hin.schema)
    return BatchEngine(
        hin, mp,
        variant=variant or args.variant,
        factor_format=factor_format
        or getattr(args, "factor_format", None),
        block_rows=block_rows or getattr(args, "block_rows", None),
        device=device,
    )


def _scheduler(args, engine):
    """``--workers N`` → a started BlockScheduler over N subprocess
    replicas serving the same dataset/metapath/variant."""
    if not getattr(args, "workers", 0):
        return None
    from ..router.batch import BlockScheduler
    from ..router.transport import SubprocessTransport

    argv_tail = [
        "--dataset", args.dataset,
        "--metapath", engine.metapath.name,
        "--variant", engine.variant,
        # batch campaigns are read-only: boot replicas WITHOUT update
        # headroom so their graph fingerprint matches the local
        # engine's raw parse (the serve parser defaults to 0.25,
        # which pads capacity and changes the token)
        "--headroom", "0",
        "--platform", args.platform,
    ]
    transports = {
        f"w{i}": SubprocessTransport(
            f"w{i}",
            [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli",
             "worker", "--worker-id", f"w{i}"] + argv_tail,
        )
        for i in range(int(args.workers))
    }
    sched = BlockScheduler(transports)
    sched.start()
    return sched


def _finish_topk(args, result) -> None:
    if args.out:
        np.savez(args.out, vals=result.vals, idxs=result.idxs)
    summary = {
        "mode": "topk",
        "n": int(result.vals.shape[0]),
        "k": int(result.vals.shape[1]),
        "blocks": result.blocks_total,
        "resumed": result.blocks_resumed,
        "rows_per_s": round(result.rows_per_s, 1),
        "bytes_read_per_row": round(result.bytes_read_per_row, 1),
        "backend": result.backend_mode,
    }
    print(json.dumps(summary))


def _finish_simjoin(args, result) -> None:
    out = getattr(args, "out", None)
    if out:
        with open(out, "w", encoding="utf-8") as f:
            for r, c, s in zip(result.rows, result.cols, result.scores):
                f.write(json.dumps(
                    {"row": int(r), "col": int(c), "score": float(s)}
                ) + "\n")
    summary = {
        "mode": "simjoin",
        "pairs": int(result.rows.shape[0]),
        "blocks": result.blocks_total,
        "resumed": result.blocks_resumed,
        "prune_ratio": round(result.prune_ratio, 4),
        "backend": result.backend_mode,
    }
    print(json.dumps(summary))


def batch_main(argv: list[str] | None = None) -> int:
    from ..resilience import (
        PREEMPTED_EXIT_CODE, Preempted, preemption_handler,
    )
    from .campaign import run_topk_campaign
    from .simjoin import run_simjoin_campaign

    args = build_batch_parser().parse_args(argv)
    installed = preemption_handler.install()
    sched = None
    try:
        if args.action == "resume":
            import pathlib

            mpath = pathlib.Path(args.checkpoint_dir) / "manifest.json"
            if not mpath.exists():
                raise FileNotFoundError(
                    f"no campaign manifest in {args.checkpoint_dir}"
                )
            cfg = json.loads(mpath.read_text()).get("__config__") or {}
            if not cfg:
                raise ValueError(
                    f"{args.checkpoint_dir} holds no campaign identity "
                    "config; was this directory written by "
                    "`dpathsim-torch batch`?"
                )
            engine = _engine(
                args,
                metapath=cfg["metapath"], variant=cfg["variant"],
                block_rows=cfg["block_rows"],
                factor_format=cfg["factor_format"],
            )
            # the manifest config check inside the campaign refuses a
            # changed graph (base_fp/delta_seq mismatch) loudly
            if cfg.get("mode") == "simjoin":
                result = run_simjoin_campaign(
                    engine, cfg["tau"],
                    checkpoint_dir=args.checkpoint_dir,
                    grouping=cfg.get("grouping", "degree"),
                    emit_pairs=args.emit_pairs,
                )
                _finish_simjoin(args, result)
            else:
                result = run_topk_campaign(
                    engine, cfg["k"],
                    checkpoint_dir=args.checkpoint_dir,
                    emit_pairs=args.emit_pairs,
                )
                _finish_topk(args, result)
            return 0
        engine = _engine(args)
        sched = _scheduler(args, engine)
        if args.action == "topk-all":
            result = run_topk_campaign(
                engine, args.k,
                checkpoint_dir=args.checkpoint_dir,
                emit_pairs=args.emit_pairs,
                scheduler=sched,
            )
            _finish_topk(args, result)
        else:
            result = run_simjoin_campaign(
                engine, args.tau,
                checkpoint_dir=args.checkpoint_dir,
                grouping=args.grouping
                if not sched else "natural",
                emit_pairs=args.emit_pairs,
                scheduler=sched,
            )
            _finish_simjoin(args, result)
        return 0
    except Preempted as exc:
        print(f"preempted: {exc}", file=sys.stderr)
        return PREEMPTED_EXIT_CODE
    finally:
        if sched is not None:
            sched.close()
        if installed:
            preemption_handler.uninstall()
            preemption_handler.reset()
