"""``dpathsim-torch learned`` — train / inspect serving tower checkpoints.

::

    dpathsim-torch learned train --dataset dblp/dblp_small.gexf \\
        --metapath APVPA --out towers.npz \\
        --pairs pairs.jsonl --steps 400

    dpathsim-torch learned inspect --towers towers.npz

``train`` distills the exact engine into a two-tower checkpoint
(exact-teacher hard mining + an optional ``--emit-pairs`` stream from
a batch campaign), keyed to the graph's base fingerprint, on the card
unless ``--platform cpu`` is given — ``dpathsim-torch serve --topk-mode
learned --learned-checkpoint towers.npz`` refuses an artifact trained
for a different graph. ``inspect`` prints a checkpoint's geometry and
keying without loading a dataset. Both print the JAX package's JSON;
checkpoints are the JAX package's format, in both directions.
"""

from __future__ import annotations

import argparse
import json


def build_learned_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dpathsim-torch learned",
        description="train / inspect learned serving towers",
    )
    sub = p.add_subparsers(dest="action", required=True)

    t = sub.add_parser("train", help="graph -> tower checkpoint")
    t.add_argument("--dataset", required=True,
                   help="GEXF path or synthetic:authors=..,papers=..,"
                   "venues=..,seed=..")
    t.add_argument("--metapath", default="APVPA")
    t.add_argument("--variant", default="rowsum",
                   choices=("rowsum", "diagonal"))
    t.add_argument("--out", required=True, help="checkpoint .npz path")
    t.add_argument("--pairs", default=None,
                   help="--emit-pairs JSONL from a batch campaign "
                   "(extra exact-teacher slates + held-out validation)")
    t.add_argument("--steps", type=int, default=400)
    t.add_argument("--dim", type=int, default=None,
                   help="tower output width (default: tuned learned_dim)")
    t.add_argument("--hidden", type=int, default=64)
    t.add_argument("--neg-ratio", type=float, default=None,
                   help="uniform-negative fraction of training slates "
                   "(default: tuned learned_neg_ratio)")
    t.add_argument("--hard-sources", type=int, default=512)
    t.add_argument("--hard-k", type=int, default=32)
    t.add_argument("--val-frac", type=float, default=0.1)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--headroom", type=float, default=0.25,
                   help="capacity reserve MATCHING the serving "
                   "process's --headroom: the checkpoint is keyed to "
                   "the padded graph's fingerprint")
    t.add_argument("--tuning-table", default=None)
    t.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="device of the training and the mining: 'cuda' "
                   "(default) fails when no card is present; 'cpu' runs "
                   "on the host")

    q = sub.add_parser("inspect", help="print a checkpoint's identity")
    q.add_argument("--towers", required=True, help="checkpoint .npz path")
    return p


def _train(args) -> int:
    from .. import tuning
    from ..index.cli import _device, _parse_dataset
    from ..ops.metapath import compile_metapath
    from .trainer import train_towers

    device = _device(args)
    if args.tuning_table:
        tuning.install_table(args.tuning_table)
    hin = _parse_dataset(args.dataset)
    if args.headroom:
        from ..data.delta import with_headroom

        hin = with_headroom(hin, args.headroom)
    mp = compile_metapath(args.metapath, hin.schema)
    n = hin.type_size(mp.source_type)
    dim = args.dim or int(tuning.choose("learned_dim", n=n, default=32))
    neg_ratio = (
        args.neg_ratio
        if args.neg_ratio is not None
        else float(tuning.choose("learned_neg_ratio", n=n, default=0.5))
    )
    _, info = train_towers(
        hin, args.metapath, variant=args.variant,
        dim=dim, hidden=args.hidden, steps=args.steps,
        seed=args.seed, hard_frac=1.0 - neg_ratio,
        hard_sources=args.hard_sources, hard_k=args.hard_k,
        pairs=args.pairs, val_frac=args.val_frac, out=args.out,
        device=device,
    )
    print(json.dumps(info, indent=2))
    return 0


def _inspect(args) -> int:
    from .checkpoint import load_towers

    encoder, token = load_towers(args.towers)
    print(json.dumps({
        "towers": args.towers,
        "dim": encoder.dim,
        "hidden": encoder.hidden,
        "v": encoder.v,
        "variant": encoder.variant,
        "metapath": encoder.metapath,
        "base_fp": token[0],
        "delta_seq": token[1],
        "meta": encoder.meta,
    }, indent=2))
    return 0


def learned_main(argv: list[str] | None = None) -> int:
    args = build_learned_parser().parse_args(argv)
    if args.action == "train":
        return _train(args)
    if args.action == "inspect":
        return _inspect(args)
    raise ValueError(f"unknown learned action {args.action!r}")
