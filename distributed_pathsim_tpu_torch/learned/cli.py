"""``dpathsim-torch learned`` — inspect serving tower checkpoints.

::

    dpathsim-torch learned inspect --towers towers.npz

``inspect`` prints a checkpoint's geometry and keying (the JAX package's
JSON) without loading a dataset. ``dpathsim-torch serve --topk-mode
learned --learned-checkpoint towers.npz`` serves it, and refuses an
artifact trained for a different graph. ``train`` exits 1: training is
not ported yet, so a checkpoint comes from the JAX package's
``dpathsim learned train``.
"""

from __future__ import annotations

import argparse
import json


def build_learned_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dpathsim-torch learned",
        description="inspect learned serving towers (training is not "
        "ported yet)",
    )
    sub = p.add_subparsers(dest="action", required=True)
    sub.add_parser("train", help="not ported yet")
    q = sub.add_parser("inspect", help="print a checkpoint's identity")
    q.add_argument("--towers", required=True, help="checkpoint .npz path")
    return p


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
    parser = build_learned_parser()
    args, rest = parser.parse_known_args(argv)
    if args.action == "train":
        # the JAX package's train command line, whatever it says
        from . import train_towers

        train_towers()
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    return _inspect(args)
