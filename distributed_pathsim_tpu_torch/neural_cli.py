"""Command-line surface for the NeuralPathSim index family.

Separate from the batch CLI (``cli.py``) on purpose: that surface mirrors
the reference's single-source/ranking workflows and its flag matrix; this
one owns the model lifecycle of the beyond-parity index — train/save,
then query the analytic (Cauchy-quadrature) or learned index, or the
two-stage exact rerank::

    python -m distributed_pathsim_tpu_torch.neural_cli train \\
      --dataset dblp_small.gexf --out model.npz --steps 600

    python -m distributed_pathsim_tpu_torch.neural_cli query \\
      --model model.npz --dataset dblp_small.gexf \\
      --source "Didier Dubois" --top-k 5 --index struct

The tower trains, mines and embeds on the card unless ``--platform cpu``
is given (without a card the default exits 1). Checkpoints are the JAX
package's ``neural_cli`` format, in both directions; the output text is
its text.
"""

from __future__ import annotations

import argparse
import sys

from .ops.pathsim import VARIANTS


def _load_hin(args):
    from .engine import USE_NATIVE_BY_LOADER, load_dataset

    return load_dataset(
        args.dataset, use_native=USE_NATIVE_BY_LOADER[args.loader]
    )


def _device(platform: str) -> str:
    """The device the command runs on, resolved before any load: 'cuda'
    without a card raises DeviceUnavailable; on the card TF32 is turned
    off (mining and the tower run in true f32)."""
    from .utils.device import resolve_device

    device = resolve_device(platform).type
    if device == "cuda":
        from .ops import cuda_kernels

        cuda_kernels.true_f32()
    return device


def cmd_train(args) -> int:
    device = _device(args.platform)
    from .models.neural import NeuralPathSim

    hin = _load_hin(args)
    model = NeuralPathSim(
        hin, args.metapath, dim=args.dim, hidden=args.hidden,
        lr=args.lr, seed=args.seed, variant=args.variant, device=device,
    )
    if args.mine:
        pool_src, pool_cand = model.mine_hard_candidates(
            args.mine, k=args.mine_k, seed=args.seed
        )
        model.set_hard_pool(pool_src, pool_cand)
    losses = model.train(steps=args.steps, batch_size=args.batch,
                         seed=args.seed)
    model.save(args.out)
    trajectory = (
        f" (loss {losses[0]:.3f} -> {losses[-1]:.3f})" if losses else ""
    )
    print(
        f"Trained {args.steps} steps on {model.n} "
        f"{model.metapath.source_type} nodes{trajectory}; "
        f"saved to {args.out}"
    )
    return 0


def cmd_query(args) -> int:
    device = _device(args.platform)
    from .models.neural import NeuralPathSim

    hin = _load_hin(args) if args.dataset else None
    model = NeuralPathSim.load(args.model, hin=hin, device=device)
    node_type = (
        model.metapath.source_type if model.metapath.node_types else None
    )
    if hin is not None and node_type:
        if hin.type_size(node_type) != model.n:
            raise ValueError(
                f"--dataset has {hin.type_size(node_type)} {node_type} "
                f"nodes but the checkpoint was trained on {model.n} — "
                "labels would be wrong; pass the training dataset"
            )
        index = hin.indices[node_type]
        src = hin.resolve_source(
            node_type, label=args.source, node_id=args.source_id
        )

        def show(t):
            return f"{index.labels[t]} ({index.ids[t]})"
    else:
        if args.source is not None:
            raise SystemExit(
                "--source needs --dataset for the label lookup; "
                "use --source-id with a bare integer index instead"
            )
        src = int(args.source_id)
        # bare indexes bypass the resolver's existence check: reject
        # out-of-range and negative values (numpy would wrap)
        if not 0 <= src < model.n:
            raise ValueError(
                f"--source-id {src} is out of range for this checkpoint "
                f"(valid bare indexes: 0..{model.n - 1})"
            )

        def show(t):
            return f"index {t}"

    if args.index == "struct":
        ranked = model.topk_struct(src, k=args.top_k)
    elif args.index == "learned":
        ranked = model.topk(src, k=args.top_k)
    else:  # rerank: embedding prefilter + exact re-scoring
        ranked = model.topk_rerank(
            src, k=args.top_k, candidates=args.candidates,
            index=args.prefilter,
        )
    print(f"Top-{args.top_k} by the {args.index} index "
          f"({model.variant} variant):")
    for t, score in ranked:
        print(f"  {score:.6f}  {show(t)}")
    return 0


def _platform_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="'cuda' (default) runs the tower on the card and "
                   "fails without one; 'cpu' runs on the host")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="distributed_pathsim_tpu_torch.neural_cli")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train + save a neural index")
    t.add_argument("--dataset", required=True)
    t.add_argument("--out", required=True, help="checkpoint path (.npz)")
    t.add_argument("--metapath", default="APVPA")
    t.add_argument("--variant", default="rowsum", choices=list(VARIANTS))
    t.add_argument("--steps", type=int, default=600)
    t.add_argument("--batch", type=int, default=1024)
    t.add_argument("--dim", type=int, default=64)
    t.add_argument("--hidden", type=int, default=128)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--mine", type=int, default=0, metavar="T",
                   help="mine exact-teacher hard candidates for T "
                   "sources and train half of each batch on them "
                   "(0 = off; lifts top-k resolution on skewed graphs)")
    t.add_argument("--mine-k", type=int, default=64,
                   help="mined candidates per source (--mine)")
    t.add_argument("--loader", default="auto",
                   choices=("auto", "python", "native"))
    _platform_arg(t)
    t.set_defaults(fn=cmd_train)

    q = sub.add_parser("query", help="query a saved index")
    q.add_argument("--model", required=True)
    q.add_argument("--dataset", default=None,
                   help="re-attach labels (required for --source)")
    src = q.add_mutually_exclusive_group(required=True)
    src.add_argument("--source", help="query node by label")
    src.add_argument("--source-id",
                     help="query node by id (or bare index w/o --dataset)")
    q.add_argument("--top-k", type=int, default=10)
    q.add_argument("--index", default="rerank",
                   choices=("struct", "learned", "rerank"))
    q.add_argument("--candidates", type=int, default=100,
                   help="prefilter width for --index rerank")
    q.add_argument("--prefilter", default="struct",
                   choices=("struct", "learned"),
                   help="which embedding index prefilters for --index "
                   "rerank (learned = O(d) scan from the trained tower)")
    q.add_argument("--loader", default="auto",
                   choices=("auto", "python", "native"))
    _platform_arg(q)
    q.set_defaults(fn=cmd_query)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except (KeyError, ValueError, RuntimeError, OSError) as e:
        msg = e.args[0] if isinstance(e, KeyError) and e.args else e
        print(f"error: {msg}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
