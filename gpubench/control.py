"""The readings that the limits of ``correct`` are set from: the port's
sound runs on many seeds, and the control's on a few, in one process.

    python3 gpubench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 101,102,103 [--seconds 2]

The port's readings are whole runs of the cell (:func:`harness.run_cell`)
with a short window. The control is the plain reference put in the
port's place and computed one precision below what the configurations
state (float32 with TF32 off): in TF32. Its operands are rounded to
TF32's 10-bit mantissa (round to nearest even) and multiplied and summed
in float32, as a TF32 tensor-core product does, on the same rows of the
same graph; :func:`check.compare` then reads it as it reads a call of the
port. Each reading is one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

from gpubench import check, graph, harness  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, ties to even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def tf32_topk(g: dict, rows: np.ndarray, k: int, device,
              block: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """The reference's top-k of ``rows`` in TF32: (values [R, k] float64,
    columns [R, k] int64), (−score, column) order."""
    n, v = g["authors"], g["venues"]
    ap_r = torch.as_tensor(g["ap_rows"], dtype=torch.int64, device=device)
    ap_c = torch.as_tensor(g["ap_cols"], dtype=torch.int64, device=device)
    venue_of = torch.zeros(g["papers"], dtype=torch.int64, device=device)
    venue_of[torch.as_tensor(g["pv_rows"], dtype=torch.int64,
                             device=device)] = torch.as_tensor(
        g["pv_cols"], dtype=torch.int64, device=device)
    c = torch.zeros(n * v, dtype=torch.float32, device=device)
    c.index_put_((ap_r * v + venue_of[ap_c],),
                 torch.ones(ap_r.numel(), device=device), accumulate=True)
    c = tf32(c.view(n, v))
    d = c @ tf32(c.sum(0))
    k = min(k, n - 1)
    rows_t = torch.as_tensor(rows, dtype=torch.int64, device=device)
    vals, idxs = [], []
    for b0 in range(0, rows.size, block):
        r = rows_t[b0:b0 + block]
        m = c[r] @ c.T
        den = d[r, None] + d[None, :]
        s = torch.where(den > 0, 2.0 * m / den.clamp_min(1e-30),
                        torch.zeros_like(m))
        s[torch.arange(r.numel(), device=device), r] = float("-inf")
        sv, si = torch.sort(s, dim=1, descending=True, stable=True)
        vals.append(sv[:, :k].double().cpu().numpy())
        idxs.append(si[:, :k].cpu().numpy())
    return np.concatenate(vals), np.concatenate(idxs)


def control_reading(cell_name: str, seed: int, device):
    """The control's checks and their parts on ``seed``'s graph."""
    bench = harness.Bench(ROOT)
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    k = int(bench.mix(cell["traffic"])["k"])
    g = graph.synthetic_coo(cfg["graph"], seed, device)
    rows = check.sample_rows(g["authors"], seed)
    out = tf32_topk(g, rows, k, device)
    reference = bench.reference(cfg["reference"]).from_graph(g)
    return check.compare([out], rows, reference, k, cfg["limits"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    for seed in seeds(args.seeds):
        r = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                             args.device)
        print(json.dumps({"workload": args.workload, "side": "program",
                          "seed": seed, "correct": r["correct"],
                          "calls": r["attempted"],
                          "checks": {a: b["value"]
                                     for a, b in r["checks"].items()}}),
              flush=True)
    for seed in seeds(args.control_seeds):
        checks, parts = control_reading(args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "side": "control_tf32",
                          "seed": seed, "correct": check.passed(checks),
                          "checks": {a: b["value"]
                                     for a, b in checks.items()},
                          "parts": parts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
