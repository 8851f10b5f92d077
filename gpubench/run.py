"""Run one cell of ``BENCHMARK.json`` once, on the card.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the set-up's parts and the window's
counts on standard error, then each number compared beside its limit as
the last lines there, and one JSON object as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; ``checks`` last.

Exits non-zero with no result when torch sees no card or fewer cards
than the cell asks for, when the port cannot be imported, and when JAX
or the JAX package is loaded in this process once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _env() -> None:
    """Caches at fixed paths inside the checkout; no tuning table.

    The port builds its kernels into its own ``_build/`` in the checkout.
    Python's bytecode goes under ``.cache/pycache``, also where the
    environment forbids writing it: a Python without it compiles
    torch's sources again in every process, which is most of set-up and
    most of its spread. So only a checkout's first run compiles them.
    ``TRITON_CACHE_DIR`` is there for Triton kernels (the port has none).
    """
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.pop("PATHSIM_TUNING_TABLE", None)
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False
    sys.path[0] = str(ROOT)  # the port and this package, from the checkout


def _finite(x):
    """The record with each non-finite number as a string (strict JSON)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _env()
    import torch

    from gpubench import harness

    harness.log(f"setup: python start to torch imported "
                f"{time.perf_counter() - T_PROCESS:.4f} s")

    if not torch.cuda.is_available():
        harness.log("no CUDA device: the benchmark measures the card only")
        return 2
    chips = int(harness.Bench(ROOT).cell(args.workload)["chips"])
    if torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} cards, torch sees "
                    f"{torch.cuda.device_count()}")
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_PROCESS)
    banned = harness.banned_modules()
    if banned:
        harness.log(f"JAX or the JAX package is loaded: {banned}")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
