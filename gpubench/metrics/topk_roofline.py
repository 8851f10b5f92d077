"""``topk_roofline``: the least time of one whole rank-all on the card,
over the device time of all kernels in one call (the kernels' summed time
in the traced window, divided by the calls in it).

The least time is counted one way whatever kernel runs (K1 + pass 2, K3 +
pass 2 in row tiles, K4): the larger of

- operations: N²·V, the symmetric half of C·Cᵀ (2·N·N·V / 2) as a dense
  int8 product, at the card's int8 tensor-core peak;
- bytes: C read once as float32 (N·V·4), d (N·4), and the [N, k] values
  and columns written once (N·k·(4 + 4)), at the card's memory bandwidth.

The count is dense: a kernel that skipped C's zero blocks could read past
100%, and the work would then have to be counted from the data.
"""


def least_time_s(n: int, v: int, k: int, peaks: dict) -> float:
    ops = float(n) * n * v
    nbytes = 4.0 * n * v + 4.0 * n + 8.0 * n * k
    return max(ops / peaks["int8_ops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def read(run: dict) -> float | None:
    tr, peaks = run.get("trace"), run.get("peaks")
    if not tr or not peaks or tr["kernel_s"] <= 0 or run["calls"] <= 0:
        return None
    per_call = tr["kernel_s"] / run["calls"]
    return 100.0 * least_time_s(run["n"], run["v"], run["k"], peaks) / per_call
