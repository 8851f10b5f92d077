"""``device_idle_pct``: the share of the traced window in which no
operation (kernel, copy or set) ran on the card, from the union of their
intervals in the ``torch.profiler`` timeline."""


def read(run: dict) -> float | None:
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
