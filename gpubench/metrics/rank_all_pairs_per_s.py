"""``rank_all_pairs_per_s``: N·(N−1) author pairs for each whole rank-all
completed in the window, over the window's seconds (from its start to the
end of the last call, each call ending with its arrays on the host)."""


def read(run: dict) -> float | None:
    pairs = run.get("pairs_per_call")
    if pairs is None or run["window_s"] <= 0:
        return None
    return pairs * run["calls"] / run["window_s"]
