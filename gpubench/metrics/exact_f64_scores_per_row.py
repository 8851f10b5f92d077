"""``exact_f64_scores_per_row``: the elements that the exact K1 scored in
f64 (its division), per row and call: how well its f32 prefilter keeps
the division off. The kernel adds to a device counter once a block; the
port carries each call's count on the pass-2 span (``f64_scores``, set
without a synchronize once the span's closing event has completed), so
it is read from the window's spans here, after the window. None where no
span carries it."""

from gpubench import spans


def read(run: dict) -> float | None:
    got = spans.port_spans()
    if got is None or not run.get("n"):
        return None
    from distributed_pathsim_tpu_torch.obs import trace

    name = getattr(trace, "PASS2_SPAN", None)
    counts = []
    for sp in got.window:
        if sp.name == name and sp.device_s is not None:  # args settled
            if "f64_scores" in sp.args:
                counts.append(sp.args["f64_scores"])
    return sum(counts) / (len(counts) * run["n"]) if counts else None
