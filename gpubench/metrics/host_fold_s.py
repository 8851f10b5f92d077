"""``host_fold_s``: host seconds of set-up's ``backend.fold`` spans, the
host fold of the symmetric half chain into the COO factor
(``planner.fold_half``, from the backend's construction), read from the
port's tracer (:mod:`gpubench.spans`). Like ``factor_prep_s`` it reads a
set-up traced against the card only: None where set-up's factor spans
carry no device time (a CPU run, or a program without them)."""

from gpubench import spans


def read(run: dict) -> float | None:
    got = spans.port_spans()
    if got is None or spans.setup_sum(got, got.factor, "device_s") is None:
        return None
    return spans.setup_sum(got, got.fold, "host_s")
