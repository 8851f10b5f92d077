"""``factor_prep_s``: the card's seconds of set-up's ``backend.factor``
and ``backend.limbs`` spans (their ``device_s``, CUDA events on the
card's stream at each span's two ends): the COO's upload, C
scatter-built or densified, the row sums, K3's ready copy and the u8
limb split, the warm call included (the limb split and the sparse arm's
densify first run there). Read from the port's tracer
(:mod:`gpubench.spans`); None where no such span has device time."""

from gpubench import spans


def read(run: dict) -> float | None:
    got = spans.port_spans()
    return None if got is None else spans.setup_sum(got, got.factor,
                                                    "device_s")
