"""``backend_init_s``: host seconds of ``create_backend`` (the host fold
of the half chain, the factor's tiling) and the first factor build on the
device (C scatter-built, its row sums), ending in
``torch.cuda.synchronize()``. The ``backend.init`` span of the port's
tracer is printed beside it."""


def read(run: dict) -> float | None:
    return run.get("backend_init_s")
