"""Engine bootstrap: dataset → encoded HIN → compiled metapath → backend.

The analog of the reference's Spark bootstrap block
(``DPathSim_APVPA.py:146-168``); the ``backend`` choice picks the
execution strategy and ``platform`` the device of the torch backend.
"""

from __future__ import annotations

from .backends.base import PathSimBackend, create_backend
from .config import RunConfig
from .data.encode import EncodedHIN, encode_hin
from .data.gexf import read_gexf
from .driver import PathSimDriver
from .ops.metapath import MetaPath, compile_metapath
from .utils.profiling import StageTimer

LOADERS = ("python", "native")


def load_dataset(path: str, loader: str = "python") -> EncodedHIN:
    """GEXF → EncodedHIN through the Python parse + encode pipeline.
    The JAX package's C++ loader (``native``) is not ported yet."""
    if loader == "native":
        raise ValueError("native GEXF loader not ported yet; use --loader python")
    if loader != "python":
        raise ValueError(f"unknown loader {loader!r}; choose from {LOADERS}")
    return encode_hin(read_gexf(path))


def build(
    config: RunConfig, timer: StageTimer | None = None
) -> tuple[EncodedHIN, MetaPath, PathSimBackend, PathSimDriver]:
    """Full batch bootstrap: :func:`build_backend` plus the driver."""
    hin, metapath, backend = build_backend(config, timer=timer)
    driver = PathSimDriver(backend, variant=config.variant)
    return hin, metapath, backend, driver


def build_backend(
    config: RunConfig, timer: StageTimer | None = None
) -> tuple[EncodedHIN, MetaPath, PathSimBackend]:
    """``timer``: optional StageTimer; the bootstrap phases (GEXF load +
    encode, metapath compile, backend init — which includes the host
    half-chain fold and the factor's transfer) are recorded on it."""
    if timer is None:
        timer = StageTimer()
    with timer.stage("load_encode"):
        hin = load_dataset(config.dataset, loader=config.loader)
    with timer.stage("metapath_compile"):
        metapath = compile_metapath(config.metapath, hin.schema)
    with timer.stage("backend_init"):
        backend = create_backend(
            config.backend, hin, metapath, **backend_options(config)
        )
    return hin, metapath, backend


def backend_options(config: RunConfig) -> dict:
    """Backend constructor kwargs from a RunConfig: the device backends
    (torch, torch-sparse) take the device named by ``platform`` and
    ``approx`` as ``exact_counts=False``; torch-sparse takes
    ``tile_rows``. The numpy oracle runs on the host whatever the
    platform."""
    if config.backend not in ("torch", "torch-sparse"):
        return {}
    options = {"device": config.platform}
    if config.approx:
        options["exact_counts"] = False
    if config.backend == "torch-sparse" and config.tile_rows is not None:
        options["tile_rows"] = config.tile_rows
    return options
