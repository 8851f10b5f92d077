"""Engine bootstrap: dataset → encoded HIN → compiled metapath → backend.

The analog of the reference's Spark bootstrap block
(``DPathSim_APVPA.py:146-168``); the ``backend`` choice picks the
execution strategy and ``platform`` the device of the torch backend.
"""

from __future__ import annotations

import numpy as np

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
    config: RunConfig, timer: StageTimer | None = None,
    hin: EncodedHIN | None = None,
) -> tuple[EncodedHIN, MetaPath, PathSimBackend]:
    """``timer``: optional StageTimer; the bootstrap phases (GEXF load +
    encode, metapath compile, backend init — which includes the host
    half-chain fold and the factor's transfer) are recorded on it.
    ``hin``: an already encoded graph (with whatever headroom it was
    given) that takes the place of ``config.dataset``."""
    if timer is None:
        timer = StageTimer()
    # count kernel builds from the very first: a serving process's
    # health op reports them (utils/compile_counter.py)
    from .utils.compile_counter import install_compile_metrics

    install_compile_metrics()
    with timer.stage("load_encode"):
        if hin is None:
            hin = _load_with_headroom(config)
    with timer.stage("metapath_compile"):
        metapath = compile_metapath(config.metapath, hin.schema)
    with timer.stage("backend_init"):
        backend = create_backend(
            config.backend, hin, metapath, **backend_options(config)
        )
    return hin, metapath, backend


def _load_with_headroom(config: RunConfig) -> EncodedHIN:
    hin = load_dataset(config.dataset, loader=config.loader)
    if config.headroom:
        # Reserve append capacity BEFORE any backend sees a shape: the
        # delta-ingestion contract (data/delta.py) — results are
        # bit-identical, shapes survive node growth.
        from .data.delta import with_headroom

        hin = with_headroom(hin, config.headroom)
    return hin


def backend_options(config: RunConfig) -> dict:
    """Backend constructor kwargs from a RunConfig — shared by the
    bootstrap above and the serving layer's delta-fallback rebuild,
    which must replay the SAME knobs. The device backends (torch,
    torch-sparse) take the device named by ``platform`` and ``approx``
    as ``exact_counts=False``; torch-sparse takes ``tile_rows``. The
    numpy oracle runs on the host whatever the platform. ``dtype``
    names a numpy dtype for numpy and a torch dtype otherwise."""
    if config.backend not in ("torch", "torch-sparse"):
        if config.dtype:
            return {"dtype": np.dtype(config.dtype)}
        return {}
    options = {"device": config.platform}
    if config.dtype:
        options["dtype"] = _torch_dtype(config.dtype)
    if config.approx:
        options["exact_counts"] = False
    if config.backend == "torch-sparse" and config.tile_rows is not None:
        options["tile_rows"] = config.tile_rows
    return options


def _torch_dtype(name: str):
    import torch

    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype
