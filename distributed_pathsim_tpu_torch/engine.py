"""Engine bootstrap: dataset → encoded HIN → compiled metapath → backend.

The analog of the reference's Spark bootstrap block
(``DPathSim_APVPA.py:146-168``); the ``backend`` choice picks the
execution strategy and ``platform`` the device of the torch backends.
Every bootstrap phase is a resilience seam (``gexf_load``,
``metapath_compile``, ``backend_init``), and the tuning table is
installed before any backend makes a tile or bucket decision.
"""

from __future__ import annotations

import numpy as np

from . import resilience
from .backends.base import PathSimBackend
from .config import RunConfig
from .data.encode import EncodedHIN, encode_hin
from .data.gexf import read_gexf
from .driver import PathSimDriver
from .ops.metapath import MetaPath, compile_metapath
from .resilience.policy import RetryPolicy
from .utils.logging import runtime_event
from .utils.profiling import StageTimer

# --loader choice → read path: None prefers native with clean fallback,
# False forces the exact Python pipeline, True requires native. One map,
# shared by every caller that accepts the CLI-facing string.
USE_NATIVE_BY_LOADER = {"auto": None, "python": False, "native": True}
LOADERS = tuple(USE_NATIVE_BY_LOADER)


class _NativeUnavailable(Exception):
    """Native loader absent (no toolchain / import failure) — a
    deterministic condition, not a transient fault: never retried, falls
    straight to the Python pipeline."""


def _load_native(path: str) -> EncodedHIN:
    from .native import gexf_native

    if not gexf_native.available():
        raise _NativeUnavailable()
    # Parse + encode in one native pass: no per-edge Python objects (the
    # marshalling, not the XML, dominates on large files).
    return gexf_native.read_gexf_encoded(path)


def load_dataset(
    path: str,
    use_native: bool | None = None,
    policy: RetryPolicy | None = None,
) -> EncodedHIN:
    """GEXF → EncodedHIN. ``use_native`` mirrors read_gexf's tri-state:
    None prefers the C++ single-pass parse+encode with clean fallback,
    False forces the exact Python pipeline (the escape hatch if the
    native path ever misbehaves), True requires native (a clean
    ValueError when it is not available).

    This is the ``gexf_load`` failure seam: each read path is retried
    under ``policy``; with ``use_native=None`` a native loader that
    keeps failing transiently degrades to the exact Python pipeline
    (with a structured ``degrade`` event) instead of killing the run."""
    # A missing file is deterministic, not transient: without this
    # filter the OSError-retryable default would back off against a
    # typo'd path and emit a misleading loader-degrade event before the
    # CLI's clean one-line error.
    policy = policy or resilience.policy_from_env()
    policy = policy.replace(
        non_retryable=policy.non_retryable + (FileNotFoundError,)
    )
    if use_native is not False:
        try:
            return resilience.resilient_call(
                "gexf_load", lambda: _load_native(path), policy
            )
        except FileNotFoundError:
            raise
        except (_NativeUnavailable, ImportError):
            if use_native is True:
                # ValueError: the CLI renders it as a clean one-liner.
                raise ValueError(
                    "native GEXF loader requested but unavailable "
                    "(no C++ toolchain?)"
                ) from None
            # Loader simply not built — no toolchain here; quiet.
        except (OSError, resilience.TransientError) as exc:
            if use_native is True:
                raise ValueError(f"native GEXF loader failed: {exc}") from exc
            resilience.degrade.record_degrade("loader")
            runtime_event(
                "degrade",
                component="loader",
                from_="native",
                to="python",
                error=repr(exc),
            )
    return resilience.resilient_call(
        "gexf_load",
        lambda: encode_hin(
            read_gexf(path, use_native=False if use_native is False else None)
        ),
        policy,
    )


def build(
    config: RunConfig, timer: StageTimer | None = None
) -> tuple[EncodedHIN, MetaPath, PathSimBackend, PathSimDriver]:
    """Full batch bootstrap: :func:`build_backend` plus the driver."""
    hin, metapath, backend = build_backend(config, timer=timer)
    driver = PathSimDriver(backend, variant=config.variant)
    return hin, metapath, backend, driver


def install_tuning(config: RunConfig) -> None:
    """Tuning dispatch for this process, BEFORE any tile or bucket
    decision is made (backend init consults it): keyed on the run's
    platform, then the explicit ``tuning_table``, else the
    PATHSIM_TUNING_TABLE deploy default, else heuristics. An unusable
    table degrades to heuristics with one ``tuning_fallback`` event — it
    never fails the bootstrap."""
    from . import tuning

    tuning.set_device(config.platform)
    tuning.set_enabled(config.tuning)
    if config.tuning:
        if config.tuning_table:
            tuning.install_table(config.tuning_table)
        else:
            tuning.install_from_env()


def build_backend(
    config: RunConfig, timer: StageTimer | None = None,
    hin: EncodedHIN | None = None,
) -> tuple[EncodedHIN, MetaPath, PathSimBackend]:
    """``timer``: optional StageTimer; the bootstrap phases (GEXF load +
    encode, metapath compile, backend init — which includes the host
    half-chain fold and the factor's transfer) are recorded on it.
    ``hin``: an already encoded graph (with whatever headroom it was
    given) that takes the place of ``config.dataset``.

    Transient failures are retried per ``config.max_retries``; a backend
    whose init keeps failing steps down the platform's degradation chain
    (resilience/degrade.py) unless ``config.degrade`` is False."""
    if timer is None:
        timer = StageTimer()
    # count kernel builds from the very first: a serving process's
    # health op reports them (utils/compile_counter.py)
    from .utils.compile_counter import install_compile_metrics

    install_compile_metrics()
    install_tuning(config)
    if config.loader not in USE_NATIVE_BY_LOADER:
        raise ValueError(
            f"unknown loader {config.loader!r}; "
            f"choose from {sorted(USE_NATIVE_BY_LOADER)}"
        )
    policy = resilience.policy_from_env(max_attempts=config.max_retries)
    with timer.stage("load_encode"):
        if hin is None:
            hin = load_dataset(
                config.dataset,
                use_native=USE_NATIVE_BY_LOADER[config.loader],
                policy=policy,
            )
            if config.headroom:
                # Reserve append capacity BEFORE any backend sees a
                # shape: the delta-ingestion contract (data/delta.py) —
                # results are bit-identical, shapes survive node growth.
                from .data.delta import with_headroom

                hin = with_headroom(hin, config.headroom)
    with timer.stage("metapath_compile"):
        metapath = resilience.resilient_call(
            "metapath_compile",
            lambda: compile_metapath(config.metapath, hin.schema),
            policy,
        )
    with timer.stage("backend_init"):
        backend = resilience.create_backend_resilient(
            config.backend,
            hin,
            metapath,
            policy=policy,
            degrade=config.degrade,
            **backend_options(config),
        )
    return hin, metapath, backend


def backend_options(config: RunConfig) -> dict:
    """Backend constructor kwargs from a RunConfig — shared by the
    bootstrap above and the serving layer's delta-fallback rebuild,
    which must replay the SAME knobs. The device backends (torch,
    torch-sparse, torch-sharded) take the device named by ``platform`` and ``approx``
    as ``exact_counts=False``; torch-sparse takes ``tile_rows`` and
    ``factor_format``. The numpy oracle runs on the host whatever the
    platform. ``torch-sharded`` takes ``n_devices``. ``dtype`` names a
    numpy dtype for numpy and a torch dtype otherwise."""
    if config.backend not in ("torch", "torch-sparse", "torch-sharded"):
        if config.dtype:
            return {"dtype": np.dtype(config.dtype)}
        return {}
    options = {"device": config.platform}
    if config.dtype:
        options["dtype"] = _torch_dtype(config.dtype)
    if config.approx:
        options["exact_counts"] = False
    if config.backend == "torch-sharded" and config.n_devices is not None:
        options["n_devices"] = config.n_devices
    if config.backend == "torch-sparse":
        if config.tile_rows is not None:
            options["tile_rows"] = config.tile_rows
        if config.factor_format is not None:
            options["factor_format"] = config.factor_format
    return options


def _torch_dtype(name: str):
    import torch

    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype
