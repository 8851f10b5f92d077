"""Multi-process execution: the rendezvous, process-spanning meshes and
process-local data placement.

The JAX package's counterpart is ``jax.distributed`` plus a global device
mesh. Here ``torch.distributed`` carries only the rendezvous and the
legs of a collective that cross a process boundary (parallel/mesh.py):
gloo on the host, NCCL between cards. Each process drives its own block
of shards as one controller. Three pieces:

1. :func:`initialize_multihost`: the rendezvous at a coordinator
   address (``tcp://host:port``); an explicit no-op for one process, so
   the same command works on one machine and on every host of a job.
2. :func:`make_hybrid_mesh`: a ``(dp, tp)`` mesh whose ``dp`` (row)
   axis spans processes, processes outermost, while ``tp`` stays inside
   one process.
3. :func:`host_row_range` / :func:`distributed_first_block`: each
   process densifies ONLY its own rows of the first chain block; no
   process ever holds the whole matrix.

Two processes cannot share one card under NCCL ("Duplicate GPU
detected"): on one card a job has one process, and several shards in it.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable

import numpy as np
import torch

from .mesh import Mesh, available_devices, pad_to_multiple, spread

# torchrun's rendezvous contract: with all three set, the environment
# names the cluster (init_method "env://").
_CLUSTER_ENV_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")

RENDEZVOUS_TIMEOUT_S = 300.0


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return _dist().get_world_size() if _initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if _initialized() else 0


def _backend(platform: str) -> str:
    """gloo for host tensors; on the card NCCL carries the CUDA tensors and
    gloo the host objects of the final fetch."""
    if torch.device(platform).type == "cuda":
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         platform: str = "cuda",
                         timeout_s: float = RENDEZVOUS_TIMEOUT_S) -> bool:
    """Join the ``torch.distributed`` job when running multi-process.

    Explicit arguments always join (``num_processes`` and ``process_id``
    then come from the arguments, else from ``WORLD_SIZE`` / ``RANK``).
    With no arguments, joins only when torchrun's environment names a
    cluster; otherwise this is a no-op. Returns True iff the process is
    part of a job of more than one process after the call."""
    explicit = coordinator_address is not None
    detected = all(v in os.environ for v in _CLUSTER_ENV_VARS)
    if _initialized():
        return process_count() > 1  # a launcher joined already
    if not (explicit or detected):
        return False
    if explicit:
        world = num_processes if num_processes is not None else _env_int(
            "WORLD_SIZE")
        rank = process_id if process_id is not None else _env_int("RANK")
        if world is None or rank is None:
            raise ValueError(
                "--coordinator-address needs --num-processes and "
                "--process-id (or WORLD_SIZE and RANK in the environment)"
            )
        if not 0 <= rank < world:
            raise ValueError(f"process id {rank} outside [0, {world})")
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=world, rank=rank)
    else:
        init = dict(init_method="env://")
    if torch.device(platform).type == "cuda":
        # one card per process when the job has several (NCCL refuses two
        # ranks on one card); the process drives its cards' shards
        local = _env_int("LOCAL_RANK") or 0
        torch.cuda.set_device(local % max(torch.cuda.device_count(), 1))

    # The rendezvous is a network operation against a coordinator that may
    # not be up yet (processes race at job start): the multihost_init seam
    # retries it with backoff. RuntimeError joins the retryable set
    # (torch.distributed raises it for a refused or timed-out store);
    # InjectedCrash (a RuntimeError meaning "hard kill") stays
    # non-retryable.
    from .. import resilience

    policy = resilience.policy_from_env()
    policy = policy.replace(
        retryable=policy.retryable + (RuntimeError,),
        non_retryable=policy.non_retryable + (resilience.InjectedCrash,),
    )
    resilience.resilient_call(
        "multihost_init",
        lambda: _dist().init_process_group(
            backend=_backend(platform),
            timeout=datetime.timedelta(seconds=timeout_s), **init),
        policy,
    )
    return process_count() > 1


def shutdown_multihost() -> None:
    """Leave the job (a no-op when none was joined)."""
    if _initialized():
        _dist().destroy_process_group()


def _env_int(name: str) -> int | None:
    raw = os.environ.get(name)
    return int(raw) if raw not in (None, "") else None


def make_hybrid_mesh(tp: int = 1, axes: tuple[str, str] = ("dp", "tp"),
                     devices=None, platform: str = "cuda",
                     n_local: int | None = None) -> Mesh:
    """A ``(dp, tp)`` mesh with ``dp`` spanning processes, processes
    outermost: process p owns global shards [p·n_local, (p+1)·n_local),
    so its rows are one contiguous range (:func:`host_row_range`).
    ``n_local``: this process's shards (default: one per device of
    ``devices``, else of :func:`available_devices`); every process must
    pass the same. One process: a local mesh of the same shape."""
    devices = list(devices if devices is not None
                   else available_devices(platform))
    n_local = len(devices) if n_local is None else int(n_local)
    if n_local % tp != 0:
        raise ValueError(
            f"tp={tp} must divide the per-process shard count {n_local}"
        )
    n_proc = process_count()
    return Mesh(spread(devices, n_local), tuple(axes),
                ((n_local // tp) * n_proc, tp),
                process_index=process_index(), process_count=n_proc)


def host_row_range(n_rows: int, mesh: Mesh, axis: str = "dp"
                   ) -> tuple[int, int]:
    """The contiguous [start, stop) of the padded global row axis owned by
    THIS process under ``axis`` sharding: process p owns rows
    [p·n_pad/P, (p+1)·n_pad/P). The last process's stop covers the
    padding; callers zero-fill rows past ``n_rows``."""
    n_pad = pad_to_multiple(n_rows, mesh.shape[axis])
    per_host = n_pad // mesh.process_count
    start = mesh.process_index * per_host
    return start, start + per_host


def distributed_first_block(load_rows: Callable[[int, int], np.ndarray],
                            n_rows: int, n_cols: int, mesh: Mesh,
                            axis: str = "dp",
                            dtype=torch.float32) -> list[torch.Tensor]:
    """This process's row shards of the first chain block, built without
    any process holding it whole. ``load_rows(start, stop)`` returns this
    process's rows (padding rows past ``n_rows`` are never requested;
    they are zero-filled here). Each shard lands on its device."""
    start, stop = host_row_range(n_rows, mesh, axis)
    real_stop = min(stop, n_rows)
    local = np.zeros((stop - start, n_cols), dtype=np.float64)
    if real_stop > start:
        local[: real_stop - start] = load_rows(start, real_stop)
    t = torch.from_numpy(local).to(dtype)
    n_loc = t.shape[0] // len(mesh.devices)
    return [t[i * n_loc:(i + 1) * n_loc].to(dev).contiguous()
            for i, dev in enumerate(mesh.devices)]
