"""Device meshes and the collectives of the single-controller design.

The JAX package names its parallelism with a ``jax.sharding.Mesh`` and
lets XLA insert the collectives. Here a :class:`Mesh` is an ordered list
of ``torch.device`` shards, driven from one process, and the collectives
are explicit:

- ``"dp"``: the author/output-row axis of the commuting matrix (1-D
  tensor parallelism of the chain);
- ``"tp"``: the optional second axis of 2-D block tiling
  (parallel/tiling.py).

A device may repeat: D virtual shards on ``cpu`` (the tests), D shards on
``cuda:0`` (one card) or one shard per card. The collectives:

- :func:`psum`: the sum of the per-shard tensors, placed on each shard's
  device;
- :func:`all_gather`: the concatenation of the shards, on each device;
- :func:`ppermute`: a rotation of the shard list, each tensor moved to
  its new shard's device with ``non_blocking=True``. A copy between two
  cards is issued by ``Tensor.to``, which orders it after the current
  stream of the source device and makes the destination's current stream
  wait for it, so a kernel launched next on the destination reads the
  finished copy.

When the job spans processes (parallel/multihost.py), each process owns
a contiguous block of shards (``Mesh.devices`` are its own), and the
legs that cross a process boundary go through ``torch.distributed``: the
colsum ``psum`` is an ``all_reduce``, the ring's hop a neighbour
``batch_isend_irecv`` and a host fetch an ``all_gather_object``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of shards. ``devices``: this process's shards in row-major
    order over ``axis_names``; ``axis_sizes``: the global grid; the
    process owns global shards ``first_shard .. first_shard +
    len(devices) - 1``."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("dp",)
    axis_sizes: tuple[int, ...] | None = None
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        if self.axis_sizes is None:
            object.__setattr__(self, "axis_sizes", (len(self.devices),))
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError("one size per mesh axis")
        if math.prod(self.axis_sizes) != len(self.devices) * self.process_count:
            raise ValueError(
                f"mesh {self.axis_sizes} does not match {len(self.devices)} "
                f"shards x {self.process_count} processes"
            )

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def first_shard(self) -> int:
        return self.process_index * len(self.devices)

    @property
    def multiprocess(self) -> bool:
        return self.process_count > 1


def available_devices(platform: str = "cuda") -> list[torch.device]:
    """The devices a mesh on ``platform`` spreads over: every visible
    card, or the one host device."""
    if torch.device(platform).type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def spread(devices, n: int) -> tuple[torch.device, ...]:
    """``n`` shards over ``devices`` in contiguous blocks (shard i on
    ``devices[i * len // n]``), so ring neighbours share a device where
    they can. A device repeats when ``n`` exceeds the device count."""
    devices = list(devices)
    if not devices:
        raise ValueError("no devices to build a mesh on")
    return tuple(devices[i * len(devices) // n] for i in range(n))


def make_mesh(n_devices: int | None = None, axis: str = "dp", devices=None,
              platform: str = "cuda") -> Mesh:
    """1-D mesh of ``n_devices`` shards (default: one per device) over
    ``devices`` (default: :func:`available_devices` of ``platform``)."""
    devices = list(devices if devices is not None
                   else available_devices(platform))
    n = len(devices) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh(spread(devices, n), (axis,))


def make_mesh_2d(shape: tuple[int, int], axes: tuple[str, str] = ("dp", "tp"),
                 devices=None, platform: str = "cuda") -> Mesh:
    """2-D mesh for block-tiled all-pairs: shard (i, j) is flat shard
    ``i * shape[1] + j``."""
    devices = list(devices if devices is not None
                   else available_devices(platform))
    n = shape[0] * shape[1]
    return Mesh(spread(devices, n), tuple(axes), tuple(shape))


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n."""
    return ((n + k - 1) // k) * k


# -- placement --------------------------------------------------------------


def split_rows(x, mesh: Mesh, dtype=None) -> list[torch.Tensor]:
    """This process's row shards of the (already padded) host or device
    array ``x``, each on its shard's device."""
    t = torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
    if dtype is not None:
        t = t.to(dtype)
    n_local = len(mesh.devices)
    if t.shape[0] % n_local:
        raise ValueError(f"{t.shape[0]} rows do not split into {n_local} shards")
    n_loc = t.shape[0] // n_local
    return [t[i * n_loc:(i + 1) * n_loc].to(dev).contiguous()
            for i, dev in enumerate(mesh.devices)]


def per_device(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """``x`` on each shard's device: one copy per distinct device, shared
    by the shards that live there."""
    copies: dict[torch.device, torch.Tensor] = {}
    out = []
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = x.to(dev, non_blocking=True)
        out.append(copies[dev])
    return out


# -- collectives --------------------------------------------------------------


def psum(parts: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """The sum over every shard of the mesh, on each local shard's device.
    Across processes the local sum is ``all_reduce``d."""
    total = parts[0].clone()
    for p in parts[1:]:
        total += p.to(total.device, non_blocking=True)
    if mesh.multiprocess:
        import torch.distributed as dist

        dist.all_reduce(total)
    return per_device(total, mesh)


def all_gather(parts: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """The concatenation (dim 0) of every shard of the mesh, in shard
    order, on each local shard's device."""
    home = parts[0].device
    local = torch.cat([p.to(home, non_blocking=True) for p in parts])
    if mesh.multiprocess:
        import torch.distributed as dist

        pieces = [torch.empty_like(local) for _ in range(mesh.process_count)]
        dist.all_gather(pieces, local)
        local = torch.cat(pieces)
    return per_device(local, mesh)


def ppermute(parts: list, mesh: Mesh, move=None) -> list:
    """Rotate the ring by one: global shard i's item goes to shard
    (i + 1) mod D. ``move(item, device)`` places an item on a device
    (default ``Tensor.to(device, non_blocking=True)``). Across processes
    the last local item is sent to the next process and the first slot
    is received from the previous one (tensors only)."""
    if move is None:
        def move(x, dev):
            return x.to(dev, non_blocking=True)
    devs = mesh.devices
    if not mesh.multiprocess:
        n = len(parts)
        return [move(parts[(j - 1) % n], devs[j]) for j in range(n)]
    import torch.distributed as dist

    out = [None] + [move(parts[j - 1], devs[j]) for j in range(1, len(parts))]
    outgoing = parts[-1].contiguous()
    incoming = torch.empty_like(outgoing)
    rank, size = mesh.process_index, mesh.process_count
    ops = [dist.P2POp(dist.isend, outgoing, (rank + 1) % size),
           dist.P2POp(dist.irecv, incoming, (rank - 1) % size)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out[0] = move(incoming, devs[0])
    return out


def gather_rows(parts: list[torch.Tensor], mesh: Mesh) -> np.ndarray:
    """Full host copy of a row-sharded array (every process gets it):
    ``[N_pad, ...]`` in global shard order."""
    local = np.concatenate([p.detach().cpu().numpy() for p in parts])
    if not mesh.multiprocess:
        return local
    import torch.distributed as dist

    pieces: list = [None] * mesh.process_count
    dist.all_gather_object(pieces, local)
    return np.concatenate(pieces)
