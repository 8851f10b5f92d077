"""Horizontal serving tier: router / worker split, replica mode.

One warm :class:`~..serving.PathSimService` is one failure domain; this
package turns N of them into one fault-tolerant service. It is the JAX
package's ``router/`` for replica fleets, module for module. Public
surface:

- :class:`Router` / :class:`RouterConfig` — the fan-out core: routes
  queries over worker replicas (consistent-hash-by-row for cache
  affinity, row-range alternative), re-dispatches the in-flight work of
  a dead or stalled replica, hedges against the slow tail, broadcasts
  deltas with ``(base_fp, delta_seq)`` fencing, sheds when every
  replica is saturated, and drains gracefully on SIGTERM (core.py);
- :class:`HashRing` / :class:`RangeRouter` — the routing policies
  (hashring.py);
- :class:`WorkerRuntime` / :func:`worker_loop` — the worker side of the
  wire protocol: async query handling, request-id dedup, health probes,
  graceful drain (worker.py);
- :class:`SubprocessTransport` / :class:`InprocTransport` — how the
  router reaches a worker: a real ``dpathsim-torch worker`` child
  process, or an in-process thread for deterministic chaos tests
  (transport.py);
- :class:`Autoscaler` / :class:`AutoscaleConfig` — the closed loop:
  queue-depth / shed / SLO-burn signals drive worker spawn (epoch
  catch-up replay) and drain (autoscale.py);
- the firehose update pipeline — bounded update-queue admission with
  backpressure and delta coalescing (firehose.py);
- the ``dpathsim-torch router`` / ``worker`` / ``fleet-stats``
  subcommands (cli.py).

The router also hosts the fleet observability plane: cross-process
trace stitching over the protocol's ``trace`` context, an exact
(bucket-wise) merge of scraped per-worker metric registries, a
multi-window burn-rate SLO engine over the merged stream, and a
tail-sampled flight recorder for slow/errored/shed/hedged/failed-over
requests (``flight_dump`` op + SIGTERM drain dump).

The batch-campaign scheduler (:class:`~.batch.BlockScheduler`,
batch.py) fans a campaign's row blocks over the same workers through
the ``batch_blocks`` op. :class:`~.partition.PartitionRouter`
(partition.py) shards ONE graph across the workers instead: each holds
a row range of the half-chain factor (serving/partition.py), and a
query scatters over the ranges and merges exactly.
"""

from .autoscale import AutoscaleConfig, Autoscaler
from .core import Router, RouterConfig, RouterShed
from .hashring import HashRing, RangeRouter, make_policy
from .partition import PartitionRouter, PartitionRouterConfig
from .transport import InprocTransport, SubprocessTransport, WorkerGone
from .worker import WorkerRuntime, worker_loop

__all__ = [
    "AutoscaleConfig",
    "Autoscaler",
    "HashRing",
    "InprocTransport",
    "PartitionRouter",
    "PartitionRouterConfig",
    "RangeRouter",
    "Router",
    "RouterConfig",
    "RouterShed",
    "SubprocessTransport",
    "WorkerGone",
    "WorkerRuntime",
    "make_policy",
    "worker_loop",
]
