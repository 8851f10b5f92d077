"""Online serving layer: coalescing, shape buckets, multi-tier cache.

Public surface:

- :class:`PathSimService` / :class:`ServeConfig` / :func:`build_service`
  — the warm query frontend (service.py);
- :class:`LoadShedError` / :class:`ServiceClosed` — admission and
  lifecycle failures callers handle (coalescer.py);
- :func:`graph_fingerprint` / :func:`chain_fingerprint` — the
  cache-identity hashes (cache.py);
- :class:`MetapathEngine` — a secondary metapath's warm engine
  (service.py);
- :class:`Compactor` / :func:`compact_hin` — background compaction and
  its re-encode (compact.py);
- :func:`~.protocol.serve_loop` / :func:`~.protocol.handle_request` —
  the JSONL protocol; the ``dpathsim-torch serve`` subcommand lives in
  cli.py.
"""

from .cache import chain_fingerprint, graph_fingerprint
from .coalescer import LoadShedError, ServiceClosed
from .compact import Compactor, compact_hin
from .service import (
    MetapathEngine,
    PathSimService,
    ServeConfig,
    build_service,
)

__all__ = [
    "Compactor",
    "MetapathEngine",
    "PathSimService",
    "ServeConfig",
    "build_service",
    "compact_hin",
    "LoadShedError",
    "ServiceClosed",
    "chain_fingerprint",
    "graph_fingerprint",
]
