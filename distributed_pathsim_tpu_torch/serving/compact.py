"""Background compaction: re-encode with fresh headroom, hot-swap.

A sustained delta firehose eventually exhausts what the O(Δ) patch
machinery can absorb: node appends eat the index-capacity reserve, and
when it runs out the NEXT update pays a full synchronous rebuild inline
— a stall in the middle of serving traffic that also re-keys the
consistency token and purges both cache tiers. This module moves that
rebuild off the serving path, as the JAX package's ``serving/compact.py``
does:

- **Triggers** (checked per absorbed delta, under the swap lock):
  capacity headroom below ``compact_headroom_frac`` of the logical
  size, or more than ``compact_chain_len`` deltas absorbed since the
  last re-encode (both thresholds are tuning-registry knobs).
- **Build** (background thread): the CURRENT logical graph is
  re-padded with fresh pow-2 headroom (:func:`compact_hin`) and a fresh
  backend is built through the service's factory (on the card: the fold,
  the scatter-build of C and the bucket warmup, then a wait until the
  card has finished all of it). Deltas that land during the build are
  recorded in a replay log; serving never stops.
- **Swap** (under the existing swap lock): the recorded deltas are
  replayed onto the new backend in O(Δ) each, the pipeline drains, and
  the backend is hot-swapped. The consistency token ``(base_fp,
  delta_seq)`` and the chained fingerprint are PRESERVED — the logical
  graph did not change, so router fencing sees nothing and both cache
  tiers stay warm (zero entries purged). A rebuild or reload racing
  the build poisons the log and the attempt abandons, bounded by
  ``compact_attempts``.
- **Compiles**: the build thread counts its own run-time compiles
  (``dpathsim_compaction_compiles_total``); a warm process compiles
  nothing there — every kernel library is already built and loaded.

The swap-lock hold (drain + replay + install) is the only pause
serving sees; it is measured into ``dpathsim_compaction_pause_seconds``.
A build that fails is counted (``failures``, ``dpathsim_compaction_total
{outcome="failed"}``) and evented (``serve_compact_failed``), and the
old backend keeps serving.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

from ..data.encode import EncodedHIN
from ..obs.metrics import get_registry
from ..obs.trace import get_tracer
from ..utils.logging import runtime_event


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(math.ceil(math.log2(max(n, 1)))), 3)


def compact_hin(hin: EncodedHIN, headroom: float = 0.25) -> EncodedHIN:
    """The current logical graph, re-padded with a FRESH pow-2 capacity
    reserve per node type: ``capacity = pow2(size · (1 + headroom))``
    (min 8 slots of reserve). Types that never reserved headroom keep
    ``capacity=None`` — compaction refreshes the reserve, it does not
    change the headroom policy. Contents are untouched; padded slots
    carry no edges, so scores are bit-identical by the same argument
    ``with_headroom`` makes. Pow-2 buckets keep successive compactions
    at the same bucket on identical array shapes."""
    indices = {}
    for t, idx in hin.indices.items():
        if idx.capacity is None:
            indices[t] = idx
            continue
        cap = _pow2_at_least(
            max(int(math.ceil(idx.size * (1.0 + headroom))), idx.size + 8)
        )
        indices[t] = dataclasses.replace(idx, capacity=cap)
    blocks = {}
    for rel, b in hin.blocks.items():
        src, dst = hin.schema.relations[rel]
        blocks[rel] = dataclasses.replace(
            b,
            shape=(indices[src].padded_size, indices[dst].padded_size),
        )
    return EncodedHIN(
        schema=hin.schema, indices=indices, blocks=blocks, name=hin.name
    )


def _finish_device_work(backend) -> None:
    """Block until the card has finished everything queued for the new
    backend (the scatter-build of C, the warmup GEMMs): the first batch
    after the swap runs on the dispatcher thread's streams, which are
    not ordered after this build thread's work by anything else."""
    device = getattr(backend, "device", None)
    if device is not None and device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


class Compactor:
    """Owns the compaction lifecycle for one :class:`PathSimService`.

    Thread discipline: every mutable field (``inflight``, the replay
    ``_log``, the chain counter) is read and written ONLY under the
    service's ``_swap_lock`` — ``note_update`` is called from
    ``service.update()`` which already holds it, and the build thread
    takes it for the snapshot and the swap. The build itself (the
    expensive part) runs outside the lock; serving continues."""

    def __init__(self, service):
        from .. import tuning

        self.service = service
        cfg = service.config
        self.chain_len = int(
            cfg.compact_chain_len
            if cfg.compact_chain_len is not None
            else tuning.choose(
                "compact_chain_len", n=service.n, default=256
            )
        )
        self.headroom = float(
            cfg.compact_headroom
            if cfg.compact_headroom is not None
            else tuning.choose(
                "compact_headroom", n=service.n, default=0.25
            )
        )
        self.headroom_frac = float(cfg.compact_headroom_frac)
        self.cooldown_s = float(cfg.compact_cooldown_s)
        self.max_attempts = max(int(cfg.compact_attempts), 1)
        # all guarded by service._swap_lock (see class docstring)
        self.inflight = False
        self._log: list | None = []
        self._chain = 0
        self._last_done = time.monotonic()
        self._done = threading.Event()
        self._done.set()
        self.compactions = 0
        self.abandoned = 0
        self.failures = 0
        self.last: dict = {}
        reg = get_registry()
        self._m_total = reg.counter(
            "dpathsim_compaction_total",
            "background compactions by outcome",
        )
        self._m_build = reg.histogram(
            "dpathsim_compaction_build_seconds",
            "off-path re-encode + backend build + rewarm time",
        ).labels()
        self._m_pause = reg.histogram(
            "dpathsim_compaction_pause_seconds",
            "swap-lock hold (drain + delta replay + install) per swap",
        ).labels()
        self._m_compiles = reg.counter(
            "dpathsim_compaction_compiles_total",
            "run-time compiles attributed to compaction builds",
        ).labels()
        self._m_headroom = reg.gauge(
            "dpathsim_compaction_headroom_frac",
            "min capacity headroom across types, as a fraction of size",
        ).labels()

    # -- trigger side (caller holds service._swap_lock) --------------------

    def _headroom_frac(self) -> float | None:
        """Min headroom/size over the types that reserved capacity;
        None when no type ever did (headroom triggering is then
        meaningless — every append already rebuilds)."""
        fracs = [
            idx.headroom / max(idx.size, 1)
            for idx in self.service.hin.indices.values()
            if idx.capacity is not None
        ]
        return min(fracs) if fracs else None

    def note_update(self, delta, mode: str) -> None:
        """One absorbed update: feed the replay log of an in-flight
        build, advance the chain counter, maybe trigger. Called under
        the swap lock from ``service.update()``."""
        if mode == "delta":
            self._chain += 1
            if self.inflight and self._log is not None:
                self._log.append(delta)
        else:
            # a rebuild re-encoded everything: the chain restarts and
            # any in-flight build is stale (its snapshot predates a
            # token re-base) — poison the log so the swap abandons
            self.note_rebuild()
        frac = self._headroom_frac()
        if frac is not None:
            self._m_headroom.set(frac)
        if not self.service.config.compact_auto or self.inflight:
            return
        if time.monotonic() - self._last_done < self.cooldown_s:
            return
        reason = None
        if self._chain >= self.chain_len:
            reason = f"delta chain at {self._chain} >= {self.chain_len}"
        elif frac is not None and frac < self.headroom_frac:
            reason = (
                f"headroom {frac:.3f} below {self.headroom_frac:.3f}"
            )
        if reason is None:
            return
        self._start(reason)

    def note_rebuild(self) -> None:
        """A reload/rebuild swapped the backend wholesale (token
        re-based): reset the chain, poison any in-flight build's log.
        Called under the swap lock."""
        self._chain = 0
        if self.inflight:
            self._log = None

    def _start(self, reason: str) -> None:
        """Spawn the build thread (caller holds the swap lock)."""
        self.inflight = True
        self._log = []
        self._done.clear()
        cur = get_tracer().current()
        link = (
            f"{cur.trace_id}:{cur.span_id}"
            if cur is not None and cur.span_id else None
        )
        runtime_event("serve_compact_trigger", reason=reason,
                      chain=self._chain)
        threading.Thread(
            target=self._run, args=(reason, link),
            name="pathsim-compact", daemon=True,
        ).start()

    # -- build side (background thread) ------------------------------------

    def compact_now(self, reason: str = "operator", wait_s: float = 300.0,
                    ) -> dict:
        """Force one compaction synchronously (the ``compact`` protocol
        op). If a background build is already in flight, wait for it and
        return its accounting instead of stacking another."""
        with self.service._swap_lock:
            if not self.inflight:
                self.inflight = True
                self._log = []
                self._done.clear()
                started = True
            else:
                started = False
        if started:
            self._run(reason, None)
        elif not self._done.wait(wait_s):
            # the in-flight build outlived the wait: say so rather
            # than returning the PREVIOUS compaction's accounting as
            # if it answered this request
            return {
                "swapped": False,
                "error": f"in-flight compaction still running after "
                         f"{wait_s:g}s",
            }
        return dict(self.last)

    def _run(self, reason: str, link: str | None) -> None:
        tracer = get_tracer()
        try:
            with tracer.span("serve.compact", reason=reason, link=link):
                result = self._compact_once(reason)
        except Exception as exc:  # background thread: report, never die
            self.failures += 1
            self._m_total.inc(outcome="failed")
            result = {"swapped": False, "error": repr(exc)}
            runtime_event("serve_compact_failed", error=repr(exc))
        finally:
            with self.service._swap_lock:
                self.inflight = False
                self._log = []
                self._last_done = time.monotonic()
                self.last = result if isinstance(result, dict) else {}
            self._done.set()

    def _compact_once(self, reason: str) -> dict:
        from ..data.delta import half_chain_cached
        from ..utils.compile_counter import (
            CompileCounter,
            warm_compile_cache,
        )

        svc = self.service
        tracer = get_tracer()
        t_all = time.perf_counter()
        for attempt in range(1, self.max_attempts + 1):
            with svc._swap_lock:
                token0 = svc.consistency_token
                fp0 = svc._fp
                hin0 = svc.hin
                self._log = []
            t_build = time.perf_counter()
            result = None
            abandon = None
            # ONE compile ledger over the whole attempt — build AND swap
            with CompileCounter() as cc:
                with tracer.child_span("compact.build", attempt=attempt):
                    hin_c = compact_hin(hin0, headroom=self.headroom)
                    # the compacted encoding IS the same logical graph:
                    # its content fingerprint is the chain the live
                    # service already carries — seeding it keeps every
                    # replica's fingerprint chain identical no matter
                    # when each one compacts (and skips an O(nnz)
                    # re-hash)
                    object.__setattr__(hin_c, "_fingerprint_cache", fp0)
                    backend = svc._backend_factory(hin_c)
                    if svc.config.warm:
                        warm_compile_cache(
                            backend, svc._bucket_ladder,
                            k=svc.config.k_default, variant=svc.variant,
                        )
                    # pre-fold the half chain OUTSIDE the lock so
                    # replayed deltas under the lock are O(Δ), never
                    # O(nnz)
                    half_chain_cached(hin_c, svc.metapath)
                    _finish_device_work(backend)
                build_s = time.perf_counter() - t_build
                self._m_build.observe(build_s)
                # the swap itself goes through the service's doorway:
                # token check, mid-build delta replay, drain, hot-swap
                applied = svc._apply_compaction(backend, hin_c, token0)
                abandon = applied.get("abandoned")
                if abandon is None:
                    pause_s = applied["pause_s"]
                    self._m_pause.observe(pause_s)
                    self.compactions += 1
                    self._m_total.inc(outcome="swapped")
                    frac = self._headroom_frac()
                    if frac is not None:
                        self._m_headroom.set(frac)
                    result = {
                        "swapped": True,
                        "reason": reason,
                        "attempts": attempt,
                        "replayed_deltas": applied["replayed_deltas"],
                        "build_ms": round(build_s * 1e3, 3),
                        "pause_ms": round(pause_s * 1e3, 3),
                        "total_ms": round(
                            (time.perf_counter() - t_all) * 1e3, 3
                        ),
                        "capacity": applied["capacity"],
                        "headroom_frac": frac,
                        "token": applied["token"],
                    }
            if cc.count:
                self._m_compiles.inc(cc.count)
            if abandon is not None:
                self.abandoned += 1
                self._m_total.inc(outcome="abandoned")
                runtime_event(
                    "serve_compact_abandoned", attempt=attempt,
                    reason=abandon, echo=False,
                )
                continue
            result["compiles"] = cc.count
            runtime_event("serve_compact", **result)
            return result
        self._m_total.inc(outcome="failed")
        self.failures += 1
        result = {
            "swapped": False,
            "reason": reason,
            "attempts": self.max_attempts,
            "error": "every attempt was abandoned (token kept moving)",
        }
        runtime_event("serve_compact_failed", **result)
        return result

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        """The stats()/health() block — O(1), no locks beyond GIL-safe
        counter reads (values are monotone counters; an off-by-one read
        under a racing swap is harmless)."""
        return {
            "auto": bool(self.service.config.compact_auto),
            "inflight": self.inflight,
            "chain": self._chain,
            "chain_len": self.chain_len,
            "headroom_frac_trigger": self.headroom_frac,
            "fresh_headroom": self.headroom,
            "compactions": self.compactions,
            "abandoned": self.abandoned,
            "failures": self.failures,
            "last": dict(self.last),
        }
