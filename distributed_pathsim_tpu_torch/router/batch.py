"""Router-side block scheduling for batch campaigns (the port of the
JAX package's ``router/batch.py``).

The serving router (core.py) is a request router: admission, hedging,
consistency fencing for single-row queries. A campaign is a different
shape — a known, finite work-list of row blocks, every block
idempotent and read-only — so it gets its own scheduler instead of
widening ``ROUTED_OPS``: a shared block queue drained by whichever
worker is free (self-balancing: a slow replica simply takes fewer
blocks), bounded in-flight per worker, straggler re-dispatch after a
latency multiple (first answer wins; ``batch_blocks`` is idempotent so
duplicated work is only wasted, never wrong), and requeue-on-death via
the transport's ``on_death``.

Consistency is campaign-scoped, not request-scoped: every worker's
ready token ``(base_fp, delta_seq)`` must equal the campaign spec's —
a mismatched worker is excluded up front (counted), and a worker that
answers ``stale batch campaign`` (its token moved mid-campaign) is
fenced for the remainder. If no worker matches, the campaign refuses
loudly rather than mixing graph versions.

Results travel as JSON (the wire's native encoding); f64 survives the
round-trip exactly (shortest-repr), so fleet shards are bit-identical
to single-host shards — tests/test_torch_batch_fleet.py checks exactly
this.
"""

from __future__ import annotations

import threading
import time

from ..obs.metrics import get_registry
from ..utils.logging import runtime_event
from .transport import WorkerGone


class BatchFleetError(RuntimeError):
    """The campaign cannot make progress: no eligible worker remains
    (all dead, fenced, or token-mismatched)."""


class BlockScheduler:
    """Fan a campaign's pending blocks across worker transports.

    Owns the transports for the campaign's duration: ``start()`` wires
    the message/death callbacks and fences ready tokens; callers hand
    in freshly-constructed (unstarted) transports, exactly like
    ``Router`` does.
    """

    def __init__(
        self,
        transports: dict,
        max_inflight: int = 2,
        straggler_after_s: float = 30.0,
        ready_timeout_s: float = 120.0,
    ):
        self._transports = dict(transports)
        self._max_inflight = max(int(max_inflight), 1)
        self._straggler_after_s = float(straggler_after_s)
        self._ready_timeout_s = float(ready_timeout_s)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._tokens: dict[str, tuple] = {}
        self._fenced: set[str] = set()
        self._inflight: dict[str, dict] = {}   # rid → dispatch record
        self._pending: list = []
        self._results: list = []
        self._failure: Exception | None = None
        self._seq = 0
        reg = get_registry()
        self._m_dispatch = reg.counter(
            "dpathsim_batch_dispatch_total",
            "fleet block dispatches by kind (first try, straggler "
            "re-dispatch, death requeue)",
        )
        self._m_fenced = reg.counter(
            "dpathsim_batch_worker_fenced_total",
            "workers excluded from a campaign (token mismatch or "
            "stale answer mid-campaign)",
        )

    def start(self) -> None:
        for wid, t in self._transports.items():
            t.start(self._on_message, self._on_death)
        for wid, t in self._transports.items():
            info = t.wait_ready(self._ready_timeout_s)
            self._tokens[wid] = (
                info.get("base_fp"), int(info.get("delta_seq", 0))
            )

    def close(self) -> None:
        for t in self._transports.values():
            close = getattr(t, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    # -- callbacks (transport reader threads) -----------------------------

    def _on_message(self, wid: str, obj: dict) -> None:
        rid = obj.get("request_id")
        if not isinstance(rid, str) or not rid.startswith("bb:"):
            return
        with self._cv:
            rec = self._inflight.pop(rid, None)
            if rec is None:
                return  # straggler's late twin: first answer won
            # drop the block's OTHER outstanding dispatches, if any
            for orid in list(self._inflight):
                if self._inflight[orid]["block"] == rec["block"]:
                    del self._inflight[orid]
            if obj.get("ok"):
                lo, hi = rec["block"]
                self._results.append((lo, hi, obj.get("result") or {}))
            else:
                err = str(obj.get("error", "batch_blocks failed"))
                if "stale batch campaign" in err:
                    # this worker's graph moved mid-campaign: fence it
                    # and requeue the block for a consistent peer
                    self._fenced.add(wid)
                    self._m_fenced.inc(reason="stale")
                    self._pending.append(rec["block"])
                elif obj.get("transient"):
                    self._pending.append(rec["block"])
                else:
                    self._failure = BatchFleetError(
                        f"worker {wid} failed block {rec['block']}: {err}"
                    )
            self._cv.notify_all()

    def _on_death(self, wid: str, reason: str) -> None:
        with self._cv:
            self._fenced.add(wid)
            runtime_event(
                "batch_worker_death", echo=False,
                worker_id=wid, reason=reason,
            )
            for rid in list(self._inflight):
                rec = self._inflight[rid]
                if rec["worker"] == wid:
                    del self._inflight[rid]
                    self._pending.append(rec["block"])
                    self._m_dispatch.inc(kind="death_requeue")
            self._cv.notify_all()

    # -- scheduling --------------------------------------------------------

    def _eligible(self, spec) -> list[str]:
        want = (spec.base_fp, int(spec.delta_seq))
        out = []
        for wid, t in self._transports.items():
            if wid in self._fenced or not t.alive:
                continue
            if self._tokens.get(wid) != want:
                continue
            out.append(wid)
        return out

    def _dispatch(self, spec, wid: str, block, kind: str) -> None:
        lo, hi = block
        self._seq += 1
        rid = f"bb:{lo}:{hi}:{self._seq}"
        req = {
            "id": self._seq,
            "op": "batch_blocks",
            "request_id": rid,
            "lo": int(lo),
            "hi": int(hi),
            "mode": spec.mode,
            "metapath": spec.metapath,
            "variant": spec.variant,
            "base_fp": spec.base_fp,
            "delta_seq": int(spec.delta_seq),
            # both campaign parameters ride every dispatch (the handler
            # reads only its mode's field; defaults match the wire's)
            "k": int(spec.k) if spec.k is not None else 10,
            "tau": float(spec.tau) if spec.tau is not None else 0.5,
        }
        try:
            self._transports[wid].send(req)
        except WorkerGone:
            self._fenced.add(wid)
            self._pending.append(block)
            return
        self._inflight[rid] = {
            "worker": wid, "block": block, "t": time.perf_counter(),
        }
        self._m_dispatch.inc(kind=kind)

    def map_blocks(self, spec, blocks):
        """Yield ``(lo, hi, result)`` for every block, in completion
        order. Raises :class:`BatchFleetError` when no eligible worker
        can finish the campaign."""
        with self._cv:
            self._pending = [tuple(b) for b in blocks]
            self._results = []
            self._inflight.clear()
            self._failure = None
            need = len(self._pending)
        got = 0
        while got < need:
            with self._cv:
                if self._failure is not None:
                    raise self._failure
                if not self._results:
                    workers = self._eligible(spec)
                    if not workers and not self._inflight:
                        raise BatchFleetError(
                            "no eligible batch worker: token mismatch, "
                            "fenced, or dead "
                            f"(want {(spec.base_fp, spec.delta_seq)}, "
                            f"have {self._tokens})"
                        )
                    load = {w: 0 for w in workers}
                    for rec in self._inflight.values():
                        if rec["worker"] in load:
                            load[rec["worker"]] += 1
                    progressed = False
                    for w in sorted(workers, key=lambda w: load[w]):
                        if not self._pending:
                            break
                        if load[w] >= self._max_inflight:
                            continue
                        self._dispatch(
                            spec, w, self._pending.pop(0), "primary"
                        )
                        load[w] += 1
                        progressed = True
                    # straggler re-dispatch: a block outstanding past
                    # the threshold gets a second copy on the least-
                    # loaded OTHER worker; first answer wins
                    now = time.perf_counter()
                    for rid, rec in list(self._inflight.items()):
                        if now - rec["t"] < self._straggler_after_s:
                            continue
                        others = [
                            w for w in workers
                            if w != rec["worker"]
                            and load.get(w, 99) < self._max_inflight
                        ]
                        dupes = sum(
                            1 for r in self._inflight.values()
                            if r["block"] == rec["block"]
                        )
                        if others and dupes < 2:
                            w = min(others, key=lambda w: load[w])
                            self._dispatch(
                                spec, w, rec["block"], "straggler"
                            )
                            load[w] += 1
                            progressed = True
                    if not self._results and self._failure is None:
                        self._cv.wait(
                            timeout=0.25 if progressed else 0.05
                        )
                ready, self._results = self._results, []
            # yield OUTSIDE the lock: the consumer's per-block callback
            # may re-enter the scheduler (e.g. kill a transport, whose
            # on_death takes the cv on this very thread)
            for lo, hi, result in ready:
                got += 1
                yield lo, hi, result
