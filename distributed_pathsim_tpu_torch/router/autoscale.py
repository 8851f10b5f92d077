"""Closed-loop fleet autoscale: load signals drive spawn/drain.

The router gives the fleet the two primitives this module composes — a
worker can be drained gracefully (SIGTERM / in-band drain: in-flight
work completes, new work reroutes) and a lagging replica catches up by
ordered idempotent replay of the epoch log. The :class:`Autoscaler` is
the loop that *decides* to spawn or drain:

- **Signals**, evaluated per tick from the router's own state: mean
  worker queue depth (the pongs' load signal, as a fraction of the
  per-replica saturation bound), query+update shed deltas (admission
  already refused work — capacity is definitionally short), and the
  PR-9 SLO engine's burn status (an objective actively burning its
  error budget).
- **Hysteresis**: scale up after ``up_consecutive`` consecutive high
  ticks, down after ``down_consecutive`` consecutive low ticks, with a
  cooldown after every action — measured in *ticks*, so the decision
  sequence is a deterministic function of the signal sequence (the
  firehose bench replays a load step and asserts the exact reactions).
- **Actions**: spawn = build a transport from the worker factory,
  ``router.add_worker`` (the new replica boots the base graph, is
  fenced, and catches up by epoch replay — it can never serve stale
  rows, only warm up); drain = ``router.remove_worker`` on the
  highest-numbered live replica (deterministic victim), which
  completes its in-flight work and exits 0.
- **Decision log**: every tick appends ``{tick, action, reason,
  signals, workers}`` — the auditable trail ``stats()`` and the bench
  artifact expose; ``dpathsim_autoscale_*`` metric families carry the
  same truth for dashboards.

Ticking is external by default (``tick()``) so tests and benches drive
it deterministically; ``start()`` runs the same tick on a timer thread
for the CLI.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time

from ..obs.metrics import get_registry
from ..utils.logging import runtime_event
from .core import DRAINING, UP


@dataclasses.dataclass
class AutoscaleConfig:
    min_workers: int = 1
    max_workers: int = 4
    eval_interval_s: float = 1.0      # timer mode only; ticks are the unit
    # high-water: mean UP-worker queue depth as a fraction of the
    # router's per-replica saturation bound (worker_queue_limit)
    queue_high_frac: float = 0.5
    queue_low_frac: float = 0.05
    # router-side backlog per UP worker (admitted, unresolved): the
    # synchronous twin of the pong-reported queue depth — a burst
    # shows up here immediately, not a heartbeat later
    pending_high: float = 64.0
    pending_low: float = 2.0
    # sheds (query admission + update backpressure) per tick that
    # count as a high signal on their own
    shed_high: int = 1
    # treat any burning SLO as a high signal
    burn_high: bool = True
    up_consecutive: int = 2
    down_consecutive: int = 5
    cooldown_ticks: int = 5           # ticks of enforced hold after an action
    ready_timeout_s: float = 180.0
    decision_log_limit: int = 512


class Autoscaler:
    """One per router. ``worker_factory(wid) -> transport`` builds an
    UNSTARTED transport for a fresh replica (the CLI passes the same
    subprocess argv the initial fleet used; benches pass in-proc
    factories). Not thread-safe against concurrent ``tick`` calls —
    drive it from one place (the timer thread or the bench loop)."""

    def __init__(self, router, worker_factory,
                 config: AutoscaleConfig | None = None):
        self.router = router
        self.factory = worker_factory
        self.config = config or AutoscaleConfig()
        self.decisions: list[dict] = []
        self._tick_n = 0
        self._hi = 0
        self._lo = 0
        self._last_action_tick = -(10 ** 9)
        self._shed_prev: float | None = None
        seq = 0
        for wid in router.workers:
            m = re.fullmatch(r"w(\d+)", wid)
            if m:
                seq = max(seq, int(m.group(1)) + 1)
        self._wid_next = seq
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        reg = get_registry()
        self._m_workers = reg.gauge(
            "dpathsim_autoscale_workers",
            "live (UP) worker replicas as the autoscaler sees them",
        ).labels()
        self._m_decisions = reg.counter(
            "dpathsim_autoscale_decisions_total",
            "autoscale decisions by action",
        )
        self._m_spawn_s = reg.histogram(
            "dpathsim_autoscale_spawn_seconds",
            "transport start + ready wait per spawned worker",
        ).labels()

    # -- signal collection -------------------------------------------------

    def _shed_total(self) -> float:
        reg = get_registry()
        return (
            reg.counter(
                "dpathsim_router_requests_total",
                "router requests by outcome",
            ).labels(outcome="shed").value
            + reg.counter(
                "dpathsim_update_backpressure_total",
                "updates refused at the queue bound",
            ).labels().value
        )

    def _signals(self) -> dict:
        r = self.router
        with r._lock:
            up = [w for w in r.workers.values() if w.status == UP]
            draining = [
                w.wid for w in r.workers.values() if w.status == DRAINING
            ]
            depths = [w.queue_depth for w in up]
            up_ids = sorted(w.wid for w in up)
            pending = len(r._pending)
        shed_now = self._shed_total()
        shed_delta = (
            shed_now - self._shed_prev
            if self._shed_prev is not None else 0.0
        )
        self._shed_prev = shed_now
        burning = sorted(
            name for name, s in r.slo.snapshot().items()
            if s.get("status") == "burning"
        )
        limit = max(r.config.worker_queue_limit, 1)
        mean_depth = (sum(depths) / len(depths)) if depths else 0.0
        return {
            "up": up_ids,
            "draining": draining,
            "mean_queue_depth": round(mean_depth, 2),
            "queue_frac": round(mean_depth / limit, 4),
            "pending_per_worker": round(pending / max(len(up), 1), 2),
            "shed_delta": int(shed_delta),
            "burning_slos": burning,
        }

    # -- the loop ----------------------------------------------------------

    def tick(self) -> dict:
        """Evaluate once, maybe act; returns (and logs) the decision
        record. Deterministic: the record is a pure function of the
        observed signal sequence and the config thresholds."""
        cfg = self.config
        self._tick_n += 1
        self.router.reap_workers()
        sig = self._signals()
        n_up = len(sig["up"])
        self._m_workers.set(n_up)
        high = (
            sig["queue_frac"] >= cfg.queue_high_frac
            or sig["pending_per_worker"] >= cfg.pending_high
            or sig["shed_delta"] >= cfg.shed_high
            or (cfg.burn_high and bool(sig["burning_slos"]))
        )
        low = (
            sig["queue_frac"] <= cfg.queue_low_frac
            and sig["pending_per_worker"] <= cfg.pending_low
            and sig["shed_delta"] == 0
            and not sig["burning_slos"]
        )
        self._hi = self._hi + 1 if high else 0
        self._lo = self._lo + 1 if low else 0
        in_cooldown = (
            self._tick_n - self._last_action_tick < cfg.cooldown_ticks
        )
        action, reason = "hold", "signals within band"
        if sig["draining"]:
            reason = f"drain of {sig['draining']} still settling"
        elif in_cooldown:
            reason = "cooldown"
        elif (
            self._hi >= cfg.up_consecutive
            and n_up < cfg.max_workers
        ):
            action, reason = "spawn", (
                f"{self._hi} consecutive high ticks "
                f"(queue_frac={sig['queue_frac']}, "
                f"pending={sig['pending_per_worker']}, "
                f"shed={sig['shed_delta']}, "
                f"burning={sig['burning_slos']})"
            )
        elif self._hi >= cfg.up_consecutive:
            reason = f"high but at max_workers={cfg.max_workers}"
        elif (
            self._lo >= cfg.down_consecutive
            and n_up > cfg.min_workers
        ):
            action, reason = "drain", (
                f"{self._lo} consecutive low ticks"
            )
        record = {
            "tick": self._tick_n,
            "action": action,
            "reason": reason,
            "signals": sig,
            "workers": n_up,
        }
        if action == "spawn":
            record["spawned"] = self._spawn(record)
        elif action == "drain":
            record["drained"] = self._drain(sig["up"])
        if action != "hold":
            self._last_action_tick = self._tick_n
            self._hi = self._lo = 0
        self._m_decisions.inc(action=action)
        self.decisions.append(record)
        del self.decisions[:-cfg.decision_log_limit]
        runtime_event(
            "autoscale_decision", echo=(action != "hold"), **{
                k: v for k, v in record.items() if k != "signals"
            },
            **{f"sig_{k}": v for k, v in record["signals"].items()},
        )
        return record

    def _spawn(self, record: dict) -> str | None:
        wid = f"w{self._wid_next}"
        self._wid_next += 1
        t0 = time.perf_counter()
        transport = None
        try:
            transport = self.factory(wid)
            self.router.add_worker(
                wid, transport,
                ready_timeout=self.config.ready_timeout_s,
            )
        except Exception as exc:
            record["spawn_error"] = repr(exc)
            runtime_event("autoscale_spawn_failed", worker_id=wid,
                          error=repr(exc))
            # the transport may already be STARTED (add_worker starts
            # it before validating): reap the child, or every failed
            # spawn attempt leaks one worker process
            if transport is not None:
                try:
                    transport.close()
                except Exception:
                    pass
            return None
        self._m_spawn_s.observe(time.perf_counter() - t0)
        return wid

    def _drain(self, up_ids: list) -> str | None:
        if not up_ids:
            return None
        # deterministic victim: the highest-numbered live replica
        # (never the seed workers first, never ambiguous)
        def sort_key(wid: str):
            m = re.fullmatch(r"w(\d+)", wid)
            return (int(m.group(1)) if m else -1, wid)

        victim = max(up_ids, key=sort_key)
        return victim if self.router.remove_worker(victim) else None

    # -- timer mode (the CLI) ----------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="pathsim-autoscale", daemon=True,
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.eval_interval_s):
            try:
                self.tick()
            except Exception as exc:  # keep ticking; report
                runtime_event("autoscale_tick_error", error=repr(exc))

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def snapshot(self) -> dict:
        return {
            "ticks": self._tick_n,
            "decisions": self.decisions[-32:],
            "config": dataclasses.asdict(self.config),
        }
