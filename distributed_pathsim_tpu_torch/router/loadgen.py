"""Closed-loop load through a :class:`~.core.Router`: each client thread
sends its rows one ``topk`` at a time and waits for the answer.

The harness the router's smokes share (the CPU tests and the fleet
phase of ``chip_smoke.py``): it keeps every response, so the caller can
hold each answer against an oracle, and it keeps the ledger of the
zero-lost-request contract — a request that resolves with an error, or
is refused at admission, is counted, never dropped.
"""

from __future__ import annotations

import threading
import time

from .core import RouterShed


def run_router_clients(router, schedule, k: int,
                       timeout_s: float = 60.0) -> dict:
    """``schedule[c]`` is client ``c``'s rows. Returns the answers
    (``(row, response)`` in client order), the requests that failed
    (``lost``: error responses, admission sheds and client-side
    timeouts), the wall time and QPS, and the failover and hedge counts
    the responses carry."""
    answers: list[list] = [[] for _ in schedule]
    errors: list = []
    barrier = threading.Barrier(len(schedule) + 1)

    def client(ci: int, rows) -> None:
        barrier.wait()
        for r in rows:
            try:
                resp = router.request(
                    {"id": ci, "op": "topk", "row": int(r), "k": k},
                    timeout=timeout_s,
                )
            except (RouterShed, TimeoutError) as exc:
                errors.append({"row": int(r), "error": repr(exc)})
                continue
            if not resp.get("ok"):
                errors.append(resp)
                continue
            answers[ci].append((int(r), resp))

    threads = [
        threading.Thread(target=client, args=(ci, rows), daemon=True)
        for ci, rows in enumerate(schedule)
    ]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout_s * max(len(rows) for rows in schedule))
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise TimeoutError("a load client never finished")
    flat = [a for per in answers for a in per]
    return {
        "answers": flat,
        "queries": len(flat),
        "lost": len(errors),
        "errors": errors[:5],
        "wall_s": wall,
        "qps": len(flat) / wall if wall > 0 else float("inf"),
        "failover_affected": sum(
            1 for _, resp in flat if resp.get("failovers")
        ),
        "hedged": sum(1 for _, resp in flat if resp.get("hedged")),
    }
