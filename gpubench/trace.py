"""The device trace of a ``--trace 1`` run, from ``torch.profiler``,
called from the benchmark's own files so that the yardstick stays here.

The profiler records the host's operations and annotations (the port's
tracer spans among them, through its ``device_annotations``) and the
card's operations: kernels, copies and sets. :func:`summarize` reduces
that to what the per-layer readers and the result's ``breakdown`` take:
the traced window, the seconds in which some device operation ran
(the union of their intervals), the kernels' time by name, and the idle
gaps by the host operation open at the time.
"""

from __future__ import annotations

import contextlib

WINDOW = "gpubench.window"


@contextlib.contextmanager
def profiled(enabled: bool):
    """A ``torch.profiler`` session over the window (host and card), or
    nothing. Yields the profiler (or None)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def _short(name: str) -> str:
    """A kernel's name without its arguments, and without its template
    arguments where those are long."""
    name = name.removeprefix("void ").split("(")[0].strip()
    return name.split("<")[0] if len(name) > 96 else name


def _union(intervals):
    """Merge [start, end) intervals; returns the sorted disjoint list."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _host_at(points, host_events):
    """For each point (sorted), the name of the innermost host event open
    there (the latest-starting one of one thread's nested events), or
    "host idle"."""
    names = []
    stack = []
    j = 0
    for p in points:
        while j < len(host_events) and host_events[j][0] <= p:
            s, e, name = host_events[j]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, name))
            j += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        names.append(stack[-1][2] if stack else "host idle")
    return names


def summarize(prof, top: int = 10) -> dict | None:
    """The trace's figures, in seconds: ``window_s``, ``busy_s`` (device
    operations' union inside the window), ``kernel_s`` (kernels' summed
    time), ``device_ops`` and ``idle_gaps`` (each the ``top`` largest
    [name, seconds] pairs), or None when the trace holds no window."""
    from torch.autograd import DeviceType

    events = prof.events()
    win = [e for e in events if e.name == WINDOW]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    thread = win[0].thread
    # host annotations (the port's spans, the window) are mirrored onto
    # the device's timeline; they are no device operation
    notes = {e.name for e in events if getattr(e, "is_user_annotation", 0)}
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if t <= w0 or s >= w1:
            continue
        if e.device_type == DeviceType.CUDA:
            if e.name not in notes:
                dev.append((max(s, w0), min(t, w1), _short(e.name)))
        elif e.thread == thread and e.name != WINDOW:
            host.append((s, t, e.name))
    busy = _union([(s, t) for s, t, _ in dev])
    by_op: dict[str, float] = {}
    kernel_us = 0.0
    for s, t, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (t - s)
        if not name.startswith(("Memcpy", "Memset")):
            kernel_us += t - s
    gaps = []
    edge = w0
    for s, t in busy + [[w1, w1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    host.sort()
    idle: dict[str, float] = {}
    mids = [(a + b) / 2 for a, b in gaps]
    for (a, b), name in zip(gaps, _host_at(mids, host)):
        idle[name] = idle.get(name, 0.0) + (b - a)

    def top_pairs(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(t - s for s, t in busy) / 1e6,
        "kernel_s": kernel_us / 1e6,
        "device_ops": top_pairs(by_op),
        "idle_gaps": top_pairs(idle),
    }
