"""``rank_all``: every author's top-k, one whole ``PathSimDriver.rank_all(k)``
a call, from one caller, each call ending with its [N, k] arrays on the
host. The mix gives ``k``.

Each call hands over the rows that :func:`gpubench.check.sample_rows`
draws from the seed; they are taken into buffers made before the port's
set-up and kept only where they differ from the last output kept, so that
the window leaves the port's host heap as the port alone would have it.
(A block that the harness kept on the heap's top would stop glibc from
giving the port's freed fetch buffers back to the system, and the port's
next fetch would find its pages already mapped: the harness would have
made the port faster.)
"""

from __future__ import annotations

import numpy as np

from gpubench import check


class Op:
    def __init__(self, mix: dict, cfg: dict, seed: int, seconds: float):
        self.k = int(mix["k"])
        self.n = int(cfg["graph"]["authors"])
        self.v = int(cfg["graph"]["venues"])
        self.rows = check.sample_rows(self.n, seed)
        shape = (self.rows.size, self.k)
        self.buf = (np.empty(shape), np.empty(shape, dtype=np.int64))
        self.first = (np.empty(shape), np.empty(shape, dtype=np.int64))
        self.outputs = []

    def bind(self, backend, driver):
        self.n = backend.n_sources
        k = self.k
        return lambda: driver.rank_all(k)

    def keep(self, output) -> None:
        vals, idxs = output
        buf_v, buf_i = self.buf
        kept = self.outputs
        try:
            np.take(vals, self.rows, axis=0, out=buf_v)
            np.take(idxs, self.rows, axis=0, out=buf_i)
        except (ValueError, TypeError, IndexError):  # another shape
            kept.append((np.asarray(vals)[self.rows],
                         np.asarray(idxs)[self.rows]))
            return
        if not kept:
            np.copyto(self.first[0], buf_v)
            np.copyto(self.first[1], buf_i)
            kept.append(self.first)
        elif not (np.array_equal(buf_v, kept[-1][0])
                  and np.array_equal(buf_i, kept[-1][1])):
            kept.append((buf_v.copy(), buf_i.copy()))

    def compare(self, reference, limits: dict, calls: int):
        return check.compare(self.outputs, self.rows, reference, self.k,
                             limits, calls)

    def record(self) -> dict:
        return {"n": self.n, "v": self.v, "k": self.k,
                "pairs_per_call": float(self.n) * (self.n - 1)}
