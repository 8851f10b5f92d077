"""Exact rank-all on the dense backend past 2^24 (``exact_counts``, the
default): every value the correctly rounded f64 quotient 2·M / (d_i +
d_j) of the exact counts, ties to the lower column, as the upstream's
formula gives it. On the CPU the exact instances' plain versions run
(float64); they are held bit for bit, values and columns, against the
benchmark's two plain references (``gpubench/reference/pathsim_f64.py``
in NumPy, ``pathsim_torch_f64.py`` in torch) on seeded graphs with
prolific authors past 2^24 and one-paper authors whose identical rows
tie across rank k. The card's instances are held against these plain
versions by ``tests/test_torch_cuda_exact.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.driver import PathSimDriver
from distributed_pathsim_tpu_torch.obs import trace
from distributed_pathsim_tpu_torch.obs.trace import Tracer
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from gpubench import harness
from gpubench.reference import pathsim_f64, pathsim_torch_f64


def exact_graph(seed: int, n_venues: int = 5) -> dict:
    """A graph past 2^24 as the benchmark's generator returns one: three
    prolific authors over thousands of papers (their row sums pass 2^24),
    a few dozen mid authors, some beside them, and a few hundred
    one-paper authors spread over the venues, whose identical factor
    rows tie with each other across rank k."""
    rng = np.random.default_rng(seed)
    ap, pv = [], []

    def paper(authors, venue):
        p = len(pv)
        pv.append((p, venue))
        ap.extend((a, p) for a in sorted(set(authors)))

    for a, (count, home) in enumerate([(6000, 0), (4500, 1), (3000, 0)]):
        for _ in range(count):
            paper([a], home if rng.random() < 0.8 else
                  int(rng.integers(n_venues)))
    n_mid = 40
    for a in range(3, 3 + n_mid):
        for _ in range(int(rng.integers(3, 40))):
            coauthors = [a] + ([int(rng.integers(3))]
                               if rng.random() < 0.3 else [])
            paper(coauthors, int(rng.integers(n_venues)))
    n_one = 260
    for a in range(3 + n_mid, 3 + n_mid + n_one):
        paper([a], int(rng.integers(2)))
    ap_rows, ap_cols = (np.array(x, dtype=np.int32) for x in zip(*ap))
    pv_rows, pv_cols = (np.array(x, dtype=np.int32) for x in zip(*pv))
    order = np.lexsort((ap_cols, ap_rows))
    return {"authors": 3 + n_mid + n_one, "papers": len(pv),
            "venues": n_venues, "ap_rows": ap_rows[order],
            "ap_cols": ap_cols[order], "pv_rows": pv_rows,
            "pv_cols": pv_cols}


def _backend(g, **options):
    hin = harness.make_hin(g)
    return create_backend("torch", hin, compile_metapath("APVPA", hin.schema),
                          device="cpu", **options)


@pytest.mark.parametrize("k", [10, 20])
@pytest.mark.parametrize("seed", [11, 2**31 + 5])
def test_exact_rank_all_equals_both_references(seed, k):
    g = exact_graph(seed)
    refs = [mod.from_graph(g) for mod in (pathsim_f64, pathsim_torch_f64)]
    n = g["authors"]
    rows = np.arange(n)
    # the graph is what the test needs: row sums past 2^24, and rows
    # whose k-th and (k+1)-th exact scores tie
    assert float(refs[0].d.max()) >= 2.0**24
    ties = 0
    for r in rows:
        s = refs[0].scores(np.full(n, r), rows)
        top = np.sort(s)[::-1]
        ties += top[k - 1] == top[k]
    assert ties > 10
    b = _backend(g)
    assert b._exact_scores()
    vals, idxs = PathSimDriver(b).rank_all(k)
    assert vals.dtype == np.float64 and idxs.dtype == np.int64
    for ref in refs:
        want_v, want_i = ref.topk(rows, k)
        np.testing.assert_array_equal(vals, want_v)
        np.testing.assert_array_equal(idxs, want_i)
    np.testing.assert_array_equal(b.global_walks(), refs[0].d)


def _counting(monkeypatch, names):
    calls = {}
    for name in names:
        real = getattr(ck, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(ck, name, wrapped)
    return calls


def test_dispatch_takes_the_exact_instances_past_2_24_only(monkeypatch):
    """Past 2^24 exact counts rank on the exact instances (K1 + pass 2
    for k <= 16, K4 past it, and past K1's budget, which counts 12-byte
    candidates), with f64 values for either score variant; below 2^24,
    and under --approx, the f32 kernels as before."""
    names = ("fused_topk_twopass_exact", "fused_topk_exact",
             "fused_topk_twopass", "fused_topk")
    calls = _counting(monkeypatch, names)
    g = exact_graph(3)
    b = _backend(g)
    for k in (10, 20):
        assert b.topk(k=k)[0].dtype == np.float64
    assert b.topk(k=10, variant="diagonal")[0].dtype == np.float64
    assert calls == {"fused_topk_twopass_exact": 2, "fused_topk_exact": 1}
    calls.clear()
    monkeypatch.setattr(ck, "twopass_fits",
                        lambda n, k, device, v, exact=False: not exact)
    b.topk(k=10)
    assert calls == {"fused_topk_exact": 1}
    calls.clear()
    _backend(g, exact_counts=False).topk(k=10)
    small = dict(g, ap_rows=g["ap_rows"][g["ap_rows"] >= 3],
                 ap_cols=g["ap_cols"][g["ap_rows"] >= 3])
    low = _backend(small)
    assert not low._exact_scores()
    assert low.topk(k=10)[0].dtype == np.float32
    assert calls == {"fused_topk_twopass": 2}



def test_a_delta_across_2_24_switches_rank_all_between_the_kernels(
        monkeypatch):
    """Rank-all follows the graph's counts through deltas: a delta that
    lifts row sums past 2^24 moves it onto the exact instances (f64
    values, bit for bit the f64 reference of the patched graph), and its
    inverse back onto the f32 kernels (bit for bit a rebuilt backend).
    ``check_delta`` refuses the crossing plan, as a service asks it to:
    its single-source rows carry counts in f32."""
    from distributed_pathsim_tpu_torch.data import delta as tdl

    calls = _counting(monkeypatch, ("fused_topk_twopass_exact",
                                    "fused_topk_twopass"))
    g = exact_graph(5)
    prolific = g["ap_rows"] < 3
    low = dict(g, ap_rows=g["ap_rows"][~prolific],
               ap_cols=g["ap_cols"][~prolific])
    hin = harness.make_hin(low)
    mp = compile_metapath("APVPA", hin.schema)
    b = create_backend("torch", hin, mp, device="cpu")
    before = b.topk(k=10)
    assert not b._exact_scores() and before[0].dtype == np.float32
    adds = np.stack([g["ap_rows"][prolific], g["ap_cols"][prolific]], 1)
    fwd = tdl.plan_delta(hin, tdl.DeltaBatch(
        edges=(tdl.edge_delta("author_of", add=adds.tolist()),)), mp,
        max_delta_fraction=100.0)
    assert not fwd.fallback
    with pytest.raises(OverflowError, match="2\\^24"):
        b.check_delta(fwd)
    b.apply_delta(fwd)
    assert b._exact_scores()
    vals, idxs = PathSimDriver(b).rank_all(10)
    want_v, want_i = pathsim_f64.from_graph(g).topk(np.arange(g["authors"]),
                                                   10)
    np.testing.assert_array_equal(vals, want_v)
    np.testing.assert_array_equal(idxs, want_i)
    back = tdl.plan_delta(fwd.hin_new, tdl.DeltaBatch(
        edges=(tdl.edge_delta("author_of", remove=adds.tolist()),)), mp,
        max_delta_fraction=100.0)
    b.apply_delta(back)
    assert not b._exact_scores()
    after = b.topk(k=10)
    assert after[0].dtype == np.float32
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])
    assert calls == {"fused_topk_twopass": 2, "fused_topk_twopass_exact": 1}

def test_exact_plain_versions_and_gates():
    """The exact wrappers' plain versions are K1 + pass 2's and K4's in
    float64; they take f64 denominators only; K1's candidate buffer
    counts 12 bytes a candidate for the exact instance; a backend whose
    row sums pass 2^52 refuses to rank."""
    g = exact_graph(5)
    ref = pathsim_f64.from_graph(g)
    c = torch.tensor(ref.c, dtype=torch.float32)
    d = torch.tensor(ref.d)
    for k in (1, 10, 16):
        got = ck.fused_topk_twopass_exact(c, d, k=k)
        want = ck.fused_topk_twopass_plain(c.double(), d, k=k)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    for mask_self in (True, False):
        got = ck.fused_topk_exact(c, d, k=40, mask_self=mask_self)
        want = ck.fused_topk_plain(c.double(), d, k=40, mask_self=mask_self)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    with pytest.raises(TypeError, match="float64 denominators"):
        ck.fused_topk_twopass_exact(c, d.float(), k=10)
    assert ck.candidate_bytes(1 << 20, 10, 64, "cpu", exact=True) * 8 == \
        ck.candidate_bytes(1 << 20, 10, 64, "cpu") * 12
    assert ck.twopass_fits(1 << 24, 16, "cpu", 64, exact=True)
    b = _backend(g)
    b.global_walks()
    b._rowsums = b._rowsums.copy()
    b._rowsums[0] = 2.0**52
    with pytest.raises(OverflowError, match="2\\^52"):
        b.topk(k=10)


def test_to_f64_passes_f64_values_as_they_are(monkeypatch):
    """The driver's cast leaves the exact path's f64 values and int64
    columns as they are, and its span records 0 bytes for them; f32
    values are cast (their bytes counted)."""
    t = Tracer()
    monkeypatch.setattr(trace, "_TRACER", t)
    t.configure(enabled=True)
    driver = PathSimDriver(_backend(exact_graph(7)))
    vals, idxs = np.zeros((4, 3)), np.zeros((4, 3), dtype=np.int64)
    out = driver._to_f64(vals, idxs)
    assert out[0] is vals and out[1] is idxs
    driver._to_f64(vals.astype(np.float32), idxs)
    spans = [s for s in t.spans() if s.name == "driver.to_f64"]
    assert [s.args["bytes"] for s in spans] == [0, vals.nbytes]


def test_deferred_span_arg_is_set_once_the_closing_event_completes(
        monkeypatch):
    """``Tracer.defer_arg``: a CPU tensor is read at once; a pending
    host copy becomes the arg where ``device_s`` is read, once the
    span's closing event has completed, and never before."""
    t = Tracer()
    monkeypatch.setattr(trace, "_TRACER", t)
    t.configure(enabled=True)
    with t.span("x") as span:
        t.defer_arg(span, "n", torch.tensor([5]))
    assert span.args["n"] == 5
    t.defer_arg(None, "n", torch.tensor([5]))  # a span sampled out

    class Event:
        done = False

        def query(self):
            return self.done

        def elapsed_time(self, other):
            return 2.0

    start, end = Event(), Event()
    span = t.start_span(trace.PASS2_SPAN)
    span._events = (start, end)
    span._deferred = {"f64_scores": torch.tensor([123])}
    assert span.device_s is None and "f64_scores" not in span.args
    end.done = True
    assert span.device_s == 0.002 and span.args["f64_scores"] == 123
