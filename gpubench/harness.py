"""One run of one cell: inputs from the seed, the port's set-up, the
measured window, the trace, the comparison, the result line.

Everything a cell needs is found by name under ``<root>/gpubench/``:
the configuration (``BENCHMARK.json``'s ``configs[].file``), the traffic
mix (``traffic/<mix>.json``) and its generator (``ops/<op>.py``, by the
mix's ``op``), the plain reference (``reference/<name>.py``, by the
configuration's ``reference``) and each metric's reader
(``metrics/<metric>.py``), end-to-end and per-layer alike. Nothing here
knows a mix or a metric by name.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

from . import check, graph, trace

# Top-level module names that no process of the benchmark may hold: JAX
# and the JAX package (the port's name begins with the latter's, so names
# are compared whole).
BANNED = ("jax", "jaxlib", "flax", "optax", "distributed_pathsim_tpu")
PORT = "distributed_pathsim_tpu_torch"


def banned_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


class Bench:
    """``BENCHMARK.json`` of a checkout and the files it names."""

    def __init__(self, root):
        self.root = pathlib.Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return json.loads(
            (self.root / "gpubench" / "traffic" / f"{name}.json").read_text())

    def _load(self, kind: str, name: str):
        path = self.root / "gpubench" / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"gpubench_{kind}_{name}", path)
        if spec is None or not path.exists():
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reference(self, name: str):
        return self._load("reference", name)

    def reader(self, metric: str):
        return self._load("metrics", metric)

    def op(self, name: str):
        return self._load("ops", name)

    def read_metrics(self, kind: str, run: dict) -> dict:
        """Each ``end_to_end`` or ``per_layer`` metric that its reader
        finds in ``run``, as ``{name: {"value", "unit"}}``."""
        out = {}
        for m in self.spec[kind]:
            value = self.reader(m["name"]).read(run)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_state() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi: none"


def peaks_for(root, kind: str) -> dict | None:
    table = json.loads(
        (pathlib.Path(root) / "gpubench" / "peaks.json").read_text())
    for key, peaks in table.items():
        if not key.startswith("_") and key in kind:
            return peaks
    return None


def make_hin(g: dict):
    """The port's input: an ``EncodedHIN`` over the generator's arrays
    (copies, so that the reference's stay as drawn)."""
    from distributed_pathsim_tpu_torch.data.encode import (
        AdjacencyBlock, EncodedHIN, TypeIndex)
    from distributed_pathsim_tpu_torch.data.schema import HINSchema

    sizes = {"author": g["authors"], "paper": g["papers"],
             "venue": g["venues"]}
    rels = {"author_of": ("author", "paper"), "submit_at": ("paper", "venue")}
    blocks = {
        "author_of": AdjacencyBlock("author_of", "author", "paper",
                                    g["ap_rows"].copy(), g["ap_cols"].copy(),
                                    (g["authors"], g["papers"])),
        "submit_at": AdjacencyBlock("submit_at", "paper", "venue",
                                    g["pv_rows"].copy(), g["pv_cols"].copy(),
                                    (g["papers"], g["venues"])),
    }
    indices = {t: TypeIndex(t, (), (), {}, size_override=n)
               for t, n in sizes.items()}
    return EncodedHIN(HINSchema(tuple(sizes), rels), indices, blocks,
                      name="gpubench")


class Window:
    """The measured window. Its storage is made before the port's set-up,
    so that during the window the harness allocates nothing that lives on
    (the traffic generator's ``keep`` takes the outputs into storage of
    its own)."""

    def __init__(self, seconds: float):
        self.durations = np.empty(int(seconds * 4000) + 64)

    def run(self, call, keep, seconds: float):
        """Whole calls back to back until ``seconds`` have passed, each
        output handed to ``keep``. Returns (each call's seconds, failures,
        window seconds); the window ends with the last call's end."""
        durations = self.durations
        failed = []
        n = 0
        t_start = t1 = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            try:
                out = call()
            except Exception as exc:  # a call that never answers counts
                failed.append(f"{type(exc).__name__}: {exc}")
                t1 = time.perf_counter()
                break
            t1 = time.perf_counter()
            if n == durations.size:
                durations = np.concatenate([durations, np.empty(n)])
            durations[n] = t1 - t0
            n += 1
            keep(out)
            if t1 - t_start >= seconds:
                break
        return durations[:n], failed, t1 - t_start


def run_cell(root, cell_name: str, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", t_process: float | None = None) -> dict:
    """Run ``cell_name`` once and return the result record (the last line
    of a run's output). ``t_process`` is the perf_counter reading at the
    process's start, where set-up begins."""
    t_process = time.perf_counter() if t_process is None else t_process
    bench = Bench(root)
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    op = bench.op(mix["op"]).Op(mix, cfg, seed, seconds)
    win = Window(seconds)
    parts = {}

    t0 = time.perf_counter()
    import torch

    from distributed_pathsim_tpu_torch import tuning
    from distributed_pathsim_tpu_torch.backends.base import create_backend
    from distributed_pathsim_tpu_torch.driver import PathSimDriver
    from distributed_pathsim_tpu_torch.obs.trace import get_tracer
    from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
    from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
    from distributed_pathsim_tpu_torch.utils.compile_counter import (
        CompileCounter)

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()
        ck.true_f32()
    tuning.set_enabled(False)  # the port's defaults: no tuning table
    parts["import_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    g = graph.synthetic_coo(cfg["graph"], seed, device)
    hin = make_hin(g)
    parts["graph_s"] = time.perf_counter() - t0

    tracer = get_tracer()
    tracer.configure(enabled=trace_on, device_annotations=trace_on)
    t0 = time.perf_counter()
    backend = create_backend(cfg["backend"], hin,
                             compile_metapath(cfg["metapath"], hin.schema),
                             device=device, **cfg.get("backend_options", {}))
    backend.global_walks()
    if on_card:
        torch.cuda.synchronize()
    parts["backend_init_s"] = time.perf_counter() - t0
    driver = PathSimDriver(backend)
    call = op.bind(backend, driver)

    t0 = time.perf_counter()
    call()
    parts["warm_call_s"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_process
    log("setup: " + ", ".join(f"{a} {b:.4f}" for a, b in parts.items())
        + f"; setup_s {setup_s:.4f}")

    init_spans = [sp.duration_s for sp in tracer.spans()
                  if sp.name == "backend.init"]
    ck.reset_launches()
    tracer.clear()
    with CompileCounter() as compiles, trace.profiled(trace_on) as prof:
        import torch.profiler as tp

        with tp.record_function(trace.WINDOW):
            durations, failed, window_s = win.run(call, op.keep, seconds)
    launches = {a: b for a, b in ck.LAUNCHES.items() if b}
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    calls = len(durations)
    log(f"window: {calls} calls in {window_s:.4f} s, {len(failed)} failed, "
        f"{compiles.count} builds or loads, launches {launches}")
    if calls:
        q = np.percentile(durations, [0, 50, 95, 100]) * 1e3
        log("call ms: min {:.4f}, median {:.4f}, p95 {:.4f}, max {:.4f}"
            .format(*q))
    for f in failed:
        log(f"failed call: {f}")

    run = {**op.record(), "calls": calls, "window_s": window_s,
           "durations": durations, "setup_s": setup_s, **parts,
           "trace": None, "peaks": None}
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    breakdown = None
    if prof is not None:
        run["trace"] = trace.summarize(prof)
        run["peaks"] = peaks_for(root, kind)
        if run["trace"]:
            breakdown = {"device_ops": run["trace"]["device_ops"],
                         "idle_gaps": run["trace"]["idle_gaps"]}
    tracer.configure(enabled=False, device_annotations=False)

    # the program's state goes before the reference runs
    del driver, backend, hin, prof, call
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reference = bench.reference(cfg["reference"]).from_graph(g)
    checks, gaps = op.compare(reference, cfg["limits"], calls)
    log(f"reference: {time.perf_counter() - t0:.2f} s; "
        + ", ".join(f"{a} {b!r}" for a, b in gaps.items()))

    metrics = bench.read_metrics("per_layer" if trace_on else "end_to_end",
                                 run)
    device_rec = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                  "count": 1, "memory_peak_bytes": int(memory_peak)}
    if trace_on and run["trace"]:
        device_rec["busy_s"] = run["trace"]["busy_s"]
        device_rec["window_s"] = run["trace"]["window_s"]
    if on_card:
        log(f"card: {card_state()}")
    if init_spans:
        log(f"backend.init span {init_spans[0]:.4f} s")
    result = {
        "correct": not failed and check.passed(checks),
        "attempted": calls + len(failed),
        "failed": len(failed),
        "metrics": metrics,
        "device": device_rec,
        "launches": launches,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check_parts"] = gaps
    result["checks"] = checks
    return result
