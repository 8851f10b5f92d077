"""A checkout of the benchmark at test size: the repository's
``BENCHMARK.json`` and ``gpubench/`` copied, with configurations and cells
added by files and entries alone, as a later change would add them."""

from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]

# name → (graph, backend, backend options); the counts of these
# graphs stay below 2^24, so the port's plain versions are exact in f32
TINY = {
    "tinydense": ({"authors": 500, "papers": 900, "venues": 12},
                  "torch", {"exact_counts": True}),
    "tinysparse": ({"authors": 700, "papers": 1500, "venues": 8},
                   "torch-sparse",
                   {"tile_rows": 128, "exact_counts": False,
                    "rect_kernel": True}),
}


def make_root(tmp: pathlib.Path, mixes=("rank-all.k10",)) -> pathlib.Path:
    """Copy the benchmark into ``tmp`` and add the TINY configurations,
    each under every mix in ``mixes``; returns the new root."""
    shutil.copytree(REPO / "gpubench", tmp / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, (graph, backend, opts) in TINY.items():
        cfg = json.loads((REPO / "gpubench/configs/dblp32k.json").read_text())
        cfg.update(name=name, graph={**graph, "authors_per_paper": 1.3},
                   backend=backend, backend_options=opts)
        (tmp / f"gpubench/configs/{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({
            "name": name, "source": "test", "reduced": [], "why": "test",
            "file": f"gpubench/configs/{name}.json"})
        for mix in mixes:
            spec["workloads"].append({
                "name": f"{name}.{mix}", "config": name, "traffic": mix,
                "chips": 1, "why": "test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
