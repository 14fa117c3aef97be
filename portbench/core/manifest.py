"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations, the
cells and the metrics.  Everything that belongs to one of them is a file of
its own under ``portbench/``, found by the name the manifest gives:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``, whose ``loop`` key names the
  general loop that reads it (``loops/<loop>.py``);
- a cell's correctness limits: ``limits/<workload>.json``;
- a per-layer metric: its reader, ``metrics/<metric>.py``.

A later change adds a cell, a configuration, a mix or a metric by adding such
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, List, Optional

from portbench.core.env import ROOT

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: str = ROOT, bench_dir: Optional[str] = None):
        self.root = root
        self.bench_dir = bench_dir or os.path.join(root, "portbench")
        path = os.path.join(root, "BENCHMARK.json")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no BENCHMARK.json at {root}")
        self.data = _load_json(path)

    # ------------------------------------------------------------- lookups --
    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _load_json(os.path.join(self.root, self.config_entry(name)["file"]))

    def traffic(self, name: str) -> dict:
        return _load_json(os.path.join(self.bench_dir, "traffic", name + ".json"))

    def limits(self, workload: str) -> Dict[str, float]:
        return _load_json(os.path.join(self.bench_dir, "limits", workload + ".json"))

    def loop(self, kind: str) -> ModuleType:
        return load_module(os.path.join(self.bench_dir, "loops", kind + ".py"),
                           f"portbench.loops.{kind}")

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(os.path.join(self.bench_dir, "metrics", name + ".py"),
                           "portbench_metric_" + re.sub(r"\W", "_", name))

    def end_to_end(self, workload: str) -> List[dict]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics whose readers find something in the cell:
        those that list it, and those without a list whose ``moves`` metric
        the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", ()) or
                ("workloads" not in m and m["moves"] in e2e)]


def load_module(path: str, name: str) -> ModuleType:
    """Import the Python file at ``path`` as module ``name``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------- checks --


def problems(manifest: Manifest) -> List[str]:
    """What in the manifest breaks the benchmark's rules or names a file
    that is not there (empty when all is well)."""
    d = manifest.data
    out: List[str] = []
    expected = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                "per_layer"}
    if set(d) != expected:
        out.append(f"top-level keys {sorted(d)} != {sorted(expected)}")
    for section, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                          ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for entry in d.get(section, []):
            if set(entry) != keys:
                out.append(f"{section} entry {entry.get('name')!r} has keys {sorted(entry)}")
    names = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    for group in (names, [w["name"] for w in d["workloads"]], [c["name"] for c in d["configs"]]):
        dup = {n for n in group if group.count(n) > 1}
        if dup:
            out.append(f"duplicate names {sorted(dup)}")
    for n in names + [w["name"] for w in d["workloads"]] + [c["name"] for c in d["configs"]]:
        if not NAME_RE.match(n):
            out.append(f"bad name {n!r}")
    e2e = {m["name"]: m for m in d["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in d["end_to_end"]:
        extra = set(m) - {"name", "unit", "better", "bound", "source", "workloads"}
        if extra:
            out.append(f"{m['name']}: extra keys {sorted(extra)}")
        if m["source"] not in SOURCES_E2E:
            out.append(f"{m['name']}: end-to-end source {m['source']!r}")
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']} outside [0.01, 0.25]")
    layers_seen: Dict[str, str] = {}
    for m in d["per_layer"]:
        extra = set(m) - {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if extra:
            out.append(f"{m['name']}: extra keys {sorted(extra)}")
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: source {m['source']!r}")
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves {m['moves']!r}, not an end-to-end metric")
        for w in m.get("workloads", [w["name"] for w in d["workloads"]]):
            if m["moves"] not in {e["name"] for e in manifest.end_to_end(w)}:
                out.append(f"{m['name']}: cell {w!r} does not report {m['moves']!r}")
        layers_seen.setdefault(m["layer"].lower(), m["layer"])
        if layers_seen[m["layer"].lower()] != m["layer"]:
            out.append(f"layer {m['layer']!r} spelled two ways")
        reader = os.path.join(manifest.bench_dir, "metrics", m["name"] + ".py")
        if not os.path.isfile(reader):
            out.append(f"{m['name']}: no reader {reader}")
    for m in d["end_to_end"] + d["per_layer"]:
        if not UNIT_RE.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better {m['better']!r}")
    workloads = {w["name"] for w in d["workloads"]}
    for m in d["end_to_end"] + d["per_layer"]:
        for w in m.get("workloads", []):
            if w not in workloads:
                out.append(f"{m['name']}: unknown workload {w!r}")
    configs = {c["name"] for c in d["configs"]}
    used = {w["config"] for w in d["workloads"]}
    if configs - used:
        out.append(f"configurations no cell uses: {sorted(configs - used)}")
    pairs = [(w["config"], w["traffic"]) for w in d["workloads"]]
    if len(set(pairs)) != len(pairs):
        out.append("a (config, traffic) pair appears twice")
    four = sum(1 for w in d["workloads"] if w["chips"] == 4)
    if four > max(1, len(d["workloads"]) // 4):
        out.append(f"{four} cells on four chips")
    for w in d["workloads"]:
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips {w['chips']}")
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']!r}")
        if not 1 <= len(w["why"]) <= 200:
            out.append(f"{w['name']}: why has {len(w['why'])} characters")
        reports = {m["name"] for m in manifest.end_to_end(w["name"])}
        if "setup_s" not in reports or len(reports) < 2:
            out.append(f"{w['name']}: reports {sorted(reports)}")
        if not manifest.per_layer(w["name"]):
            out.append(f"{w['name']}: no per-layer metric")
        for path in (os.path.join(manifest.bench_dir, "traffic", w["traffic"] + ".json"),
                     os.path.join(manifest.bench_dir, "limits", w["name"] + ".json")):
            if not os.path.isfile(path):
                out.append(f"{w['name']}: missing {path}")
    for c in d["configs"]:
        if not os.path.isfile(os.path.join(manifest.root, c["file"])):
            out.append(f"{c['name']}: missing {c['file']}")
        if not c["file"].startswith(tuple(p.rstrip("/") + "/" for p in d["paths"])):
            out.append(f"{c['name']}: file outside paths")
    if not 1 <= int(d["run_seconds"]) <= 51:
        out.append(f"run_seconds {d['run_seconds']}")
    total = 2 + 14 * 24
    if total * (d["run_seconds"] + 60) + 24 * 2 * 90 + 1200 > 43200:
        out.append("run_seconds too long for 24 cells")
    return out
