"""`BENCHMARK.json` and the files it names, found by name.

- a configuration: the file its `configs` entry names;
- a traffic mix: `benchmark/traffic/<traffic>.json`;
- a cell's limits: `benchmark/limits/<workload>.json`;
- a metric's reader: `benchmark/metrics/<metric>.py`, whose `read(ctx)`
  returns the value, or None where it finds nothing to read.

A cell reports every end-to-end metric that lists it under `workloads` or
has no such list, and every per-layer metric that lists it, or, without a
list, that moves an end-to-end metric the cell reports. Adding a cell, a
configuration, a mix or a metric is adding files and entries: nothing
here names one.
"""

from __future__ import annotations

import copy
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def merged(base: dict, over: dict) -> dict:
    """`base` with `over`'s keys set, nested dicts merged key by key."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class Manifest:
    def __init__(self, doc: dict, root: Path = ROOT, here: Path = HERE):
        self.doc = doc
        self.root = root
        self.here = here
        self._readers: dict = {}

    @classmethod
    def load(cls, root: Path = ROOT, here: Path = HERE) -> "Manifest":
        with open(root / "BENCHMARK.json") as f:
            return cls(json.load(f), root, here)

    @staticmethod
    def _by_name(entries: list, name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._by_name(self.doc["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._by_name(self.doc["configs"], name, "configuration")
        with open(self.root / entry["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.here / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def limits(self, workload: str) -> dict:
        with open(self.here / "limits" / f"{workload}.json") as f:
            return json.load(f)["limits"]

    def metric(self, name: str) -> dict:
        return self._by_name(self.doc["end_to_end"] + self.doc["per_layer"], name, "metric")

    def end_to_end_names(self, workload: str) -> list:
        return [m["name"] for m in self.doc["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]

    def per_layer_names(self, workload: str) -> list:
        e2e = set(self.end_to_end_names(workload))
        return [m["name"] for m in self.doc["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, name: str):
        """`read` of `metrics/<name>.py` (a name may hold dots, so the file
        is loaded by path)."""
        if name not in self._readers:
            path = self.here / "metrics" / f"{name}.py"
            spec = importlib.util.spec_from_file_location(
                "benchmark_metric_" + name.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[name] = mod.read
        return self._readers[name]
