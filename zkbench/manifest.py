"""Find a cell's files by the names in BENCHMARK.json.

Under <root>/zkbench/: configs are the files BENCHMARK.json names; a traffic
mix is traffic/<traffic>.json; a configuration's "driver" is
drivers/<driver>.py; a metric is metrics/<metric>.py, a module with
read(ctx) -> number or None.  Drivers and metric readers are loaded from
their files, so a cell, a configuration or a metric is added by adding
files and entries, without editing any file that is there.
"""
from __future__ import annotations

import importlib.util
import json
import os

HARNESS = "zkbench"


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


_LOADED: dict[str, object] = {}


def _module(root: str, kind: str, name: str):
    """The module of <root>/zkbench/<kind>/<name>.py, loaded once per process."""
    path = os.path.abspath(os.path.join(root, HARNESS, kind, f"{name}.py"))
    if path not in _LOADED:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no {kind[:-1]} file {path}")
        spec = importlib.util.spec_from_file_location(f"{HARNESS}_{kind}_{name}".replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic, driver and metrics."""

    def __init__(self, root: str, bench: dict, name: str):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = by_name[name]
        cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
        with open(os.path.join(root, cfg_entry["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(root, HARNESS, "traffic", f"{w['traffic']}.json")) as f:
            self.traffic = json.load(f)
        if self.traffic.get("loop") != "closed" or int(self.traffic.get("clients", 0)) != 1:
            raise ValueError(f"traffic {w['traffic']}: the harness drives a closed loop of one client")
        self.driver = _module(root, "drivers", self.config["driver"])
        self.end_to_end = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
        self.readers = {m["name"]: _module(root, "metrics", m["name"]) for m in self.end_to_end + self.per_layer}
        self.chips = int(w["chips"])
