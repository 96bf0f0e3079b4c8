"""The manifest and the record of one run.

``BENCHMARK.json`` names the cells; each cell's configuration file, its
workload file (``workloads/<cell>.json``: the driver and the traffic's
parameters), its driver (``drivers/<driver>.py``) and each per-layer
metric's reader (``metrics/<metric>.py``) are found by name, so a new
configuration, mix or metric is a new file.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


def log(msg: str):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in man['workloads']]}")


def config_file(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def workload_file(name: str) -> dict:
    return json.loads((BENCH / "workloads" / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{path} not found: a {kind[:-1]} is found "
                                "by its name in BENCHMARK.json")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(man: dict, cell_name: str) -> list:
    """The cell's end-to-end metrics: those listing it, or listing no
    cells."""
    return [m for m in man["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(man: dict, cell_name: str) -> list:
    """The cell's per-layer metrics: those listing it, or, listing no
    cells, those whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(man, cell_name)}
    return [m for m in man["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


class Record:
    """What a run hands the per-layer readers: host spans, counters, the
    hand-written kernels' calls (shapes only, from
    ``repro_torch.kernels.observers``), the trace sessions, and the
    configuration and traffic of the cell."""

    def __init__(self, cfg: dict, traffic: dict):
        self.cfg, self.traffic = cfg, traffic
        self.spans = {}
        self.counters = {}
        self.calls = []
        self.sessions = []
        self.phase = ""

    def span(self, name: str, seconds: float):
        self.spans.setdefault(name, []).append(seconds)

    def count(self, name: str, n: float = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    # the observer interface of repro_torch.kernels.record_call
    def custom_call(self, name, operands, results):
        def spec(t):
            return (tuple(t.shape), t.element_size())
        self.calls.append((self.phase, name,
                           [spec(t) for t in operands],
                           [spec(t) for t in results]))

    def sessions_of(self, phase: str):
        return [s for s in self.sessions if s.phase == phase]

    def calls_of(self, phase: str, name: str):
        return [c for c in self.calls if c[0] == phase and c[1] == name]
