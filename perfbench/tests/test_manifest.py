"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by name."""
import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = ["command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"]
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(man):
    assert list(man) == TOP
    assert man["paths"] == ["perfbench"]
    assert man["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= man["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(man):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in man[key]]
    names += [w["traffic"] for w in man["workloads"]]
    names += [k for c in man["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    assert len({m["name"] for m in man["end_to_end"] + man["per_layer"]}) \
        == len(man["end_to_end"]) + len(man["per_layer"])
    for e in man["configs"] + man["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


def test_entry_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_every_cell_reports_what_it_needs(man):
    from perfbench.harness import bench
    e2e = {m["name"] for m in man["end_to_end"]}
    for w in man["workloads"]:
        mine = {m["name"] for m in bench.end_to_end(man, w["name"])}
        assert "setup_s" in mine and len(mine) >= 2
        layer = bench.per_layer(man, w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in e2e and m["moves"] in mine, m


def test_files_found_by_name(man):
    from perfbench.harness import bench
    for w in man["workloads"]:
        wl = bench.workload_file(w["name"])
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        assert (ROOT / "perfbench" / "drivers" / f"{wl['driver']}.py")\
            .exists()
        bench.config_file(man, w["config"])
        for m in bench.per_layer(man, w["name"]):
            assert callable(bench.load_module("metrics", m["name"]).read)
    files = [c["file"] for c in man["configs"]]
    assert len(set(files)) == len(files)


@pytest.mark.parametrize("cell", ["mamba2-2.7b.cpsl-train",
                                  "deepseek-v2-lite-16b.serve"])
def test_config_files_are_the_registry_models(cell):
    """The driver's ModelConfig from the file is the program's registry
    model with only the run's options changed, and the sizes the file
    states otherwise than the registry (mamba2's published vocabulary
    rows and norm eps)."""
    from perfbench.harness import bench
    from repro_torch.configs import registry
    man = bench.manifest()
    cfg = bench.config_file(man, bench.cell(man, cell)["config"])
    drv = bench.load_module("drivers", bench.workload_file(cell)["driver"])
    got = drv.port_config(cfg)
    base = registry.get(cfg["port_arch"])
    opts = {k: getattr(got, k) for k in ("dtype", "param_dtype", "remat",
                                         "loss_chunk", "ssd_impl",
                                         "attn_impl", "vocab_size",
                                         "norm_eps")}
    assert got == base.replace(**opts)
