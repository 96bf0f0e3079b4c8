"""One run of one cell of the benchmark of ``repro_torch`` on the H100.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights drawn on the card from ``--seed``, the program's kernels
loaded or built, every shape of the cell warmed up, the first steps
driven for the check) is timed as ``setup_s``; then the window runs for
``--seconds``. With ``--trace 0`` the result carries the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from
the device trace, the host spans and the kernels' calls. After the
window the program's state is freed and the plain float32 reference
under ``perfbench/reference/`` decides ``correct``. The last line of
standard output is the result, one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error and the
result's last key.

Without a CUDA card (or with fewer cards than the cell asks for) the run
exits with 2 and prints no result; it never falls back to the CPU.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / _sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Run:
    """One run: its arguments, the cell's configuration and traffic, the
    record the per-layer readers get, and the driver's own state."""

    def __init__(self, seed, seconds, trace, device, cfg, traffic, rec):
        self.seed, self.seconds, self.trace = int(seed), float(seconds), \
            bool(trace)
        self.device, self.cfg, self.traffic, self.rec = device, cfg, \
            traffic, rec
        self.attempted = 0
        self.failed = 0
        self.min_calls = 1      # a serving window's least number of calls


def judge(checks) -> bool:
    """``correct``: every number compared, each (name, value, limit), is
    finite and within its limit. The control's readings are judged by the
    same rule (``control.py``)."""
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float = None,
            config: dict = None, traffic: dict = None) -> dict:
    """The run without the look for a card: set-up, window, per-layer
    readers, the check. ``config`` and ``traffic`` replace the cell's files
    (the tests run a cell at a small size on the CPU)."""
    import torch
    from perfbench.harness import bench
    from perfbench.harness.bench import log
    t_start = time.perf_counter() if t_start is None else t_start
    man = bench.manifest()
    entry = bench.cell(man, cell_name)
    wl = bench.workload_file(cell_name)
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{cell_name}.json names "
                         f"{wl['config']}/{wl['traffic']}, BENCHMARK.json "
                         f"{entry['config']}/{entry['traffic']}")
    cfg = config or bench.config_file(man, entry["config"])
    driver = bench.load_module("drivers", wl["driver"])
    rec = bench.Record(cfg, traffic or wl["params"])
    run = Run(seed, seconds, trace, torch.device(device), cfg, rec.traffic,
              rec)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    driver.prepare(run)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    if trace:
        from repro_torch import kernels
        kernels.observers.append(rec)
    try:
        e2e = driver.window(run)
    finally:
        if trace:
            kernels.observers.remove(rec)
    t_window = time.perf_counter()
    log(f"window {t_window - t_start - setup_s:.3f} s: {e2e}")
    on_card = run.device.type == "cuda"
    dev = {"platform": "gpu" if on_card else run.device.type,
           "kind": (torch.cuda.get_device_name(run.device) if on_card
                    else "cpu"),
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(run.device)
                                 if on_card else 0)}
    metrics = {}
    if trace:
        from perfbench.harness import trace as tr
        for s in rec.sessions:
            s.collect()
        dev["busy_s"] = sum(s.busy_s() for s in rec.sessions)
        dev["window_s"] = sum(s.wall_s for s in rec.sessions)
        for m in bench.per_layer(man, cell_name):
            value = bench.load_module("metrics", m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(e2e, setup_s=setup_s)
        for m in bench.end_to_end(man, cell_name):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    if on_card:
        dev["power_limit"] = _power_limit()

    t_check = time.perf_counter()
    checks = driver.verify(run)
    log(f"read-out {t_check - t_window:.3f} s, check "
        f"{time.perf_counter() - t_check:.3f} s")
    result = {"correct": judge(checks), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = tr.breakdown(rec.sessions)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    from perfbench.harness import bench
    chips = bench.cell(bench.manifest(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} card(s): no result",
              file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules {found} are loaded in the process: "
              "no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
