"""The benchmark's core: one cell, run once, reported as one JSON line.

    python3 portbench/run.py --workload splash256.run --seed 7 --seconds 51 --trace 0

A cell of `BENCHMARK.json` names a configuration (`configs/<name>.json`)
and a traffic mix (`traffic/<name>.json`, driven by `entries.py`); its
correctness limits are `limits/<cell>.json`, and every metric is read by
its own module, `metrics/<metric>.py`, from the run's record.  Adding a
cell, a mix, a configuration or a metric adds files and entries and edits
none of these.

A run: the configuration's scene made on the card from the seed; the
entry's warm-up (kernels built or loaded, programs captured); the window,
`--seconds` of units back to back; with `--trace 1` the profiler and the
host-sync count over the window.  Then the peak memory is read, the
program's state freed, and the sample of the window's units held against
the plain reference.  The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "geometricmultigridpressuresolver_tpu"}


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(spec: dict, workload: str, root: Path) -> dict:
    """The cell's entry, configuration, traffic mix and limits."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return {
        "cell": cell,
        "config": json.loads((root / config["file"]).read_text()),
        "traffic": json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((HERE / "limits" / f"{workload}.json").read_text()),
    }


def metrics_of(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: end-to-end without the trace,
    per-layer with it; each applies to the cells in its `workloads`, or to
    every cell."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The `read(record)` function of `metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(sys.modules)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_line() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def run_cell(files: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             grid=None, control: bool = False) -> dict:
    """Run the cell once on `device` and check it.  Returns the record the
    metric readers read, with the check's readings (and the control's,
    with `control`).  `grid` replaces the configuration's grid (a small
    rehearsal off the card)."""
    import torch

    from portbench import check, entries, roofline, tracing, window
    from geometricmultigridpressuresolver_tpu_torch.solver import graph

    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    traffic = files["traffic"]
    entry = entries.ENTRIES[traffic["entry"]](files["config"], traffic, seed, device, grid)
    for _ in range(traffic["warm_units"]):
        entry.unit()
    entry.start_sample()
    graph.STATS.reset()
    stats = graph.STATS
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    sync()
    # The set-up's objects are kept out of the collector's passes in the
    # window, so that its pauses follow the window's own allocations.
    gc.collect()
    gc.freeze()
    retries = torch.cuda.memory_stats(device).get("num_alloc_retries", 0) if on_card else 0
    pauses = GcPauses()
    captured = []

    def unit():
        out = entry.unit()
        captured.append(sum(stats.program_captures.values()) + stats.frame_captures)
        return out

    setup_s = time.perf_counter() - t_start
    tracer = tracing.Trace(on_card) if trace else None
    with pauses:
        if tracer is not None:
            with tracer:
                window_s, durations, units = window.run(unit, seconds, sync)
        else:
            window_s, durations, units = window.run(unit, seconds, sync)
    gc.unfreeze()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else None
    record = {
        "entry": traffic["entry"], "setup_s": setup_s, "window_s": window_s, "unit_seconds": durations,
        "units": len(units), "attempted": sum(u.get("frames", u.get("projections", 0)) for u in units),
        "failed": sum(u["failed"] for u in units),
        "frames": sum(u.get("frames", 0) for u in units) or None,
        "projections": sum(u.get("projections", 0) for u in units) or None,
        "dofs": [u["dofs"] for u in units if "dofs" in u],
        "iterations": [i for u in units for i in u["iterations"]],
        "stage_seconds": {k: [u["seconds"][k] for u in units] for k in ("advect", "setup", "project")}
        if units and "seconds" in units[0] else None,
        "program_captures": sum(stats.program_captures.values()),
        "frame_captures": stats.frame_captures,
        "capture_s": sum(stats.program_capture_seconds.values()) + stats.frame_capture_seconds
        + stats.frame_instantiate_seconds,
        "memory_peak_bytes": memory_peak,
        "host_syncs": tracer.host_syncs if tracer is not None else None,
        "trace": None,
        "slowest_units": slowest(durations, captured),
        "alloc_retries": (torch.cuda.memory_stats(device).get("num_alloc_retries", 0) - retries) if on_card else 0,
        "gc_pauses": pauses.count, "gc_s": pauses.seconds,
    }
    if tracer is not None:
        t0 = time.perf_counter()
        record["trace"] = tracer.summary()
        record["trace"]["read_s"] = time.perf_counter() - t0
    if traffic["entry"] == "project":
        s = files["config"]["solver"]
        sizes = {k: roofline.DTYPE_BYTES[s[f"{k}_dtype"]] for k in ("solve", "mg", "mg_ew")}
        dtypes = {"solve": sizes["solve"], "mg": sizes["mg"], "ew": sizes["mg_ew"]}
        record["project_least_s"] = sum(roofline.projection_seconds(i, entry.levels, dtypes)
                                        for i in record["iterations"])
    # The program's state goes before the reference runs.
    entry.release()
    graph.PROGRAMS.clear()
    del units
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    record["readings"] = entry.check()
    record["check_s"] = time.perf_counter() - t0
    if control:
        record["control_readings"] = entry.check(control=True)
    record["correct"], record["check"] = check.judge(record["readings"], files["limits"])
    return record


class GcPauses:
    """The collector's passes while the block runs: how many, and their
    seconds."""

    def __init__(self):
        self.count, self.seconds, self._t = 0, 0.0, None

    def _callback(self, phase, info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.count += 1
            self.seconds += time.perf_counter() - self._t
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)
        return False


def slowest(durations, captured, n: int = 3) -> list:
    """The `n` slowest units: [index, seconds, captures the unit made]."""
    order = sorted(range(len(durations)), key=lambda i: -durations[i])[:n]
    return [[i, durations[i], captured[i] - (captured[i - 1] if i else 0)] for i in order]


def result_line(spec: dict, workload: str, record: dict, trace: bool, chips: int) -> dict:
    """The result's JSON object.  Only a run on the card reports device
    metrics."""
    import torch

    if not torch.cuda.is_available() or record["memory_peak_bytes"] is None:
        raise RuntimeError("no CUDA device: a device metric is never reported from another device")
    metrics = {}
    for m in metrics_of(spec, workload, trace):
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    card = card_line()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": record["memory_peak_bytes"],
              "power_limit": card.split(",")[-1].strip() if card else None}
    line = {"correct": record["correct"], "attempted": record["attempted"], "failed": record["failed"],
            "metrics": metrics, "device": device}
    if trace and record["trace"] is not None:
        device["busy_s"] = record["trace"]["busy_s"]
        device["window_s"] = record["window_s"]
        line["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                             "idle_gaps": record["trace"]["idle_gaps"]}
    line["check"] = record["check"]
    return line


def main(argv, t_start: float) -> int:
    parser = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path.cwd()
    spec = load_spec(root)
    files = cell_files(spec, args.workload, root)
    chips = files["cell"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 3
    record = run_cell(files, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    line = result_line(spec, args.workload, record, bool(args.trace), chips)
    extra = {"check_s": record["check_s"], "units": record["units"], "capture_s": record["capture_s"],
             "captures": record["program_captures"] + record["frame_captures"],
             "median_unit_s": sorted(record["unit_seconds"])[len(record["unit_seconds"]) // 2],
             "slowest_units": record["slowest_units"], "alloc_retries": record["alloc_retries"],
             "gc_pauses": record["gc_pauses"], "gc_s": record["gc_s"],
             "label_flips": record["readings"].get("label_flips"),
             **{k: (record["trace"] or {}).get(k) for k in
                ("read_s", "device_events", "traced_busy_s", "graph_s", "graph_launches")},
             "card": card_line()}
    print(f"portbench: {json.dumps(extra)}", file=sys.stderr)
    for name, c in record["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
