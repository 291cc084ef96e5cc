"""The benchmark's hygiene on the CPU: a cell's set-up loads neither JAX
nor the JAX package, nothing reports a device metric without a card, and
`BENCHMARK.json` keeps to its contract and finds every file it names."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_set_up_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, sys.argv[1])\n"
        "from pathlib import Path\n"
        "from portbench import harness, entries\n"
        "spec = harness.load_spec(Path(sys.argv[1]))\n"
        "for cell in ('splash256.run', 'splash256.project'):\n"
        "    files = harness.cell_files(spec, cell, Path(sys.argv[1]))\n"
        "    entry = entries.ENTRIES[files['traffic']['entry']](files['config'], files['traffic'], 5, 'cpu', (16, 16, 16))\n"
        "    assert entry.cfg.kernel_mode == 'torch'\n"
        "    entry.unit()\n"
        "print(harness.forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, env=env,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    forbidden, loaded = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    top = set(eval(loaded))
    assert "geometricmultigridpressuresolver_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "geometricmultigridpressuresolver_tpu"}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "geometricmultigridpressuresolver_tpu_torch_fake", sys)
    assert "geometricmultigridpressuresolver_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()


def test_no_device_metric_without_a_card():
    record = {"memory_peak_bytes": None, "correct": True, "attempted": 1, "failed": 0, "check": {}}
    with pytest.raises(RuntimeError):
        harness.result_line(SPEC, "splash256.run", record, False, 1)


def test_the_command_refuses_to_run_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "splash256.run", "--seed",
                          "2147483700", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


def test_names_units_and_texts_keep_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    for name in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in SPEC["workloads"]] + [c["why"] for c in SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]] + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(CELLS) // 4)


def test_every_per_layer_metric_is_reported_where_its_moves_metric_is():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        moves = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moves.get("workloads", CELLS), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = [m["name"] for m in harness.metrics_of(SPEC, cell, False)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert harness.metrics_of(SPEC, cell, True), cell


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_a_cell_names_is_there(cell):
    files = harness.cell_files(SPEC, cell, ROOT)
    assert files["traffic"]["entry"] in ("run", "project")
    assert set(files["limits"]) >= {"pressure_err", "velocity_err"}
    for m in harness.metrics_of(SPEC, cell, False) + harness.metrics_of(SPEC, cell, True):
        assert callable(harness.reader(m["name"]))
    config = next(c for c in SPEC["configs"] if c["name"] == files["cell"]["config"])
    assert config["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
    assert files["config"]["name"] == config["name"]


def test_paths_hold_the_command():
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    assert all(not p.startswith("/") and ".." not in p for p in SPEC["paths"])


def test_slowest_units_name_their_captures():
    assert harness.slowest([0.1, 0.5, 0.2], [0, 1, 1], n=2) == [[1, 0.5, 1], [2, 0.2, 0]]


def test_a_run_shot_starts_again_from_the_scene():
    from portbench import entries

    files = harness.cell_files(SPEC, "splash256.run", ROOT)
    traffic = dict(files["traffic"], shot_frames=2, checked=4)
    entry = entries.ENTRIES["run"](files["config"], traffic, 2**31 + 3, "cpu", (12, 12, 12))
    entry.start_sample()
    cold = [entry.unit()["iterations"][0] for _ in range(3)]
    starts = [prev[0] is entry.scene.phi for prev, _ in entry.sample.items]
    assert starts == [True, False, True]
    assert cold[2] == cold[0]
