"""The benchmark's frozen arithmetic: the roofline's bytes and operations,
the window's statistics, and the trace's reduction.  CPU only."""

import math
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import roofline, tracing, window  # noqa: E402


def test_bound_takes_the_larger_time():
    t, which = roofline.bound(3.35e12, 1.0)
    assert (t, which) == (1.0, "bytes")
    t, which = roofline.bound(1.0, 67e12 * 2)
    assert (t, which) == (2.0, "operations")


def test_active_bytes_reads_on_cells_and_writes_on_out_cells():
    assert roofline.active_bytes(10, (4, 2), 3, (8,)) == 10 * 6 + 3 * 8


@pytest.mark.parametrize("schedule,cells,band,dot,want", [
    ("rk", 10, 0, False, 16 * 10),
    ("bbbrkbbb", 10, 4, True, 16 * (6 * 4 + 10) + 2 * 10),
    ("j", 7, 0, False, 16 * 7),
])
def test_block_ops(schedule, cells, band, dot, want):
    assert roofline.block_ops(schedule, cells, band, dot) == want


def test_hierarchy_coarsens_by_any_child():
    mask = torch.zeros((8, 8, 8), dtype=torch.bool)
    mask[0, 0, 0] = True
    mask[5, 5, 5] = True
    mask[4, 4, 4] = True
    assert roofline.hierarchy(mask, 1) == [3, 2, 2, 1]
    assert roofline.hierarchy(mask, 3) == [3]


def test_hierarchy_of_an_odd_grid():
    mask = torch.ones((5, 3, 2), dtype=torch.bool)
    assert roofline.hierarchy(mask, 6) == [30, 6]


def test_vcycle_and_cg_bytes():
    d = {"solve": 4, "mg": 4, "ew": 2}
    moved, ops = roofline.vcycle_work([80, 10], d)
    # down 80*(4+6+4) + 80*8, restrict 80*4 + 10*4, prolong 10*4 + 80*4 + 80*4,
    # up 80*(4+4+6+4) + 80*4, the 10-DOF inverse 100*4 + 2*10*4
    assert moved == 80 * 14 + 640 + 320 + 40 + 40 + 320 + 320 + 80 * 18 + 320 + 400 + 80
    assert ops == 2 * 16 * 80 + 15 * 80 + 200
    moved, ops = roofline.cg_work(100, 4)
    assert moved == 100 * 4 * 6 + 100 * 4 * 2 + 100 * 4 * 4 + 100 * 4 * 2
    assert ops == (18 + 2 + 6) * 100


def test_solve_seconds_counts_one_more_vcycle_than_steps():
    d = {"solve": 4, "mg": 4, "ew": 2}
    levels = [6_000_000, 750_000, 94_000, 12_000, 1_500]
    vc, _ = roofline.vcycle_work(levels, d)
    cg, _ = roofline.cg_work(levels[0], 4)
    assert roofline.solve_seconds(12, levels, d) == pytest.approx((13 * vc + 12 * cg) / 3.35e12)
    assert roofline.solve_seconds(0, levels, d) == pytest.approx(vc / 3.35e12)


def test_projection_seconds_adds_the_right_hand_side_and_writeback():
    d = {"solve": 4, "mg": 4, "ew": 2}
    levels = [6_000_000, 750_000, 94_000, 12_000, 1_500]
    vc, _ = roofline.vcycle_work(levels, d)
    cg, _ = roofline.cg_work(levels[0], 4)
    fw, ops = roofline.field_work(levels[0], 4)
    # rhs: 3 velocities and 3 weights in, 1 out; writeback: 3 + 3 + 1 in, 3 out
    assert fw == levels[0] * 4 * (6 + 1 + 7 + 3)
    assert ops == 12 * levels[0]
    assert roofline.projection_seconds(12, levels, d) == pytest.approx((13 * vc + 12 * cg + fw) / 3.35e12)


@pytest.mark.parametrize("q", [0, 50, 95, 100])
def test_percentile_matches_numpy(q):
    values = [random.Random(i).random() for i in range(37)]
    assert window.percentile(values, q) == pytest.approx(float(np.percentile(values, q)))


def test_rate_is_all_work_over_all_time():
    assert window.rate(30, 10.0) == 3.0
    with pytest.raises(ValueError):
        window.rate(1, 0.0)


def test_reservoir_is_seeded_and_uniform():
    picks = []
    for seed in range(2000):
        r = window.Reservoir(2, seed)
        for i in range(10):
            r.offer(i)
        picks.extend(r.items)
    again = window.Reservoir(2, 7)
    for i in range(10):
        again.offer(i)
    first = window.Reservoir(2, 7)
    for i in range(10):
        first.offer(i)
    assert again.items == first.items
    counts = np.bincount(picks, minlength=10)
    assert counts.min() > 0.8 * 400 and counts.max() < 1.2 * 400


def test_window_runs_past_the_seconds_and_times_each_unit():
    now = [0.0]

    def clock():
        return now[0]

    def unit():
        now[0] += 0.3
        return "u"

    seconds, durations, results = window.run(unit, 1.0, lambda: None, clock)
    assert results == ["u"] * 4
    assert durations == pytest.approx([0.3] * 4)
    assert seconds == pytest.approx(1.2)
    assert math.fsum(durations) == pytest.approx(seconds)


def test_a_graph_launch_spans_its_first_to_its_last_operation():
    ids = np.array([5, 5, 7, 0, 9, 9])
    iv = np.array([[0, 10], [50, 60], [20, 30], [70, 75], [80, 90], [95, 99]])
    spans = tracing.launches(ids, iv, {5, 9, 11})
    assert sorted(spans.tolist()) == [[0, 60], [80, 99]]
    assert tracing.launches(ids, iv, set()).shape == (0, 2)


class FakeEvent:
    def __init__(self, name, cuda, corr, start, end):
        from torch.autograd import DeviceType

        self._v = (name, DeviceType.CUDA if cuda else DeviceType.CPU, corr, start, end - start)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]


def test_a_graph_launch_is_busy_across_its_untraced_body():
    events = [
        FakeEvent("cudaGraphLaunch", False, 9, 0, 2_000),
        FakeEvent("pre", True, 9, 1_000, 2_000),        # one graph launch: pre ...
        FakeEvent("body", True, 3, 40_000, 41_000),     # ... a body node under another id ...
        FakeEvent("post", True, 9, 90_000, 100_000),    # ... post
        FakeEvent("cudaLaunchKernel", False, 10, 99_000, 99_500),
        FakeEvent("copy", True, 10, 100_000, 101_000),  # an eager operation
        FakeEvent("wait", False, 0, 101_000, 201_000),  # the host waits
        FakeEvent("copy", True, 11, 200_000, 201_000),
        FakeEvent("replayed", True, 3, 300_000, 301_000),  # the stale id again: not a launch
    ]
    out = tracing.summarize(events)
    assert out["busy_s"] == pytest.approx((99_000 + 1_000 + 1_000 + 1_000) / 1e9)
    assert out["traced_busy_s"] == pytest.approx((1_000 + 1_000 + 10_000 + 1_000 + 1_000 + 1_000) / 1e9)
    assert out["graph_launches"] == 1 and out["graph_s"] == pytest.approx(99_000 / 1e9)
    assert out["device_events"] == 6
    assert out["idle_gaps"][0] == ["wait", pytest.approx(99_000 / 1e9)]
