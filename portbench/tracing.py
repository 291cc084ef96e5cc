"""The traced run's readings: the device's busy intervals from the
profiler's trace, the operations that took most device time, the longest
idle gaps by what the host was doing, and the host syncs the program made
(`torch.cuda.set_sync_debug_mode`, as the repo's `chip_smoke.count_syncs`
counts them).

The profiler does not see every operation of a captured CUDA graph: most
kernels inside a conditional (WHILE/IF) body are missing from its trace,
and those it sees, like the replayed nodes of a graph captured while it
traced, can carry another launch's correlation id.  A graph launch runs
on the device from its first node to its last with no host in between,
so each graph launch (the device operations whose correlation id is that
of a host `cudaGraphLaunch`) counts as busy from its first traced
operation's start to its last one's end, and the gaps inside it are not
idle; every other operation counts for its own interval."""

from __future__ import annotations

import collections
import contextlib
import warnings

import numpy as np

TOP = 10
GAPS_ATTRIBUTED = 500


def merged(intervals: np.ndarray) -> np.ndarray:
    """The union of [start, end] rows as disjoint rows, in order."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    first = np.ones(len(iv), dtype=bool)
    first[1:] = iv[1:, 0] > ends[:-1]
    starts = np.flatnonzero(first)
    last = np.append(starts[1:] - 1, len(iv) - 1)
    return np.stack([iv[starts, 0], ends[last]], axis=1)


GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def launches(ids: np.ndarray, intervals: np.ndarray, graph_ids) -> np.ndarray:
    """Per graph launch (the rows whose correlation id is in `graph_ids`):
    [first start, last end]."""
    keep = np.isin(ids, np.asarray(sorted(graph_ids), dtype=np.int64))
    if not keep.any():
        return intervals[:0].reshape(0, 2)
    keys, inverse = np.unique(ids[keep], return_inverse=True)
    first = np.full(len(keys), np.iinfo(np.int64).max)
    last = np.full(len(keys), np.iinfo(np.int64).min)
    np.minimum.at(first, inverse, intervals[keep, 0])
    np.maximum.at(last, inverse, intervals[keep, 1])
    return np.stack([first, last], axis=1)


def summarize(events) -> dict:
    """busy seconds (each graph launch busy from its first operation to
    its last, every other operation for its own interval), the graph
    launches' seconds and count, the traced operations' own union, and the
    breakdown, from the profiler's kineto events (each with `name()`,
    `device_type()`, `correlation_id()`, `start_ns()`, `duration_ns()`)."""
    from torch.autograd import DeviceType

    dev_names, dev_iv, dev_ids, cpu_names, cpu_iv, graph_ids = [], [], [], [], [], set()
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev_names.append(e.name())
            dev_iv.append((start, start + dur))
            dev_ids.append(e.correlation_id())
        else:
            if e.name() in GRAPH_LAUNCHES:
                graph_ids.add(e.correlation_id())
            if dur > 0:
                cpu_names.append(e.name())
                cpu_iv.append((start, start + dur))
    dev_iv = np.asarray(dev_iv, dtype=np.int64).reshape(-1, 2)
    graphs = launches(np.asarray(dev_ids, dtype=np.int64), dev_iv, graph_ids)
    busy = merged(np.concatenate([dev_iv, graphs]))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9
    traced = merged(dev_iv)
    per_op = collections.Counter()
    for name, (s, e) in zip(dev_names, dev_iv):
        per_op[name] += (e - s) / 1e9
    gaps = np.stack([busy[:-1, 1], busy[1:, 0]], axis=1) if len(busy) > 1 else np.zeros((0, 2), np.int64)
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")][:GAPS_ATTRIBUTED]
    cpu_iv = np.asarray(cpu_iv, dtype=np.int64).reshape(-1, 2)
    by_host = collections.Counter()
    for s, e in gaps:
        mid = (s + e) // 2
        inside = np.flatnonzero((cpu_iv[:, 0] <= mid) & (cpu_iv[:, 1] >= mid))
        if len(inside):
            # the innermost host span over the gap's middle
            name = cpu_names[inside[np.argmin(cpu_iv[inside, 1] - cpu_iv[inside, 0])]]
        else:
            name = "(no host span)"
        by_host[name] += (e - s) / 1e9
    return {
        "busy_s": busy_s,
        "graph_s": float((graphs[:, 1] - graphs[:, 0]).sum()) / 1e9,
        "graph_launches": int(len(graphs)),
        "traced_busy_s": float((traced[:, 1] - traced[:, 0]).sum()) / 1e9,
        "device_events": len(dev_names),
        "device_ops": [[n, s] for n, s in per_op.most_common(TOP)],
        "idle_gaps": [[n, s] for n, s in by_host.most_common(TOP)],
    }


class Trace:
    """A profiler over the window, and the host syncs made in it (on the
    card; off it the profiler traces the host alone and no sync is
    counted)."""

    def __init__(self, on_card: bool):
        self.on_card = on_card

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._warnings = warnings.catch_warnings(record=True)
        self._caught = self._warnings.__enter__()
        warnings.simplefilter("always")
        activities = [ProfilerActivity.CPU]
        if self.on_card:
            torch.cuda.set_sync_debug_mode("warn")
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        with contextlib.ExitStack() as stack:
            stack.callback(self._warnings.__exit__, None, None, None)
            if self.on_card:
                stack.callback(torch.cuda.set_sync_debug_mode, "default")
                torch.cuda.synchronize()
            self._prof.__exit__(*exc)
        return False

    @property
    def host_syncs(self) -> int | None:
        if not self.on_card:
            return None
        return sum("called a synchronizing" in str(w.message) for w in self._caught)

    def summary(self) -> dict:
        return summarize(self._prof.profiler.kineto_results.events())
