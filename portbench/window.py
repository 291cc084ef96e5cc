"""The measured window and its statistics, frozen with the benchmark.

A window runs units of work (a frame, a projection, a call of frames)
back to back for at least the asked seconds; each unit is timed at its
end, which waits for the device.  A rate is all the work completed over
all the window's time, and a tail is a percentile over every unit.
"""

from __future__ import annotations

import math
import random
import time


def percentile(values, q: float) -> float:
    """The `q`-th percentile (0-100) of every value, linear between the
    two nearest ranks (numpy's default rule)."""
    data = sorted(values)
    if not data:
        raise ValueError("no values")
    pos = (len(data) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(data) - 1)
    return data[lo] + (data[hi] - data[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """All the work completed over all the window's seconds."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return work / seconds


class Reservoir:
    """A uniform sample of `size` items from a stream of unknown length,
    drawn from `seed` (the same seed and stream give the same sample)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.seen = 0
        self.items: list = []

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def run(unit, seconds: float, sync, clock=time.perf_counter):
    """Call `unit()` until `seconds` have passed since the start, each call
    ending on `sync()`.  Returns (window seconds, [seconds of each unit],
    [each unit's return value])."""
    sync()
    start = last = clock()
    durations, results = [], []
    while True:
        results.append(unit())
        sync()
        now = clock()
        durations.append(now - last)
        last = now
        if now - start >= seconds:
            return now - start, durations, results
