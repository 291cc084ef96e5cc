"""The comparison that decides `correct`: relative L2 gaps between what
the timed path produced and the plain reference, each held to its limit."""

from __future__ import annotations

import math

import torch


def gap(got, want) -> float:
    """||got - want|| / ||want|| over every element, in float64; `got` and
    `want` are tensors or sequences of tensors (the three MAC components)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    diff = sum(float((g.double() - w.double()).square().sum()) for g, w in zip(got, want))
    norm = sum(float(w.double().square().sum()) for w in want)
    if norm == 0.0:
        return 0.0 if diff == 0.0 else math.inf
    return math.sqrt(diff / norm)


def worst(readings: list[dict]) -> dict:
    """The largest reading of each number over the checked items (a NaN
    reading wins)."""
    out: dict = {}
    for item in readings:
        for name, value in item.items():
            old = out.get(name)
            if old is None or (not math.isnan(old) and (math.isnan(value) or value > old)):
                out[name] = value
    return out


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every limited number read and
    at or under its limit (a NaN or a missing reading fails)."""
    lines = {name: {"value": readings.get(name), "limit": limit} for name, limit in limits.items()}
    correct = bool(limits) and all(
        line["value"] is not None and line["value"] <= line["limit"] for line in lines.values())
    return correct, lines
