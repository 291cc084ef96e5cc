"""`frame_p95_s`: the 95th percentile of every frame's wall seconds in the
window (a cell that runs one frame per unit)."""

from portbench import window


def read(record):
    if record["entry"] != "run":
        return None
    return window.percentile(record["unit_seconds"], 95)
