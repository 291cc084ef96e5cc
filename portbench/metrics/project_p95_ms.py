"""`project_p95_ms`: the 95th percentile of every projection's wall
milliseconds in the window."""

from portbench import window


def read(record):
    if not record["projections"]:
        return None
    return 1e3 * window.percentile(record["unit_seconds"], 95)
