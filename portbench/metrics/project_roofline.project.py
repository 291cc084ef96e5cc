"""`project_roofline.project`: the least time of the window's projections
(`roofline.projection_seconds`: the MGPCG solve's bytes and the right-hand
side's and writeback's, reckoned from the problem, over the card's memory
bandwidth) over the device time of the projection program's launches in
the trace (each launch from its first operation to its last, the CG
loop's untraced body inside it; `tracing.py`), in percent.  Copies in and
out and the host's gaps between launches are not in it."""


def read(record):
    trace = record.get("trace")
    if not record.get("project_least_s") or not trace or not trace["graph_launches"]:
        return None
    return 100.0 * record["project_least_s"] / trace["graph_s"]
