"""`program_captures.project`: programs the program cache captured in the
window (`graph.STATS.program_captures`), per projection."""


def read(record):
    return record["program_captures"] / record["projections"] if record["projections"] else None
