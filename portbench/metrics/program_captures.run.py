"""`program_captures.run`: programs the program cache captured in the
window (`graph.STATS.program_captures`), per frame."""


def read(record):
    return record["program_captures"] / record["frames"] if record["frames"] else None
