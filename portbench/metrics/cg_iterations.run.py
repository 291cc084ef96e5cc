"""CG iterations per solve, the mean over every solve of the window
(`CGResult.iterations`)."""


def read(record):
    its = record["iterations"]
    return sum(its) / len(its) if its else None
