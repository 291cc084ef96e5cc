"""`frame_s`: the window's seconds over the frames completed in it."""


def read(record):
    return record["window_s"] / record["frames"] if record["frames"] else None
