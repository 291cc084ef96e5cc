"""`advect_s.run`: the mean of the window's frames' `advect` stage seconds
(`simulate.step`'s `FrameResult.seconds`, each ending on a device sync)."""


def read(record):
    stages = record["stage_seconds"]
    return sum(stages["advect"]) / len(stages["advect"]) if stages else None
