"""`setup_stage_s.run`: the mean of the window's frames' `setup` stage seconds
(`simulate.step`'s `FrameResult.seconds`, each ending on a device sync)."""


def read(record):
    stages = record["stage_seconds"]
    return sum(stages["setup"]) / len(stages["setup"]) if stages else None
