"""`project_stage_s.run`: the mean of the window's frames' `project` stage seconds
(`simulate.step`'s `FrameResult.seconds`, each ending on a device sync)."""


def read(record):
    stages = record["stage_seconds"]
    return sum(stages["project"]) / len(stages["project"]) if stages else None
