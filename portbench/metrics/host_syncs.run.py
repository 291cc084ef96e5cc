"""`host_syncs.run`: the host syncs the program made in the traced window
(`torch.cuda.set_sync_debug_mode("warn")`), per frame."""


def read(record):
    if record["host_syncs"] is None or not record["frames"]:
        return None
    return record["host_syncs"] / record["frames"]
