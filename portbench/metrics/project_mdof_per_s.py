"""`project_mdof_per_s`: liquid DOFs of every projection completed in the
window, in millions, over the window's seconds."""

from portbench import window


def read(record):
    if not record["projections"]:
        return None
    return window.rate(sum(record["dofs"]), record["window_s"]) / 1e6
