"""`setup_s`: process start to the first timed unit: imports, the CUDA
context, the kernels' library, the scene, the warm-up units and their
captures."""


def read(record):
    return record["setup_s"]
