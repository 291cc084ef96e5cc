"""Run one benchmark cell of the PyTorch/CUDA port once, from the root of
a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without the CUDA devices the cell
asks for, or when JAX or the JAX package was loaded.  See README.md.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here: process start to the first timed unit

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
