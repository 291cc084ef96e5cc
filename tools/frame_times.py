"""Seconds per frame of the port's two frame loops on the card, for
comparing two checkouts of the repo in one call.

Runs `simulate.run` and `simulate.run_fused` (one chunk) over `--frames`
frames of the n^3 splash in `chip_smoke.py`'s bench configuration, after
one warm-up call of each, `--reps` times in turns, each call ending on a
device sync.  Prints one JSON line: each loop's seconds per frame (best
and every turn), the frame graph's capture + instantiate seconds per
`run_fused` call (`graph.STATS`), the package's root, and the card's name
and power limit.  `--root DIR` imports the package from DIR (another
checkout, e.g. a parent commit unpacked with `git archive`), so one script
times both trees, in turns, on one card:

    python tools/frame_times.py --root /path/to/parent --n 256
    python tools/frame_times.py --n 256
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        help="the checkout whose package is timed (default: this one)")
    parser.add_argument("--n", type=int, default=256)
    parser.add_argument("--frames", type=int, default=4)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("frame_times: no CUDA device", file=sys.stderr)
        return 1
    from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
    from geometricmultigridpressuresolver_tpu_torch.models import sdf, simulate
    from geometricmultigridpressuresolver_tpu_torch.solver import graph

    dev = torch.device("cuda", 0)
    config = SolverConfig(solve_dtype=torch.float32, mg_dtype=torch.float32, mg_ew_dtype=torch.bfloat16,
                          tolerance=1e-5, max_iterations=200)
    shape = (args.n,) * 3
    phi, velocity = sdf.splash_scene(shape, device=dev, dtype=torch.float32)
    weights = sdf.open_box_weights(shape, device=dev, dtype=torch.float32)
    loops = {
        "run": lambda: simulate.run(phi, velocity, weights, num_frames=args.frames, config=config),
        "run_fused": lambda: simulate.run_fused(phi, velocity, weights, num_frames=args.frames, config=config,
                                                chunk=args.frames),
    }
    for fn in loops.values():
        fn()  # the kernels built, the first captures made
    per_frame = {k: [] for k in loops}
    capture = []
    for _ in range(args.reps):
        for name, fn in loops.items():
            graph.STATS.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            per_frame[name].append((time.perf_counter() - t0) / args.frames)
            if name == "run_fused":
                capture.append(graph.STATS.frame_capture_seconds + graph.STATS.frame_instantiate_seconds)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "root": os.path.abspath(args.root), "n": args.n, "frames": args.frames,
        "seconds_per_frame": {k: {"best": min(v), "each": v} for k, v in per_frame.items()},
        "run_fused_frame_capture_seconds": capture, "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
