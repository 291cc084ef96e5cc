from geometricmultigridpressuresolver_tpu_torch.utils.profiling import (
    StageTimes,
    StageTimer,
    instrumented_solve,
    trace,
    vcycle_stage_times,
)

__all__ = [
    "StageTimes",
    "StageTimer",
    "instrumented_solve",
    "trace",
    "vcycle_stage_times",
]
