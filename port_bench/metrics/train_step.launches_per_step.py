"""train_step.launches_per_step (launches/step): the kernels the device ran
in the traced steps (every launch, a library's too, appears once as a
kernel in the profiler's device trace), over the traced steps; moves
frames_per_s."""

MOVES = "frames_per_s"


def read(ctx: dict):
    return len(ctx["kernels"]) / ctx["trace_steps"] if ctx["kernels"] else None
