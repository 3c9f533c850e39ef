"""models.other_ms_per_step (ms/step): device time of every kernel that is
not a convolution, matrix product, ``crf_filter`` or NCCL kernel (the
casts, batch norms and elementwise work) in the traced steps, over the
traced steps; moves frames_per_s."""

from harness import trace

MOVES = "frames_per_s"


def read(ctx: dict):
    ms = trace.kernel_ms(ctx["kernels"], ("other",))
    return ms / ctx["trace_steps"] if ms > 0 else None
