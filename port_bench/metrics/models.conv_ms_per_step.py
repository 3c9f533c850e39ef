"""models.conv_ms_per_step (ms/step): device time of the convolution and
matrix-product kernels in the traced steps (grouped by name, ``harness/
trace.py::group``), over the traced steps; moves frames_per_s."""

from harness import trace

MOVES = "frames_per_s"


def read(ctx: dict):
    ms = trace.kernel_ms(ctx["kernels"], ("gemm_conv",))
    return ms / ctx["trace_steps"] if ms > 0 else None
