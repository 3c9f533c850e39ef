"""device.mfu_pct (%): the model FLOPs of the window's steps (outside the
profiler) over the window's wall time on the host clock and over the peak
of the compute dtype, times the cell's cards; moves frames_per_s.

The FLOPs are the benchmark's own count from the configuration's plain
reference at the cell's shapes (``step_flops`` of
``port_bench/reference/<reference>.py``). The peak is the dense
tensor-core rate of the compute dtype on one H100 SXM (NVIDIA's data
sheet): bf16 989 TFLOP/s; the f32 recipe's convolutions run in TF32
(cuDNN's default), 495 TFLOP/s, and no f32 path is faster.
"""

MOVES = "frames_per_s"
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}


def read(ctx: dict):
    if not ctx["window_steps"] or ctx["window_seconds"] <= 0:
        return None
    rate = ctx["flops_per_step"] * ctx["window_steps"] / ctx["window_seconds"]
    return 100.0 * rate / (PEAK_FLOPS[ctx["compute_dtype"]] * ctx["chips"])
