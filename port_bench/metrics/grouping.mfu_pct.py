"""grouping.mfu_pct (%): the model FLOPs of the window's frames (outside the
profiler) over the window's wall time on the host clock and over 495
TFLOP/s, the H100 SXM's dense TF32 tensor-core rate, which no
float32-accurate path beats; moves frames_per_s.

The FLOPs are the benchmark's own count from shapes (``frame_flops`` of the
configuration's plain reference: the ViT's products to the last block's
qkv and the affinity's Gram matrix, 984.9 GFLOP a 480 x 856 frame).
"""

MOVES = "frames_per_s"
PEAK_FLOPS = 495e12


def read(ctx: dict):
    if not ctx.get("window_frames") or ctx["window_seconds"] <= 0:
        return None
    return 100.0 * ctx["flops_per_frame"] * ctx["window_frames"] / ctx["window_seconds"] / PEAK_FLOPS
