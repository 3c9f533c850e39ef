"""kernels.crf_filter_roofline_pct (%): the least time of the traced steps'
mean-field filters over ``crf_filter``'s device time in the trace; moves
frames_per_s.

The least time of one iteration (one filter over the batch's images) is the
larger of two floors at the cell's shapes, B images of N = grid^2 pixels:

* bytes: the features [B, N, 5], the values [B, N] and the output [B, N],
  f32, each read or written once, over 3.35 TB/s (H100 SXM HBM3);
* exponentials: the B N^2 pair weights, over the highest rate at which the
  chip can form them: the SFU's ex2 (16 per SM per clock) plus the FP32
  pipes (128 lanes per SM per clock) each making one exponential per
  operation, which is looser than any polynomial exponential (several FP32
  operations each), on 132 SMs at 1.98 GHz (the H100 SXM's highest boost
  clock): 144 x 132 x 1.98e9 = 3.76e13 exponentials a second.

No filter that passes the output check can run under this floor. The
iterations are the program's counter (``ops.crf.STATS``).
"""

MOVES = "frames_per_s"
HBM_BYTES_PER_S = 3.35e12
SMS = 132
CLOCK_HZ = 1.98e9
SFU_EX2_PER_SM_CLK = 16
FP32_LANES_PER_SM_CLK = 128
FP32_OPS_PER_EXP = 1
EXP_PER_S = SMS * CLOCK_HZ * (SFU_EX2_PER_SM_CLK + FP32_LANES_PER_SM_CLK / FP32_OPS_PER_EXP)


def least_seconds(images: int, pixels: int, dims: int = 5) -> float:
    """The floor of one filter over ``images`` images of ``pixels`` pixels."""
    bytes_moved = images * pixels * (dims + 2) * 4
    return max(bytes_moved / HBM_BYTES_PER_S, images * pixels * pixels / EXP_PER_S)


def read(ctx: dict):
    from harness import trace

    ms = trace.kernel_ms(ctx["kernels"], ("crf_filter",))
    if ms <= 0 or not ctx["crf_iters"]:
        return None
    h, w = ctx["crf_grid"]
    floor = ctx["crf_iters"] * least_seconds(ctx["crf_images"], h * w)
    return 100.0 * floor / (ms * 1e-3)
