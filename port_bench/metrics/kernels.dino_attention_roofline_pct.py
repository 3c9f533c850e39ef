"""kernels.dino_attention_roofline_pct (%): the least time of the ViT's
attention over the device time of the span ``rcf.dino.attention`` (each
block's product, softmax and product; ``harness/spans.py``) in the labelled
traced pass; moves frames_per_s.

The work is counted from shapes (``attention_work`` of the configuration's
plain reference, times the blocks that run attention and the frames of the
pass), so it reads the same whatever implements the attention. The least
time is the largest of three floors:

* the FLOPs of Q K^T and A V over 495 TFLOP/s, the H100 SXM's dense TF32
  tensor-core rate, which no float32-accurate path beats;
* the heads x N^2 exponentials of the softmax over 3.76e13 a second, the
  rate ``kernels.crf_filter_roofline_pct`` sets out (the SFU's ex2 and the
  FP32 lanes each making one, 132 SMs at 1.98 GHz);
* the bytes of q, k, v and o in float32, each moved once, over 3.35 TB/s.
"""

MOVES = "frames_per_s"
PEAK_FLOPS = 495e12
EXP_PER_S = 132 * 1.98e9 * (16 + 128)
HBM_BYTES_PER_S = 3.35e12


def least_seconds(work: dict) -> float:
    return max(work["flops"] / PEAK_FLOPS, work["exps"] / EXP_PER_S, work["bytes"] / HBM_BYTES_PER_S)


def read(ctx: dict):
    ms = (ctx.get("span_ms") or {}).get("rcf.dino.attention", 0.0)
    work = ctx.get("attention_work")
    if ms <= 0 or not work or work["flops"] <= 0:
        return None
    return 100.0 * least_seconds(work) / (ms * 1e-3)
