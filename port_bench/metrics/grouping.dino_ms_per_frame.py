"""grouping.dino_ms_per_frame (ms/frame): device time of the span
``rcf.dino.forward`` (the ViT's normalisation, resize and forward, each
kernel counted by the runtime call that launched it; ``harness/spans.py``)
in the labelled traced pass, over the frames of that pass
(``rcf_tpu_torch.grouping.STATS["frames"]``); moves frames_per_s."""

MOVES = "frames_per_s"


def read(ctx: dict):
    ms = (ctx.get("span_ms") or {}).get("rcf.dino.forward", 0.0)
    return ms / ctx["span_frames"] if ms > 0 and ctx.get("span_frames") else None
