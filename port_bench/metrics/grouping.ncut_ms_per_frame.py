"""grouping.ncut_ms_per_frame (ms/frame): device time of the spans
``rcf.ncut.affinity`` and ``rcf.ncut.refine`` (the thresholded affinity and
the Adam steps on the NCut value; ``harness/spans.py``) in the labelled
traced pass, over the frames of that pass; moves frames_per_s."""

MOVES = "frames_per_s"


def read(ctx: dict):
    span = ctx.get("span_ms") or {}
    ms = span.get("rcf.ncut.affinity", 0.0) + span.get("rcf.ncut.refine", 0.0)
    return ms / ctx["span_frames"] if ms > 0 and ctx.get("span_frames") else None
