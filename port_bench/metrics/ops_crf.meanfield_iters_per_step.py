"""ops_crf.meanfield_iters_per_step (iters/step): the mean field's
iterations in the traced steps, from the program's counter
``rcf_tpu_torch.ops.crf.STATS["iterations"]`` (reset before them), over the
traced steps; moves frames_per_s."""

MOVES = "frames_per_s"


def read(ctx: dict):
    return ctx["crf_iters"] / ctx["trace_steps"] if ctx["crf_iters"] else None
