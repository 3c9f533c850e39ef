"""device.idle_pct (%): the share of the traced window in which no kernel,
copy or fill runs on any stream (the union of their intervals); moves
frames_per_s."""

MOVES = "frames_per_s"


def read(ctx: dict):
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"]) if ctx["window_s"] > 0 else None
