from .harness import EvalResult, Evaluator, Exporter, frame_id_from_path  # noqa: F401
from .iou import iou_counts  # noqa: F401
