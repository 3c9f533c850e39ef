from .dataset import VideoDataset, parse_split  # noqa: F401
from .loader import DataLoader  # noqa: F401
from .transforms import EvalTransform, TrainTransform, get_transform  # noqa: F401
