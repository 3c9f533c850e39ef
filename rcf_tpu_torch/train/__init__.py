from .state import TrainState, create_train_state, poly_epoch_schedule  # noqa: F401
from .step import make_train_step  # noqa: F401
