from .state import (TrainState, compute_dtype, create_train_state,  # noqa: F401
                    poly_epoch_schedule)
from .step import make_train_step  # noqa: F401
