from .state import (TrainState, compute_dtype, create_train_state,  # noqa: F401
                    ema_update, poly_epoch_schedule)
from .step import make_eval_step, make_train_step, maybe_crf_fn  # noqa: F401
