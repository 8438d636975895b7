from .loop import TrainLoop
from .step import bool_view, make_decode_step, make_prefill_step, make_train_step
