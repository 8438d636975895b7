from .loop import TrainLoop
from .step import bool_view, make_train_step
