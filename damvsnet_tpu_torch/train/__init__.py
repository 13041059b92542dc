"""Training (counterpart of damvsnet_tpu/train): the learning-rate schedule
and optimizer, metrics, checkpoints and the train/eval loop. JAX's
``create_train_state``, ``save_checkpoint`` and ``wait_for_saves`` are
``TrainState`` and ``Checkpointer`` here."""
from .loop import Trainer, make_eval_step, make_train_step
from .metrics import DictAverageMeter, abs_depth_error_metrics, thres_metrics
from .schedule import parse_lr_epochs, warmup_multistep_schedule
from .state import TrainState, restore_checkpoint
