"""Training (counterpart of damvsnet_tpu/train): the learning-rate schedule
and optimizer, metrics, checkpoints and the train/eval loop."""
