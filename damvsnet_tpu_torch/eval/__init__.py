"""DTU evaluation (counterpart of damvsnet_tpu/eval)."""
from .dtu_eval import evaluate_scan, evaluate_scans, nn_distances, reduce_points
