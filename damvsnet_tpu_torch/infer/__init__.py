"""Inference and fusion (counterpart of damvsnet_tpu/infer): DepthRunner
and the depth-file writer, the dypcd and pcd filters (host, cv2), the
device-batched consistency filter (``fusion_device``) and the
Tanks-and-Temples confidences."""
from .fusion_dypcd import dypcd_filter, filter_depth_dypcd
from .fusion_pcd import pcd_filter
from .runner import DepthRunner, save_scene_depth
from .tank_config import TANK_CFG
