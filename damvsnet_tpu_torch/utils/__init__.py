"""Device selection, the flax-checkpoint weight bridge and the depth
visualizations (counterpart of damvsnet_tpu/utils)."""
from .visualize import depth_to_color, save_depth_png
