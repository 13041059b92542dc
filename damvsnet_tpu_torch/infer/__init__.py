from .runner import DepthRunner, save_scene_depth
