from .runner import DepthRunner
