from .cascade import CascadeMVSNet, fuse_projection_matrices
