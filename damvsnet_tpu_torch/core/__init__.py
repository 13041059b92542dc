"""Cameras, pfm / PLY / pair-file IO and the image codec (numpy; counterpart
of damvsnet_tpu/core)."""
from .cameras import (Camera, fuse_proj, read_cam_file, stage_intrinsics, stage_proj_matrices,
                      write_cam_file)
from .pairs import read_pair_file, write_pair_file
from .pfm import read_pfm, write_pfm
from .ply import read_ply, write_ply
