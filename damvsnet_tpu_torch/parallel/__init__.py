"""Ranks, process groups and the collectives across them (counterpart of
damvsnet_tpu/parallel): the (data, space) mesh, the scan-parallel and
batch splits, FMT's sequence-parallel attention, and the depth-slab axis
(``slab.py``)."""
from .fmt_sp import sequence_parallel_linear_attention
from .mesh import (Mesh, batch_rows, local_device, make_mesh,
                   maybe_initialize_distributed, shard_work_items)
