"""The depth-slab axis across the cards of one machine over NCCL:
chip_smoke.py's phase 22 (c) with a card a rank.

    python3 scripts/slab_cards_torch.py          (needs 4 cards)

Builds the kernels, then runs phase 22 (c): the fused training step
(512x640, global B=4, N=5, bf16, the trained weights, Adam, CPC) on the
2x2 mesh, data 2 x space 2, each data rank its 2 rows of every global
batch and each rank of a space group half of every stage's depth
hypotheses, the halos all-gathered over NCCL: 1 warm and 3 timed steps
with the launch counters and the depth of each K1 call, one more step
profiled for its collectives and halo exchanges, then one fp32 step (TF32
off) held against the same step in one process at B=4 on card 0, at the
phase's limits. Prints the phase's line and each card's name and power
limit.
"""
from __future__ import annotations

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import torch

    import chip_smoke as smoke
    from damvsnet_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("slab_cards_torch: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < 4:
        print(f"slab_cards_torch: {torch.cuda.device_count()} cards; the 2x2 mesh needs 4",
              file=sys.stderr)
        return 2
    build.build()
    smi = smoke.nvidia_smi()
    print(f"cards: {smi}", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        smoke.phase_slab_train(torch.device("cuda:0"), smi, workdir, data_ranks=(2,),
                               backend="nccl")
    return 0


if __name__ == "__main__":
    sys.exit(main())
