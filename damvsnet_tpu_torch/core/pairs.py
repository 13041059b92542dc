"""pair.txt IO: per-reference-view ranked source views (copy of
damvsnet_tpu/core/pairs.py).

The format of the reference readers (datasets/dtu_yao.py:39-49,
filter/dypcd.py:84-94):

    <num_views>
    <ref_id>
    <n_src> src_0 score_0 src_1 score_1 ...
    ...
"""
from __future__ import annotations


def read_pair_file(filename):
    """Returns list of (ref_view, [src views]) skipping refs with no sources."""
    data = []
    with open(filename) as f:
        num_viewpoint = int(f.readline())
        for _ in range(num_viewpoint):
            ref_view = int(f.readline().rstrip())
            fields = f.readline().rstrip().split()
            src_views = [int(x) for x in fields[1::2]]
            if len(src_views) > 0:
                data.append((ref_view, src_views))
    return data


def write_pair_file(filename, pairs, scores=None):
    """pairs: list of (ref, [srcs]); scores: optional parallel list of score lists."""
    with open(filename, "w") as f:
        f.write(f"{len(pairs)}\n")
        for i, (ref, srcs) in enumerate(pairs):
            f.write(f"{ref}\n")
            sc = scores[i] if scores is not None else [0.0] * len(srcs)
            f.write(str(len(srcs)) + " " + " ".join(
                f"{s} {v:.4f}" for s, v in zip(srcs, sc)) + "\n")
