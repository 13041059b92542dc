"""Device ms a step in NCCL's kernels (the collective family: DDP's
gradient all-reduce, the synced BatchNorm's all-gathers and all-reduces,
the metrics' mean) on the rank that spends least there. A collective's
kernel runs from its launch until every rank has arrived, so the rank
whose host arrives last waits least: its time is nearest the transfer.
Rank 0's time, the wait with it, is the breakdown's "collective (NCCL)".
None where the step launches none."""
from benchmark.readers import traced


def read(record):
    t = traced(record, "train")
    if t is None or not any(t.get("nccl_s", ())):
        return None
    return 1e3 * min(t["nccl_s"]) / t["units"]
