"""Host ms a step in the call of the train step, before its metrics are
read (the upload, the forward, backward and update enqueued)."""
from benchmark.readers import dispatch_ms


def read(record):
    return dispatch_ms(record, "train")
