"""DepthRunner's own counter, ``time_dispatch``, a request: the upload and
the forward's enqueue, before the answer is fetched."""
from benchmark.readers import dispatch_ms


def read(record):
    return dispatch_ms(record, "serve")
