"""Device idle ms a request while the host is in DepthRunner's
``runner.forward`` span, its children included: the traced window's idle
gaps named ``bench.request/runner.forward`` (the model's host work and
launches the device waits for). None where the program opens no such
span."""
from benchmark.readers import traced

GAP = "bench.request/runner.forward"


def read(record):
    t = traced(record, "serve")
    if t is None or GAP not in t["gaps"]:
        return None
    return 1e3 * t["gaps"][GAP] / t["units"]
