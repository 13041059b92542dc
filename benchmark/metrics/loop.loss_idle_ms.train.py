"""Device idle ms a step while the host is in the train step's
``loop.loss`` span: the traced window's idle gaps named
``bench.step/loop.loss`` (the CPC loss's inverse waiting for the device).
None where the program opens no such span."""
from benchmark.readers import traced

GAP = "bench.step/loop.loss"


def read(record):
    t = traced(record, "train")
    if t is None or GAP not in t["gaps"]:
        return None
    return 1e3 * t["gaps"][GAP] / t["units"]
