"""Device ms a request in the "layer norm" family (kernel names holding
``layer_norm``: PyTorch's ``vectorized_layer_norm_kernel``). In the serving
cascade only FMT's LayerNorms (``nn/fmt.py``, two a layer: 8 launches for
the reference view's four self layers, 16 for the sources' eight) launch
that family: FeatureNet, geo fusion, the weight nets and CostRegNet
normalise with BatchNorm folded into their convolutions, and a traced
``fmt_serve`` request lists no other kernel of the family. None where the
family is absent, as in a cascade without FMT."""
from benchmark.readers import traced

FAMILY = "layer norm"


def read(record):
    t = traced(record, "serve")
    if t is None or t["families"].get(FAMILY, 0.0) <= 0.0:
        return None
    return 1e3 * t["families"][FAMILY] / t["units"]
