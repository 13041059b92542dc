"""Datasets (counterpart of damvsnet_tpu/data). The registry holds only the
synthetic scene: the DTU, BlendedMVS and TnT loaders wait for their data
and a loader without cv2 (ROADMAP Queue 1)."""
from .common import DataLoader, collate
from .synthetic import SyntheticDataset, make_synthetic_sample

_REGISTRY = {"synthetic": SyntheticDataset}


def find_dataset_def(name: str):
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"dataset {name!r}: the port has only 'synthetic'; the DTU, "
            "BlendedMVS and TnT loaders wait for their data and a loader "
            "without cv2 (ROADMAP Queue 1 item 10.3)")
    return _REGISTRY[name]
