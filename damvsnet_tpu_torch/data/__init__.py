"""Datasets (counterpart of damvsnet_tpu/data): the training loaders, DTU
(``dtu_yao``, ``dtu``) and BlendedMVS, and the synthetic scene. The eval
loaders wait for the test CLI that reads them (ROADMAP Queue 1 item 13)."""
from .blendedmvs import BlendedMVSDataset
from .common import DataLoader, collate
from .dtu import DTUTrainDataset
from .synthetic import SyntheticDataset, make_synthetic_sample

_REGISTRY = {
    "dtu_yao": DTUTrainDataset,
    "dtu": DTUTrainDataset,
    "blendedmvs": BlendedMVSDataset,
    "synthetic": SyntheticDataset,
}
_EVAL_LOADERS = ("general_eval", "tnt_eval_trans")


def find_dataset_def(name: str):
    if name in _EVAL_LOADERS:
        raise NotImplementedError(
            f"dataset {name!r}: the port's eval loaders wait for its test CLI "
            "(ROADMAP Queue 1 item 13)")
    return _REGISTRY[name]
