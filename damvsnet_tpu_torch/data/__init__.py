"""Datasets (counterpart of damvsnet_tpu/data): the training loaders, DTU
(``dtu_yao``, ``dtu``) and BlendedMVS, the eval loaders ``general_eval``
and ``tnt_eval_trans``, and the synthetic scene."""
from .blendedmvs import BlendedMVSDataset
from .common import DataLoader, collate
from .dtu import DTUTrainDataset
from .general_eval import GeneralEvalDataset
from .synthetic import SyntheticDataset, make_synthetic_sample
from .tnt_eval import TnTEvalDataset

_REGISTRY = {
    "dtu_yao": DTUTrainDataset,
    "dtu": DTUTrainDataset,
    "blendedmvs": BlendedMVSDataset,
    "general_eval": GeneralEvalDataset,
    "tnt_eval_trans": TnTEvalDataset,
    "synthetic": SyntheticDataset,
}


def find_dataset_def(name: str):
    return _REGISTRY[name]
