from . import augment, coords, noise, processing
from .amass import AmassDataset
from .base import SmplPoseDataset, SmplTable, mixed_epoch_indices
from .coco_ds import CocoDataset
from .gt_synth import GtSynthesizer
from .h36m import Human36M
from .muco import MucoDataset
from .pipeline import BatchPipeline
from .processing import ProcessOptions
from .pw3d import PW3D
from .synthetic import SyntheticDataset

# dataset-name registry matching the reference's cfg.DATASET.train_list /
# test_list names (reference: lib/core/base.py:27)
DATASETS = {
    "Human36M": Human36M,
    "COCO": CocoDataset,
    "MuCo": MucoDataset,
    "PW3D": PW3D,
    "AMASS": AmassDataset,
    "Synthetic": SyntheticDataset,
}

__all__ = [
    "AmassDataset", "BatchPipeline", "CocoDataset", "DATASETS",
    "GtSynthesizer", "Human36M", "MucoDataset", "PW3D", "ProcessOptions",
    "SmplPoseDataset", "SmplTable", "SyntheticDataset", "augment",
    "coords", "mixed_epoch_indices", "noise", "processing",
]
