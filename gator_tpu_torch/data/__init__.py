from . import augment, coords, noise, processing
from .base import SmplPoseDataset, SmplTable, mixed_epoch_indices
from .gt_synth import GtSynthesizer
from .pipeline import BatchPipeline
from .processing import ProcessOptions
from .synthetic import SyntheticDataset

__all__ = ["BatchPipeline", "GtSynthesizer", "ProcessOptions",
           "SmplPoseDataset", "SmplTable", "SyntheticDataset", "augment",
           "coords", "mixed_epoch_indices", "noise", "processing"]
