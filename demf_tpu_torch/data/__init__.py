"""Data layer of the port: the declarative pipeline transforms, the SUN
RGB-D dataset and its synthetic stand-in, the fixed-shape loader, and the
on-device preprocessing of raw batches (``device_pipeline``: a dataset
given ``LoadRaw`` as its pipeline and a loader given ``collate_raw`` feed
``TrainStep(preprocess=)``)."""
from . import pipeline  # noqa: F401  (registers the transforms)
from ..registry import DATASETS, build_from_cfg
from .device_pipeline import (DevicePreprocessSpec, LoadRaw,
                              UnsupportedPipeline, build_device_pipeline,
                              make_device_preprocess, make_raw_collate)
from .loader import DataLoader, build_dataloader, collate_fixed
from .sunrgbd import (SUNRGBD_CLASSES, RepeatDataset, SUNRGBDDataset,
                      SyntheticSUNRGBD)

__all__ = ['DataLoader', 'DevicePreprocessSpec', 'LoadRaw',
           'RepeatDataset', 'SUNRGBDDataset', 'SUNRGBD_CLASSES',
           'SyntheticSUNRGBD', 'UnsupportedPipeline', 'build_dataloader',
           'build_dataset', 'build_device_pipeline', 'collate_fixed',
           'make_device_preprocess', 'make_raw_collate']


def build_dataset(cfg):
    """The dataset a config's ``data.train`` / ``val`` / ``test`` names."""
    return build_from_cfg(cfg, DATASETS)
