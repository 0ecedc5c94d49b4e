"""Data layer of the port: the declarative pipeline transforms, the SUN
RGB-D dataset and its synthetic stand-in, and the fixed-shape loader."""
from . import pipeline  # noqa: F401  (registers the transforms)
from ..registry import DATASETS, build_from_cfg
from .loader import DataLoader, build_dataloader, collate_fixed
from .sunrgbd import (SUNRGBD_CLASSES, RepeatDataset, SUNRGBDDataset,
                      SyntheticSUNRGBD)

__all__ = ['DataLoader', 'RepeatDataset', 'SUNRGBDDataset',
           'SUNRGBD_CLASSES', 'SyntheticSUNRGBD', 'build_dataloader',
           'build_dataset', 'collate_fixed']


def build_dataset(cfg):
    """The dataset a config's ``data.train`` / ``val`` / ``test`` names."""
    return build_from_cfg(cfg, DATASETS)
