"""Input data for the port: the synthetic batch, the datasets, the dataset
factory and the loader (the port's own copies of the JAX package's)."""

from .argoverse import Argoverse
from .aux_datasets import (CityscapesDataset, Eth3dDataset, EurocDataset, NuscenesDataset,
                           SequenceFrameDataset)
from .calib import load_odometry_calib, load_raw_calib, read_calib_file
from .folder import FolderDataset
from .kitti import KittiDepth, KittiObject, KittiOdometry, KittiRaw
from .loader import DataLoader, collate
from .simulated import SimulatedDataset
from .splits import (get_dataset, readlines, scan_object_split, scan_odometry_split,
                     split_file)
from .synthetic import synthetic_batch
from .velodyne import generate_depth_map

__all__ = ["Argoverse", "CityscapesDataset", "DataLoader", "Eth3dDataset", "EurocDataset",
           "FolderDataset", "KittiDepth", "KittiObject", "KittiOdometry", "KittiRaw",
           "NuscenesDataset", "SequenceFrameDataset", "SimulatedDataset", "collate",
           "generate_depth_map", "get_dataset",
           "load_odometry_calib", "load_raw_calib", "read_calib_file", "readlines",
           "scan_object_split", "scan_odometry_split", "split_file", "synthetic_batch"]
