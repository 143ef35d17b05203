"""Data layer: NIfTI I/O, datasets, host transforms, batching/prefetch
(numpy only)."""
from .datasets import (RegDataSetBrains, RegDataSetMindBoggle,
                       RegDataSetOAIZIB, RegDataSetOASIS, SegDataset,
                       SegDataSetBrains, SegDataSetMindBoggle,
                       SegDataSetOAIZIB, SegDataSetOASIS, get_reg_dataset,
                       get_seg_dataset)
from .loader import DataLoader, endless
from .nifti import NiftiImage, read_nifti, write_nifti
from .transforms import (Compose, CropVolume, LeftToRight, Partition,
                         VolumeToArray)

__all__ = [
    "NiftiImage", "read_nifti", "write_nifti",
    "SegDataset", "SegDataSetBrains", "SegDataSetMindBoggle",
    "SegDataSetOAIZIB", "SegDataSetOASIS", "get_seg_dataset",
    "RegDataSetBrains", "RegDataSetMindBoggle", "RegDataSetOAIZIB",
    "RegDataSetOASIS", "get_reg_dataset",
    "DataLoader", "endless", "Compose", "CropVolume", "LeftToRight",
    "Partition", "VolumeToArray",
]
