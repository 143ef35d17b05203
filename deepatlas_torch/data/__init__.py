"""Data layer: NIfTI I/O (the native C++ tier with a Python fallback),
datasets, host transforms, batching/prefetch (numpy only).  Importing it
builds nothing: the native library builds at its first use."""
from .datasets import (RegDataSetBrains, RegDataSetMindBoggle,
                       RegDataSetOAIZIB, RegDataSetOASIS, SegDataset,
                       SegDataSetBrains, SegDataSetMindBoggle,
                       SegDataSetOAIZIB, SegDataSetOASIS, get_reg_dataset,
                       get_seg_dataset)
from .loader import DataLoader, endless
from .nifti import (NiftiImage, read_counts, read_nifti, reset_read_counts,
                    write_nifti)
from .transforms import (BalancedRandomCrop, BilateralFilter, Compose,
                         CropVolume, IdentityTransform, LeftToRight,
                         Normalization, PadVolume, Partition, RandomCrop,
                         Resample, SegmentationLabelFilter, VolumeToArray)

__all__ = [
    "NiftiImage", "read_counts", "read_nifti", "reset_read_counts",
    "write_nifti",
    "SegDataset", "SegDataSetBrains", "SegDataSetMindBoggle",
    "SegDataSetOAIZIB", "SegDataSetOASIS", "get_seg_dataset",
    "RegDataSetBrains", "RegDataSetMindBoggle", "RegDataSetOAIZIB",
    "RegDataSetOASIS", "get_reg_dataset",
    "DataLoader", "endless", "BalancedRandomCrop", "BilateralFilter",
    "Compose", "CropVolume", "IdentityTransform", "LeftToRight",
    "Normalization", "PadVolume", "Partition", "RandomCrop", "Resample",
    "SegmentationLabelFilter", "VolumeToArray",
]
