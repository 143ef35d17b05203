"""NIfTI segmentation and pairwise registration datasets.

List-file driven datasets per corpus (OAI-ZIB, OASIS, the four brain atlases,
MindBoggle101) with the original reference's ``n_samples`` int-prefix /
index-list semantics, optional preloading and pre/running transforms.

Filename conventions per corpus:
  * OAI:        <name>_image.nii.gz / <name>_masks.nii.gz
  * OASIS:      <name>_image.nii.gz / <name>_seg.nii.gz
  * Brains:     brain_affine_icbm_hist_matched/<name>.nii /
                label_affine_icbm_reID/<name>.nii
  * MindBoggle: image_in_MNI152_normalized/<name>.nii.gz /
                label_31_reID_merged/<name>.nii.gz

The registration datasets index the ordered pairs of a corpus and yield
``(moving, fixed)`` sample tuples.

Pure Python + numpy; batching and prefetch live in data/loader.py.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .nifti import read_nifti

Sample = dict
NSamples = Union[None, int, Sequence[int]]


def _filter_lines(lines: Sequence[str], n_samples: NSamples) -> List[str]:
    """int keeps the first n entries, a sequence keeps those indices, None
    keeps all."""
    names = [ln.strip("\n") for ln in lines if ln.strip()]
    if n_samples is None:
        return names
    if isinstance(n_samples, int):
        return names[:n_samples]
    if isinstance(n_samples, (list, tuple, range, np.ndarray)):
        wanted = set(int(i) for i in n_samples)
        return [n for i, n in enumerate(names) if i in wanted]
    raise TypeError("n_samples should be None, or int, or a sequence of int "
                    f"but got {type(n_samples)}")


def _read_lists(text_files: Union[str, Sequence[str]],
                n_samples: NSamples) -> List[str]:
    if isinstance(text_files, (str, os.PathLike)):
        text_files = [text_files]
    lines: List[str] = []
    for tf in text_files:
        with open(tf) as f:
            lines.extend(f.readlines())
    return _filter_lines(lines, n_samples)


class SegDataset:
    """Base segmentation dataset: list files -> (image, seg, name) samples.

    Subclasses override ``image_path`` / ``seg_path`` for their corpus's
    filename convention.
    """

    def __init__(self, txt_files, data_dir: str, with_seg: bool = True,
                 preload: bool = False, pre_transform: Optional[Callable] = None,
                 running_transform: Optional[Callable] = None,
                 n_samples: NSamples = None, shuffle: bool = False,
                 seed: int = 0):
        self.data_dir = data_dir
        self.with_seg = with_seg
        self.preload = preload
        self.pre_transform = pre_transform
        self.running_transform = running_transform

        self.name_list = _read_lists(txt_files, n_samples)
        self.image_list = [self.image_path(data_dir, n) for n in self.name_list]
        self.segmentation_list = [self.seg_path(data_dir, n)
                                  for n in self.name_list]
        self.length = len(self.name_list)

        self.shuffle = shuffle
        if shuffle:
            self.shuffle_id = np.random.RandomState(seed).permutation(
                self._index_space())
        if preload:
            self.sample_list = [self._load(i) for i in range(self.length)]

    @staticmethod
    def image_path(data_dir: str, name: str) -> str:
        return os.path.join(data_dir, name + "_image.nii.gz")

    @staticmethod
    def seg_path(data_dir: str, name: str) -> str:
        return os.path.join(data_dir, name + "_masks.nii.gz")

    def _index_space(self) -> int:
        """How many indices ``__getitem__`` takes: the volumes here, the
        ordered pairs in the registration datasets."""
        return self.length

    def __len__(self) -> int:
        return self._index_space()

    def _load(self, idx: int) -> Sample:
        image_file = self.image_list[idx]
        if not os.path.exists(image_file):
            raise ValueError(image_file + " not exist!")
        sample: Sample = {"image": read_nifti(image_file),
                          "name": self.name_list[idx]}
        if self.with_seg:
            seg_file = self.segmentation_list[idx]
            if not os.path.exists(seg_file):
                raise ValueError(seg_file + " not exist!")
            sample["segmentation"] = read_nifti(seg_file)
        if self.pre_transform:
            sample = self.pre_transform(sample)
        return sample

    def get_sample(self, idx: int) -> Sample:
        if self.preload:
            sample = dict(self.sample_list[idx])
        else:
            sample = self._load(idx)
        if self.running_transform:
            sample = self.running_transform(sample)
        return sample

    def __getitem__(self, idx: int) -> Sample:
        if self.shuffle:
            idx = int(self.shuffle_id[idx])
        return self.get_sample(idx)


class SegDataSetOAIZIB(SegDataset):
    pass


class SegDataSetOASIS(SegDataset):
    @staticmethod
    def seg_path(data_dir, name):
        return os.path.join(data_dir, name + "_seg.nii.gz")


class SegDataSetBrains(SegDataset):
    """LPBA40 / CUMC12 / IBSR18 / MGH10."""

    @staticmethod
    def image_path(data_dir, name):
        return os.path.join(data_dir, "brain_affine_icbm_hist_matched",
                            name + ".nii")

    @staticmethod
    def seg_path(data_dir, name):
        return os.path.join(data_dir, "label_affine_icbm_reID", name + ".nii")


class SegDataSetMindBoggle(SegDataset):
    @staticmethod
    def image_path(data_dir, name):
        return os.path.join(data_dir, "image_in_MNI152_normalized",
                            name + ".nii.gz")

    @staticmethod
    def seg_path(data_dir, name):
        return os.path.join(data_dir, "label_31_reID_merged", name + ".nii.gz")


class _RegPairMixin:
    """Ordered-pair indexing over a seg dataset: ``N * (N - 1)`` pairs,
    id -> (moving, fixed) with the self-pair skipped."""

    def _index_space(self) -> int:
        return self.length * (self.length - 1)

    @staticmethod
    def pair_indices(pair_id: int, length: int) -> Tuple[int, int]:
        fixed = pair_id // (length - 1)
        moving = pair_id % (length - 1)
        if moving >= fixed:
            moving += 1
        return moving, fixed

    def __getitem__(self, idx: int):
        if self.shuffle:
            idx = int(self.shuffle_id[idx])
        moving_ind, fixed_ind = self.pair_indices(idx, self.length)
        return self.get_sample(moving_ind), self.get_sample(fixed_ind)


class RegDataSetOAIZIB(_RegPairMixin, SegDataSetOAIZIB):
    pass


class RegDataSetOASIS(_RegPairMixin, SegDataSetOASIS):
    pass


class RegDataSetBrains(_RegPairMixin, SegDataSetBrains):
    pass


class RegDataSetMindBoggle(_RegPairMixin, SegDataSetMindBoggle):
    pass


_SEG = {"OAI": SegDataSetOAIZIB, "OASIS": SegDataSetOASIS,
        "LPBA40": SegDataSetBrains, "CUMC12": SegDataSetBrains,
        "IBSR18": SegDataSetBrains, "MGH10": SegDataSetBrains,
        "MindBoggle": SegDataSetMindBoggle}


_REG = {"OAI": RegDataSetOAIZIB, "OASIS": RegDataSetOASIS,
        "LPBA40": RegDataSetBrains, "CUMC12": RegDataSetBrains,
        "IBSR18": RegDataSetBrains, "MGH10": RegDataSetBrains,
        "MindBoggle": RegDataSetMindBoggle}


def get_seg_dataset(data: str):
    if data not in _SEG:
        raise ValueError("Wrong dataset given!")
    return _SEG[data]


def get_reg_dataset(data: str):
    if data not in _REG:
        raise ValueError("Wrong dataset given!")
    return _REG[data]
