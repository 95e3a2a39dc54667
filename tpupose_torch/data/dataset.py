"""Dataset manifests and image loading.

Counterpart of `tpupose/data/dataset.py` (`src/dataset.py:19-45`):
per-camera globs natural-sorted and transposed into per-frame lists;
Panoptic timestamps parsed from the filename suffix. Decodes with PIL
(imported where an image is read) into RGB uint8 arrays.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from tpupose_torch.data.config import DatasetConfig
from tpupose_torch.utils.natsort import natsorted


def load_filenames(dataset: DatasetConfig):
    """Per-frame lists of N camera image paths (`src/dataset.py:19-34`)."""
    files = []
    for folder in dataset.folders_order:
        pattern = os.path.join(dataset.root, folder, dataset.data_format)
        files.append(natsorted(glob.glob(pattern)))
    n = min(len(f) for f in files) if files else 0
    return [[f[i] for f in files] for i in range(n)]


def parse_timestamp(dataset_name: str, path: str):
    """Frame timestamp from a file path (`src/dataset.py:37-40`)."""
    stem = os.path.basename(path).rsplit(".", 1)[0]
    if dataset_name == "Panoptic":
        return int(stem.split("_")[-1])
    return stem


def load_images(dataset_name: str, files):
    """Load one frame's images from all cameras -> (list of HxWx3 RGB uint8,
    timestamp)."""
    from PIL import Image

    timestamp = parse_timestamp(dataset_name, files[0])
    images = [np.asarray(Image.open(f).convert("RGB")) for f in files]
    return images, timestamp
