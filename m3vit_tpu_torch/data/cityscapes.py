"""Cityscapes (preprocessed .npy, 7-class semseg + depth; the port's own
copy of m3vit_tpu/data/cityscapes.py).

reference: data/cityscapes.py:113-145 — image/<i>.npy NHWC float,
label_7/<i>.npy (-1 -> 255), depth/<i>.npy with 0 -> 255 ignore.
Augmentation (scale-crop/flip) comes from the shared transform stack.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


class CityScapes:
    def __init__(
        self,
        root: str,
        split="val",
        transform=None,
        retname: bool = True,
        overfit: bool = False,
        do_semseg: bool = True,
        do_depth: bool = True,
    ):
        self.data_path = os.path.join(root, split)
        if not os.path.isdir(self.data_path):
            raise FileNotFoundError(f"CityScapes path {self.data_path} not found")
        self.transform = transform
        self.retname = retname
        self.do_semseg = do_semseg
        self.do_depth = do_depth
        n = len(
            [f for f in os.listdir(os.path.join(self.data_path, "image"))
             if f.endswith(".npy")]
        )
        self.n = min(n, 64) if overfit else n

    def __len__(self):
        return self.n

    def __getitem__(self, index: int) -> Dict:
        sample: Dict = {}
        img = np.load(os.path.join(self.data_path, "image", f"{index}.npy"))
        sample["image"] = (np.asarray(img, np.float32) * 255.0)  # to 0..255
        if self.do_semseg:
            sem = np.load(
                os.path.join(self.data_path, "label_7", f"{index}.npy")
            ).astype(np.float32)
            sem[sem == -1] = 255
            sample["semseg"] = sem
        if self.do_depth:
            dep = np.load(
                os.path.join(self.data_path, "depth", f"{index}.npy")
            ).astype(np.float32)
            dep[dep == 0] = 255.0
            sample["depth"] = np.squeeze(dep)
        if self.retname:
            sample["meta"] = {"image": str(index), "im_size": img.shape[:2]}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
