"""Data augmentation pipeline (numpy + cv2), HWC output per sample (the
port's own copy of m3vit_tpu/data/transforms.py:36-216; data/loader.py
collates the samples into NCHW batches).

Semantics mirror the reference transforms exactly
(reference: data/custom_transforms.py):
  ScaleNRotate          :18-85   — rotation/scale warp, normals in-plane vector
                                   rotation (:67-73), depth /= scale (:77-78)
  FixedResize           :88-141  — per-element interp flags, normals
                                   re-normalization after resize (:131-134)
  RandomHorizontalFlip  :174-194 — flips + normals x-component sign flip
  AddIgnoreRegions      :243-271 — zero-norm normals -> 255, empty human_parts
                                   -> 255, zero depth -> 255
  Normalize (ImageNet)  :307-318 — composed after a uint8-cast /255
                                   (ToTensor casts to uint8 first, :295)

Output layout: image [H,W,3] float32 normalized; labels [H,W,C] float32.
Every random draw comes from the RandomState passed to the call.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import cv2
import numpy as np

CV2_FLAGS = {
    "nearest": cv2.INTER_NEAREST,
    "linear": cv2.INTER_LINEAR,
    "cubic": cv2.INTER_CUBIC,
}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def fixed_resize(sample: np.ndarray, resolution, flagval: int) -> np.ndarray:
    """reference: utils/helpers.py:66-92 (tuple-resolution branch)."""
    if isinstance(resolution, int):
        tmp = [resolution, resolution]
        tmp[int(np.argmax(sample.shape[:2]))] = int(
            round(float(resolution) / np.min(sample.shape[:2]) * np.max(sample.shape[:2]))
        )
        resolution = tuple(tmp)
    resolution = tuple(resolution)
    if sample.ndim == 2 or (sample.ndim == 3 and sample.shape[2] == 3):
        return cv2.resize(sample, resolution[::-1], interpolation=flagval)
    out = np.zeros(np.append(resolution, sample.shape[2]), dtype=np.float32)
    for ii in range(sample.shape[2]):
        out[:, :, ii] = cv2.resize(
            sample[:, :, ii], resolution[::-1], interpolation=flagval
        )
    return out


class ScaleNRotate:
    def __init__(self, rots=(-30, 30), scales=(0.75, 1.25), flagvals=None):
        self.rots = rots
        self.scales = scales
        self.flagvals = flagvals  # dict name -> interp string

    def __call__(self, sample: Dict, rng: np.random.RandomState) -> Dict:
        if isinstance(self.rots, tuple):
            rot = (self.rots[1] - self.rots[0]) * rng.random_sample() - (
                self.rots[1] - self.rots[0]
            ) / 2
            sc = (self.scales[1] - self.scales[0]) * rng.random_sample() - (
                self.scales[1] - self.scales[0]
            ) / 2 + 1
        else:  # fixed lists
            rot = self.rots[rng.randint(0, len(self.rots))]
            sc = self.scales[rng.randint(0, len(self.scales))]

        for elem in list(sample.keys()):
            if "meta" in elem:
                continue
            tmp = sample[elem]
            h, w = tmp.shape[:2]
            center = (w / 2, h / 2)
            M = cv2.getRotationMatrix2D(center, rot, sc)
            flagval = CV2_FLAGS[self.flagvals[elem]]

            if elem == "normals":
                # rotate the in-plane component of the normal vectors
                in_plane = np.arctan2(tmp[:, :, 0], tmp[:, :, 1])
                nrm_0 = np.sqrt(tmp[:, :, 0] ** 2 + tmp[:, :, 1] ** 2)
                rot_rad = rot * 2 * math.pi / 360
                tmp = tmp.copy()
                tmp[:, :, 0] = np.sin(in_plane + rot_rad) * nrm_0
                tmp[:, :, 1] = np.cos(in_plane + rot_rad) * nrm_0

            tmp = cv2.warpAffine(tmp, M, (w, h), flags=flagval)
            if elem == "depth":
                tmp = tmp / sc
            sample[elem] = tmp
        return sample


class FixedResize:
    def __init__(self, resolutions: Dict, flagvals: Dict):
        self.resolutions = resolutions
        self.flagvals = flagvals

    def __call__(self, sample: Dict, rng=None) -> Dict:
        for elem in list(sample.keys()):
            if "meta" in elem:
                continue
            if elem not in self.resolutions:
                del sample[elem]
                continue
            if self.resolutions[elem] is None:
                continue
            sample[elem] = fixed_resize(
                sample[elem], self.resolutions[elem], CV2_FLAGS[self.flagvals[elem]]
            )
            if elem == "normals":
                n = sample[elem]
                nn = np.sqrt((n**2).sum(-1)) + np.finfo(np.float32).eps
                sample[elem] = n / nn[..., None]
        return sample


class RandomHorizontalFlip:
    def __call__(self, sample: Dict, rng: np.random.RandomState) -> Dict:
        if rng.random_sample() < 0.5:
            for elem in list(sample.keys()):
                if "meta" in elem:
                    continue
                sample[elem] = cv2.flip(sample[elem], flipCode=1)
                if elem == "normals":
                    sample[elem] = sample[elem].copy()
                    sample[elem][:, :, 0] *= -1
        return sample


class AddIgnoreRegions:
    def __call__(self, sample: Dict, rng=None) -> Dict:
        for elem in list(sample.keys()):
            if "meta" in elem:
                continue
            tmp = sample[elem]
            if elem == "normals":
                nn = np.sqrt((tmp**2).sum(-1))
                tmp = tmp.copy()
                tmp[nn == 0, :] = 255.0
                sample[elem] = tmp
            elif elem == "human_parts":
                if (tmp == 0).all():
                    sample[elem] = 255 * np.ones(tmp.shape, dtype=tmp.dtype)
            elif elem == "depth":
                tmp = tmp.copy()
                tmp[tmp == 0] = 255.0
                sample[elem] = tmp
        return sample


class ToArrays:
    """uint8-cast + /255 + ImageNet normalization for the image; labels
    promoted to [H,W,C] float32 (the ToTensor+Normalize pair, NHWC)."""

    def __call__(self, sample: Dict, rng=None) -> Dict:
        for elem in list(sample.keys()):
            if "meta" in elem:
                continue
            tmp = sample[elem]
            if tmp.ndim == 2:
                tmp = tmp[:, :, None]
            if elem == "image":
                img = tmp.astype(np.uint8).astype(np.float32) / 255.0
                sample[elem] = (img - IMAGENET_MEAN) / IMAGENET_STD
            else:
                sample[elem] = tmp.astype(np.float32)
        return sample


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample: Dict, rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random.RandomState()
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


def get_transformations(p):
    """Train/val transform stacks (reference: utils/common_config.py:583-632)."""
    all_names = ["image"] + [t.name for t in p["ALL_TASKS"]]
    flagvals = {"image": "cubic"}
    for t in p["ALL_TASKS"]:
        flagvals[t.name] = t.flagval

    db = p["train_db_name"]
    if db == "PASCALContext":
        aug = ScaleNRotate(rots=(-20, 20), scales=(0.75, 1.25), flagvals=flagvals)
    elif db in ("NYUD", "CityScapes"):
        aug = ScaleNRotate(rots=[0], scales=[1.0, 1.2, 1.5], flagvals=flagvals)
    else:
        raise ValueError(db)

    train_res = {n: tuple(p["train_scale"]) for n in all_names}
    test_res = {n: tuple(p["test_scale"]) for n in all_names}

    transforms_tr = Compose(
        [
            RandomHorizontalFlip(),
            aug,
            FixedResize(train_res, flagvals),
            AddIgnoreRegions(),
            ToArrays(),
        ]
    )
    transforms_ts = Compose(
        [FixedResize(test_res, flagvals), AddIgnoreRegions(), ToArrays()]
    )
    return transforms_tr, transforms_ts
