"""NYUD-v2 multi-task dataset reader (the port's own copy of
m3vit_tpu/data/nyud.py; reference: data/nyud.py).

Layout: images/<id>.jpg, edge/<id>.npy, segmentation/<id>.png (1..40, 0=void),
normals/<id>.npy, depth/<id>.npy, gt_sets/<split>.txt.  Semseg labels are
shifted down by one with void (0) mapped to 255 (reference :200-205).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
from PIL import Image


class NYUD:
    def __init__(
        self,
        root: str,
        split="val",
        transform=None,
        retname: bool = True,
        overfit: bool = False,
        do_edge: bool = False,
        do_semseg: bool = False,
        do_normals: bool = False,
        do_depth: bool = False,
    ):
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"NYUD_MT root {root} not found (the reader does not download "
                "it)."
            )
        self.root = root
        self.transform = transform
        self.retname = retname
        self.split = [split] if isinstance(split, str) else sorted(split)
        self.do_edge = do_edge
        self.do_semseg = do_semseg
        self.do_normals = do_normals
        self.do_depth = do_depth

        self.im_ids: List[str] = []
        self.images: List[str] = []
        self.edges: List[str] = []
        self.semsegs: List[str] = []
        self.normals: List[str] = []
        self.depths: List[str] = []

        for splt in self.split:
            with open(os.path.join(root, "gt_sets", splt + ".txt")) as f:
                lines = f.read().splitlines()
            for line in lines:
                line = line.strip()
                self.im_ids.append(line)
                self.images.append(os.path.join(root, "images", line + ".jpg"))
                self.edges.append(os.path.join(root, "edge", line + ".npy"))
                self.semsegs.append(
                    os.path.join(root, "segmentation", line + ".png")
                )
                self.normals.append(os.path.join(root, "normals", line + ".npy"))
                self.depths.append(os.path.join(root, "depth", line + ".npy"))

        if overfit:
            n_of = 64
            for name in ("im_ids", "images", "edges", "semsegs", "normals",
                         "depths"):
                setattr(self, name, getattr(self, name)[:n_of])

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int) -> Dict:
        sample: Dict = {}
        img = np.array(Image.open(self.images[index]).convert("RGB")).astype(
            np.float32
        )
        sample["image"] = img
        if self.do_edge:
            sample["edge"] = np.load(self.edges[index]).astype(np.float32)
        if self.do_semseg:
            semseg = np.array(Image.open(self.semsegs[index])).astype(np.float32)
            semseg[semseg == 0] = 256
            sample["semseg"] = semseg - 1
        if self.do_normals:
            sample["normals"] = np.load(self.normals[index]).astype(np.float32)
        if self.do_depth:
            sample["depth"] = np.load(self.depths[index]).astype(np.float32)
        if self.retname:
            sample["meta"] = {
                "image": str(self.im_ids[index]),
                "im_size": img.shape[:2],
            }
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
