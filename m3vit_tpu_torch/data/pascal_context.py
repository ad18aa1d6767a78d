"""PASCAL-Context multi-task dataset reader (the port's own copy of
m3vit_tpu/data/pascal_context.py:31-278).

Same on-disk layout and label semantics as the reference
(reference: data/pascal_context.py):
  JPEGImages/<id>.jpg
  pascal-context/trainval/<id>.mat   (LabelMap; edges via |Laplacian|>0 + thin)
  human_parts/<id>.mat               (part annotations, merged to 6 parts)
  semseg/VOC12/<id>.png | semseg/pascal-context/<id>.png
  normals_distill/<id>.png           ([0,255] -> [-1,1], masked by valid classes)
  sal_distill/<id>.png               (binarized at 0.5)
  ImageSets/Context/<split>.txt, ImageSets/Parts/<split>.txt (json obj dict)

No auto-download; raises with instructions if the root is missing.
Morphological thinning uses the native library (m3vit_tpu_torch.native) or
its behavioural reference here, a pure-numpy Zhang-Suen
implementation (the reference uses skimage.morphology.thin).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import cv2
import numpy as np
from PIL import Image

from m3vit_tpu_torch.data.db_info import HUMAN_PART, NORMALS_VALID_CLASSES


def zhang_suen_thin(img: np.ndarray, max_iter: int = 10000) -> np.ndarray:
    """Morphological thinning of a binary image (Zhang-Suen, vectorized)."""
    img = (img > 0).astype(np.uint8)

    def neighbours(p):
        # clockwise from north: P2..P9 as shifted views
        return [
            np.roll(p, 1, 0),                      # P2 north
            np.roll(np.roll(p, 1, 0), -1, 1),      # P3 ne
            np.roll(p, -1, 1),                     # P4 east
            np.roll(np.roll(p, -1, 0), -1, 1),     # P5 se
            np.roll(p, -1, 0),                     # P6 south
            np.roll(np.roll(p, -1, 0), 1, 1),      # P7 sw
            np.roll(p, 1, 1),                      # P8 west
            np.roll(np.roll(p, 1, 0), 1, 1),       # P9 nw
        ]

    for _ in range(max_iter):
        changed = False
        for step in (0, 1):
            P = neighbours(img)
            B = sum(P)
            seq = P + [P[0]]
            A = sum(
                ((seq[i] == 0) & (seq[i + 1] == 1)).astype(np.uint8)
                for i in range(8)
            )
            if step == 0:
                cond = (P[0] * P[2] * P[4] == 0) & (P[2] * P[4] * P[6] == 0)
            else:
                cond = (P[0] * P[2] * P[6] == 0) & (P[0] * P[4] * P[6] == 0)
            delete = (img == 1) & (B >= 2) & (B <= 6) & (A == 1) & cond
            # border pixels never deleted (roll wraps around)
            delete[0, :] = delete[-1, :] = False
            delete[:, 0] = delete[:, -1] = False
            if delete.any():
                img[delete] = 0
                changed = True
        if not changed:
            break
    return img


class PASCALContext:
    """Multi-task PASCAL-Context (reference: data/pascal_context.py:27-505)."""

    def __init__(
        self,
        root: str,
        split="val",
        transform=None,
        retname: bool = True,
        overfit: bool = False,
        do_edge: bool = True,
        do_human_parts: bool = False,
        do_semseg: bool = False,
        do_normals: bool = False,
        do_sal: bool = False,
        num_human_parts: int = 6,
    ):
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"PASCAL_MT root {root} not found. Download PASCAL_MT.tgz "
                "(ASTMT release) and extract it there; the reader does not "
                "download it."
            )
        self.root = root
        self.transform = transform
        self.split = [split] if isinstance(split, str) else sorted(split)
        self.retname = retname
        self.do_edge = do_edge
        self.do_human_parts = do_human_parts
        self.do_semseg = do_semseg
        self.do_normals = do_normals
        self.do_sal = do_sal

        self.human_parts_category = 15
        self.part_merge = HUMAN_PART[num_human_parts]
        self.normals_valid_classes = list(NORMALS_VALID_CLASSES)

        image_dir = os.path.join(root, "JPEGImages")
        edge_gt_dir = os.path.join(root, "pascal-context", "trainval")
        part_gt_dir = os.path.join(root, "human_parts")
        normal_gt_dir = os.path.join(root, "normals_distill")
        sal_gt_dir = os.path.join(root, "sal_distill")
        splits_dir = os.path.join(root, "ImageSets", "Context")

        self.im_ids: List[str] = []
        self.images: List[str] = []
        self.edges: List[str] = []
        self.parts: List[str] = []
        self.semsegs: List[Optional[str]] = []
        self.normals: List[str] = []
        self.sals: List[str] = []

        for splt in self.split:
            with open(os.path.join(splits_dir, splt + ".txt")) as f:
                lines = f.read().splitlines()
            for line in lines:
                line = line.strip()
                self.im_ids.append(line)
                self.images.append(os.path.join(image_dir, line + ".jpg"))
                if do_edge:
                    self.edges.append(os.path.join(edge_gt_dir, line + ".mat"))
                if do_human_parts:
                    self.parts.append(os.path.join(part_gt_dir, line + ".mat"))
                if do_semseg:
                    self.semsegs.append(self._get_semseg_fname(line))
                if do_normals:
                    self.normals.append(os.path.join(normal_gt_dir, line + ".png"))
                if do_sal:
                    self.sals.append(os.path.join(sal_gt_dir, line + ".png"))

        # human-parts presence index (ImageSets/Parts/<split>.txt is a json
        # {im_id: [object categories]}, reference :196-217)
        if do_human_parts:
            parts_file = os.path.join(
                root, "ImageSets", "Parts", "".join(self.split) + ".txt"
            )
            with open(parts_file) as f:
                part_obj_dict = json.load(f)
            self.has_human_parts = [
                1 if self.human_parts_category in part_obj_dict.get(i, []) else 0
                for i in self.im_ids
            ]
            only_parts = not (do_edge or do_semseg or do_sal or do_normals)
            if only_parts:
                keep = [i for i, h in enumerate(self.has_human_parts) if h]
                self.im_ids = [self.im_ids[i] for i in keep]
                self.images = [self.images[i] for i in keep]
                self.parts = [self.parts[i] for i in keep]
                self.has_human_parts = [1] * len(keep)

        if overfit:
            n_of = 64
            for name in ("im_ids", "images", "edges", "parts", "semsegs",
                         "normals", "sals"):
                setattr(self, name, getattr(self, name)[:n_of])
            if do_human_parts:
                self.has_human_parts = self.has_human_parts[:n_of]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int) -> Dict:
        sample: Dict = {}
        img = np.array(Image.open(self.images[index]).convert("RGB")).astype(
            np.float32
        )
        sample["image"] = img
        hw = img.shape[:2]

        if self.do_edge:
            edge = self._load_edge(index)
            if edge.shape != hw:
                edge = cv2.resize(edge, hw[::-1], interpolation=cv2.INTER_NEAREST)
            sample["edge"] = edge
        if self.do_human_parts:
            parts = self._load_human_parts(index)
            if parts.shape != hw:
                parts = cv2.resize(parts, hw[::-1], interpolation=cv2.INTER_NEAREST)
            sample["human_parts"] = parts
        if self.do_semseg:
            semseg = np.array(Image.open(self.semsegs[index])).astype(np.float32)
            if semseg.shape != hw:
                semseg = cv2.resize(semseg, hw[::-1], interpolation=cv2.INTER_NEAREST)
            sample["semseg"] = semseg
        if self.do_normals:
            normals = self._load_normals_distilled(index)
            if normals.shape[:2] != hw:
                normals = cv2.resize(normals, hw[::-1], interpolation=cv2.INTER_CUBIC)
            sample["normals"] = normals
        if self.do_sal:
            sal = self._load_sal_distilled(index)
            if sal.shape[:2] != hw:
                sal = cv2.resize(sal, hw[::-1], interpolation=cv2.INTER_NEAREST)
            sample["sal"] = sal

        if self.retname:
            sample["meta"] = {"image": str(self.im_ids[index]), "im_size": hw}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample

    # --- label loaders ----------------------------------------------------
    def _load_edge(self, index: int) -> np.ndarray:
        import scipy.io as sio

        label_map = sio.loadmat(self.edges[index])["LabelMap"]
        edge = cv2.Laplacian(label_map.astype(np.float64), cv2.CV_64F)
        binary = np.abs(edge) > 0
        from m3vit_tpu_torch import native

        thinned = native.thin(binary)
        if thinned is None:
            thinned = zhang_suen_thin(binary)
        return thinned.astype(np.float32)

    def _load_human_parts(self, index: int) -> np.ndarray:
        import scipy.io as sio

        if not self.has_human_parts[index]:
            return np.zeros((512, 512), np.float32)
        part_mat = sio.loadmat(self.parts[index])["anno"][0][0][1][0]
        target = None
        for obj in part_mat:
            has_human = obj[1][0][0] == self.human_parts_category
            has_parts = len(obj[3]) != 0
            if has_human and has_parts:
                if target is None:
                    target = np.zeros(obj[2].shape, np.float32)
                for part in obj[3][0]:
                    cat_part = str(part[0][0])
                    mask_id = self.part_merge[cat_part]
                    target[part[1].astype(bool)] = mask_id
        if target is None:
            return np.zeros((512, 512), np.float32)
        return target.astype(np.float32)

    def _load_normals_distilled(self, index: int) -> np.ndarray:
        import scipy.io as sio

        tmp = np.array(Image.open(self.normals[index])).astype(np.float32)
        tmp = 2.0 * tmp / 255.0 - 1.0
        labels = sio.loadmat(
            os.path.join(self.root, "pascal-context", "trainval",
                         self.im_ids[index] + ".mat")
        )["LabelMap"]
        normals = np.zeros(tmp.shape, np.float32)
        for x in np.unique(labels):
            if x in self.normals_valid_classes:
                normals[labels == x, :] = tmp[labels == x, :]
        return normals

    def _load_sal_distilled(self, index: int) -> np.ndarray:
        sal = np.array(Image.open(self.sals[index])).astype(np.float32) / 255.0
        return (sal > 0.5).astype(np.float32)

    def _get_semseg_fname(self, fname: str) -> Optional[str]:
        fname_voc = os.path.join(self.root, "semseg", "VOC12", fname + ".png")
        fname_context = os.path.join(
            self.root, "semseg", "pascal-context", fname + ".png"
        )
        if os.path.isfile(fname_voc):
            return fname_voc
        if os.path.isfile(fname_context):
            return fname_context
        return None
