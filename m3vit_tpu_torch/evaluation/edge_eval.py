"""Offline boundary evaluation: odsF / oisF / AP without MATLAB (the
port's own copy of m3vit_tpu/evaluation/edge_eval.py).

Replaces the reference's external seism pipeline (reference:
evaluation/run_evaluation_edge.py:30-85 — rsync + sbatch MATLAB job that
computes the BSDS-style boundary F-measure).  This is a Python
implementation of the same protocol:

  for each threshold t in a sweep:
    binarize + thin the predicted edge map
    correspond pred/GT boundary pixels one-to-one within a distance
    tolerance (max_dist * image diagonal)
    accumulate matched/total counts over the dataset
  odsF = best F over thresholds on dataset-aggregated counts
  oisF = mean over images of the per-image best F
  AP   = area under the (interpolated) precision-recall curve

Pixel correspondence, two matchers:

  * exact (default): MAXIMUM-cardinality one-to-one bipartite matching over
    all pred/GT pixel pairs within tolerance (Hopcroft-Karp via
    scipy.sparse.csgraph).  seism's correspondPixels solves a min-COST
    max-cardinality assignment (CSA); the boundary F-measure consumes only
    the match COUNTS, so max-cardinality matching reproduces seism's
    precision/recall exactly — distances only affect which pixels pair up,
    not how many.
  * greedy: nearest-first one-to-one matching via KD-tree with 4 candidates
    per pred pixel (native C++ kernel when available).  Faster; a lower
    bound on the exact count (maximal-within-candidates ⇒ ≥ 1/2 maximum in
    the worst case; the native kernel considers every GT pixel within
    tolerance, the Python fallback the 4 nearest).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree

from m3vit_tpu_torch.data.pascal_context import zhang_suen_thin


def _match_counts(
    pred: np.ndarray, gt: np.ndarray, max_dist_px: float
) -> Tuple[int, int, int, int]:
    """One-to-one greedy correspondence within max_dist_px.

    Returns (matched_pred, total_pred, matched_gt, total_gt).
    Uses the native C++ kernel when available (m3vit_tpu_torch.native)."""
    from m3vit_tpu_torch import native

    res = native.match_boundaries(pred, gt, max_dist_px)
    if res is not None:
        return res
    pred_pts = np.argwhere(pred)
    gt_pts = np.argwhere(gt)
    n_pred, n_gt = len(pred_pts), len(gt_pts)
    if n_pred == 0 or n_gt == 0:
        return 0, n_pred, 0, n_gt

    tree = cKDTree(gt_pts)
    # candidate pairs sorted by distance -> greedy one-to-one
    dists, idxs = tree.query(pred_pts, k=min(4, n_gt),
                             distance_upper_bound=max_dist_px)
    dists = np.atleast_2d(dists)
    idxs = np.atleast_2d(idxs)
    cand = []
    for pi in range(n_pred):
        for k in range(dists.shape[1]):
            if np.isfinite(dists[pi, k]):
                cand.append((dists[pi, k], pi, idxs[pi, k]))
    cand.sort()
    used_pred = np.zeros(n_pred, bool)
    used_gt = np.zeros(n_gt, bool)
    matched = 0
    for _, pi, gi in cand:
        if not used_pred[pi] and not used_gt[gi]:
            used_pred[pi] = used_gt[gi] = True
            matched += 1
    return matched, n_pred, matched, n_gt


def _match_counts_exact(
    pred: np.ndarray, gt: np.ndarray, max_dist_px: float
) -> Tuple[int, int, int, int]:
    """Maximum-cardinality one-to-one correspondence within max_dist_px.

    Exactly reproduces the seism/BSDS correspondPixels match counts
    (reference evaluation/seism/, run_evaluation_edge.py:30-85): CSA's
    min-cost max-cardinality assignment has the same cardinality as plain
    maximum bipartite matching, and the F-measure uses only the counts.
    """
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching

    pred_pts = np.argwhere(pred)
    gt_pts = np.argwhere(gt)
    n_pred, n_gt = len(pred_pts), len(gt_pts)
    if n_pred == 0 or n_gt == 0:
        return 0, n_pred, 0, n_gt

    pairs = cKDTree(pred_pts).query_ball_tree(cKDTree(gt_pts), max_dist_px)
    rows = np.fromiter(
        (pi for pi, js in enumerate(pairs) for _ in js), np.int32
    )
    cols = np.fromiter((j for js in pairs for j in js), np.int32)
    if len(rows) == 0:
        return 0, n_pred, 0, n_gt
    graph = csr_matrix(
        (np.ones(len(rows), np.int8), (rows, cols)), shape=(n_pred, n_gt)
    )
    m = maximum_bipartite_matching(graph, perm_type="column")
    matched = int((m != -1).sum())
    return matched, n_pred, matched, n_gt


def evaluate_boundaries(
    preds: Iterable[np.ndarray],  # float edge probability maps [H, W] in [0,1]
    gts: Iterable[np.ndarray],  # binary GT boundary maps [H, W]
    thresholds: int = 25,
    max_dist: float = 0.0075,
    apply_thinning: bool = True,
    matcher: str = "exact",
) -> Dict:
    assert matcher in ("exact", "greedy"), matcher
    match_fn = _match_counts_exact if matcher == "exact" else _match_counts
    ts = np.linspace(1.0 / (thresholds + 1), 1.0 - 1.0 / (thresholds + 1),
                     thresholds)
    cnt_p = np.zeros(thresholds)
    sum_p = np.zeros(thresholds)
    cnt_r = np.zeros(thresholds)
    sum_r = np.zeros(thresholds)
    ois_f: List[float] = []

    for pred, gt in zip(preds, gts):
        pred = np.asarray(pred, np.float32)
        gt = np.asarray(gt) > 0.5
        diag = float(np.hypot(*pred.shape))
        tol = max_dist * diag
        img_f = []
        for ti, t in enumerate(ts):
            pb = pred >= t
            if apply_thinning and pb.any():
                from m3vit_tpu_torch import native

                thinned = native.thin(pb)
                pb = (thinned if thinned is not None
                      else zhang_suen_thin(pb)).astype(bool)
            mp, tp_, mg, tg = match_fn(pb, gt, tol)
            cnt_p[ti] += mp
            sum_p[ti] += tp_
            cnt_r[ti] += mg
            sum_r[ti] += tg
            prec = mp / max(tp_, 1)
            rec = mg / max(tg, 1)
            img_f.append(2 * prec * rec / max(prec + rec, 1e-12))
        ois_f.append(max(img_f))

    prec = cnt_p / np.maximum(sum_p, 1)
    rec = cnt_r / np.maximum(sum_r, 1)
    f = 2 * prec * rec / np.maximum(prec + rec, 1e-12)
    best = int(np.argmax(f))

    # AP: precision envelope integrated over recall (monotone interp)
    order = np.argsort(rec)
    r_s, p_s = rec[order], prec[order]
    # np.trapezoid is numpy >= 2's name of np.trapz
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    ap = float(trapezoid(p_s, r_s)) if len(r_s) > 1 else 0.0

    return {
        "odsF": float(f[best]),
        "ods_threshold": float(ts[best]),
        "ods_precision": float(prec[best]),
        "ods_recall": float(rec[best]),
        "oisF": float(np.mean(ois_f)) if ois_f else 0.0,
        "ap": ap,
        "thresholds": ts.tolist(),
        "f_curve": f.tolist(),
    }


def eval_edge_predictions_from_dir(
    save_dir: str, dataset, thresholds: int = 25, matcher: str = "exact",
    gts: Optional[Sequence[np.ndarray]] = None,
) -> Dict:
    """Score saved edge PNGs (save_model_predictions layout) against a
    dataset that yields {'edge': ...} samples (reference protocol); `gts`,
    when given, are those samples' edge maps in dataset order, already
    read."""
    import os

    import cv2

    def preds():
        for i in range(len(dataset)):
            im_id = dataset.im_ids[i]
            path = os.path.join(save_dir, "edge", f"{im_id}.png")
            yield cv2.imread(path, cv2.IMREAD_GRAYSCALE).astype(np.float32) / 255.0

    if gts is None:
        gts = (dataset[i]["edge"] for i in range(len(dataset)))
    return evaluate_boundaries(preds(), gts, thresholds, matcher=matcher)
