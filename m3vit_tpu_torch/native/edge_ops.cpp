// Native eval kernels: Zhang-Suen thinning + greedy boundary correspondence.
//
// These are the CPU-side hot loops of the evaluation pipeline (the reference
// offloads them to MATLAB seism / skimage): thinning runs per threshold per
// image in the odsF sweep, and pixel correspondence is quadratic-ish in
// boundary length.  Built as a shared library, bound via ctypes
// (m3vit_tpu_torch/native/__init__.py); the Python implementations remain as
// fallbacks and as the reference for tests.

#include <cstdint>
#include <cstring>
#include <vector>
#include <cmath>
#include <algorithm>

extern "C" {

// In-place Zhang-Suen thinning of a binary image (uint8 0/1), row-major.
void zhang_suen_thin(uint8_t* img, int h, int w, int max_iter) {
    std::vector<int> del;
    del.reserve(1024);
    auto at = [&](int y, int x) -> uint8_t& { return img[y * w + x]; };

    for (int it = 0; it < max_iter; ++it) {
        bool changed = false;
        for (int step = 0; step < 2; ++step) {
            del.clear();
            for (int y = 1; y < h - 1; ++y) {
                for (int x = 1; x < w - 1; ++x) {
                    if (!at(y, x)) continue;
                    uint8_t p2 = at(y - 1, x),     p3 = at(y - 1, x + 1);
                    uint8_t p4 = at(y, x + 1),     p5 = at(y + 1, x + 1);
                    uint8_t p6 = at(y + 1, x),     p7 = at(y + 1, x - 1);
                    uint8_t p8 = at(y, x - 1),     p9 = at(y - 1, x - 1);
                    int b = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9;
                    if (b < 2 || b > 6) continue;
                    uint8_t seq[9] = {p2, p3, p4, p5, p6, p7, p8, p9, p2};
                    int a = 0;
                    for (int k = 0; k < 8; ++k)
                        if (seq[k] == 0 && seq[k + 1] == 1) ++a;
                    if (a != 1) continue;
                    bool cond = step == 0
                        ? (p2 * p4 * p6 == 0 && p4 * p6 * p8 == 0)
                        : (p2 * p4 * p8 == 0 && p2 * p6 * p8 == 0);
                    if (cond) del.push_back(y * w + x);
                }
            }
            if (!del.empty()) {
                changed = true;
                for (int idx : del) img[idx] = 0;
            }
        }
        if (!changed) break;
    }
}

// Greedy one-to-one correspondence between two boundary maps within
// max_dist.  pred/gt: binary uint8 [h*w].  Returns counts through pointers:
// matched (one-to-one pairs), n_pred, n_gt.
void match_boundaries(const uint8_t* pred, const uint8_t* gt, int h, int w,
                      double max_dist, int* matched_out, int* n_pred_out,
                      int* n_gt_out) {
    std::vector<int> pred_pts, gt_pts;
    for (int i = 0; i < h * w; ++i) {
        if (pred[i]) pred_pts.push_back(i);
        if (gt[i]) gt_pts.push_back(i);
    }
    *n_pred_out = (int)pred_pts.size();
    *n_gt_out = (int)gt_pts.size();
    if (pred_pts.empty() || gt_pts.empty()) {
        *matched_out = 0;
        return;
    }

    // bucket GT pixels into a grid of cell size r >= max_dist so the
    // +-1-cell neighbourhood always covers the search radius
    int r = std::max(1, (int)std::ceil(max_dist));
    int gh = (h + r - 1) / r, gw = (w + r - 1) / r;
    std::vector<std::vector<int>> grid(gh * gw);
    for (int gi : gt_pts)
        grid[(gi / w / r) * gw + (gi % w / r)].push_back(gi);

    // candidate pairs (dist, pred_idx, gt_idx) within max_dist
    struct Cand { float d; int p; int g; };
    std::vector<Cand> cands;
    double md2 = max_dist * max_dist;
    for (int pi = 0; pi < (int)pred_pts.size(); ++pi) {
        int py = pred_pts[pi] / w, px = pred_pts[pi] % w;
        int cy = py / r, cx = px / r;
        for (int dy = -1; dy <= 1; ++dy) {
            for (int dx = -1; dx <= 1; ++dx) {
                int ny = cy + dy, nx = cx + dx;
                if (ny < 0 || ny >= gh || nx < 0 || nx >= gw) continue;
                for (int gi : grid[ny * gw + nx]) {
                    int gy = gi / w, gx = gi % w;
                    double d2 = double(py - gy) * (py - gy)
                              + double(px - gx) * (px - gx);
                    if (d2 <= md2)
                        cands.push_back({(float)d2, pi, gi});
                }
            }
        }
    }
    std::sort(cands.begin(), cands.end(),
              [](const Cand& a, const Cand& b) { return a.d < b.d; });

    std::vector<uint8_t> used_pred(pred_pts.size(), 0);
    std::vector<uint8_t> used_gt(h * w, 0);
    int matched = 0;
    for (const Cand& c : cands) {
        if (used_pred[c.p] || used_gt[c.g]) continue;
        used_pred[c.p] = 1;
        used_gt[c.g] = 1;
        ++matched;
    }
    *matched_out = matched;
}

}  // extern "C"
