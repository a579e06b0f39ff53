// Copy of torchmetrics_tpu/native/match.cpp, built with g++ by torchmetrics_tpu_torch/native/rle_mask.py.
// COCO greedy detection<->ground-truth matcher, one call per (image, class).
//
// Replaces the per-(image, class, area, threshold) Python loops in
// detection/mean_ap.py (reference semantics: mean_ap.py:510-635): one call
// evaluates ALL area ranges and IoU thresholds, so the Python side makes
// n_nonempty_pairs calls instead of n_pairs * areas * thresholds * dets numpy ops.
//
// Semantics pinned by tests/detection goldens (pycocotools parity):
// - detections arrive score-sorted (stable desc) and truncated to max_det;
// - per area range, ground truths are stably partitioned: in-range first,
//   out-of-range (ignored) last; matching considers only unmatched, non-ignored
//   gts; ties resolve to the lowest partitioned index (numpy argmax semantics);
// - a detection matches the best such gt if IoU > threshold (STRICT inequality);
// - unmatched detections whose own area is out of range are marked ignored.
//
// Threshold convention (deliberate, test-pinned divergence from pycocotools):
// pycocotools seeds its per-detection running best at `min(thr, 1 - 1e-10)`,
// which makes a gt with IoU EXACTLY equal to the threshold matchable
// (effectively `iou >= thr - 1e-10`), and additionally lets "crowd" gts match
// after all real gts were exhausted. This kernel — and the numpy fallback and
// the epoch-level evaluator below, which share the rule — uses strict
// `IoU > thr` and never matches ignored gts. The two conventions differ only
// when an IoU sits exactly ON a threshold (easy to construct with integer
// boxes at thr 0.5, measure-zero for float predictions) or when crowd
// annotations are present (the update API does not ingest `iscrowd`).
// Exact-threshold behaviour is pinned by
// tests/detection/test_native_eval_parity.py::test_exact_threshold_iou_is_not_a_match;
// if pycocotools parity at exact-threshold IoU ever becomes a requirement,
// change BOTH kernels and the numpy fallback together to `best >= thr - 1e-10`.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// iou:          (D, G) row-major; rows score-sorted, columns in original gt order
// det_areas:    (D,)
// gt_areas:     (G,)
// thrs:         (T,) IoU thresholds
// ranges:       (A, 2) [lo, hi] area ranges
// det_matches:  (A, T, D) out, zero-initialised by caller
// det_ignore:   (A, T, D) out, zero-initialised
// gt_ignore:    (A, G)    out — ignore flags in the per-area partitioned order
void coco_match(const double* iou, const double* det_areas, const double* gt_areas,
                int64_t D, int64_t G, const double* thrs, int64_t T,
                const double* ranges, int64_t A,
                uint8_t* det_matches, uint8_t* det_ignore, uint8_t* gt_ignore) {
    std::vector<int64_t> gtind(G);
    std::vector<uint8_t> gt_matched(G);
    for (int64_t a = 0; a < A; ++a) {
        const double lo = ranges[2 * a], hi = ranges[2 * a + 1];
        uint8_t* gti = gt_ignore + a * G;
        int64_t k = 0;
        for (int64_t g = 0; g < G; ++g)
            if (!(gt_areas[g] < lo || gt_areas[g] > hi)) gtind[k++] = g;
        const int64_t n_valid = k;
        for (int64_t g = 0; g < G; ++g)
            if (gt_areas[g] < lo || gt_areas[g] > hi) gtind[k++] = g;
        for (int64_t g = 0; g < G; ++g) gti[g] = g >= n_valid;

        for (int64_t t = 0; t < T; ++t) {
            const double thr = thrs[t];
            std::fill(gt_matched.begin(), gt_matched.end(), 0);
            uint8_t* dm = det_matches + (a * T + t) * D;
            uint8_t* di = det_ignore + (a * T + t) * D;
            for (int64_t d = 0; d < D; ++d) {
                const double* row = iou + d * G;
                double best = 0.0;
                int64_t bi = -1;
                for (int64_t g = 0; g < n_valid; ++g) {  // ignored gts never match
                    if (gt_matched[g]) continue;
                    const double v = row[gtind[g]];
                    if (bi < 0 || v > best) { best = v; bi = g; }
                }
                if (bi < 0 || best <= thr) continue;
                dm[d] = 1;
                gt_matched[bi] = 1;
            }
            for (int64_t d = 0; d < D; ++d)
                if (!dm[d] && (det_areas[d] < lo || det_areas[d] > hi)) di[d] = 1;
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Epoch-level COCO bbox evaluation: the WHOLE accumulate stage in one call.
//
// Replaces the per-(class, image) Python driver around coco_match
// (detection/mean_ap.py _calculate/_evaluate_pair/_accumulate, reference
// semantics mean_ap.py:510-844): detections and ground truths arrive as flat
// epoch arrays with image/class-index columns; bucketing, per-image score
// sorting, IoU, greedy matching, and PR-curve accumulation all run here.
// Outputs are the final precision (T,R,C,A,M) and recall (T,C,A,M) tensors,
// pre-filled with -1 by the caller; cells the data never touches stay -1.
//
// Semantics pinned against the numpy path by tests/detection
// (pycocotools-parity fixtures + native-vs-numpy equivalence sweep).

namespace {

struct ImgEval {
    // per-image segment for one (class, image) pair, in ascending image order
    std::vector<double> scores;          // truncated to max_dets[M-1], desc
    std::vector<uint8_t> matches;        // (A, T, D) flat
    std::vector<uint8_t> ignore;         // (A, T, D) flat
    std::vector<int64_t> npig;           // (A,) non-ignored gt count
    int64_t D = 0;
};

inline double box_area_xyxy(const double* b) {
    return (b[2] - b[0]) * (b[3] - b[1]);
}

inline double box_iou_pair(const double* a, const double* b) {
    const double ax = a[2] - a[0], ay = a[3] - a[1];
    const double bx = b[2] - b[0], by = b[3] - b[1];
    const double lx = std::max(a[0], b[0]), ly = std::max(a[1], b[1]);
    const double rx = std::min(a[2], b[2]), ry = std::min(a[3], b[3]);
    const double w = std::max(rx - lx, 0.0), h = std::max(ry - ly, 0.0);
    const double inter = w * h;
    const double uni = ax * ay + bx * by - inter;
    return inter / (uni == 0.0 ? 1.0 : uni);
}

}  // namespace

extern "C" {

void coco_eval_bbox(const double* det_boxes, const double* det_scores,
                    const int64_t* det_img, const int64_t* det_cls, int64_t Nd,
                    const double* gt_boxes, const int64_t* gt_img,
                    const int64_t* gt_cls, int64_t Ng,
                    int64_t n_img, int64_t n_cls,
                    const double* iou_thrs, int64_t T,
                    const double* rec_thrs, int64_t R,
                    const double* ranges, int64_t A,
                    const int64_t* max_dets, int64_t M,
                    double* precision, double* recall) {
    const double EPS = 2.220446049250313e-16;  // np.finfo(float64).eps
    const int64_t max_det_cap = M ? max_dets[M - 1] : 0;

    // counting-sort det/gt indices into (class, image) buckets
    auto bucket = [n_img](const int64_t* cls, const int64_t* img, int64_t N,
                          int64_t n_cls_) {
        std::vector<int64_t> offs(n_cls_ * n_img + 1, 0), out(N);
        for (int64_t i = 0; i < N; ++i) ++offs[cls[i] * n_img + img[i] + 1];
        for (size_t k = 1; k < offs.size(); ++k) offs[k] += offs[k - 1];
        std::vector<int64_t> cur(offs.begin(), offs.end() - 1);
        for (int64_t i = 0; i < N; ++i) out[cur[cls[i] * n_img + img[i]]++] = i;
        return std::make_pair(std::move(offs), std::move(out));
    };
    auto [d_offs, d_idx] = bucket(det_cls, det_img, Nd, n_cls);
    auto [g_offs, g_idx] = bucket(gt_cls, gt_img, Ng, n_cls);

    std::vector<int64_t> order, gtind;
    std::vector<double> iou;
    std::vector<uint8_t> gt_matched;

    for (int64_t c = 0; c < n_cls; ++c) {
        std::vector<ImgEval> evals;
        for (int64_t im = 0; im < n_img; ++im) {
            const int64_t d0 = d_offs[c * n_img + im], d1 = d_offs[c * n_img + im + 1];
            const int64_t g0 = g_offs[c * n_img + im], g1 = g_offs[c * n_img + im + 1];
            const int64_t nD_all = d1 - d0, G = g1 - g0;
            if (nD_all == 0 && G == 0) continue;

            // score sort (stable desc) + truncation to the largest max-det
            order.resize(nD_all);
            for (int64_t i = 0; i < nD_all; ++i) order[i] = d_idx[d0 + i];
            std::stable_sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
                return det_scores[x] > det_scores[y];
            });
            const int64_t D = std::min<int64_t>(nD_all, max_det_cap);

            ImgEval ev;
            ev.D = D;
            ev.scores.resize(D);
            for (int64_t i = 0; i < D; ++i) ev.scores[i] = det_scores[order[i]];
            ev.matches.assign(A * T * D, 0);
            ev.ignore.assign(A * T * D, 0);
            ev.npig.assign(A, 0);

            iou.resize(D * G);
            for (int64_t i = 0; i < D; ++i)
                for (int64_t g = 0; g < G; ++g)
                    iou[i * G + g] =
                        box_iou_pair(det_boxes + order[i] * 4, gt_boxes + g_idx[g0 + g] * 4);

            gtind.resize(G);
            gt_matched.resize(G);
            for (int64_t a = 0; a < A; ++a) {
                const double lo = ranges[2 * a], hi = ranges[2 * a + 1];
                // stable partition: in-range gts first (match.cpp coco_match order)
                int64_t k = 0;
                for (int64_t g = 0; g < G; ++g) {
                    const double ar = box_area_xyxy(gt_boxes + g_idx[g0 + g] * 4);
                    if (!(ar < lo || ar > hi)) gtind[k++] = g;
                }
                const int64_t n_valid = k;
                for (int64_t g = 0; g < G; ++g) {
                    const double ar = box_area_xyxy(gt_boxes + g_idx[g0 + g] * 4);
                    if (ar < lo || ar > hi) gtind[k++] = g;
                }
                ev.npig[a] = n_valid;

                for (int64_t t = 0; t < T; ++t) {
                    const double thr = iou_thrs[t];
                    std::fill(gt_matched.begin(), gt_matched.begin() + G, 0);
                    uint8_t* dm = ev.matches.data() + (a * T + t) * D;
                    uint8_t* di = ev.ignore.data() + (a * T + t) * D;
                    for (int64_t d = 0; d < D; ++d) {
                        const double* row = iou.data() + d * G;
                        double best = 0.0;
                        int64_t bi = -1;
                        for (int64_t g = 0; g < n_valid; ++g) {
                            if (gt_matched[g]) continue;
                            const double v = row[gtind[g]];
                            if (bi < 0 || v > best) { best = v; bi = g; }
                        }
                        if (bi < 0 || best <= thr) continue;
                        dm[d] = 1;
                        gt_matched[bi] = 1;
                    }
                    for (int64_t d = 0; d < D; ++d) {
                        if (dm[d]) continue;
                        const double ar = box_area_xyxy(det_boxes + order[d] * 4);
                        if (ar < lo || ar > hi) di[d] = 1;
                    }
                }
            }
            evals.push_back(std::move(ev));
        }
        if (evals.empty()) continue;

        // accumulate per (area, max_det): concatenate per-image segments
        // (each truncated to max_det), global stable desc sort, PR curve
        std::vector<double> cat_scores;
        std::vector<int64_t> seg_img, seg_pos, sidx;
        std::vector<double> tp_cum, fp_cum, rc, pr;
        for (int64_t a = 0; a < A; ++a) {
            int64_t npig = 0;
            for (const auto& ev : evals) npig += ev.npig[a];
            if (npig == 0) continue;
            for (int64_t m = 0; m < M; ++m) {
                const int64_t md = max_dets[m];
                cat_scores.clear(); seg_img.clear(); seg_pos.clear();
                for (size_t e = 0; e < evals.size(); ++e) {
                    const int64_t take = std::min(evals[e].D, md);
                    for (int64_t i = 0; i < take; ++i) {
                        cat_scores.push_back(evals[e].scores[i]);
                        seg_img.push_back(static_cast<int64_t>(e));
                        seg_pos.push_back(i);
                    }
                }
                const int64_t nd = static_cast<int64_t>(cat_scores.size());
                sidx.resize(nd);
                for (int64_t i = 0; i < nd; ++i) sidx[i] = i;
                std::stable_sort(sidx.begin(), sidx.end(), [&](int64_t x, int64_t y) {
                    return cat_scores[x] > cat_scores[y];
                });

                for (int64_t t = 0; t < T; ++t) {
                    tp_cum.resize(nd); fp_cum.resize(nd);
                    rc.resize(nd); pr.resize(nd);
                    double tp = 0, fp = 0;
                    for (int64_t i = 0; i < nd; ++i) {
                        const auto& ev = evals[seg_img[sidx[i]]];
                        const int64_t pos = seg_pos[sidx[i]];
                        const uint8_t mt = ev.matches[(a * T + t) * ev.D + pos];
                        const uint8_t ig = ev.ignore[(a * T + t) * ev.D + pos];
                        tp += (mt && !ig);
                        fp += (!mt && !ig);
                        tp_cum[i] = tp; fp_cum[i] = fp;
                        rc[i] = tp / npig;
                        pr[i] = tp / (fp + tp + EPS);
                    }
                    // recall cell: (t, c, a, m) in (T, C, A, M)
                    recall[((t * n_cls + c) * A + a) * M + m] = nd ? rc[nd - 1] : 0.0;
                    // monotone envelope (reverse cummax)
                    for (int64_t i = nd - 2; i >= 0; --i) pr[i] = std::max(pr[i], pr[i + 1]);
                    // searchsorted(rc, rec_thrs, left) then fill until first
                    // out-of-range index (numpy argmax-of-max semantics)
                    int64_t j = 0;
                    for (int64_t r = 0; r < R; ++r) {
                        while (j < nd && rc[j] < rec_thrs[r]) ++j;
                        double* cell = precision + ((((int64_t)t * R + r) * n_cls + c) * A + a) * M + m;
                        *cell = (j < nd) ? pr[j] : 0.0;
                    }
                }
            }
        }
    }
}

}  // extern "C"

extern "C" {

// Longest-common-subsequence length over int token ids (two-row DP).
// Replaces the pure-Python table in functional/text/rouge.py _lcs for ROUGE-L,
// which only needs the length (ROUGE-Lsum backtracks and keeps the table).
int64_t lcs_len(const int64_t* a, int64_t na, const int64_t* b, int64_t nb) {
    if (na <= 0 || nb <= 0) return 0;
    std::vector<int64_t> prev(nb + 1, 0), cur(nb + 1, 0);
    for (int64_t i = 1; i <= na; ++i) {
        const int64_t ai = a[i - 1];
        for (int64_t j = 1; j <= nb; ++j) {
            cur[j] = (ai == b[j - 1]) ? prev[j - 1] + 1
                                      : std::max(prev[j], cur[j - 1]);
        }
        std::swap(prev, cur);
    }
    return prev[nb];
}

}  // extern "C"
