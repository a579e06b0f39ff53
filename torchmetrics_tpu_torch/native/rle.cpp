// Copy of torchmetrics_tpu/native/rle.cpp, built with g++ by torchmetrics_tpu_torch/native/rle_mask.py.
// COCO-style run-length-encoded mask kernels (host-side native component).
//
// TPU-native equivalent of the pycocotools C mask ops the reference leans on for
// iou_type="segm" (reference ``detection/mean_ap.py:38,131`` via ``mask_utils``;
// SURVEY §2.12 "pycocotools RLE mask IoU (C) -> C++ RLE kernel (host)").
// Dense-mask IoU stays on-device as a flattened matmul; these kernels handle the
// compressed-RLE interchange format without materializing H*W pixels per mask.
//
// Layout: masks are encoded column-major (Fortran order), runs alternate
// background/foreground starting with background, matching the COCO spec.

#include <cstdint>
#include <cstring>

extern "C" {

// Encode a column-major uint8 mask of h*w pixels into alternating run lengths.
// Returns the number of runs written to `counts` (capacity must be >= h*w + 1).
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w, uint32_t* counts) {
    const int64_t n = h * w;
    int64_t n_runs = 0;
    uint8_t current = 0;  // runs start with the background count (possibly 0)
    int64_t run = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (mask[i] != current) {
            counts[n_runs++] = (uint32_t)run;
            run = 0;
            current = mask[i];
        }
        ++run;
    }
    counts[n_runs++] = (uint32_t)run;
    return n_runs;
}

// Decode alternating run lengths back into a column-major uint8 mask.
void rle_decode(const uint32_t* counts, int64_t n_runs, uint8_t* mask, int64_t n) {
    int64_t pos = 0;
    uint8_t value = 0;
    for (int64_t r = 0; r < n_runs && pos < n; ++r) {
        int64_t len = counts[r];
        if (len > n - pos) len = n - pos;
        memset(mask + pos, value, (size_t)len);
        pos += len;
        value = !value;
    }
}

// Foreground pixel count of an encoding.
int64_t rle_area(const uint32_t* counts, int64_t n_runs) {
    int64_t area = 0;
    for (int64_t r = 1; r < n_runs; r += 2) area += counts[r];
    return area;
}

// Intersection of two encodings by merging their run lists — no decode, O(runs).
int64_t rle_intersection(const uint32_t* a, int64_t na, const uint32_t* b, int64_t nb) {
    int64_t ia = 0, ib = 0;          // current run index in a / b
    int64_t ra = (na > 0) ? (int64_t)a[0] : 0;  // pixels left in current run
    int64_t rb = (nb > 0) ? (int64_t)b[0] : 0;
    uint8_t va = 0, vb = 0;          // current run value
    int64_t inter = 0;
    while (ia < na && ib < nb) {
        // skip exhausted runs
        while (ra == 0 && ++ia < na) { ra = a[ia]; va = !va; }
        while (rb == 0 && ++ib < nb) { rb = b[ib]; vb = !vb; }
        if (ia >= na || ib >= nb) break;
        int64_t step = (ra < rb) ? ra : rb;
        if (va && vb) inter += step;
        ra -= step;
        rb -= step;
    }
    return inter;
}

// Pairwise IoU matrix between nd detection and ng ground-truth encodings.
// Encodings are packed: counts_flat holds all runs, offsets/lengths index them.
// iscrowd semantics follow COCO: for crowd gt, the union is just the detection area.
void rle_iou(const uint32_t* counts_flat,
             const int64_t* d_off, const int64_t* d_len, int64_t nd,
             const int64_t* g_off, const int64_t* g_len, int64_t ng,
             const uint8_t* g_iscrowd,
             double* out) {
    for (int64_t i = 0; i < nd; ++i) {
        const uint32_t* dc = counts_flat + d_off[i];
        int64_t da = rle_area(dc, d_len[i]);
        for (int64_t j = 0; j < ng; ++j) {
            const uint32_t* gc = counts_flat + g_off[j];
            int64_t ga = rle_area(gc, g_len[j]);
            int64_t inter = rle_intersection(dc, d_len[i], gc, g_len[j]);
            double uni = g_iscrowd && g_iscrowd[j] ? (double)da : (double)(da + ga - inter);
            out[i * ng + j] = uni > 0 ? (double)inter / uni : 0.0;
        }
    }
}

}  // extern "C"
