"""ctypes bindings of the host C++ kernels, with their numpy plain versions
(counterpart of ``torchmetrics_tpu/native/rle_mask.py``).

The sources are the port's own copies, ``rle.cpp`` and ``match.cpp`` beside this file.
They build at first use with ``g++ -O2 -shared -fPIC`` into
``torchmetrics_tpu_torch/_build/libtm_native_<hash>.so``, where the hash covers the
sources, the compiler and the flags; the build writes a temporary file and renames it
into place, so processes building at once never load a half-written library.

Unlike the JAX package, a failed build or load raises ``RuntimeError`` with the
compiler's output: the port never falls back to numpy quietly. Each entry point keeps
its numpy version beside it (``_*_plain``), which the tests hold the C++ against.

RLE objects are ``{"size": [h, w], "counts": uint32 array}`` with column-major
alternating background / foreground runs, uncompressed (pycocotools' layout).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "rle.cpp", _HERE / "match.cpp")
BUILD_DIR = _HERE.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None

_U32P = ctypes.POINTER(ctypes.c_uint32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.c_int64
# (restype, argtypes) of every C entry point: the JAX package's declarations
_SIGNATURES = {
    "rle_encode": (_I64, [_U8P, _I64, _I64, _U32P]),
    "rle_decode": (None, [_U32P, _I64, _U8P, _I64]),
    "rle_area": (_I64, [_U32P, _I64]),
    "rle_iou": (None, [_U32P, _I64P, _I64P, _I64, _I64P, _I64P, _I64, _U8P, _F64P]),
    "coco_match": (None, [_F64P, _F64P, _F64P, _I64, _I64, _F64P, _I64, _F64P, _I64, _U8P, _U8P, _U8P]),
    "lcs_len": (_I64, [_I64P, _I64, _I64P, _I64]),
    "coco_eval_bbox": (
        None,
        [
            _F64P, _F64P, _I64P, _I64P, _I64,
            _F64P, _I64P, _I64P, _I64,
            _I64, _I64,
            _F64P, _I64,
            _F64P, _I64,
            _F64P, _I64,
            _I64P, _I64,
            _F64P, _F64P,
        ],
    ),
}


def library_path() -> Path:
    """Where the library for the current sources, compiler and flags lives (built or not)."""
    digest = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libtm_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into one shared library; a no-op if it is already built.

    Raises:
        RuntimeError: the compiler is missing or failed; the message holds its output.
    """
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, *(str(s) for s in SOURCES)]
    try:
        try:
            res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=300)
        except OSError as err:
            raise RuntimeError(f"the native build could not start:\n$ {' '.join(cmd)}\n{err}") from err
        if res.returncode != 0:
            raise RuntimeError(f"the native build failed:\n$ {' '.join(cmd)}\n{res.stdout.decode(errors='replace')}")
        os.replace(tmp, target)  # atomic publish: a concurrent build writes the same file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def library() -> ctypes.CDLL:
    """The loaded library, built on first use; raises when it cannot be built or loaded."""
    global _LIB
    if _LIB is None:
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as err:
            raise RuntimeError(f"the native library {path} did not load: {err}") from err
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
    return _LIB


def native_available() -> bool:
    """True once the C++ library is built and loaded. Kept for parity with the JAX
    package's predicate: it never returns False, since a failed build or load raises
    (with the compiler's output) where the JAX package would take the numpy versions."""
    return library() is not None


def coco_eval_bbox_available() -> bool:
    """Whether the epoch-level C++ bbox evaluator is usable. As ``native_available``, it
    never returns False: a failed build or load raises."""
    return native_available()


def _as_u32(counts) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(counts, dtype=np.uint32))


def _col_major(mask: np.ndarray) -> np.ndarray:
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"Expected a 2D mask, got shape {mask.shape}")
    return np.ascontiguousarray(mask.astype(np.uint8).reshape(-1, order="F"))


# ------------------------------------------------------------------ RLE masks


def rle_encode(mask: np.ndarray) -> Dict[str, object]:
    """Encode a binary (h, w) mask into a COCO-style uncompressed RLE dict."""
    flat = _col_major(mask)
    h, w = np.shape(mask)
    buf = np.empty(h * w + 1, dtype=np.uint32)
    n_runs = library().rle_encode(flat.ctypes.data_as(_U8P), h, w, buf.ctypes.data_as(_U32P))
    return {"size": [int(h), int(w)], "counts": buf[:n_runs].copy()}


def _rle_encode_plain(mask: np.ndarray) -> Dict[str, object]:
    flat = _col_major(mask)
    h, w = np.shape(mask)
    changes = np.flatnonzero(np.diff(flat)) + 1
    counts = np.diff(np.concatenate([[0], changes, [flat.size]])).astype(np.uint32)
    if flat.size and flat[0] == 1:
        counts = np.concatenate([[np.uint32(0)], counts])
    return {"size": [int(h), int(w)], "counts": counts}


def rle_decode(rle: Dict[str, object]) -> np.ndarray:
    """Decode an RLE dict back into a binary (h, w) mask."""
    h, w = rle["size"]
    counts = _as_u32(rle["counts"])
    out = np.zeros(h * w, dtype=np.uint8)
    library().rle_decode(counts.ctypes.data_as(_U32P), len(counts), out.ctypes.data_as(_U8P), h * w)
    return out.reshape((h, w), order="F").astype(bool)


def _rle_decode_plain(rle: Dict[str, object]) -> np.ndarray:
    h, w = rle["size"]
    counts = _as_u32(rle["counts"])
    values = np.zeros(len(counts), dtype=np.uint8)
    values[1::2] = 1
    out = np.repeat(values, counts.astype(np.int64))
    out = np.pad(out[: h * w], (0, max(0, h * w - out.size)))
    return out.reshape((h, w), order="F").astype(bool)


def rle_area(rle: Dict[str, object]) -> int:
    """Foreground pixel count."""
    counts = _as_u32(rle["counts"])
    return int(library().rle_area(counts.ctypes.data_as(_U32P), len(counts)))


def _rle_area_plain(rle: Dict[str, object]) -> int:
    return int(_as_u32(rle["counts"])[1::2].sum())


def rle_iou(
    det: Sequence[Dict[str, object]],
    gt: Sequence[Dict[str, object]],
    iscrowd: Optional[Sequence[bool]] = None,
) -> np.ndarray:
    """Pairwise IoU matrix between detection and ground-truth RLEs (COCO crowd rules)."""
    nd, ng = len(det), len(gt)
    if nd == 0 or ng == 0:
        return np.zeros((nd, ng))
    crowd = np.zeros(ng, dtype=np.uint8) if iscrowd is None else np.ascontiguousarray(iscrowd, dtype=np.uint8)
    all_counts: List[np.ndarray] = [_as_u32(r["counts"]) for r in (*det, *gt)]
    offsets = np.zeros(len(all_counts) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in all_counts], out=offsets[1:])
    flat = np.ascontiguousarray(np.concatenate(all_counts))
    d_off = np.ascontiguousarray(offsets[:nd])
    d_len = np.ascontiguousarray(offsets[1 : nd + 1] - offsets[:nd])
    g_off = np.ascontiguousarray(offsets[nd:-1])
    g_len = np.ascontiguousarray(offsets[nd + 1 :] - offsets[nd:-1])
    out = np.zeros(nd * ng, dtype=np.float64)
    library().rle_iou(
        flat.ctypes.data_as(_U32P),
        d_off.ctypes.data_as(_I64P), d_len.ctypes.data_as(_I64P), nd,
        g_off.ctypes.data_as(_I64P), g_len.ctypes.data_as(_I64P), ng,
        crowd.ctypes.data_as(_U8P),
        out.ctypes.data_as(_F64P),
    )
    return out.reshape(nd, ng)


def _rle_iou_plain(
    det: Sequence[Dict[str, object]],
    gt: Sequence[Dict[str, object]],
    iscrowd: Optional[Sequence[bool]] = None,
) -> np.ndarray:
    nd, ng = len(det), len(gt)
    out = np.zeros((nd, ng))
    crowd = np.zeros(ng, dtype=np.uint8) if iscrowd is None else np.asarray(iscrowd, dtype=np.uint8)
    d_masks = [_rle_decode_plain(r).reshape(-1) for r in det]
    g_masks = [_rle_decode_plain(r).reshape(-1) for r in gt]
    for i, dm in enumerate(d_masks):
        da = dm.sum()
        for j, gm in enumerate(g_masks):
            inter = np.logical_and(dm, gm).sum()
            union = da if crowd[j] else da + gm.sum() - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


# ------------------------------------------------------------------ COCO matching


def _f64(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float64)


def coco_match(
    iou: np.ndarray,
    det_areas: np.ndarray,
    gt_areas: np.ndarray,
    thresholds: np.ndarray,
    area_ranges: np.ndarray,
):
    """Greedy COCO matching for one (image, class) over ALL areas x thresholds.

    Args:
        iou: ``(D, G)`` with rows score-sorted (stable desc) and truncated to the
            largest max-det threshold; columns in original gt order.
        det_areas / gt_areas: per-box (or per-mask) areas.
        thresholds: ``(T,)`` IoU thresholds.
        area_ranges: ``(A, 2)`` [lo, hi] pairs.

    Returns:
        ``(det_matches, det_ignore, gt_ignore)`` bool arrays of shapes ``(A, T, D)`` /
        ``(A, T, D)`` / ``(A, G)``; gt flags in the per-area partitioned order (in-range
        gts first). A detection matches only when ``IoU > thr`` (strict), as in the
        JAX package (see the ``match.cpp`` header for the divergence from pycocotools).
    """
    iou, det_areas, gt_areas = _f64(iou), _f64(det_areas), _f64(gt_areas)
    thresholds, area_ranges = _f64(thresholds), _f64(area_ranges)
    d, g = det_areas.shape[0], gt_areas.shape[0]
    t, a = thresholds.shape[0], area_ranges.shape[0]
    det_matches = np.zeros((a, t, d), dtype=np.uint8)
    det_ignore = np.zeros((a, t, d), dtype=np.uint8)
    gt_ignore = np.zeros((a, g), dtype=np.uint8)
    library().coco_match(
        iou.ctypes.data_as(_F64P), det_areas.ctypes.data_as(_F64P), gt_areas.ctypes.data_as(_F64P), d, g,
        thresholds.ctypes.data_as(_F64P), t, area_ranges.ctypes.data_as(_F64P), a,
        det_matches.ctypes.data_as(_U8P), det_ignore.ctypes.data_as(_U8P), gt_ignore.ctypes.data_as(_U8P),
    )
    return det_matches.astype(bool), det_ignore.astype(bool), gt_ignore.astype(bool)


def _coco_match_plain(
    iou: np.ndarray,
    det_areas: np.ndarray,
    gt_areas: np.ndarray,
    thresholds: np.ndarray,
    area_ranges: np.ndarray,
):
    iou, det_areas, gt_areas = _f64(iou), _f64(det_areas), _f64(gt_areas)
    thresholds, area_ranges = _f64(thresholds), _f64(area_ranges)
    d, g = det_areas.shape[0], gt_areas.shape[0]
    t, a = thresholds.shape[0], area_ranges.shape[0]
    det_matches = np.zeros((a, t, d), dtype=bool)
    det_ignore = np.zeros((a, t, d), dtype=bool)
    gt_ignore_out = np.zeros((a, g), dtype=bool)
    for ai, (lo, hi) in enumerate(area_ranges):
        ignore = (gt_areas < lo) | (gt_areas > hi)
        gtind = np.argsort(ignore.astype(np.uint8), kind="stable")
        gt_ign = ignore[gtind]
        gt_ignore_out[ai] = gt_ign
        iou_s = iou[:, gtind] if iou.size else iou
        for ti, thr in enumerate(thresholds):
            gt_matched = np.zeros(g, dtype=bool)
            for di in range(d):
                masked = iou_s[di] * ~(gt_matched | gt_ign)
                if masked.size == 0:
                    continue
                m = int(masked.argmax())
                if masked[m] <= thr:
                    continue
                det_matches[ai, ti, di] = True
                gt_matched[m] = True
        out_of_range = (det_areas < lo) | (det_areas > hi)
        det_ignore[ai] |= ~det_matches[ai] & out_of_range[None, :]
    return det_matches, det_ignore, gt_ignore_out


def coco_eval_bbox(
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    det_img: np.ndarray,
    det_cls: np.ndarray,
    gt_boxes: np.ndarray,
    gt_img: np.ndarray,
    gt_cls: np.ndarray,
    n_img: int,
    n_cls: int,
    iou_thrs: np.ndarray,
    rec_thrs: np.ndarray,
    area_ranges: np.ndarray,
    max_dets: np.ndarray,
):
    """Epoch-level COCO bbox evaluation: the whole accumulate stage in one C++ call.

    Its plain version is ``MeanAveragePrecision``'s ``_calculate`` route
    (``detection/mean_ap.py``), which the tests hold it against.

    Args:
        det_boxes / gt_boxes: ``(N, 4)`` xyxy epoch concatenations.
        det_scores: ``(Nd,)``.
        det_img / gt_img: ``(N,)`` image indices in ``[0, n_img)``.
        det_cls / gt_cls: ``(N,)`` class indices in ``[0, n_cls)`` (pre-mapped).
        iou_thrs / rec_thrs: threshold grids (``rec_thrs`` ascending); area_ranges
            ``(A, 2)``; max_dets: ascending max-detection thresholds.

    Returns:
        ``(precision, recall)`` of shapes ``(T, R, C, A, M)`` / ``(T, C, A, M)``, cells
        untouched by data at ``-1``.
    """
    lib = library()
    det_boxes = _f64(np.asarray(det_boxes).reshape(-1, 4))
    gt_boxes = _f64(np.asarray(gt_boxes).reshape(-1, 4))
    det_scores = _f64(det_scores)
    det_img, det_cls = (np.ascontiguousarray(x, dtype=np.int64) for x in (det_img, det_cls))
    gt_img, gt_cls = (np.ascontiguousarray(x, dtype=np.int64) for x in (gt_img, gt_cls))
    iou_thrs, rec_thrs, area_ranges = _f64(iou_thrs), _f64(rec_thrs), _f64(area_ranges)
    max_dets = np.ascontiguousarray(max_dets, dtype=np.int64)
    t, r, a, m = len(iou_thrs), len(rec_thrs), area_ranges.shape[0], len(max_dets)
    precision = -np.ones((t, r, n_cls, a, m), dtype=np.float64)
    recall = -np.ones((t, n_cls, a, m), dtype=np.float64)
    lib.coco_eval_bbox(
        det_boxes.ctypes.data_as(_F64P), det_scores.ctypes.data_as(_F64P),
        det_img.ctypes.data_as(_I64P), det_cls.ctypes.data_as(_I64P), det_scores.shape[0],
        gt_boxes.ctypes.data_as(_F64P), gt_img.ctypes.data_as(_I64P), gt_cls.ctypes.data_as(_I64P), gt_img.shape[0],
        n_img, n_cls,
        iou_thrs.ctypes.data_as(_F64P), t,
        rec_thrs.ctypes.data_as(_F64P), r,
        area_ranges.ctypes.data_as(_F64P), a,
        max_dets.ctypes.data_as(_I64P), m,
        precision.ctypes.data_as(_F64P), recall.ctypes.data_as(_F64P),
    )
    return precision, recall


# ------------------------------------------------------------------ LCS (ROUGE-L)


def lcs_len(a_ids: np.ndarray, b_ids: np.ndarray) -> int:
    """Longest-common-subsequence length over int64 token-id sequences."""
    a = np.ascontiguousarray(a_ids, dtype=np.int64)
    b = np.ascontiguousarray(b_ids, dtype=np.int64)
    return int(library().lcs_len(a.ctypes.data_as(_I64P), a.shape[0], b.ctypes.data_as(_I64P), b.shape[0]))


def _lcs_len_plain(a_ids: np.ndarray, b_ids: np.ndarray) -> int:
    a, b = np.asarray(a_ids), np.asarray(b_ids)
    prev = np.zeros(len(b) + 1, dtype=np.int64)
    for ai in a:
        cur = np.zeros_like(prev)
        for j in range(1, len(b) + 1):
            cur[j] = prev[j - 1] + 1 if ai == b[j - 1] else max(prev[j], cur[j - 1])
        prev = cur
    return int(prev[-1])
