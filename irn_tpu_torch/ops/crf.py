"""Fully-connected CRF mean-field inference: the port's copy of
``irn_tpu.ops.crf`` (numpy and ctypes only), so that cam_to_ir_label's
native backend runs without the JAX package.

The pipeline needs :func:`crf_inference_label_pair` (reference:
misc/imutils.py:156-170, twice per image in step/cam_to_ir_label.py):
refine a hard label map with Gaussian (sxy=3, compat=3) + bilateral
(sxy=50, srgb=5, compat=10) pairwise kernels for 10 iterations and return
the argmax. Two implementations with identical math:

- the native C++ permutohedral lattice (``native/densecrf.cpp``, built and
  loaded by :mod:`irn_tpu_torch.ops.native`), the production path;
- a vectorized NumPy lattice here, the fallback where no compiler exists.

Both use symmetric kernel normalization (D^-1/2 K D^-1/2) and include the
lattice's self-contribution, the conventions of the public DenseCRF v2
implementation that pydensecrf wraps. The device counterpart is
:mod:`irn_tpu_torch.ops.crf_device`.
"""

from __future__ import annotations

import ctypes

import numpy as np

from irn_tpu_torch.ops import native


# ---------------------------------------------------------------------------
# NumPy permutohedral lattice (same algorithm as native/permutohedral.cpp)
# ---------------------------------------------------------------------------

def permutohedral_prepare(features: np.ndarray):
    """Precompute (splat indices, barycentric weights, blur neighbors)."""
    f = np.asarray(features, np.float64)
    n, d = f.shape
    dp1 = d + 1

    scale = (dp1 * np.sqrt(2.0 / 3.0)) / np.sqrt(
        (np.arange(d) + 1.0) * (np.arange(d) + 2.0)
    )
    cf = f * scale

    elevated = np.zeros((n, dp1))
    sm = np.zeros(n)
    for j in range(d, 0, -1):
        c = cf[:, j - 1]
        elevated[:, j] = sm - j * c
        sm = sm + c
    elevated[:, 0] = sm

    down = 1.0 / dp1
    v = elevated * down
    up_ = np.ceil(v) * dp1
    dn = np.floor(v) * dp1
    rem0 = np.where(up_ - elevated < elevated - dn, up_, dn)
    sums = np.rint((rem0 * down).sum(axis=1)).astype(np.int64)

    diff = elevated - rem0
    rank = np.zeros((n, dp1), np.int64)
    for i in range(dp1):
        for j in range(i + 1, dp1):
            less = diff[:, i] < diff[:, j]
            rank[:, i] += less
            rank[:, j] += ~less
    rank += sums[:, None]
    low = rank < 0
    rank[low] += dp1
    rem0[low] += dp1
    high = rank > d
    rank[high] -= dp1
    rem0[high] -= dp1

    bary = np.zeros((n, dp1 + 1))
    vv = (elevated - rem0) * down
    rows = np.repeat(np.arange(n), dp1)
    np.add.at(bary, (rows, (d - rank).ravel()), vv.ravel())
    np.add.at(bary, (rows, (d - rank + 1).ravel()), -vv.ravel())
    bary[:, 0] += 1.0 + bary[:, dp1]

    keys = np.zeros((n, dp1, d), np.int64)
    for r in range(dp1):
        keys[:, r] = rem0[:, :d].astype(np.int64) + r - np.where(
            rank[:, :d] > d - r, dp1, 0
        )
    flat = keys.reshape(-1, d)
    uniq, inverse = np.unique(flat, axis=0, return_inverse=True)

    # vectorized row lookup: bytewise void views of the rows are compared
    # lexicographically (order differs from numeric, but only CONSISTENCY
    # matters for searchsorted) — the old per-key Python dict loop probed
    # n_lattice*(d+1)*2 tuples per prepare, millions of interpreter
    # iterations on a bilateral lattice (found by review)
    def rows_view(a: np.ndarray) -> np.ndarray:
        a = np.ascontiguousarray(a)
        return a.view(
            np.dtype((np.void, a.dtype.itemsize * a.shape[1]))
        ).ravel()

    uv = rows_view(uniq)
    uorder = np.argsort(uv)
    uv_sorted = uv[uorder]

    def lookup(arr: np.ndarray) -> np.ndarray:
        av = rows_view(np.ascontiguousarray(arr, uniq.dtype))
        pos = np.minimum(np.searchsorted(uv_sorted, av), len(uv_sorted) - 1)
        return np.where(uv_sorted[pos] == av, uorder[pos], -1)

    neighbors = []
    for j in range(dp1):
        n1 = uniq + 1
        n2 = uniq - 1
        if j < d:
            n1[:, j] = uniq[:, j] - d
            n2[:, j] = uniq[:, j] + d
        neighbors.append((lookup(n1), lookup(n2)))

    return inverse.reshape(n, dp1), bary[:, :dp1], neighbors, len(uniq)


def _run_lattice(kern, vals: np.ndarray) -> np.ndarray:
    offsets, weights, neighbors, n_lattice = kern
    vd = vals.shape[1]
    lat = np.zeros((n_lattice, vd))
    contrib = (weights[..., None] * vals[:, None, :]).reshape(-1, vd)
    np.add.at(lat, offsets.reshape(-1), contrib)
    for i1, i2 in neighbors:
        v1 = np.where((i1 >= 0)[:, None], lat[np.maximum(i1, 0)], 0.0)
        v2 = np.where((i2 >= 0)[:, None], lat[np.maximum(i2, 0)], 0.0)
        lat = 2.0 * lat + v1 + v2
    return (weights[..., None] * lat[offsets]).sum(axis=1)


def _prepare_normalized(features: np.ndarray):
    """One-time lattice build + symmetric normalizer for a feature set —
    the per-kernel analogue of the native NormalizedKernel, so mean-field
    iterations reuse the lattice instead of rebuilding it (the old
    per-iteration rebuild made the fallback ~10x slower than necessary,
    found by review)."""
    kern = permutohedral_prepare(features)
    norm = _run_lattice(kern, np.ones((features.shape[0], 1)))
    inv_sqrt = 1.0 / np.sqrt(np.maximum(norm, 1e-20))
    return kern, inv_sqrt


def _apply_normalized(kern, inv_sqrt, values: np.ndarray) -> np.ndarray:
    return inv_sqrt * _run_lattice(kern, values * inv_sqrt)


def _filter_normalized_np(features: np.ndarray, values: np.ndarray) -> np.ndarray:
    kern, inv_sqrt = _prepare_normalized(features)
    return _apply_normalized(kern, inv_sqrt, values)


def filter_normalized(features: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Symmetric-normalized lattice filter, native if available."""
    lib = native.load()
    f = np.ascontiguousarray(features, np.float32)
    v = np.ascontiguousarray(values, np.float32)
    if lib is None:
        return _filter_normalized_np(f, v).astype(np.float32)
    n, d = f.shape
    vd = v.shape[1]
    out = np.empty((n, vd), np.float32)
    lib.irn_permutohedral_filter(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, d, vd,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


# ---------------------------------------------------------------------------
# Mean-field CRF
# ---------------------------------------------------------------------------

def _crf_label_np(img, labels, t, n_labels, gt_prob,
                  sxy_g, w_g, sxy_b, srgb_b, w_b) -> np.ndarray:
    h, w = labels.shape
    n = h * w
    m = n_labels

    p_other = (1.0 - gt_prob) / max(n_labels - 1, 1)
    neg_unary = np.full((n, m), np.log(p_other), np.float64)
    # out-of-range labels (e.g. 255 void) get a uniform unary — exactly
    # what the native path does (densecrf.cpp: (c == li) never matches);
    # fancy indexing used to IndexError here, making behavior depend on
    # whether the native lib was built (found by review)
    lab = labels.reshape(-1)
    valid = (lab >= 0) & (lab < m)
    neg_unary[np.where(valid)[0], lab[valid]] = np.log(gt_prob)

    ys, xs = np.mgrid[0:h, 0:w]
    feat_g = np.stack([xs / sxy_g, ys / sxy_g], -1).reshape(n, 2)
    feat_b = np.concatenate(
        [
            np.stack([xs / sxy_b, ys / sxy_b], -1).reshape(n, 2),
            img.reshape(n, 3) / srgb_b,
        ],
        axis=1,
    )

    def softmax(x):
        e = np.exp(x - x.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    # both lattices built ONCE (like the native NormalizedKernel pair),
    # then reused across all t iterations
    kern_g, inv_g = _prepare_normalized(feat_g)
    kern_b, inv_b = _prepare_normalized(feat_b)

    q = softmax(neg_unary)
    for _ in range(t):
        logits = neg_unary.copy()
        logits += w_g * _apply_normalized(kern_g, inv_g, q)
        logits += w_b * _apply_normalized(kern_b, inv_b, q)
        q = softmax(logits)
    return q.argmax(axis=1).reshape(h, w).astype(np.int32)


def crf_inference_label(
    img: np.ndarray,
    labels: np.ndarray,
    t: int = 10,
    n_labels: int = 21,
    gt_prob: float = 0.7,
    sxy_gaussian: float = 3.0,
    compat_gaussian: float = 3.0,
    sxy_bilateral: float = 50.0,
    srgb_bilateral: float = 5.0,
    compat_bilateral: float = 10.0,
) -> np.ndarray:
    """Refine a hard label map with dense-CRF mean field.

    Args:
      img: [h, w, 3] uint8 RGB.
      labels: [h, w] int in [0, n_labels).

    Returns [h, w] int32 refined labels. Defaults match the reference call
    (imutils.py:156-166).
    """
    img = np.ascontiguousarray(img, np.uint8)
    labels_i = np.ascontiguousarray(labels, np.int32)
    lib = native.load()
    if lib is None:
        return _crf_label_np(
            img.astype(np.float64), labels_i, t, n_labels, gt_prob,
            sxy_gaussian, compat_gaussian, sxy_bilateral, srgb_bilateral,
            compat_bilateral,
        )
    h, w = labels_i.shape
    out = np.empty((h, w), np.int32)
    lib.irn_dense_crf_label(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        labels_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        h, w, n_labels,
        ctypes.c_float(gt_prob), t,
        ctypes.c_float(sxy_gaussian), ctypes.c_float(compat_gaussian),
        ctypes.c_float(sxy_bilateral), ctypes.c_float(srgb_bilateral),
        ctypes.c_float(compat_bilateral),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def crf_inference_label_pair(
    img: np.ndarray,
    labels_a: np.ndarray,
    labels_b: np.ndarray,
    t: int = 10,
    n_labels: int = 21,
    gt_prob: float = 0.7,
    sxy_gaussian: float = 3.0,
    compat_gaussian: float = 3.0,
    sxy_bilateral: float = 50.0,
    srgb_bilateral: float = 5.0,
    compat_bilateral: float = 10.0,
):
    """Refine two label maps sharing one image (and one lattice build).

    The IR-seed stage runs fg- and bg-thresholded CRF passes per image
    (cam_to_ir_label.py:29-34); sharing the kernels roughly halves the cost.
    """
    img = np.ascontiguousarray(img, np.uint8)
    la = np.ascontiguousarray(labels_a, np.int32)
    lb = np.ascontiguousarray(labels_b, np.int32)
    lib = native.load()
    if lib is None:
        kw = dict(t=t, n_labels=n_labels, gt_prob=gt_prob,
                  sxy_gaussian=sxy_gaussian, compat_gaussian=compat_gaussian,
                  sxy_bilateral=sxy_bilateral, srgb_bilateral=srgb_bilateral,
                  compat_bilateral=compat_bilateral)
        return (crf_inference_label(img, la, **kw),
                crf_inference_label(img, lb, **kw))
    h, w = la.shape
    out_a = np.empty((h, w), np.int32)
    out_b = np.empty((h, w), np.int32)
    lib.irn_dense_crf_label2(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        la.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        h, w, n_labels,
        ctypes.c_float(gt_prob), t,
        ctypes.c_float(sxy_gaussian), ctypes.c_float(compat_gaussian),
        ctypes.c_float(sxy_bilateral), ctypes.c_float(srgb_bilateral),
        ctypes.c_float(compat_bilateral),
        out_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out_a, out_b
