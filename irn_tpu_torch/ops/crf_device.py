"""Device dense-CRF mean field on PyTorch: the counterpart of
:mod:`irn_tpu.ops.crf_tpu` (its ``crf_pair_program`` and ``LandmarkCRF``),
cam_to_ir_label's device backend.

The exact CRF operator is approximated with dense products instead of the
permutohedral lattice's scatter and gather (:mod:`irn_tpu_torch.ops.crf`,
the host backend):

- **Gaussian kernel (sxy 3, compat 3): exact.** A truncated separable
  convolution (|tap| <= 4 sigma) as two banded Toeplitz products in f32,
  with the symmetric normalisation's row sums from the blurred validity
  mask.
- **Bilateral kernel (sxy 50, srgb 5, compat 10): landmark subgrid.**
  Every pixel exchanges messages with a stride-``s`` subgrid of landmark
  pixels; the 5-D kernel to each landmark is evaluated exactly (one
  [N, 5] @ [5, S] product, then one exp), built in chunks of at most 4096
  rows. Each mean-field iteration is then one [N, S] @ [S, 2L] product:
  bf16 storage with f32 accumulation (``kernel_store='dense'``), or int8
  storage with int32 accumulation (``'int8'``, the activations quantized
  per column on the fly, the row sums taken from the quantized kernel).

DenseCRF v2 conventions as the JAX module: unit-variance kernels on 1/sxy-
and 1/srgb-scaled features, symmetric D^-1/2 K D^-1/2 normalisation, self
term included, positive-Potts update, unary log gt_prob /
log((1 - gt_prob) / (n - 1)). The fg/bg pair of the ir-label stage shares
one kernel build and rides one product ([S, 2L] right operand).

The products are library calls: on CUDA ``torch._int_mm`` (int8 x int8 ->
int32, its right operand padded to a multiple of 8 columns and laid out
column-major) and ``torch.mm(..., out_dtype=torch.float32)`` for bf16; on
the CPU the same ``torch._int_mm``, and the bf16 product upcast to f32
(exact products, f32 sums, as XLA's bf16 dot with an f32 result).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

CHUNK_ROWS = 4096
KERNEL_STORES = ("dense", "int8")


def _toeplitz(n: int, taps: torch.Tensor) -> torch.Tensor:
    """[n, n] banded Toeplitz blur matrix: T[i, j] = taps[j - i + r]."""
    r = (taps.shape[0] - 1) // 2
    i = torch.arange(n, device=taps.device)
    d = i[None, :] - i[:, None] + r
    inside = (d >= 0) & (d < taps.shape[0])
    return torch.where(inside, taps[d.clamp(0, taps.shape[0] - 1)],
                       torch.zeros((), device=taps.device))


def _sep_gauss(x: torch.Tensor, th: torch.Tensor,
               tw: torch.Tensor) -> torch.Tensor:
    """Separable 2-D blur of x [C, H, W] with zero padding: x @ tw along
    the width, then th^T @ . along the height (f32)."""
    return torch.matmul(th.t(), torch.matmul(x, tw))


def _chunk(n: int) -> int:
    """The largest divisor of n that is <= CHUNK_ROWS (never n itself for
    a large n, which would materialize the full [N, S] f32 build)."""
    return max(c for c in range(1, min(CHUNK_ROWS, n) + 1) if n % c == 0)


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 0, (-x.shape[0]) % multiple))


def product_f32(k: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """k [N, S] (f32 or bf16) @ q [S, M] in k's dtype with an f32 result;
    q's columns padded to a multiple of 8 (zero columns, aligned rows for
    cuBLAS)."""
    m = q.shape[1]
    q = torch.nn.functional.pad(q.to(k.dtype), (0, (-m) % 8))
    if k.dtype == torch.float32:
        return torch.mm(k, q)[:, :m]
    if k.device.type == "cuda":
        return torch.mm(k, q, out_dtype=torch.float32)[:, :m]
    return torch.mm(k.float(), q.float())[:, :m]


def product_int8(k8: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """k8 [N, S] int8 @ q8 [S, M] int8 -> int32 (exact). ``torch._int_mm``
    wants S and the output's columns in multiples of 8 (S is padded at the
    kernel build), so q8's columns are padded here; q8 goes column-major,
    the layout cuBLAS's int8 product takes without a slower path."""
    m = q8.shape[1]
    q8 = torch.nn.functional.pad(q8, (0, (-m) % 8)).t().contiguous().t()
    return torch._int_mm(k8, q8)[:, :m]


class LandmarkKernel:
    """One image's kernels at a bucket shape: the validity mask, the
    Gaussian's Toeplitz factors and row norms, the bilateral landmark
    kernel (None when streaming) and its row norms."""

    def __init__(self, img_u8: torch.Tensor, eh: int, ew: int, *,
                 stride: int = 4, sxy_gaussian: float = 3.0,
                 sxy_bilateral: float = 50.0, srgb_bilateral: float = 5.0,
                 matmul_dtype: str = "bfloat16", stream_kernel: bool = False,
                 kernel_store: str = "dense"):
        if kernel_store not in KERNEL_STORES:
            raise ValueError(f"kernel_store {kernel_store!r}")
        if stream_kernel and kernel_store == "int8":
            # streaming recomputes the kernel every iteration: there is no
            # stored kernel to quantize
            raise ValueError("stream_kernel and kernel_store='int8' exclude "
                             "each other")
        dev = img_u8.device
        h, w = img_u8.shape[:2]
        self.hw = (h, w)
        self.n = h * w
        self.stride = stride
        self.off = stride // 2
        self.int8 = kernel_store == "int8"
        self.stream = stream_kernel
        self.mdt = getattr(torch, matmul_dtype)

        ys = torch.arange(h, device=dev)[:, None].expand(h, w)
        xs = torch.arange(w, device=dev)[None, :].expand(h, w)
        self.valid = ((ys < eh) & (xs < ew)).float()

        # bilateral landmark kernel
        feats = torch.cat([
            (xs / sxy_bilateral).float()[..., None],
            (ys / sxy_bilateral).float()[..., None],
            img_u8.float() / srgb_bilateral,
        ], dim=-1)                                            # [H, W, 5]
        off = self.off
        f_land = feats[off::stride, off::stride].reshape(-1, 5)
        v_land = self.valid[off::stride, off::stride].reshape(-1)
        self.n_land = f_land.shape[0]
        if self.int8 and self.n_land * 127 * 127 >= 2 ** 31:
            raise ValueError(f"{self.n_land} landmarks overflow the int32 "
                             "accumulator of the int8 store")
        # int8 products need S in multiples of 8: zero landmarks (v 0) add
        # zero columns and change nothing
        s_pad = (-self.n_land) % 8 if self.int8 else 0
        self.f_land = _pad_rows(f_land, 8) if s_pad else f_land
        self.v_land = torch.nn.functional.pad(v_land, (0, s_pad))
        self.sq_land = (self.f_land ** 2).sum(1)
        chunk = _chunk(self.n)
        self.f_chunks = feats.reshape(-1, chunk, 5)
        # only the stored kernel [N, S] and the f32 row sums stay; the f32
        # intermediates live one chunk at a time
        d_b = torch.empty(self.n, device=dev)
        self.k_land = None if stream_kernel else torch.empty(
            (self.n, self.f_land.shape[0]),
            dtype=torch.int8 if self.int8 else self.mdt, device=dev)
        for i, f in enumerate(self.f_chunks):
            k, d_b[i * chunk:(i + 1) * chunk] = self.build_chunk(f)
            if self.k_land is not None:
                self.k_land[i * chunk:(i + 1) * chunk] = k
        self.nr_b = torch.rsqrt(d_b.clamp_min(1e-12)).reshape(h, w) * self.valid

        # gaussian separable kernel
        r = int(math.ceil(4.0 * sxy_gaussian))
        taps = torch.exp(-0.5 * (torch.arange(-r, r + 1, dtype=torch.float32,
                                              device=dev) / sxy_gaussian) ** 2)
        self.th = _toeplitz(h, taps)
        self.tw = _toeplitz(w, taps)
        d_g = _sep_gauss(self.valid[None], self.th, self.tw)[0]
        self.nr_g = torch.rsqrt(d_g.clamp_min(1e-12)) * self.valid

    def build_chunk(self, f_c: torch.Tensor):
        """(kernel rows in storage dtype, their f32 row sums) for the
        feature rows f_c [chunk, 5]."""
        cross = torch.mm(f_c, self.f_land.t())
        d2 = (f_c ** 2).sum(1)[:, None] + self.sq_land[None, :] - 2.0 * cross
        k = torch.exp(-0.5 * d2.clamp_min(0.0)) * self.v_land[None, :]
        if self.int8:
            # entries live in [0, 1]: symmetric scale 127; the row sums
            # come from the quantized values, the kernel actually applied
            kq = torch.round(k * 127.0)
            return kq.to(torch.int8), kq.sum(1) * np.float32(1.0 / 127.0)
        return k.to(self.mdt), k.sum(1)

    def bilateral(self, q_land: torch.Tensor) -> torch.Tensor:
        """[N, 2L] f32 = K @ q_land^T for landmark activations q_land
        [2L, S]."""
        qlT = q_land.t()
        if self.stream:
            return torch.cat([product_f32(self.build_chunk(f)[0], qlT)
                              for f in self.f_chunks])
        if self.int8:
            # the activations are nonnegative, so one max per column is an
            # exact symmetric scale; the kernel carries the static 1/127
            qscale = qlT.amax(0).clamp_min(1e-20)
            q8 = _pad_rows(torch.round(qlT * (127.0 / qscale)).to(torch.int8),
                           8)  # the zero landmarks of the padded kernel
            return product_int8(self.k_land, q8).float() * (
                qscale * np.float32(1.0 / (127.0 * 127.0)))[None, :]
        return product_f32(self.k_land, qlT)

    def nbytes(self) -> int:
        """Bytes of the stored landmark kernel (0 when streaming)."""
        k = self.k_land
        return 0 if k is None else k.numel() * k.element_size()


def mean_field_pair(kern: LandmarkKernel, labels: torch.Tensor,
                    n_labels: int, gt_prob: float, *, n_label_cap: int = 21,
                    t: int = 10, compat_gaussian: float = 3.0,
                    compat_bilateral: float = 10.0) -> torch.Tensor:
    """t mean-field iterations for two label maps labels [2, H, W] (ints
    in [0, n_labels)) over one kernel build; returns the argmax [2, H, W]
    uint8."""
    h, w = kern.hw
    cap = n_label_cap
    dev = labels.device
    gt = torch.tensor(gt_prob, dtype=torch.float32, device=dev)
    p_other = (1.0 - gt) / max(float(n_labels) - 1.0, 1.0)
    one = torch.nn.functional.one_hot(labels.long(), cap).permute(
        0, 3, 1, 2).float()                                   # [2, cap, H, W]
    u = one * torch.log(gt) + (1.0 - one) * torch.log(p_other)
    # channels beyond this image's label count can never win
    chans = torch.arange(cap, device=dev)
    u = torch.where((chans < n_labels)[None, :, None, None], u,
                    torch.full((), -1e30, device=dev))

    off, s = kern.off, kern.stride
    q = torch.softmax(u, dim=1)
    for _ in range(t):
        qm = q * kern.valid
        mg = compat_gaussian * kern.nr_g * _sep_gauss(
            (kern.nr_g * qm).reshape(2 * cap, h, w), kern.th, kern.tw
        ).reshape(2, cap, h, w)
        qb = kern.nr_b * qm
        q_land = qb[:, :, off::s, off::s].reshape(2 * cap, -1)
        mb = compat_bilateral * kern.nr_b.reshape(-1, 1) * kern.bilateral(
            q_land)
        q = torch.softmax(u + mg + mb.t().reshape(2, cap, h, w), dim=1)
    return torch.argmax(q, dim=1).to(torch.uint8)


class LandmarkCRF:
    """Pads to shape buckets, runs the kernel build and the mean field on
    ``device``, crops: the counterpart of ``irn_tpu.ops.crf_tpu.
    LandmarkCRF`` and a drop-in for
    :func:`irn_tpu_torch.ops.crf.crf_inference_label_pair` (the hyper
    defaults match the reference call, imutils.py:156-166).

    Under ``kernel_store='int8'`` ``matmul_dtype`` is unused, as in the
    JAX class."""

    def __init__(self, stride: int = 4, t: int = 10, pad_multiple: int = 64,
                 n_label_cap: int = 21, matmul_dtype: str = "bfloat16",
                 stream_kernel: bool = False, kernel_store: str = "dense",
                 device="cuda"):
        if n_label_cap > 255:
            raise ValueError("labels ride uint8 planes: n_label_cap <= 255")
        self.stride = stride
        self.t = t
        self.pad_multiple = pad_multiple
        self.n_label_cap = n_label_cap
        self.matmul_dtype = matmul_dtype
        self.stream_kernel = stream_kernel
        self.kernel_store = kernel_store
        self.device = torch.device(device)

    def _bucket(self, h: int, w: int) -> Tuple[int, int]:
        m = self.pad_multiple
        return (-(-h // m) * m, -(-w // m) * m)

    def upload(self, img: np.ndarray, labels_a: np.ndarray,
               labels_b: np.ndarray) -> torch.Tensor:
        """The image and both label maps as one [5, ph, pw] uint8 upload at
        the bucket shape."""
        h, w = labels_a.shape
        for lab in (labels_a, labels_b):
            # a label >= n_label_cap would wrap in the uint8 pack
            if lab.max(initial=0) >= self.n_label_cap:
                raise ValueError(f"label {int(lab.max())} >= n_label_cap "
                                 f"{self.n_label_cap}")
        ph, pw = self._bucket(h, w)
        packed = np.zeros((5, ph, pw), np.uint8)
        packed[:3, :h, :w] = np.moveaxis(img, -1, 0)
        packed[3, :h, :w] = labels_a
        packed[4, :h, :w] = labels_b
        return torch.from_numpy(packed).to(self.device)

    def build(self, packed: torch.Tensor, h: int, w: int) -> LandmarkKernel:
        """The kernels of the upload's image, true extent (h, w)."""
        return LandmarkKernel(
            packed[:3].permute(1, 2, 0), h, w, stride=self.stride,
            matmul_dtype=self.matmul_dtype, stream_kernel=self.stream_kernel,
            kernel_store=self.kernel_store)

    def iterate(self, kern: LandmarkKernel, packed: torch.Tensor,
                n_labels: int, gt_prob: float) -> torch.Tensor:
        """The mean field over the upload's two label maps: [2, ph, pw]
        uint8 on the device."""
        return mean_field_pair(kern, packed[3:5], n_labels, gt_prob,
                               n_label_cap=self.n_label_cap, t=self.t)

    @torch.no_grad()
    def pair(self, img: np.ndarray, labels_a: np.ndarray,
             labels_b: np.ndarray, n_labels: int = 21, gt_prob: float = 0.7
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Refine two [h, w] label maps of one [h, w, 3] uint8 image;
        returns both refined maps (uint8)."""
        h, w = labels_a.shape
        packed = self.upload(img, labels_a, labels_b)
        kern = self.build(packed, h, w)
        out = self.iterate(kern, packed, n_labels, gt_prob).cpu().numpy()
        return out[0, :h, :w], out[1, :h, :w]

    def single(self, img, labels, n_labels: int = 21,
               gt_prob: float = 0.7) -> np.ndarray:
        a, _ = self.pair(img, labels, labels, n_labels, gt_prob)
        return a
