"""The hand-written CUDA kernels vs their plain PyTorch twins on the card.

Marked ``gpu``: they need an NVIDIA card and nvcc, and skip without CUDA.
On the card host: ``python -m pytest tests/test_torch_kernels_gpu.py -q``.
Shapes are small; ``chip_smoke.py`` checks the main-path shapes."""

import numpy as np
import pytest
import torch

from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import matpow_kernels as mk
from irn_tpu_torch.ops import random_walk as rw

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.reset_launches()
    return torch.device("cuda")


def _banded(n, h, seed=0):
    g = np.random.default_rng(seed)
    r = np.arange(n)
    t = np.where(np.abs(r[:, None] - r[None, :]) <= h,
                 g.random((n, n), dtype=np.float32), 0.0).astype(np.float32)
    return torch.from_numpy(t / t.sum(0, keepdims=True))


def test_diag_chain_bit_equal(cuda):
    geom = rw.build_geometry(32, 32, radius=5)
    g = np.random.default_rng(0)
    edge = torch.from_numpy(g.random((32, 32), dtype=np.float32)).to(cuda)
    w, inv = rw.build_diag_operator(geom, edge)
    x = torch.from_numpy(g.random((5, geom.n_pad), dtype=np.float32)).to(cuda)
    doffs = rw.diag_offsets(geom)
    got = rw.apply_diag_chain(x, w, inv, doffs, 16)
    want = rw.apply_diag_chain_plain(x, w, inv, doffs, 16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["diag_chain"] == 16  # one per application
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_pack_banded_bit_equal(cuda):
    t = _banded(1024, 200).to(cuda)
    got = mk.pack_banded(t, 200, 128)
    assert torch.equal(got, mk.pack_banded_plain(t, 200, 128))
    assert _build.LAUNCHES["pack_banded"] == 1


def test_square_banded_in_band(cuda):
    n, h, bs = 1024, 130, 128
    t = _banded(n, h).to(cuda)
    got = mk.square_banded(t, h, bs)
    want = mk.square_banded_plain(t, h, bs)
    r = torch.arange(n, device=cuda)
    inband = (r[:, None] - r[None, :]).abs() <= 2 * h
    torch.testing.assert_close(got[inband], want[inband], rtol=1e-5,
                               atol=1e-6)
    assert _build.LAUNCHES["square_banded"] == 1


def test_packed_chain(cuda):
    n, h, bs = 1024, 130, 128
    t = _banded(n, h).to(cuda)
    x = torch.rand((12, n), generator=torch.Generator().manual_seed(0)).to(cuda)
    tp = mk.pack_banded(t, h, bs)
    got = mk.packed_chain(x, tp, 6, bs)
    want = mk.packed_chain_plain(x, tp, 6, bs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert _build.LAUNCHES["pack_banded"] == 1
    assert _build.LAUNCHES["packed_chain"] == 2 * 6  # two per application


def test_kernels_refuse_non_f32(cuda):
    t = _banded(512, 60).to(cuda).to(torch.float64)
    with pytest.raises(TypeError):
        mk.pack_banded(t, 60, 128)
    with pytest.raises(TypeError):
        mk.square_banded(t, 60, 128)
