"""K10's staged schedule on the CPU (``csrc/diag_operator.cu``).

The card is the only place the kernel runs, so these tests decode the
schedule that :func:`random_walk.diag_operator_schedule` hands the kernel
and run it in plain torch the way the kernel's CTAs do: per tile the staged
padded edge, per group of nodes the strict-> chains over the head cells with
the suffix stack, the stored values over the tile and its halo, then the
column sums in pair order. The result must be bit-equal to
``build_diag_operator_plain`` (the twin that ``test_torch_walk_kernels.py``
holds to JAX): every output written once, every neighbour read from the
halo, NaN and -inf as the plain chain takes them."""

import math

import numpy as np
import pytest
import torch

from irn_tpu_torch.ops import paths
from irn_tpu_torch.ops import random_walk as rw
from irn_tpu_torch.ops.affinity import path_table
from irn_tpu_torch.ops.matpow_kernels import pow_int


def _edge(kind, cap, seed=0):
    g = np.random.default_rng(seed)
    e = 1.0 / (1.0 + np.exp(-g.normal(size=cap)))
    if kind == "ties":
        e = np.round(e * 7) / 7
    elif kind == "ones":
        e = np.ones(cap)
    elif kind == "special":
        e[g.random(cap) < 0.03] = np.nan
        e[g.random(cap) < 0.03] = -np.inf
        e[g.random(cap) < 0.02] = -0.0
    return torch.from_numpy(e.astype(np.float32))


def emulate(geom, edge, beta, words):
    """The staged kernel's arithmetic, CTA by CTA, on the CPU."""
    r, rf = geom.radius, geom.path_set.radius_floor
    cap_h, cap_w = geom.cap
    ph, pw = geom.padded
    n, n_pairs = geom.n_pad, geom.path_set.n_pairs
    th, tw = rw.K10_TILE
    ew, rwid, eh = tw + 4 * rf, tw + 2 * rf, th + 2 * rf
    nq = (th + rf) * rwid
    groups, levels, n_nodes, n_heads = (int(v) for v in words[:4])
    starts = words[4: 5 + groups]
    nodes = words[5 + groups: 5 + groups + 2 * n_nodes].reshape(-1, 2)
    heads = torch.from_numpy(
        words[5 + groups + 2 * n_nodes:][:n_heads].astype(np.int64))
    nb = words[5 + groups + 2 * n_nodes + n_heads:]
    assert nb.size == n_pairs
    w = torch.full((n_pairs, n), float("nan"))
    inv = torch.full((n,), float("nan"))
    written = torch.zeros((n_pairs, n), dtype=torch.int32)
    padded = torch.ones((ph + 2 * rf, pw + 4 * rf + th + tw))
    padded[2 * rf: 2 * rf + cap_h, 2 * rf + r: 2 * rf + r + cap_w] = edge
    rows = -(-n // pw)
    q = torch.arange(nq)
    ry, rx = q // rwid, q % rwid
    base = ry * ew + rx + rf
    neg_inf = torch.tensor(float("-inf"))
    for y0 in range(0, rows, th):
        for x0 in range(0, pw, tw):
            # staged edge: padded rows from y0 - rf, columns from x0 - 2 rf
            # (the frame of ones stands in for the kernel's 1.0 fill)
            et = torch.ones((eh, ew))
            part = padded[rf + y0: rf + y0 + eh, x0: x0 + ew]
            et[: part.shape[0], : part.shape[1]] = part
            et = et.reshape(-1)
            Y, X = y0 - rf + ry, x0 - rf + rx
            inside = (Y >= 0) & (Y < ph - rf) & (X >= rf) & (X < pw - rf)
            flat = Y * pw + X
            own = (ry >= rf) & (rx >= rf) & (rx < rf + tw) & (X < pw) & (
                flat < n)
            wv = torch.full((n_pairs, nq), float("nan"))
            for g in range(groups):
                stk = torch.full((levels, nq), float("nan"))
                for i in range(starts[g], starts[g + 1]):
                    w0, w1 = int(nodes[i, 0]), int(nodes[i, 1])
                    pair, depth, flags = w0 & 0xfff, (w0 >> 12) & 0xff, \
                        w0 >> 20
                    b, e = w1 & 0xffff, w1 >> 16
                    v0 = et[base + heads[b]]
                    m = torch.fmax(v0, neg_inf)
                    for j in range(b + 1, e):
                        v = et[base + heads[j]]
                        m = torch.where(v > m, v, m)
                    if flags & 1:
                        a = stk[depth - 1]
                        m = torch.where(a > m, a, m)
                    if flags & 2:
                        stk[depth] = m
                    if flags & 4:
                        val = pow_int(1.0 - torch.where(torch.isnan(v0), v0,
                                                        m), beta)
                        val = torch.where(inside, val, torch.zeros(()))
                        assert torch.isnan(wv[pair]).all()
                        wv[pair] = val
                        w[pair, flat[own]] = val[own]
                        written[pair, flat[own]] += 1
            t = torch.arange(th * tw)
            ty, tx = t // tw, t % tw
            cflat = (y0 + ty) * pw + x0 + tx
            keep = (x0 + tx < pw) & (cflat < n)
            qo = (ty + rf) * rwid + tx + rf
            total = torch.zeros(th * tw)
            for k in range(n_pairs):
                total = total + (wv[k, qo - int(nb[k])] + wv[k, qo])
            inv[cflat[keep]] = (1.0 / (1.0 + total))[keep]
    assert (written == 1).all()
    return w, inv


def _same(a, b):
    return a.shape == b.shape and torch.equal(torch.isnan(a), torch.isnan(b)) \
        and torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("kind", ["sigmoid", "ties", "ones", "special"])
@pytest.mark.parametrize("radius,cap", [(5, (20, 28)), (5, (13, 37)),
                                        (4, (24, 24)), (2, (9, 40)),
                                        (8, (18, 20))])
@pytest.mark.parametrize("beta", [1, 10])
def test_staged_schedule_bit_equal_to_twin(radius, cap, kind, beta):
    """The staged schedule run as the kernel runs it equals the twin, bit
    for bit (NaN where the twin has NaN): radii 2 to 8, odd grids whose
    last tile is cut at pw and at n_pad."""
    geom = rw.build_geometry(*cap, radius=radius)
    words = rw.diag_operator_schedule(path_table(geom.path_set))
    assert words is not None
    edge = _edge(kind, cap, seed=radius + beta)
    got = emulate(geom, edge, beta, words)
    want = rw.build_diag_operator_plain(geom, edge, beta)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_staged_schedule_at_the_main_path_bucket():
    """The default walk's 96 x 128 bucket at radius 5, beta 10: 117 CTAs
    of three groups of 288 positions."""
    geom = rw.build_geometry(96, 128, radius=5)
    words = rw.diag_operator_schedule(path_table(geom.path_set))
    assert int(words[0]) == 3
    edge = _edge("sigmoid", (96, 128), seed=3)
    got = emulate(geom, edge, 10, words)
    want = rw.build_diag_operator_plain(geom, edge, 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("radius", [2, 3, 4, 5, 6, 7, 8, 10, 14])
def test_schedule_layout(radius):
    """Each pair stored once, each group's stack filled before it is read
    (a node with a suffix follows a pushed node one level up), every node's
    head cells its path's head, the words and the shared memory within the
    kernel's limits; radius 10 and up take the direct schedule (None)."""
    table = path_table(paths.build_path_set(radius))
    words = rw.diag_operator_schedule(table)
    assert words is rw.diag_operator_schedule(table)  # cached
    if radius >= 10:
        assert words is None
        return
    rf = table.rf
    th, tw = rw.K10_TILE
    groups, levels, n_nodes, n_heads = (int(v) for v in words[:4])
    assert words.size == 5 + groups + 2 * n_nodes + n_heads + table.n_pairs
    assert words.size <= rw.K10_WORDS and groups >= 1
    nq_pad = -(-((th + rf) * (tw + 2 * rf)) // 32) * 32
    assert groups * nq_pad <= rw.K10_THREADS
    smem = 4 * (table.n_pairs * (th + rf) * (tw + 2 * rf)
                + (th + 2 * rf) * (tw + 4 * rf) + levels * groups * nq_pad)
    assert smem <= rw.K10_SMEM
    starts = words[4: 5 + groups]
    nodes = words[5 + groups: 5 + groups + 2 * n_nodes].reshape(-1, 2)
    heads = words[5 + groups + 2 * n_nodes:][:n_heads]
    stored = []
    ew = tw + 4 * rf
    for g in range(groups):
        pushed = {}
        for i in range(starts[g], starts[g + 1]):
            w0, w1 = int(nodes[i, 0]), int(nodes[i, 1])
            p, depth, flags = w0 & 0xfff, (w0 >> 12) & 0xff, w0 >> 20
            assert depth == table.depth[p]
            assert bool(flags & 1) == (table.suffix[p] >= 0)
            if flags & 1:
                assert pushed.get(depth - 1) == table.suffix[p]
            if flags & 2:
                pushed[depth] = p
            if flags & 4:
                stored.append(p)
            b, e = w1 & 0xffff, w1 >> 16
            cells = table.cells[p][: table.head_length(p)]
            assert [int(h) for h in heads[b:e]] == [
                dy * ew + dx for dy, dx in cells]
    assert sorted(stored) == list(range(table.n_pairs))
    assert math.prod(words[4: 5 + groups].shape) == groups + 1


@pytest.mark.parametrize("radius", [5, 10])
def test_launch_arguments(radius):
    """K10's launch arguments, built once per grid, radius and device: the
    staged schedule's host words (its address and size) at radius 5, the
    direct schedule's device tables at radius 10, then the grid."""
    dev = torch.device("cpu")
    args = rw.k10_args((20, 28), radius, dev)
    assert rw.k10_args((20, 28), radius, dev) is args
    geom = rw.build_geometry(20, 28, radius=radius)
    table = path_table(geom.path_set)
    words = rw.diag_operator_schedule(table)
    if radius == 5:
        assert args[:4] == (words.ctypes.data, words.size, None, None)
    else:
        cells, starts = table.tables(dev)[:2]
        assert args[:4] == (None, 0, cells.data_ptr(), starts.data_ptr())
    assert args[4:] == (20, 28, radius, table.rf, geom.n_pad,
                        geom.path_set.n_pairs,
                        0 if radius == 5 else cells.shape[0])
