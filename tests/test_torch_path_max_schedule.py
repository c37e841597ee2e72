"""The schedules of K13a and K13b (``csrc/path_max.cu``) on the CPU.

``PathTable`` builds the suffix links and the depth-first pair order that
K13a walks, and the cell words (unique cell, dy, dx) that K13b's pair-major
sums use. The kernels run only on the card; here each schedule runs as a
pure-torch emulation that decodes the very tables the kernels get, in the
kernels' order, and is held bit for bit to the unchanged plain twins
``path_max_plain`` and ``path_max_bwd_plain`` (which
tests/test_torch_train_irn.py holds to JAX)."""

import numpy as np
import pytest
import torch

from irn_tpu_torch.ops import affinity, paths

CPU = torch.device("cpu")
RADII = (4, 5, 10)
# (radius, [B, H, W]): ragged tiles of 32 columns, a window width that is
# not a multiple of 4, two tile rows and more
SHAPES = ((4, (1, 16, 40)), (5, (3, 37, 29)), (5, (2, 24, 30)),
          (10, (2, 20, 40)), (10, (1, 27, 52)))


def _table(radius):
    return affinity.path_table(paths.build_path_set(radius))


def _edge(kind, shape, seed=0):
    g = np.random.default_rng(seed)
    e = 1.0 / (1.0 + np.exp(-g.standard_normal(shape)))
    if kind == "ties":
        e = np.round(e * 7) / 7
    elif kind == "zeros":
        e = np.zeros(shape)
    elif kind == "nan":
        e[g.random(shape) < 0.05] = np.nan
        e[g.random(shape) < 0.05] = -np.inf
    return torch.from_numpy(e.astype(np.float32))


def _bits(x):
    return x.contiguous().view(torch.int32)


def emulate_fwd(edge, table):
    """K13a's order: the pairs in the table's depth-first order, each its
    head's strict-> chain started at max(destination, -inf), one compare
    against its suffix pair's (m, a) from the stack, NaN destinations
    written as they are."""
    words = table.tables(CPU).fwd.numpy()
    n, rf = table.n_pairs, table.rf
    b, h, w = edge.shape
    ch, cw = h - rf, w - 2 * rf
    nodes, heads = words[: 4 * n].reshape(n, 4), words[4 * n :]
    stack = {}
    maxed = torch.empty((b, n, ch, cw))
    winner = torch.empty((b, n, ch, cw), dtype=torch.int8)

    def window(c):
        dy, dx = int(c) >> 16, (int(c) & 0xFFFF) - rf
        return affinity.shifted_window(edge, dy, dx, rf, ch, cw)

    for p, begin, end, flags in nodes:
        v0 = window(heads[begin])
        m = torch.where(torch.isnan(v0), -torch.inf, v0)
        a = torch.zeros(v0.shape, dtype=torch.int32)
        for l in range(1, end - begin):
            v = window(heads[begin + l])
            take = v > m
            m, a = torch.where(take, v, m), torch.where(take, l, a)
        depth = flags & 0xFF
        if flags & 1 << 8:
            pm, pa = stack[depth - 1]
            take = pm > m
            m, a = torch.where(take, pm, m), torch.where(take, end - begin + pa,
                                                         a)
        if flags & 1 << 9:
            stack[depth] = (m, a)
        nan0 = torch.isnan(v0)
        maxed[:, p] = torch.where(nan0, v0, m)
        winner[:, p] = torch.where(nan0, 0, a).to(torch.int8)
    return maxed, winner


def emulate_bwd(g, winner, table, hw, rows_t=8, lanes=32):
    """K13b's order: every block of lanes x rows_t pixels keeps a sum per
    (unique cell u, pixel) from +0.0; the pairs in ascending order, each
    output position of the block's window reads its winner, decodes the
    cell's sum offset, and on a hit (the pixel in the tile) adds its
    cotangent there; then each pixel adds its sums in u order."""
    h, w = hw
    rf, n_unique = table.rf, len(table.by_cell)
    ch, cw = h - rf, w - 2 * rf
    tab = table.tables(CPU)
    starts, cells = tab.starts.long(), tab.bwd.long()
    b = g.shape[0]
    nby, nbx = -(-h // rows_t), -(-w // lanes)
    # window positions (sy, sx) of every block, relative to its (Y0, X0)
    sy = torch.arange(rows_t + rf)[:, None] - rf
    sx = torch.arange(lanes + 2 * rf)[None, :] - 2 * rf
    y = (torch.arange(nby) * rows_t)[:, None, None, None] + sy
    x = (torch.arange(nbx) * lanes)[None, :, None, None] + sx
    inside = (y >= 0) & (y < ch) & (x >= 0) & (x < cw)  # [nby, nbx, ., .]
    yc, xc = y.clamp(0, ch - 1), x.clamp(0, cw - 1)
    tp = rows_t * lanes
    sums = torch.zeros((b, nby, nbx, n_unique * tp))
    flat = sums.view(b, -1)
    base = ((torch.arange(nby)[:, None] * nbx + torch.arange(nbx))
            * n_unique * tp)[None, :, :, None, None]
    bi = torch.arange(b)[:, None, None, None, None]
    for p in range(table.n_pairs):
        wl = winner[:, p].long()[:, yc, xc]  # [b, nby, nbx, ., .]
        c = cells[int(starts[p]) + torch.where(inside, wl, 0)]
        dy, dxr = c >> 8 & 0xFF, c & 0xFF
        hit = (inside & (sy + dy >= 0) & (sy + dy < rows_t)
               & (sx + dxr >= 0) & (sx + dxr < lanes))
        at = ((c >> 16) * tp + dy * lanes + dxr + sy * lanes + sx
              + base).expand_as(hit)
        gv = g[:, p][:, yc, xc]
        bb = bi.expand_as(hit)
        flat[bb[hit], at[hit]] = flat[bb[hit], at[hit]] + gv[hit]
    sums = sums.view(b, nby, nbx, n_unique, tp)
    acc = torch.zeros(sums.shape[:3] + (tp,))
    for u in range(n_unique):
        acc = acc + sums[..., u, :]
    acc = acc.reshape(b, nby, nbx, rows_t, lanes).permute(0, 1, 3, 2, 4)
    return acc.reshape(b, nby * rows_t, nbx * lanes)[:, :h, :w]


@pytest.mark.parametrize("radius", RADII)
def test_suffix_links_and_order(radius):
    """Each link's path is the longest proper tail of its pair's path that
    is a pair's whole path; every suffix comes before the pairs that extend
    it; the depth counts the links to a root."""
    table = _table(radius)
    index = {c: p for p, c in enumerate(table.cells)}
    pos = {p: i for i, p in enumerate(table.order)}
    assert sorted(table.order) == list(range(table.n_pairs))
    for p, (path, s) in enumerate(zip(table.cells, table.suffix)):
        tails = [path[k:] for k in range(1, len(path)) if path[k:] in index]
        if s < 0:
            assert not tails and table.depth[p] == 0
            continue
        assert table.cells[s] == path[len(path) - len(table.cells[s]) :]
        assert table.cells[s] == tails[0]
        assert pos[s] < pos[p] and table.depth[p] == table.depth[s] + 1


@pytest.mark.parametrize("radius,reads", [(4, 82), (5, 142), (10, 1110)])
def test_suffix_reuse_reads(radius, reads):
    """The head cells plus one combine per link: 1,110 at radius 10 for the
    2,134 cells of the full chains, 142 for 242 at radius 5."""
    table = _table(radius)
    links = sum(s >= 0 for s in table.suffix)
    assert sum(map(table.head_length, range(table.n_pairs))) + links == reads


@pytest.mark.parametrize("kind", ["sigmoid", "ties", "zeros", "nan"])
@pytest.mark.parametrize("radius,shape", SHAPES)
def test_fwd_schedule_matches_plain(kind, radius, shape):
    """K13a's suffix-reuse order gives the plain chain's values and winners
    bit for bit: ties keep the first cell, NaN and -inf in the map."""
    table = _table(radius)
    edge = _edge(kind, shape, seed=radius)
    got_m, got_w = emulate_fwd(edge, table)
    want_m, want_w = affinity.path_max_plain(edge, table)
    assert torch.equal(_bits(got_m), _bits(want_m))
    assert torch.equal(got_w, want_w)


@pytest.mark.parametrize("kind", ["sigmoid", "ties", "zeros"])
@pytest.mark.parametrize("radius,shape", SHAPES)
def test_bwd_schedule_matches_plain(kind, radius, shape):
    """K13b's pair-major hits-only sums equal the plain routing bit for
    bit, sign of zero included, with a g that holds signed zeros."""
    table = _table(radius)
    edge = _edge(kind, shape, seed=radius)
    _, winner = affinity.path_max_plain(edge, table)
    g = np.random.default_rng(1).standard_normal(tuple(winner.shape))
    g[np.random.default_rng(2).random(g.shape) < 0.3] = 0.0
    g[np.random.default_rng(3).random(g.shape) < 0.3] *= -0.0
    g = torch.from_numpy(g.astype(np.float32))
    got = emulate_bwd(g, winner, table, shape[1:])
    want = affinity.path_max_bwd_plain(g, winner, table, shape[1:])
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("radius,shape", SHAPES[:2])
def test_bwd_schedule_inf_nan(radius, shape):
    """Signed zeros, +-inf and a planted NaN in g: the skipped misses do
    not show."""
    table = _table(radius)
    _, winner = affinity.path_max_plain(_edge("ties", shape), table)
    g = np.random.default_rng(4).standard_normal(tuple(winner.shape))
    r = np.random.default_rng(5).random(g.shape)
    g[r < 0.2] = -0.0
    g[(r >= 0.2) & (r < 0.25)] = np.inf
    g[(r >= 0.25) & (r < 0.3)] = -np.inf
    g.flat[g.size // 2] = np.nan
    g = torch.from_numpy(g.astype(np.float32))
    got = emulate_bwd(g, winner, table, shape[1:])
    want = affinity.path_max_bwd_plain(g, winner, table, shape[1:])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_bwd_tables_fit():
    """Every radius whose table check_table admits packs K13b's cell words
    without loss: each (pair, position) decodes to its cell's index in
    by_cell and its (dy, dx + rf)."""
    for radius in range(2, 15):
        table = _table(radius)
        affinity.check_table(table)
        words = table.tables(CPU).bwd.tolist()
        flat = [c for path in table.cells for c in path]
        assert len(words) == len(flat)
        for word, (dy, dx) in zip(words, flat):
            u = word >> 16
            assert table.by_cell[u][0] == (dy, dx)
            assert (word >> 8 & 0xFF, word & 0xFF) == (dy, dx + table.rf)


@pytest.mark.parametrize("tile", [(32, 4), (64, 8), (128, 4)])
@pytest.mark.parametrize("radius,shape", [(4, (2, 16, 40)), (5, (3, 37, 29)),
                                          (10, (2, 40, 52))])
def test_staged_probe_tables(radius, shape, tile):
    """The staged K13b probe's tables (tools/probe_path_max_bwd.py): for
    every entry and every in-window pixel of every block, the window byte
    the kernel reads is the one its loader staged from winner[b, p, y - dy,
    x - rf - dx], and the cotangent offset points at the same output; each
    cell's last entry carries the flag, in by_cell order."""
    from irn_tpu_torch.tools.probe_path_max_bwd import staged_tables

    table = _table(radius)
    b_n, h, w = shape
    rf, n = table.rf, table.n_pairs
    ch, cw = h - rf, w - 2 * rf
    tx_t, ty_t = tile
    words, n_ent, _, smem = staged_tables(table, tx_t, ty_t, (h, w))
    ent = words[: 3 * n_ent].reshape(n_ent, 3).astype(np.int64)
    a = ent[:, 0] & 0xFFFFFFFF
    pair = words[3 * n_ent :].reshape(n, 2).astype(np.int64)
    flat = [(p, l, c) for c, plist in table.by_cell for p, l in plist]
    p = np.array([f[0] for f in flat])
    dy = np.array([f[2][0] for f in flat])
    dxr = np.array([f[2][1] + rf for f in flat])
    assert np.array_equal(a >> 24 & 127, [f[1] for f in flat])
    lasts = np.cumsum([len(pl) for _, pl in table.by_cell]) - 1
    assert np.array_equal(np.flatnonzero(a >> 31), lasts)
    woff, rw = pair[p, 0] & 0xFFFF, pair[p, 0] >> 16
    dy1, dx1r = pair[p, 1] & 0xFF, pair[p, 1] >> 8 & 0xFF
    assert 4 * (woff + (pair[p, 1] >> 24) * rw).max() <= smem
    for b in range(b_n):
        for y in range(h):
            for x in range(0, w, 4):
                y0, x0 = y - y % ty_t, x - x % tx_t
                ty, tx = y - y0, x - x0
                oy, ox = y - dy, x - dxr
                sh = (b * n * ch * cw + x0 + y * cw) & 0xFFFFFFFF
                byte = ((a & 0x3FFFF) + ty * (a >> 16 & 0xFC)
                        + ((sh + ent[:, 2]) & 3) + tx)
                r, q = np.divmod(byte - 4 * woff, 4 * rw)
                gs = ((b * n + p) * ch + y0 - dy1 + r) * cw + x0 - dx1r
                staged = gs - (gs & 3) + q
                want = ((b * n + p) * ch + oy) * cw + ox
                inside = (oy >= 0) & (oy < ch) & (ox >= 0) & (ox + 3 < cw)
                assert np.array_equal(staged[inside], want[inside])
                g_at = b * n * ch * cw + y * cw + x + ent[:, 1]
                assert np.array_equal(g_at[inside], want[inside])
