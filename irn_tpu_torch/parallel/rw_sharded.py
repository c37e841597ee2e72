"""One image's random walk split over several devices — the counterpart of
:mod:`irn_tpu.parallel.rw_sharded` (``--rw_mesh_model k``, the walk's
"long-context" mode).

The JAX package splits one walk over the model axis of a mesh that one
controller drives (``make_mesh(n_data=1, n_model=k)``); its make stages
give each process its own images, so an image's walk lives inside one
process. The port does the same: one process drives a :class:`ModelMesh`,
an ordered tuple of devices (a device may repeat), and a matrix split over
it is a list of blocks, block i on device i. Halos and partial sums move
between devices by ``Tensor.to``: between two cards PyTorch queues such a
copy after the work already queued on the current streams of both, and
the destination's stream waits for it, so no event is needed.

Routes (the JAX functions named beside each):

- :func:`diag_apply` (``diag_apply_in_jit``), the default: x @ T^n with T
  in diagonal form and the seed columns split over the devices. Each round
  hands every device its neighbours' edge columns, runs K0 (the hand
  kernel of :func:`irn_tpu_torch.ops.random_walk.apply_diag_chain`) for m
  applications on its window (its columns and m*H more each side, H the
  largest diagonal offset) and keeps its own columns. The window's zero
  fill reaches H columns per application, so the kept columns see the
  adds of the whole-matrix chain in its order: bit-equal to it.
- :func:`assemble_rows`, :func:`normalize_rows`, :func:`banded_power`,
  :func:`banded_apply` (``*_in_jit``): the banded matrix T row-split; no
  device holds all of it, squarings ship only the band's rows.
- :func:`sharded_matrix_power` and :func:`sharded_propagate_rows`: the
  dense route with the rows split.

The JAX package runs every product here as ``jnp.dot`` outside its Pallas
kernels (those are single-chip): at HIGHEST precision for f32 operands, or
on bf16 operands with f32 accumulation and an f32 result at
``matmul_dtype`` bfloat16. The port's are ``torch.matmul`` in f32, with
TF32 off as the stages pin it, on operands rounded to bf16 at
``matmul_dtype`` ``torch.bfloat16`` (:func:`matpow_kernels.operand`): each
product exact, the carry between squarings and applications f32.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from irn_tpu_torch.ops import matpow_kernels as mk
from irn_tpu_torch.ops.matpow_kernels import pow_int
from irn_tpu_torch.parallel import mesh as mesh_mod

Bounds = List[Tuple[int, int]]


class ModelMesh:
    """The devices that share one walk, in order. Device i holds the i-th
    contiguous block of a split matrix's rows or columns (:meth:`bounds`).
    A device may repeat: ``("cpu",) * k`` in the tests, ``("cuda:0",) * k``
    on a host with one card."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(mesh_mod.indexed(d) for d in devices)
        if not self.devices:
            raise ValueError("ModelMesh: no devices")

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """Where a split result is gathered."""
        return self.devices[0]

    def bounds(self, n: int) -> Bounds:
        """Each device's block [lo, hi) of n rows or columns: n // k each,
        the first n % k blocks one longer."""
        q, r = divmod(n, len(self.devices))
        out, lo = [], 0
        for i in range(len(self.devices)):
            out.append((lo, lo + q + (i < r)))
            lo = out[-1][1]
        return out

    def split(self, t: torch.Tensor, dim: int) -> List[torch.Tensor]:
        """``t``'s blocks along ``dim``, block i on device i."""
        return [t.narrow(dim, lo, hi - lo).to(d) for (lo, hi), d in
                zip(self.bounds(t.shape[dim]), self.devices)]

    def gather(self, blocks: Sequence[torch.Tensor], dim: int,
               device: Optional[torch.device] = None) -> torch.Tensor:
        """The blocks joined along ``dim`` on ``device`` (default
        :attr:`first`)."""
        dev = device or self.first
        return torch.cat([b.to(dev) for b in blocks], dim)

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The partials summed on :attr:`first`, in device order."""
        acc = parts[0].to(self.first)
        for p in parts[1:]:
            acc = acc + p.to(self.first)
        return acc


def _span(blocks: Sequence[torch.Tensor], bounds: Bounds, lo: int, hi: int,
          dim: int, device: torch.device) -> torch.Tensor:
    """Rows (``dim`` 0) or columns (1) [lo, hi) of the split matrix on
    ``device``, each piece copied from the device that holds it, zeros
    outside [0, n)."""
    n = bounds[-1][1]
    ref = blocks[0]

    def zeros(k):
        shape = list(ref.shape)
        shape[dim] = k
        return torch.zeros(shape, dtype=ref.dtype, device=device)

    parts = [zeros(-lo)] if lo < 0 else []
    for (b0, b1), blk in zip(bounds, blocks):
        a, b = max(lo, b0), min(hi, b1)
        if a < b:
            parts.append(blk.narrow(dim, a - b0, b - a).to(device))
    if hi > n:
        parts.append(zeros(hi - n))
    return torch.cat(parts, dim)


# -- the diagonal stencil, columns split -------------------------------------

class DiagPlan(NamedTuple):
    """:func:`diag_apply`'s schedule: m applications per round, the rounds,
    each device's window [lo, hi) of columns, and the halo columns all
    devices receive per round (the window's columns held by others)."""

    per_round: int
    rounds: int
    windows: Tuple[Tuple[int, int], ...]
    halo_columns: int


def diag_max_per_round(n: int, doffs: Sequence[int], n_dev: int) -> int:
    """The most applications a round may take with one neighbour hop:
    n_loc // H."""
    return (n // n_dev) // max(doffs)


def diag_plan(n: int, doffs: Sequence[int], n_dev: int, n_apply: int,
              per_round: Optional[int] = None) -> DiagPlan:
    """The rounds of :func:`diag_apply` over ``n_dev`` devices, m
    applications each (default :func:`diag_max_per_round`; never more than
    ``n_apply``). Each window is the device's columns plus m*H each side,
    clipped to [0, n) and widened to a multiple of 4 (K0's column unit).
    Raises unless the columns split evenly and each block covers H (the
    JAX gate ``diag_sharded_fits``), or when m is out of [1, n_loc // H]."""
    h = max(doffs)
    top = diag_max_per_round(n, doffs, n_dev)
    if n % n_dev or top < 1:
        raise ValueError(f"diag_apply: {n} columns over {n_dev} devices "
                         f"(blocks must be equal and >= the halo {h})")
    m = top if per_round is None else per_round
    if not 1 <= m <= top:
        raise ValueError(f"diag_apply: {m} applications per round, "
                         f"not in [1, {top}]")
    m = min(m, max(n_apply, 1))  # no window wider than the walk needs
    n_loc = n // n_dev
    windows, halo = [], 0
    for j in range(n_dev):
        c0, c1 = j * n_loc, (j + 1) * n_loc
        lo, hi = max(0, c0 - m * h), min(n, c1 + m * h)
        extra = -(hi - lo) % 4
        grow = min(extra, n - hi)
        lo, hi = lo - (extra - grow), hi + grow
        windows.append((lo, hi))
        halo += (c0 - lo) + (hi - c1)
    return DiagPlan(m, -(-n_apply // m), tuple(windows), halo)


def diag_apply(x: torch.Tensor, w: torch.Tensor, inv: torch.Tensor,
               doffs: Sequence[int], n_apply: int, mesh: ModelMesh,
               per_round: Optional[int] = None) -> torch.Tensor:
    """x @ T^n_apply with T in diagonal form (``w`` [n_pairs, n], ``inv``
    [n], as :func:`irn_tpu_torch.ops.random_walk.build_diag_operator`
    returns them, on any device) and the seed columns of ``x`` [C, n]
    split over ``mesh``: :func:`diag_plan`'s rounds, each one K0 launch per
    device on its window (``apply_diag_chain``; its plain twin on the CPU),
    a short last round. Every device slices ``w`` and ``inv`` to its window
    once. Returns [C, n] gathered on ``mesh.first``, bit-equal to
    ``apply_diag_chain`` on the whole matrix."""
    from irn_tpu_torch.ops.random_walk import apply_diag_chain

    c, n = x.shape
    plan = diag_plan(n, doffs, len(mesh), n_apply, per_round)
    bounds = mesh.bounds(n)
    ops = [(w[:, lo:hi].to(d).contiguous(), inv[lo:hi].to(d).contiguous())
           for (lo, hi), d in zip(plan.windows, mesh.devices)]
    blocks = mesh.split(x, 1)
    done = 0
    while done < n_apply:
        step = min(plan.per_round, n_apply - done)
        # every window is cut from the blocks as the round found them
        wins = [_span(blocks, bounds, lo, hi, 1, d)
                for (lo, hi), d in zip(plan.windows, mesh.devices)]
        blocks = [
            apply_diag_chain(xw, wo, io, doffs, step)[:, c0 - lo : c1 - lo]
            for xw, (wo, io), (lo, _), (c0, c1) in zip(
                wins, ops, plan.windows, bounds)]
        done += step
    return mesh.gather(blocks, 1)


# -- the banded matrix, rows split ------------------------------------------

def assemble_rows(vs: torch.Tensor, doffs: Sequence[int], n: int,
                  mesh: ModelMesh) -> List[torch.Tensor]:
    """The affinity matrix's row blocks, each built on its device from the
    [n_pairs, n] band table ``vs`` (JAX ``assemble_rows_in_jit``): in a
    row-major (n, n+1) buffer H the upper band d lies in column d and the
    lower band in column n+1-d, and A.flat = H.flat[:n*n]. A device's A
    rows start r0 elements before its own H rows' span, so the previous
    device's last H row closes the gap. No device holds all of A."""
    bounds = mesh.bounds(n)
    hs = []
    for (r0, r1), d in zip(bounds, mesh.devices):
        v = vs.to(d)
        h_loc = torch.zeros((r1 - r0, n + 1), dtype=torch.float32, device=d)
        h_loc[:, 0] = 1.0  # the unit diagonal
        for k, doff in enumerate(doffs):
            h_loc[:, doff] = v[k, r0:r1]
            h_loc[:, n + 1 - doff] = F.pad(v[k], (doff - 1, 0))[r0:r1]
        hs.append(h_loc)
    out = []
    for j, ((r0, r1), h_loc, d) in enumerate(zip(bounds, hs, mesh.devices)):
        prev = (hs[j - 1][-1].to(d) if j else
                torch.zeros((n + 1,), dtype=torch.float32, device=d))
        flat = torch.cat([prev, h_loc.reshape(-1)])
        start = n + 1 - r0
        out.append(flat[start : start + (r1 - r0) * n].reshape(r1 - r0, n))
    return out


def normalize_rows(a_blocks: Sequence[torch.Tensor], beta: int,
                   mesh: ModelMesh) -> List[torch.Tensor]:
    """A^beta divided by its column sums, A row-split (JAX
    ``normalize_rows_in_jit``): each device's column sums, summed over the
    devices in order."""
    scaled = [pow_int(a, beta) for a in a_blocks]
    col = mesh.sum([s.sum(0) for s in scaled])
    return [s / col.to(s.device)[None, :] for s in scaled]


def halo_rows(blocks: Sequence[torch.Tensor], h: int,
              mesh: ModelMesh) -> List[torch.Tensor]:
    """Each device's rows [r0 - h, r1 + h) of the row-split matrix, from as
    many neighbours as h needs, zero rows beyond the matrix's edges (JAX
    ``_halo_rows``: exactly the zeros a banded matrix holds there)."""
    bounds = mesh.bounds(sum(b.shape[0] for b in blocks))
    return [_span(blocks, bounds, r0 - h, r1 + h, 0, d)
            for (r0, r1), d in zip(bounds, mesh.devices)]


def banded_power(t_blocks: Sequence[torch.Tensor], exp_times: int, h: int,
                 mesh: ModelMesh, matmul_dtype=None) -> List[torch.Tensor]:
    """T^(2^exp_times) for a banded T of halfwidth ``h``, row-split, still
    row-split (JAX ``banded_power_in_jit``). Each squaring ships the band's
    rows (:func:`halo_rows`) and runs one product per device, [n_loc,
    n_loc + 2h] @ [n_loc + 2h, n]: full output rows, so entries beyond the
    band stay exact zeros. At ``matmul_dtype`` bf16 each squaring rounds
    the blocks to bf16 before the halo rows are cut (JAX casts them before
    its exchange); the products and the carry stay f32."""
    n = t_blocks[0].shape[1]
    bounds = mesh.bounds(n)
    blocks = list(t_blocks)
    for _ in range(exp_times):
        blocks = [mk.operand(b, matmul_dtype) for b in blocks]
        ctx = halo_rows(blocks, h, mesh)
        new = []
        for (r0, r1), blk, rows in zip(bounds, blocks, ctx):
            a, b = max(0, r0 - h), min(n, r1 + h)
            cols = F.pad(blk[:, a:b], (a - (r0 - h), (r1 + h) - b))
            new.append(torch.matmul(cols, rows))
        blocks = new
        h *= 2
    return blocks


def banded_apply(seeds: torch.Tensor, t_blocks: Sequence[torch.Tensor],
                 n_apply: int, mesh: ModelMesh,
                 matmul_dtype=None) -> torch.Tensor:
    """x @ T^n_apply with T row-split (JAX ``banded_apply_in_jit``): each
    application contracts the seed columns of a device's rows with its
    block, and the partials are summed on ``mesh.first`` in device order.
    At ``matmul_dtype`` bf16 the blocks are rounded once and the seed
    columns before each product. Returns [C, n] there."""
    bounds = mesh.bounds(seeds.shape[1])
    blocks = [mk.operand(b, matmul_dtype) for b in t_blocks]
    x = seeds.to(mesh.first)
    for _ in range(n_apply):
        xb = mk.operand(x, matmul_dtype)
        x = mesh.sum([torch.matmul(xb[:, r0:r1].to(blk.device), blk)
                      for (r0, r1), blk in zip(bounds, blocks)])
    return x


# -- the dense matrix, rows split -------------------------------------------

def sharded_matrix_power(t: torch.Tensor, exp_times: int, mesh: ModelMesh,
                         matmul_dtype=None) -> List[torch.Tensor]:
    """T^(2^exp_times) with T's rows split (JAX ``sharded_matrix_power``):
    per squaring each device's row block times the whole T, gathered once
    per distinct device (both rounded to bf16 first at ``matmul_dtype``
    bf16; the carry f32). Returns the row blocks."""
    blocks = mesh.split(t, 0)
    for _ in range(exp_times):
        blocks = [mk.operand(b, matmul_dtype) for b in blocks]
        whole = {}
        for d in mesh.devices:
            if d not in whole:
                whole[d] = mesh.gather(blocks, 0, d)
        blocks = [torch.matmul(b, whole[d])
                  for b, d in zip(blocks, mesh.devices)]
    return blocks


def sharded_propagate_rows(seeds: torch.Tensor, t: torch.Tensor,
                           mesh: ModelMesh,
                           matmul_dtype=None) -> torch.Tensor:
    """x @ T with T's rows split (JAX ``sharded_propagate_rows``): each
    device contracts its seed columns with its row block (at
    ``matmul_dtype``, as :func:`banded_apply`); the partials are summed on
    ``mesh.first`` in device order."""
    return banded_apply(seeds, mesh.split(t, 0), 1, mesh, matmul_dtype)
