"""Fixed-capacity cell-list neighbour search for large particle systems
(port of gamd_tpu/neighbors/cell_list.py: cell_list_neighbor_list).

  1. particles are binned into an [n_cells + 1, cell_capacity] buffer by a
     stable sort on the cell id and a scatter of each particle's rank
     within its cell; entries past the capacity fall into a trash row
     (never read) and set the overflow flag;
  2. each particle gathers the candidates of its 27 neighbouring cells, a
     block of `chunk` particles at a time, so the [N, 27 * C] candidate
     tensors never exist whole;
  3. candidates are filtered by the cutoff and the nearest K kept by top-k
     of -d^2, into the padded [N, K] layout of the dense list: nearest
     first, padded slots holding the row's own index.

box and cutoff are Python floats, since they size the grid. Everything
stays on pos's device, and the overflow flag is a 0-d bool tensor there
(no host sync).
"""

import math

import torch

from gamd_tpu_torch.core import space

#: The 27 neighbour-cell offsets, in the JAX package's order.
_OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
            for k in (-1, 0, 1)]


def _grid_dims(box: float, cutoff: float) -> int:
    """Cells per dimension; cell width >= cutoff so 27 cells cover the
    ball."""
    n = int(math.floor(box / cutoff))
    if n < 3:
        raise ValueError(
            f"box/cutoff = {box / cutoff:.2f} < 3: cell list would alias "
            "periodic images; use dense_neighbor_list for this system.")
    return n


def cell_list_neighbor_list(pos, box: float, cutoff: float, k_max: int,
                            cell_capacity: int = 16, chunk: int = 4096):
    """Padded [N, K] neighbour list by cell binning.

    Args:
        pos: [N, 3] positions.
        box: cubic box edge (A).
        cutoff: search radius (build with cutoff + skin for reuse).
        k_max: neighbour capacity K.
        cell_capacity: most particles a cell holds.
        chunk: particles per block of the distance-filter stage.

    Returns idx [N, K] int32 (self-padded), mask [N, K] bool and overflow,
    a 0-d bool tensor: a cell held more than cell_capacity particles or a
    row had more than k_max neighbours in range.
    """
    n = pos.shape[0]
    dev = pos.device
    n_dim = _grid_dims(box, cutoff)
    n_cells = n_dim ** 3
    cell_width = box / n_dim

    p = space.wrap(pos, box)
    coords = torch.clamp((p / cell_width).to(torch.int64), 0, n_dim - 1)
    cid = (coords[:, 0] * n_dim + coords[:, 1]) * n_dim + coords[:, 2]

    # Bin fill: sort by cell id, rank within the cell, scatter.
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    first_of_cell = torch.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = torch.arange(n, device=dev) - first_of_cell
    bin_overflow = torch.any(rank >= cell_capacity)
    fits = rank < cell_capacity
    target_cell = torch.where(fits, sorted_cid, n_cells)
    target_slot = torch.where(fits, rank, 0)
    cell_buf = torch.full((n_cells + 1, cell_capacity), n, dtype=torch.int64,
                          device=dev)
    cell_buf[target_cell, target_slot] = order

    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)   # [27, 3]
    # Index n (an empty slot) maps to a sentinel outside every cutoff.
    pos_pad = torch.cat([p, torch.full((1, 3), 2.0 * box, dtype=p.dtype,
                                       device=dev)])
    idx_blocks, mask_blocks = [], []
    row_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for start in range(0, n, chunk):
        ids = torch.arange(start, min(start + chunk, n), device=dev)
        nbr = torch.remainder(coords[ids][:, None, :] + offs[None], n_dim)
        nbr_cid = (nbr[..., 0] * n_dim + nbr[..., 1]) * n_dim + nbr[..., 2]
        cand = cell_buf[nbr_cid].reshape(ids.shape[0], -1)      # [B, 27*C]
        d = space.min_image(pos_pad[cand] - p[ids][:, None, :], box)
        d2 = torch.sum(d * d, dim=-1)
        valid = (cand < n) & (cand != ids[:, None]) \
            & (d2 < cutoff * cutoff)
        row_overflow = row_overflow | torch.any(valid.sum(dim=1) > k_max)
        neg, sel = torch.topk(torch.where(valid, -d2, -torch.inf), k_max,
                              dim=1)
        mask = neg > -torch.inf
        idx = torch.where(mask, torch.gather(cand, 1, sel), ids[:, None])
        idx_blocks.append(idx.to(torch.int32))
        mask_blocks.append(mask)
    return (torch.cat(idx_blocks), torch.cat(mask_blocks),
            bin_overflow | row_overflow)
