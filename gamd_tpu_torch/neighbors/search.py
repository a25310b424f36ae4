"""Neighbour-list container and a stateful searcher with overflow recovery
(port of gamd_tpu/neighbors/search.py).

Positions are wrapped into the box before every search, the list is built
at cutoff + skin so it can be reused across steps, and a capacity overflow
makes NeighborSearcher rebuild with a capacity grown 1.5x.
"""

from typing import NamedTuple

import torch

from gamd_tpu_torch.core import space
from gamd_tpu_torch.neighbors import dense
from gamd_tpu_torch.neighbors.cell_list import cell_list_neighbor_list


class NeighborList(NamedTuple):
    """Padded fixed-capacity neighbour list.

    idx:  [N, K] int32 neighbour ids (padded slots hold the row index).
    mask: [N, K] bool, True where the slot holds a neighbour within the
          build radius (cutoff + skin).
    overflow: 0-d bool tensor, capacity exceeded (edges may be missing).
    reference_pos: [N, 3] wrapped positions the list was built from.
    """

    idx: torch.Tensor
    mask: torch.Tensor
    overflow: torch.Tensor
    reference_pos: torch.Tensor


def build_neighbor_list(pos, box, cutoff, skin, k_max, method="dense",
                        **cell_kwargs) -> NeighborList:
    """A NeighborList at radius cutoff + skin, by the dense all-pairs
    search or the cell list (cell_kwargs go to cell_list_neighbor_list)."""
    pos = space.wrap(pos, box)
    radius = cutoff + skin
    if method == "dense":
        idx, mask, ovf = dense.dense_neighbor_list(pos, box, radius, k_max)
    elif method == "cell":
        idx, mask, ovf = cell_list_neighbor_list(
            pos, float(box), float(radius), k_max, **cell_kwargs)
    else:
        raise ValueError(f"unknown neighbor method {method!r}")
    return NeighborList(idx=idx, mask=mask, overflow=ovf, reference_pos=pos)


def edge_mask_fn(pos, box, cutoff, nbrs: NeighborList):
    """True-cutoff edge mask over a (possibly stale) neighbour list."""
    return dense.refresh_mask(pos, box, cutoff, nbrs.idx, nbrs.mask)


def needs_rebuild(pos, box, skin, nbrs: NeighborList):
    """0-d bool tensor: some particle moved more than skin / 2 since the
    list's reference positions (half-skin displacement test)."""
    d2 = torch.sum(space.min_image(space.wrap(pos, box)
                                   - nbrs.reference_pos, box) ** 2, dim=-1)
    return torch.any(d2 > (0.5 * skin) ** 2)


class NeighborSearcher:
    """Host-side wrapper with automatic capacity growth: on overflow the
    capacity grows to int(1.5 K + 1) and the list is rebuilt, until it
    fits. Reading the flag waits for the device."""

    def __init__(self, box, cutoff, skin=None, k_max=64, method="dense"):
        self.box = box
        self.cutoff = cutoff
        self.skin = cutoff / 6.0 if skin is None else skin
        self.k_max = int(k_max)
        self.method = method
        self.has_been_init = False

    def init_new_neighbor_lst(self, pos) -> NeighborList:
        nbrs = self._build_with_growth(pos)
        self.has_been_init = True
        return nbrs

    def update_neighbor_lst(self, pos, nbrs: NeighborList) -> NeighborList:
        if bool(needs_rebuild(pos, self.box, self.skin, nbrs)):
            return self._build_with_growth(pos)
        return nbrs

    def _build_with_growth(self, pos) -> NeighborList:
        while True:
            nbrs = build_neighbor_list(pos, self.box, self.cutoff, self.skin,
                                       self.k_max, method=self.method)
            if not bool(nbrs.overflow):
                return nbrs
            self.k_max = int(self.k_max * 1.5 + 1)
