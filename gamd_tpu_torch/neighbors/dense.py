"""Dense O(N^2) neighbour search into fixed-capacity padded [N, K] lists
(port of gamd_tpu/neighbors/dense.py: dense_neighbor_list, refresh_mask,
all_pairs_edges; build_nbrs is the k_model rule of gamd_tpu/md/simulate.py:94-112).

Row i holds up to K neighbours of atom i, nearest first; padded slots point
at atom i itself so gathers stay in bounds, and the mask zeroes them. When a
row has more than K atoms in range the farthest are dropped and the
overflow flag says so. The search and build_nbrs also take replicas
[R, N, 3] and give each its own list [R, N, K] (JAX's run_replicas maps
its single-system search over the replica axis), in one pass.
"""

import torch

from gamd_tpu_torch.core import space


def dense_neighbor_list(pos, box, cutoff, k_max, include_self=False):
    """Padded neighbour list from all-pairs minimum-image distances, i == j
    pairs kept only with include_self (the reference's add_self_loop is a
    silent no-op, so the models never set it).

    Returns idx [N, K] int32 (padded slots hold the row index), mask [N, K]
    bool, and overflow, a 0-d bool tensor on pos's device (read it on the
    host only when needed: reading it waits for the device). Replicas
    [R, N, 3] give [R, N, K] lists (indices within the replica) and one
    flag for all.
    """
    n = pos.shape[-2]
    lead = tuple(pos.shape[:-2])
    d2 = space.pairwise_distance2(pos, box)
    within = d2 < cutoff * cutoff
    if not include_self:
        within = within & ~torch.eye(n, dtype=torch.bool, device=pos.device)
    overflow = torch.any(torch.sum(within, dim=-1) > k_max)

    d2_masked = torch.where(within, d2, torch.inf)
    k_eff = min(k_max, n)
    neg, idx = torch.topk(-d2_masked, k_eff, dim=-1)
    mask = neg > -torch.inf
    row = torch.arange(n, device=pos.device)[:, None]
    idx = torch.where(mask, idx, row)
    if k_eff < k_max:
        pad = k_max - k_eff
        idx = torch.cat([idx, row.expand(*lead, n, pad)], dim=-1)
        mask = torch.cat([mask, torch.zeros((*lead, n, pad),
                                            dtype=torch.bool,
                                            device=pos.device)], dim=-1)
    return idx.to(torch.int32), mask, overflow


def build_nbrs(pos, system, k_model=None):
    """The list a simulation chunk reuses: built at cutoff + skin with the
    system's capacity, then cut to the nearest k_model slots (when k_model
    is given and smaller). Lists are distance-sorted, so the nearest k
    slots are a valid smaller working set; if a dropped slot is live at
    build time (a cutoff + skin neighbour would be lost for the chunk),
    overflow is flagged so the caller reruns with a larger k_model.

    Returns idx [N, k] int32 (contiguous), mask [N, k] bool and the 0-d
    bool overflow tensor ([R, N, k] lists and one flag for replicas
    [R, N, 3]).
    """
    idx, mask, ovf = dense_neighbor_list(
        pos, system.box, system.cutoff + system.skin, system.nbr_capacity)
    return keep_nearest(idx, mask, ovf, k_model)


def keep_nearest(idx, mask, ovf, k_model=None):
    """The nearest k_model slots of a distance-sorted list (all of it when
    k_model is None or not smaller), with overflow also flagged when a
    dropped slot is live. Returns contiguous idx and mask, and ovf."""
    if k_model is not None and k_model < idx.shape[-1]:
        ovf = ovf | torch.any(mask[..., k_model:])
        idx = idx[..., :k_model].contiguous()
        mask = mask[..., :k_model].contiguous()
    return idx, mask, ovf


def refresh_mask(pos, box, cutoff, idx, mask):
    """Re-validate a stale list against current positions: the index set
    (built at cutoff + skin) is kept, only the true-cutoff mask is redone."""
    rel = space.min_image(pos[idx.long()] - pos[:, None, :], box)
    return mask & (torch.sum(rel * rel, dim=-1) < cutoff * cutoff)


def all_pairs_edges(pos, box, cutoff):
    """Every ordered pair as an edge slot, the reference's get_neighbor set
    with static shapes: disp [N, N, 3] (min-image pos[j] - pos[i]), dist
    [N, N] and mask [N, N] bool (dist <= cutoff, i != j)."""
    disp = space.pairwise_displacement(pos, box)
    dist = torch.sqrt(torch.sum(disp * disp, dim=-1))
    n = pos.shape[-2]
    mask = (dist <= cutoff) & ~torch.eye(n, dtype=torch.bool,
                                         device=pos.device)
    return disp, dist, mask
