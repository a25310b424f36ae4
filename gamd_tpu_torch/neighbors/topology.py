"""Water topology over the padded neighbour layout (port of
gamd_tpu/neighbors/topology.py: water_bond_mask, edge_type_water,
neighbor_bond_channel).

Atoms are ordered O, H, H per molecule, so the topology is integer
arithmetic on atom ids: no graph object. Ids of padded slots may be
anything (the centre's own id, negative, N or past it); they are never
used to index, only compared, so the results are exact for any id.
"""

import torch


def water_bond_mask(center_idx, neigh_idx):
    """O-H covalent bond indicator (the model's bond channel): 1.0 where
    one end is a molecule's O (id 0 mod 3) and the other one of its two
    H's (ids +1, +2), else 0.0. H-H pairs are not bonds.

    Args:
        center_idx, neigh_idx: integer tensors of one broadcast shape.
    Returns:
        float32 tensor in {0, 1} of that shape.
    """
    i, j = center_idx, neigh_idx
    i_is_o = torch.remainder(i, 3) == 0
    j_is_o = torch.remainder(j, 3) == 0
    o_to_h = i_is_o & (j - i >= 1) & (j - i <= 2)
    h_to_o = j_is_o & (i - j >= 1) & (i - j <= 2)
    return (o_to_h | h_to_o).to(torch.float32)


def edge_type_water(i, j):
    """Same-molecule test: 0 where i and j belong to one molecule (H-H
    included), 1 otherwise (int64)."""
    r = torch.remainder(i, 3)
    cond1 = (r == 0) & (j - i > 0) & (j - i <= 2)
    cond2 = (r == 1) & (torch.abs(j - i) <= 1)
    cond3 = (r == 2) & (i - j > 0) & (i - j <= 2)
    return torch.where(cond1 | cond2 | cond3, 0, 1)


def neighbor_bond_channel(idx):
    """Bond channel [..., N, K] float32 of a padded list idx [..., N, K]
    (the centre is the second-to-last axis; leading axes such as replicas
    share the topology). Contiguous, as the kernels take it."""
    n = idx.shape[-2]
    center = torch.arange(n, dtype=idx.dtype, device=idx.device)[:, None]
    return water_bond_mask(center, idx).contiguous()
