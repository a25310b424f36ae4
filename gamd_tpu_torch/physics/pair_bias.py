"""Pair-distance-resolved projection profiles, the RDF-gate diagnostic
(port of gamd_tpu/physics/pair_bias.py: pair_projection_profile).

Given per-atom 3-vectors v_i (force errors, forces, ...) on a set of
frames, the mean projection onto pair directions as a function of pair
distance:

    P(r) = E[ v_i . rhat_ij  |  |r_ij| = r ],   rhat_ij = (p_i - p_j)/r

over all ordered pairs in a distance bin. For the force error of a model
whose error decomposes pairwise, P(r) estimates the pair-force bias; the
estimate is shape-faithful but attenuated (the JAX module's docstring
says why), so read it as the sign, shape and place of the bias and a
lower bound on its size.

The frames are torch tensors (or arrays) and the work runs on their
device, a frame at a time as the JAX module does, in float64; the results
come back as numpy arrays, as JAX's do.
"""

import numpy as np
import torch

__all__ = ["pair_projection_profile"]


def pair_projection_profile(pos, vec, box, edges, r_min=0.0):
    """Accumulate mean pair-direction projections binned by pair distance.

    Args:
        pos: [M, N, 3] (or [N, 3]) frame positions (A; any wrapping).
        vec: [M, N, 3] (or [N, 3]) per-atom vectors to project.
        box: cubic box edge (A), minimum-image convention.
        edges: [B+1] increasing distance bin edges.
        r_min: pairs closer than this are skipped (beside edges[0]).

    Returns:
        (profile, count): numpy [B] mean projection per bin (0 where
        empty) and [B] int64 ordered-pair counts.
    """
    pos = torch.as_tensor(pos).to(torch.float64)
    vec = torch.as_tensor(vec).to(device=pos.device, dtype=torch.float64)
    if pos.ndim == 2:
        pos, vec = pos[None], vec[None]
    edges = np.asarray(edges, np.float64)
    bins = torch.as_tensor(edges, device=pos.device)
    n_bins = len(edges) - 1
    lo = max(float(edges[0]), r_min)
    hi = float(edges[-1])
    sums = torch.zeros(n_bins, dtype=torch.float64, device=pos.device)
    cnt = torch.zeros(n_bins, dtype=torch.int64, device=pos.device)
    for f in range(pos.shape[0]):
        p = torch.remainder(pos[f], box)
        dr = p[None, :, :] - p[:, None, :]          # dr[i, j] = p_j - p_i
        dr = dr - box * torch.round(dr / box)
        r = torch.linalg.vector_norm(dr, dim=-1)
        r.fill_diagonal_(torch.inf)
        ii, jj = torch.nonzero((r >= lo) & (r < hi), as_tuple=True)
        r_pair = r[ii, jj]
        rhat = -dr[ii, jj] / r_pair[:, None]         # unit vector j -> i
        proj = torch.sum(vec[f][ii] * rhat, dim=-1)
        # np.digitize(x, edges) - 1, clipped to the bins.
        b = torch.clamp(torch.bucketize(r_pair, bins, right=True) - 1, 0,
                        n_bins - 1)
        sums += torch.bincount(b, weights=proj, minlength=n_bins)
        cnt += torch.bincount(b, minlength=n_bins)
    profile = sums / torch.clamp(cnt, min=1)
    return profile.cpu().numpy(), cnt.cpu().numpy()
