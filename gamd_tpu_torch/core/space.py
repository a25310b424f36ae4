"""Periodic-space math on torch tensors: minimum image and box wrapping.

Port of gamd_tpu/core/space.py (min_image, wrap, displacement, distance2,
distance, pairwise_displacement, pairwise_distance2, center_positions,
pairwise_displacement_two_system). The box is a float or a tensor
broadcastable against the displacement (a scalar or [3] for one frame);
frame_box shapes a box a frame ([B] or [B, 3]) so.
"""

import numpy as np
import torch


def min_image(dr, box):
    """Map displacement vectors to their minimum-image representative, each
    component in [-L/2, L/2) (remainder form, as the JAX package)."""
    return torch.remainder(dr + 0.5 * box, box) - 0.5 * box


def one_box(box):
    """Whether box is one box for every frame (a number or a 0-d tensor),
    not one a frame."""
    return box.ndim == 0 if torch.is_tensor(box) else np.ndim(box) == 0


def frame_box(box, x):
    """box shaped to broadcast against frames x [B, ..., 3]: one box for
    all (a number or 0-d tensor) as it is; one a frame, [B] as
    [B, 1, ..., 1] and [B, 3] as [B, 1, ..., 3], in x's dtype and device
    (gamd_tpu/models/gnn.py::_box_for_edges, gamd_tpu/train/loop.py::
    _broadcast_box)."""
    if one_box(box):
        return box
    b = torch.as_tensor(box, dtype=x.dtype, device=x.device)
    if b.ndim == 1:
        return b.reshape(-1, *[1] * (x.ndim - 1))
    if b.ndim == 2:
        return b.reshape(b.shape[0], *[1] * (x.ndim - 2), b.shape[1])
    raise ValueError(f"box must be scalar, [B], or [B,3]; got "
                     f"{tuple(b.shape)}")


def wrap(pos, box):
    """Wrap absolute positions into the primary cell [0, L)."""
    return torch.remainder(pos, box)


def displacement(p_i, p_j, box):
    """Minimum-image displacement from particle i to particle j,
    pos_j - pos_i."""
    return min_image(p_j - p_i, box)


def distance2(p_i, p_j, box):
    """Squared minimum-image distance."""
    d = displacement(p_i, p_j, box)
    return torch.sum(d * d, dim=-1)


def distance(p_i, p_j, box):
    """Minimum-image distance."""
    return torch.sqrt(distance2(p_i, p_j, box))


def pairwise_displacement(pos, box):
    """All-pairs minimum-image displacements [..., N, N, 3] of pos
    [..., N, 3]: dr[i, j] = min_image(pos[j] - pos[i]), row i from particle
    i to every other."""
    return min_image(pos[..., None, :, :] - pos[..., :, None, :], box)


def pairwise_distance2(pos, box):
    """All-pairs squared minimum-image distances [..., N, N] of pos
    [..., N, 3]; row i holds the displacements pos[j] - pos[i]."""
    dr = pairwise_displacement(pos, box)
    return torch.sum(dr * dr, dim=-1)


def center_positions(pos):
    """(pos less its centroid, the centroid [..., 3]) of pos [..., N, 3]."""
    offset = torch.mean(pos, dim=-2)
    return pos - offset[..., None, :], offset


def pairwise_displacement_two_system(pos1, pos2, box):
    """Minimum-image displacements [N2, N1, 3] between two sets:
    dr[i, j] = min_image(pos1[j] - pos2[i])."""
    return min_image(pos1[None, :, :] - pos2[:, None, :], box)
