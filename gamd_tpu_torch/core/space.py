"""Periodic-space math on torch tensors: minimum image and box wrapping.

Port of gamd_tpu/core/space.py (min_image, wrap). The box is a float or a
tensor broadcastable against the displacement.
"""

import torch


def min_image(dr, box):
    """Map displacement vectors to their minimum-image representative, each
    component in [-L/2, L/2) (remainder form, as the JAX package)."""
    return torch.remainder(dr + 0.5 * box, box) - 0.5 * box


def wrap(pos, box):
    """Wrap absolute positions into the primary cell [0, L)."""
    return torch.remainder(pos, box)


def pairwise_distance2(pos, box):
    """All-pairs squared minimum-image distances [..., N, N] of pos
    [..., N, 3]; row i holds the displacements pos[j] - pos[i]."""
    dr = min_image(pos[..., None, :, :] - pos[..., :, None, :], box)
    return torch.sum(dr * dr, dim=-1)
