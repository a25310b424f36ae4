"""Data augmentation inside the train step (port of
gamd_tpu/train/augment.py: random_flip_rotation, rotate_sample with a
fixed box or a per-frame box, jitter_positions, rigid_jitter_positions).

  * with probability 0.3 a frame's positions AND forces are rotated by a
    composition Rz @ Ry @ Rx of axis rotations by k*pi, k in {-2,-1,0,1};
  * the rotation acts about the frame centroid after wrapping;
  * independent Gaussian position jitter is added after the neighbour
    search, or for rigid water each molecule is moved rigidly (a random
    translation and a small rotation about its centroid), which keeps
    the O-H and H-H distances.

The draws (draw_flip_ks, draw_rigid_jitter) are apart from the transforms
(rotation_from_ks, rigid_transform), so a test can hand both packages the
same draws. Under a process group of data-parallel ranks, each holding its
share of a batch, the jitter is drawn at the global batch's shape and
each rank keeps its rows (parallel.mesh.global_rows), so the ranks draw
what one process draws. Rotations are computed as
elementwise products and sums in float32, never as a matmul that TF32
could round: on the TPU the bf16 default of a matmul rounded the rotated
coordinates to 20x the jitter (gamd_tpu/train/augment.py:49-53).
Random numbers come from a torch.Generator, so they are not JAX's.
"""

import math

import torch

from gamd_tpu_torch.parallel.mesh import global_rows


def draw_flip_ks(generator, batch: int, prob: float = 0.3, device="cpu"):
    """ks [B, 3] float32 in {-2, -1, 0, 1}, zeroed for frames whose apply
    draw (uniform < prob) fails."""
    apply = torch.rand((batch,), generator=generator, device=device) < prob
    ks = torch.randint(-2, 2, (batch, 3), generator=generator, device=device)
    return torch.where(apply[:, None], ks, 0).to(torch.float32)


def _matmul3(a, b):
    """[..., 3, 3] @ [..., 3, 3] as products and sums in float32."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def rotation_from_ks(ks):
    """Rz @ Ry @ Rx [..., 3, 3] for the angles ks * pi (ks [..., 3]; pi and
    the angles in float32, as the JAX package computes them)."""
    angles = ks.to(torch.float32) * torch.tensor(math.pi, dtype=torch.float32)
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[..., 0]), torch.zeros_like(c[..., 0])

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    cx, cy, cz = c.unbind(-1)
    sx, sy, sz = s.unbind(-1)
    rx = mat([(one, zero, zero), (zero, cx, -sx), (zero, sx, cx)])
    ry = mat([(cy, zero, sy), (zero, one, zero), (-sy, zero, cy)])
    rz = mat([(cz, -sz, zero), (sz, cz, zero), (zero, zero, one)])
    return _matmul3(_matmul3(rz, ry), rx)


def random_flip_rotation(generator, batch: int, prob: float = 0.3,
                         device="cpu"):
    """[B, 3, 3] rotations: identity, or (with prob) an axis-aligned k*pi
    composition."""
    return rotation_from_ks(draw_flip_ks(generator, batch, prob, device))


def rotate_sample(pos, forces, box, r, rotate_box: bool = False,
                  box_vec=None):
    """Rotate frames about their centroid: pos and forces [..., N, 3] by r
    [..., 3, 3] (row vectors times r), positions wrapped by the scalar box
    first (box None: the DFT set's per-frame boxes, not wrapped, as JAX).
    Returns (pos', forces', box_vec'): with rotate_box, a per-frame
    3-vector box_vec ([..., 3] beside pos [..., N, 3]) rotated and made
    positive, |box_vec r|, and a scalar one per frame ([...]) unchanged,
    since the k*pi flips only negate axes
    (gamd_tpu/train/augment.py:38-63); else box_vec as given."""
    p = pos if box is None else torch.remainder(pos, box)
    offset = torch.mean(p, dim=-2, keepdim=True)
    rot = lambda x: torch.sum(x[..., :, :, None] * r[..., None, :, :],
                              dim=-2)
    if rotate_box and box_vec is not None:
        b = torch.as_tensor(box_vec, dtype=pos.dtype, device=pos.device)
        if b.ndim == pos.ndim - 1:      # a 3-vector a frame
            box_vec = torch.abs(torch.sum(b[..., :, None] * r, dim=-2))
    return rot(p - offset) + offset, rot(forces), box_vec


def jitter_positions(generator, pos, sigma: float = 0.005, group=None):
    """Gaussian position noise of standard deviation sigma (always drawn,
    so a zero sigma keeps the stream of draws the same)."""
    return pos + sigma * global_rows(
        lambda s: torch.randn(s, generator=generator, device=pos.device,
                              dtype=pos.dtype), pos.shape, group)


def draw_rigid_jitter(generator, pos, sigma_t: float, group_size: int = 3,
                      sigma_rot: float = None, group=None):
    """(dt, omega), each [..., M, 1, 3] for pos [..., M * group_size, 3]:
    translations of standard deviation sigma_t (A) and rotation vectors of
    sigma_rot (rad; default sigma_t / 0.65, so that an H atom 0.65 A from
    its TIP3P centroid moves about sigma_t), drawn in that order."""
    if sigma_rot is None:
        sigma_rot = sigma_t / 0.65
    shape = (*pos.shape[:-2], pos.shape[-2] // group_size, 1, 3)

    def draw(s):
        randn = lambda: torch.randn(s, generator=generator,
                                    device=pos.device, dtype=pos.dtype)
        return randn(), randn()
    dt, omega = global_rows(draw, shape, group)
    return sigma_t * dt, sigma_rot * omega


def _group_box(box, pos):
    """A scalar, [3], [B] or [B, 3] box shaped against molecules
    [..., M, G, 3] of pos (gamd_tpu/train/loop.py::_broadcast_box's rule:
    for frames [B, N, 3] a 1-d box is one edge a frame; for one frame
    [N, 3] it is the three edges)."""
    if isinstance(box, (int, float)):
        return box
    b = torch.as_tensor(box, dtype=pos.dtype, device=pos.device)
    if b.ndim == 0 or pos.ndim == 2:
        return b
    if b.ndim == 1:
        return b[:, None, None, None]
    return b[:, None, None, :]


def rigid_transform(pos, dt, omega, box=None, group_size: int = 3):
    """pos [..., N, 3] with each molecule (group_size consecutive atoms)
    rotated by the vector omega (Rodrigues' formula, series near 0) about
    its centroid and translated by dt (both [..., M, 1, 3]).

    With box given (a scalar, [3], [B] or [B, 3]), a molecule is first
    made whole under the minimum image from its first atom: stored frames
    wrap each atom into the box, and a molecule straddling the boundary
    would otherwise be rotated about a centroid between its images (the
    JAX docstring records force_std blowing up 286 times that way)."""
    m = pos.shape[-2] // group_size
    p = pos.reshape(*pos.shape[:-2], m, group_size, 3)
    if box is not None:
        b = _group_box(box, pos)
        anchor = p[..., :1, :]
        dv = p - anchor
        p = anchor + (dv - b * torch.round(dv / b))
    c = torch.mean(p, dim=-2, keepdim=True)
    v = p - c
    t2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    t = torch.sqrt(torch.clamp(t2, min=1e-24))
    small = t2 < 1e-8
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2)
    wxv = torch.linalg.cross(omega, v)
    wxwxv = torch.linalg.cross(omega, wxv)
    return (c + (v + a * wxv + b * wxwxv) + dt).reshape(pos.shape)


def rigid_jitter_positions(generator, pos, sigma_t: float, box=None,
                           group_size: int = 3, sigma_rot: float = None,
                           group=None):
    """Rigid per-molecule jitter: draw_rigid_jitter's draws applied by
    rigid_transform. Augmented frames stay on the rigid-water constraint
    manifold that the validation frames and every rollout state live on,
    where per-atom jitter would move them off it."""
    dt, omega = draw_rigid_jitter(generator, pos, sigma_t, group_size,
                                  sigma_rot, group)
    return rigid_transform(pos, dt, omega, box, group_size)
