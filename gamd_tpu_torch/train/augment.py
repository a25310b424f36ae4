"""Data augmentation inside the train step (port of
gamd_tpu/train/augment.py: random_flip_rotation, rotate_sample with a
scalar box, jitter_positions).

  * with probability 0.3 a frame's positions AND forces are rotated by a
    composition Rz @ Ry @ Rx of axis rotations by k*pi, k in {-2,-1,0,1};
  * the rotation acts about the frame centroid after wrapping;
  * independent Gaussian position jitter is added after the neighbour
    search.

The draw (draw_flip_ks) is apart from the matrix (rotation_from_ks), so a
test can hand both packages the same k. Rotations are computed as
elementwise products and sums in float32, never as a matmul that TF32
could round: on the TPU the bf16 default of a matmul rounded the rotated
coordinates to 20x the jitter (gamd_tpu/train/augment.py:49-53).
Random numbers come from a torch.Generator, so they are not JAX's.
"""

import math

import torch


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
    """Rotate frames about their wrapped centroid: pos and forces [..., N, 3]
    by r [..., 3, 3] (row vectors times r), box a scalar wrap modulus.
    Returns (pos', forces')."""
    if rotate_box or box_vec is not None:
        raise NotImplementedError(
            "per-sample boxes (rotate_box) come with the port's water / DFT "
            "slice")
    p = torch.remainder(pos, box)
    offset = torch.mean(p, dim=-2, keepdim=True)
    rot = lambda x: torch.sum(x[..., :, :, None] * r[..., None, :, :],
                              dim=-2)
    return rot(p - offset) + offset, rot(forces)


def jitter_positions(generator, pos, sigma: float = 0.005):
    """Gaussian position noise of standard deviation sigma (always drawn,
    so a zero sigma keeps the stream of draws the same)."""
    return pos + sigma * torch.randn(pos.shape, generator=generator,
                                     device=pos.device, dtype=pos.dtype)


def rigid_jitter_positions(*args, **kwargs):
    raise NotImplementedError("rigid_jitter_positions (rigid per-molecule "
                              "jitter) comes with the port's water slice")
