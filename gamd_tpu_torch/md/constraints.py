"""Rigid-water holonomic constraints: analytic SETTLE and iterative SHAKE
(port of gamd_tpu/md/constraints.py: _solve3, RigidWaterParams,
tip3p_rigid_params, _unwrap_molecules, RigidWater, _canonical_triangle,
settle_correction, settle, _targets, shake, _rattle_velocities_impl,
rattle_velocities).

Atoms are ordered O, H1, H2 per molecule; the constraints are |O-H1| =
|O-H2| = d_oh and |H1-H2| = d_hh. SETTLE (Miyamoto & Kollman, J. Comput.
Chem. 13:952, 1992) projects positions in closed form, and RATTLE's
velocity condition is an exact 3x3 solve a molecule; both are batched over
the molecules [M, 3, 3] with no iteration and no data-dependent control
flow. SHAKE, a fixed number of Gauss-Seidel sweeps, is the test oracle of
SETTLE and snaps a start onto the constraints (project_initial).

Precision: every product here is written as elementwise products and sums
in float32 (cross products, dot products as sums over the last axis, the
3x3 solve by Cramer's rule), never as a matmul or einsum: on the TPU the
default low-precision matmul took rigid water from 300 K to 2,200 K in
4,000 steps, and TF32, the card's form of that hazard, reaches only
matmuls and convolutions. So no TF32 setting changes a bit of the results.
"""

from typing import NamedTuple

import numpy as np
import torch

from gamd_tpu_torch.core import space


def _solve3(a, b):
    """x with a x = b for a [..., 3, 3], b [..., 3], by Cramer's rule in
    elementwise operations (the JAX function's expression order)."""
    A = lambda i, j: a[..., i, j]
    B = lambda i: b[..., i]
    c00 = A(1, 1) * A(2, 2) - A(1, 2) * A(2, 1)
    c01 = A(1, 2) * A(2, 0) - A(1, 0) * A(2, 2)
    c02 = A(1, 0) * A(2, 1) - A(1, 1) * A(2, 0)
    det = A(0, 0) * c00 + A(0, 1) * c01 + A(0, 2) * c02
    x0 = (B(0) * c00
          + A(0, 1) * (A(1, 2) * B(2) - B(1) * A(2, 2))
          + A(0, 2) * (B(1) * A(2, 1) - A(1, 1) * B(2)))
    x1 = (A(0, 0) * (B(1) * A(2, 2) - A(1, 2) * B(2))
          + B(0) * c01
          + A(0, 2) * (A(1, 0) * B(2) - B(1) * A(2, 0)))
    x2 = (A(0, 0) * (A(1, 1) * B(2) - B(1) * A(2, 1))
          + A(0, 1) * (B(1) * A(2, 0) - A(1, 0) * B(2))
          + B(0) * c02)
    return torch.stack([x0, x1, x2], dim=-1) / det[..., None]


class RigidWaterParams(NamedTuple):
    d_oh: float          # O-H constraint length [A]
    d_hh: float          # H-H constraint length [A]
    m_o: float = 15.9994
    m_h: float = 1.008


def tip3p_rigid_params(r_oh: float = 0.9572,
                       theta0: float = 104.52 * np.pi / 180.0):
    """Constraint lengths of the rigid monomer (TIP3P and TIP4P-Ew)."""
    return RigidWaterParams(d_oh=r_oh, d_hh=2.0 * r_oh * np.sin(theta0 / 2))


def _unwrap_molecules(pos, box):
    """[M, 3, 3] molecules with the H sites made whole around their O
    (a start may arrive wrapped, with molecules split across the box)."""
    o = pos[:, 0:1, :]
    return torch.cat([o, o + space.min_image(pos[:, 1:, :] - o, box)],
                     dim=1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _norm(a):
    return torch.sqrt(_dot(a, a))


class RigidWater:
    """SETTLE/RATTLE projections of an N = 3M rigid-water system.

    The integrators (md.integrators) call
        positions(x_ref [N, 3], x_new [N, 3]) -> constrained x [N, 3]
        velocities(x [N, 3], v [N, 3]) -> constrained v [N, 3]
    and read n_constraints (3 a molecule of one system) for the degrees of
    freedom. Every projection also takes a leading replica axis, [R, N, 3]
    (the molecules of all replicas in one batch), as the JAX package
    vmaps its single-system projections over replicas.
    method="settle" (the default) projects positions in closed form;
    "shake" by 60 SHAKE sweeps.
    """

    def __init__(self, n_molecules: int, box: float,
                 params: RigidWaterParams = tip3p_rigid_params(),
                 method: str = "settle"):
        if method not in ("settle", "shake"):
            raise ValueError(f"unknown constraint method {method!r}")
        self.n_molecules = n_molecules
        self.box = box
        self.params = params
        self.method = method
        self.n_constraints = 3 * n_molecules

    def positions(self, x_ref, x_new):
        ref = _unwrap_molecules(x_ref.reshape(-1, 3, 3), self.box)
        new = ref + space.min_image(
            x_new.reshape(-1, 3, 3) - x_ref.reshape(-1, 3, 3), self.box)
        if self.method == "settle":
            out = settle(ref, new, self.params)
        else:
            out = shake(ref, new, self.params)
        # The caller's unwrapped frame is kept: only the correction is
        # applied to x_new.
        return (x_new.reshape(-1, 3, 3) + (out - new)).reshape(x_new.shape)

    def velocities(self, x, v):
        pos = _unwrap_molecules(x.reshape(-1, 3, 3), self.box)
        return rattle_velocities(pos, v.reshape(-1, 3, 3),
                                 self.params).reshape(v.shape)

    def project_initial(self, x):
        """Snap an almost rigid configuration onto the constraints (200
        SHAKE sweeps; once, after minimisation)."""
        pos = _unwrap_molecules(x.reshape(-1, 3, 3), self.box)
        out = shake(pos, pos, self.params, iters=200)
        return (x.reshape(-1, 3, 3) + (out - pos)).reshape(x.shape)

    def residual(self, x):
        """Largest constraint violation |d - d0| of the system (of all
        replicas) [A], a 0-d tensor on x's device."""
        pos = _unwrap_molecules(x.reshape(-1, 3, 3), self.box)
        p = self.params
        d_oh1 = _norm(pos[:, 1] - pos[:, 0])
        d_oh2 = _norm(pos[:, 2] - pos[:, 0])
        d_hh = _norm(pos[:, 2] - pos[:, 1])
        return torch.max(torch.stack([torch.abs(d_oh1 - p.d_oh),
                                      torch.abs(d_oh2 - p.d_oh),
                                      torch.abs(d_hh - p.d_hh)]))


# ---------------------------------------------------------------------------
# Analytic SETTLE
# ---------------------------------------------------------------------------

def _canonical_triangle(p: RigidWaterParams):
    """(ra, rb, rc) of the mass-centred canonical monomer: O at (0, ra, 0),
    the H's at (-+rc, -rb, 0); the centre of mass splits the triangle's
    height as ra : rb = 2 m_h : m_o."""
    rc = 0.5 * p.d_hh
    t = np.sqrt(p.d_oh ** 2 - rc ** 2)
    m_tot = p.m_o + 2.0 * p.m_h
    return t * 2.0 * p.m_h / m_tot, t * p.m_o / m_tot, rc


def settle_correction(old, new, params: RigidWaterParams):
    """The correction [M, 3, 3] that puts new + correction on the
    constraints, given constraint-satisfying `old` positions; both whole
    molecules.

    The constrained triangle is the canonical monomer rotated by Rz(theta)
    Rx(phi) Ry(psi) about the new centre of mass, in a frame whose z axis
    is the old plane's normal: phi and psi match the z components of the
    unconstrained positions, theta makes the corrections' torque about z
    zero. Every vector relative to the centre of mass is made from
    differences of atoms of one molecule, never from the absolute centre
    of mass: in float32 that keeps the rounding of box-sized coordinates
    (about 2e-6 A) out of sin(phi), which would amplify it some 15 times
    into a rotation that RATTLE cannot remove (the JAX package measured it
    as NVE heating).
    """
    p = params
    ra, rb, rc = _canonical_triangle(p)
    w_h = p.m_h / (p.m_o + 2.0 * p.m_h)

    d01, d02 = new[:, 0] - new[:, 1], new[:, 0] - new[:, 2]
    a1 = w_h * (d01 + d02)
    b1 = a1 - d01
    c1 = a1 - d02
    b0, c0 = old[:, 1] - old[:, 0], old[:, 2] - old[:, 0]

    # Orthonormal frame: z = the old plane's normal, a1 in the y-z plane.
    n0 = torch.linalg.cross(b0, c0)
    n0 = n0 / _norm(n0)[:, None]
    n1 = torch.linalg.cross(a1, n0)
    n1 = n1 / _norm(n1)[:, None]
    n2 = torch.linalg.cross(n0, n1)
    rot = torch.stack([n1, n2, n0], dim=1)      # lab -> primed, rows

    mv = lambda x: _dot(rot, x[:, None, :])     # rot @ x per molecule
    a1p, b1p, c1p = mv(a1), mv(b1), mv(c1)
    b0p, c0p = mv(b0), mv(c0)

    sinphi = torch.clamp(a1p[:, 2] / ra, -1.0, 1.0)
    cosphi = torch.sqrt(1.0 - sinphi ** 2)
    sinpsi = torch.clamp((b1p[:, 2] - c1p[:, 2]) / (2.0 * rc * cosphi),
                         -1.0, 1.0)
    cospsi = torch.sqrt(1.0 - sinpsi ** 2)

    # The canonical triangle after Rx(phi) Ry(psi).
    a2 = torch.stack([torch.zeros_like(cosphi), ra * cosphi, ra * sinphi],
                     dim=-1)
    b2 = torch.stack([-rc * cospsi,
                      -rb * cosphi - rc * sinpsi * sinphi,
                      -rb * sinphi + rc * sinpsi * cosphi], dim=-1)
    c2 = torch.stack([rc * cospsi,
                      -rb * cosphi + rc * sinpsi * sinphi,
                      -rb * sinphi - rc * sinpsi * cosphi], dim=-1)

    # No torque about z: P sin(theta) + Q cos(theta) = G.
    pp = (b0p[:, 0] * b2[:, 0] + b0p[:, 1] * b2[:, 1]
          + c0p[:, 0] * c2[:, 0] + c0p[:, 1] * c2[:, 1])
    qq = (b0p[:, 0] * b2[:, 1] - b0p[:, 1] * b2[:, 0]
          + c0p[:, 0] * c2[:, 1] - c0p[:, 1] * c2[:, 0])
    gg = (b0p[:, 0] * b1p[:, 1] - b0p[:, 1] * b1p[:, 0]
          + c0p[:, 0] * c1p[:, 1] - c0p[:, 1] * c1p[:, 0])
    pq2 = pp * pp + qq * qq
    disc = torch.sqrt(torch.clamp(pq2 - gg * gg, min=0.0))
    sinth = (pp * gg - qq * disc) / pq2
    costh = torch.sqrt(torch.clamp(1.0 - sinth ** 2, min=0.0))

    def rz(r):
        return torch.stack([r[:, 0] * costh - r[:, 1] * sinth,
                            r[:, 0] * sinth + r[:, 1] * costh,
                            r[:, 2]], dim=-1)

    out = torch.stack([rz(a2), rz(b2), rz(c2)], dim=1)     # [M, 3, 3]
    # out @ rot (rot^T applied to each row), less the unconstrained
    # positions relative to the centre of mass: all in ~1 A arithmetic.
    back = torch.sum(out[:, :, :, None] * rot[:, None, :, :], dim=2)
    return back - torch.stack([a1, b1, c1], dim=1)


def settle(old, new, params: RigidWaterParams):
    """`new` [M, 3, 3] projected onto the constraints, given constraint-
    satisfying `old` positions (see settle_correction)."""
    return new + settle_correction(old, new, params)


# ---------------------------------------------------------------------------
# SHAKE / RATTLE
# ---------------------------------------------------------------------------

_PAIRS = ((0, 1), (0, 2), (1, 2))


def _targets(p: RigidWaterParams):
    return (p.d_oh, p.d_oh, p.d_hh)


def _inv_masses(p: RigidWaterParams, device):
    return torch.tensor([1.0 / p.m_o, 1.0 / p.m_h, 1.0 / p.m_h],
                        dtype=torch.float32, device=device)


def shake(old, new, params: RigidWaterParams, iters: int = 60):
    """Fixed-iteration SHAKE on [M, 3, 3] molecules: Gauss-Seidel over the
    three pair constraints, each sweep in the order O-H1, O-H2, H1-H2,
    with the constraint directions taken from `old`."""
    p = params
    # float32 constants, as the JAX package's arrays (exact as floats).
    inv_m = np.array([1.0 / p.m_o, 1.0 / p.m_h, 1.0 / p.m_h], np.float32)
    d2 = [float(d) for d in np.array(_targets(p), np.float32) ** 2]
    pair_w = [float(inv_m[i] + inv_m[j]) for i, j in _PAIRS]
    inv_m = [float(m) for m in inv_m]
    rows = [new[:, a] for a in range(3)]
    r_old = [old[:, i] - old[:, j] for i, j in _PAIRS]
    for _ in range(iters):
        for k, (i, j) in enumerate(_PAIRS):
            r = rows[i] - rows[j]
            diff = _dot(r, r) - d2[k]
            g = diff / (2.0 * _dot(r, r_old[k]) * pair_w[k])
            rows[i] = rows[i] + (-g * inv_m[i])[:, None] * r_old[k]
            rows[j] = rows[j] + (g * inv_m[j])[:, None] * r_old[k]
    return torch.stack(rows, dim=1)


#: S[k, a]: +1 for the first atom of constraint k, -1 for the second.
_S = ((1.0, -1.0, 0.0), (1.0, 0.0, -1.0), (0.0, 1.0, -1.0))


def _rattle_velocities_impl(pos, vel, inv_m):
    """Velocities [M, 3, 3] with e_k . (v_i - v_j) = 0 for every
    constraint k: one 3x3 solve for the Lagrange multipliers a molecule."""
    s = torch.tensor(_S, dtype=torch.float32, device=pos.device)
    e = torch.stack([pos[:, i] - pos[:, j] for i, j in _PAIRS], dim=1)
    e = e / _norm(e)[..., None]                                # [M, 3, 3]
    g = torch.stack([_dot(e[:, k], vel[:, i] - vel[:, j])
                     for k, (i, j) in enumerate(_PAIRS)], dim=-1)
    # M_kl = (sum_a S_ka S_la / m_a) e_k . e_l
    c = torch.sum(s[:, None, :] * s[None, :, :] * inv_m, dim=-1)
    mat = c * torch.sum(e[:, :, None, :] * e[:, None, :, :], dim=-1)
    tau = _solve3(mat, -g)                                     # [M, 3]
    dv = torch.sum(tau[:, :, None, None] * s[None, :, :, None]
                   * e[:, :, None, :], dim=1) * inv_m[:, None]
    return vel + dv


def rattle_velocities(pos, vel, params: RigidWaterParams):
    """The exact velocity projection of whole molecules pos [M, 3, 3]:
    e_k . (v_i - v_j) = 0 for all three constraints."""
    return _rattle_velocities_impl(pos, vel,
                                   _inv_masses(params, pos.device))
