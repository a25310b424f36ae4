"""Ewald summation of long-range electrostatics on torch tensors (port of
gamd_tpu/physics/ewald.py: EwaldParams, make_ewald_params, recip_energy,
make_recip_force_fn, ewald_energy, switched_lj_energy).

The classical (plain) Ewald sum of a neutral set of point charges in a
cubic box of side L:

  E = E_real + E_recip + E_self + E_excl

  E_real  = k_e/2 sum_{i!=j, r_ij < rc}  q_i q_j erfc(alpha r_ij) / r_ij
            (minimum image; intra-molecular pairs excluded)
  E_recip = k_e * 2 pi / V  sum_{k != 0}  exp(-|k|^2 / 4 alpha^2)/|k|^2 |S(k)|^2,
            S(k) = sum_i q_i exp(i k . r_i)
  E_self  = -k_e * alpha/sqrt(pi) sum_i q_i^2
  E_excl  = -k_e sum_{(i,j) excluded}  q_i q_j erf(alpha r_ij) / r_ij

alpha follows OpenMM's rule alpha = sqrt(-log(2 tol)) / cutoff; the k-space
cutoff keeps every neglected term below `recip_tol` of the Gaussian
factor. make_ewald_params runs in float64 numpy and gives the JAX
package's alpha, k-vectors and factors bit for bit, in its order (largest
factor first).

Every energy takes positions [..., N, 3] and returns one energy a frame
[...] (0-d for one frame), so a stack of frames or replicas is one call.
Forces are -grad E by torch.autograd, as the JAX package takes jax.grad;
they reach the real atoms through derived sites (TIP4P-Ew's M site) the
same way.

Precision: JAX pins its highest matmul precision for the reciprocal force
(its TPU default is bf16). Here the phases k . r and the structure factors
are written as elementwise products and sums in float32, never as a
matmul, so TF32 (the card's low-precision matmul, switched on by a global
setting a caller may leave behind) cannot round them.

Units: angstrom, elementary charge; energies in kJ/mol through coulomb_k.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from gamd_tpu_torch.core import space, units


class EwaldParams(NamedTuple):
    """Static Ewald configuration (float64 numpy, as the JAX package's)."""
    alpha: float          # splitting parameter [1/A]
    cutoff: float         # real-space cutoff [A]
    kvecs: np.ndarray     # [K, 3] reciprocal vectors (half space) [1/A]
    kfac: np.ndarray      # [K] 2 * (2 pi / V) * exp(-k^2/4a^2)/k^2
    coulomb_k: float = 332.0637128 * units.KCAL_TO_KJ  # kJ mol^-1 A e^-2


def make_ewald_params(box: float, cutoff: float = 10.0,
                      tolerance: float = 1.0e-5,
                      recip_tol: float = 1.0e-7,
                      coulomb_k: float = 332.0637128 * units.KCAL_TO_KJ
                      ) -> EwaldParams:
    """Ewald parameters of a cubic box of side `box` [A]: alpha from the
    real-space `tolerance` (OpenMM's rule), and the half-space k-vectors
    with |n| <= nmax, nmax = ceil(k_cut L / 2 pi) for k_cut = 2 alpha
    sqrt(-ln recip_tol), sorted by descending factor."""
    alpha = math.sqrt(-math.log(2.0 * tolerance)) / cutoff
    k_cut = 2.0 * alpha * math.sqrt(-math.log(recip_tol))
    nmax = int(math.ceil(k_cut * box / (2.0 * math.pi)))

    # Half space (k and -k give the same |S(k)|^2): nx > 0, or nx == 0 and
    # ny > 0, or nx == ny == 0 and nz > 0.
    rng = np.arange(-nmax, nmax + 1)
    grid = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    nsq = np.sum(grid ** 2, axis=1)
    half = ((grid[:, 0] > 0)
            | ((grid[:, 0] == 0) & (grid[:, 1] > 0))
            | ((grid[:, 0] == 0) & (grid[:, 1] == 0) & (grid[:, 2] > 0)))
    keep = half & (nsq > 0) & (nsq <= nmax * nmax)
    kvecs = (2.0 * math.pi / box) * grid[keep].astype(np.float64)
    k2 = np.sum(kvecs ** 2, axis=1)
    vol = box ** 3
    # The factor 2 folds the -k partner into the half-space sum.
    kfac = 2.0 * (2.0 * math.pi / vol) * np.exp(-k2 / (4.0 * alpha ** 2)) / k2
    order = np.argsort(-kfac)         # largest terms first (f32 summation)
    return EwaldParams(alpha=alpha, cutoff=cutoff, kvecs=kvecs[order],
                       kfac=kfac[order], coulomb_k=coulomb_k)


#: (id of the numpy array, dtype, device) -> (the array, its tensor). The
#: array is kept and compared by identity, so a reused id cannot match; a
#: tensor is copied to a device once, not on every force call (a copy from
#: the host would make the host wait for the card).
_TABLES = {}


def _table(array, dtype, device):
    key = (id(array), dtype, torch.device(device))
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not array:
        hit = (array, torch.tensor(array, dtype=dtype, device=device))
        _TABLES[key] = hit
    return hit[1]


def recip_energy(sites, q, ew: EwaldParams):
    """Reciprocal-space (k-space) Ewald energy [...] of charge sites
    [..., N, 3] with charges q [N] [kJ/mol]: the smooth, box-global part of
    the lattice sum, the long-range channel GNNForceField adds to a model
    trained on the short-range residual (ModelConfig.longrange)."""
    kvecs = _table(ew.kvecs, sites.dtype, sites.device)        # [K, 3]
    kfac = _table(ew.kfac, sites.dtype, sites.device)          # [K]
    x = sites[..., None, :, :]                                 # [..., 1, N, 3]
    # k . r per (k, site) as three products and two sums: no matmul.
    phase = (kvecs[:, None, 0] * x[..., 0] + kvecs[:, None, 1] * x[..., 1]
             + kvecs[:, None, 2] * x[..., 2])                  # [..., K, N]
    s_re = torch.sum(torch.cos(phase) * q, dim=-1)             # [..., K]
    s_im = torch.sum(torch.sin(phase) * q, dim=-1)
    return ew.coulomb_k * torch.sum(kfac * (s_re ** 2 + s_im ** 2), dim=-1)


def neg_grad(energy, pos, *args):
    """-d(sum of energy(pos, *args)) / d pos by autograd, also under
    torch.no_grad (pos itself is not differentiated through)."""
    with torch.enable_grad():
        x = pos.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(energy(x, *args)), x)
    return -g


def make_recip_force_fn(box: float, q, cutoff: float = 10.0,
                        tolerance: float = 1.0e-5,
                        recip_tol: float = 1.0e-7):
    """Closure pos [..., N, 3] (A) -> reciprocal-space force [..., N, 3]
    (kJ/mol/A) of charges q [N] (float32 on pos's device at each call)."""
    ew = make_ewald_params(box, cutoff, tolerance, recip_tol)
    q = np.asarray(q, np.float32)

    def force(pos):
        return neg_grad(recip_energy, pos, _table(q, pos.dtype, pos.device),
                        ew)
    return force


def ewald_energy(sites, q, box, same_mol, ew: EwaldParams):
    """Total Coulomb energy [...] of charge sites [..., N, 3] with charges
    q [N] in a periodic cubic box [kJ/mol]; same_mol [N, N] bool marks the
    intra-molecular (excluded) pairs (its diagonal is ignored). Sites may
    be derived (virtual) sites: the gradient runs through them."""
    n = sites.shape[-2]
    dtype, dev = sites.dtype, sites.device
    ke = ew.coulomb_k
    alpha = ew.alpha
    qq = q[:, None] * q[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=dev)

    d2 = space.pairwise_distance2(sites, box) \
        + torch.eye(n, dtype=dtype, device=dev) * 1e9
    inter = (~same_mol) & (~eye)
    ok = inter & (d2 < ew.cutoff ** 2)
    # Both sides of the double where are finite, so the unused side's
    # gradient is a finite number times zero, never NaN.
    r = torch.sqrt(torch.where(ok, d2, ew.cutoff ** 2))
    e_real = 0.5 * ke * torch.sum(
        torch.where(ok, qq * torch.special.erfc(alpha * r) / r, 0.0),
        dim=(-2, -1))

    e_recip = recip_energy(sites, q, ew)

    e_self = -ke * alpha / math.sqrt(math.pi) * torch.sum(q * q)

    # The reciprocal sum counted the intra-molecular pairs: take off their
    # whole erf/r interaction (minimum image; these distances are far
    # below half the box).
    excl = same_mol & (~eye)
    r_x = torch.sqrt(torch.where(excl, d2, 1.0))
    e_excl = -0.5 * ke * torch.sum(
        torch.where(excl, qq * torch.special.erf(alpha * r_x) / r_x, 0.0),
        dim=(-2, -1))

    return e_real + e_recip + e_self + e_excl


def switched_lj_energy(d2, ok, sigma, eps, cutoff, switch_width):
    """OpenMM-style switched Lennard-Jones energy [...] of the pairs `ok` of
    the squared distances d2 [..., M, M]: 4 eps [(s/r)^12 - (s/r)^6] S(r),
    S = 1 below rc - w and 1 - 10x^3 + 15x^4 - 6x^5 on the window,
    x = (r - (rc - w)) / w."""
    r2 = torch.where(ok, d2, cutoff ** 2)
    r = torch.sqrt(r2)
    inv6 = (sigma ** 2 / r2) ** 3
    e_pair = 4.0 * eps * (inv6 ** 2 - inv6)
    r_on = cutoff - switch_width
    x = torch.clamp((r - r_on) / switch_width, 0.0, 1.0)
    s = 1.0 + x ** 3 * (-10.0 + x * (15.0 - 6.0 * x))
    return 0.5 * torch.sum(torch.where(ok, e_pair * s, 0.0), dim=(-2, -1))
