"""Classical TIP3P and TIP4P-Ew water (port of gamd_tpu/physics/water.py:
TIP3PParams, WATER_MASSES, atom_charges, the TIP3P energies and forces
with the damped-shifted-force and the Ewald electrostatics,
tip3p_force_fn, water_box, and the TIP4P-Ew family: TIP4PEwParams,
tip4pew_m_sites, tip4p_charge_sites, tip4pew_energy[_rigid][_ewald],
tip4pew_forces[_rigid], tip4pew_force_fn, make_tip4p_recip_force_fn,
expand_with_m_sites).

Two variants, atoms ordered O, H, H per molecule:
* RIGID (*_energy_rigid*): nonbonded terms only, LJ on O-O pairs and
  Coulomb between sites of different molecules. The monomer geometry is
  held by md.constraints (SETTLE, RATTLE).
* FLEXIBLE: adds harmonic O-H bonds and the H-O-H angle; a plain
  differentiable potential (FIRE starts minimise it).

The Coulomb term is the damped-shifted-force cutoff (alpha = 0; continuous
in energy and force at the cutoff), or under the reference protocol
(*_ewald) the full Ewald sum of physics.ewald with LJ switched over the
last 1.5 A (openmmtools' WaterBox defaults: PME, cutoff 10 A, error
tolerance 1e-5). TIP4P-Ew puts the oxygen's charge on a virtual M site on
the H-O-H bisector, placed under the minimum image; its force reaches the
real atoms through autograd.

Every energy takes positions [..., N, 3] and returns one energy a frame
[...], so a stack of frames or replicas is one call. Energies kJ/mol,
forces kJ/mol/A, lengths angstrom. Forces are -grad E by torch.autograd,
where the JAX package takes jax.grad: the same function, summed in
another order.
"""

from typing import NamedTuple

import numpy as np
import torch

from gamd_tpu_torch.core import space, units
from gamd_tpu_torch.physics import ewald as _ewald
from gamd_tpu_torch.physics.ewald import neg_grad


class TIP3PParams(NamedTuple):
    r_oh: float = 0.9572
    k_bond: float = 450.0 * units.KCAL_TO_KJ          # kJ/mol/A^2
    theta0: float = 104.52 * np.pi / 180.0
    k_angle: float = 55.0 * units.KCAL_TO_KJ          # kJ/mol/rad^2
    sigma_o: float = 3.15061
    eps_o: float = 0.1521 * units.KCAL_TO_KJ
    q_o: float = -0.834
    q_h: float = 0.417
    cutoff: float = 9.0
    coulomb_k: float = 332.0637128 * units.KCAL_TO_KJ  # kJ mol^-1 A e^-2


WATER_MASSES = (15.9994, 1.008, 1.008)


def _site_charges(n_molecules, q_first, q_h, device, dtype):
    """[3 M] charges q_first, q_h, q_h per molecule, made on the device
    (no copy from the host, which would make the host wait)."""
    q = torch.full((3 * n_molecules,), q_h, dtype=dtype, device=device)
    q[0::3] = q_first
    return q


def atom_charges(n_molecules, p: TIP3PParams, device=None,
                 dtype=torch.float32):
    """Charges [3 M]: q_o, q_h, q_h per molecule."""
    return _site_charges(n_molecules, p.q_o, p.q_h, device, dtype)


def _atoms(pos):
    """O, H1, H2 rows [..., M, 3] of positions [..., 3 M, 3]."""
    if pos.shape[-2] % 3:
        raise ValueError(f"water takes 3 atoms a molecule, not "
                         f"N={pos.shape[-2]}")
    return pos[..., 0::3, :], pos[..., 1::3, :], pos[..., 2::3, :]


def _same_molecule(n, device):
    mol = torch.arange(n, device=device) // 3
    return mol[:, None] == mol[None, :]


def _eye(n, pos):
    return torch.eye(n, dtype=pos.dtype, device=pos.device)


def _intra_energy(pos, box, params):
    """Harmonic bond and angle energy [...] (the flexible variants' terms;
    TIP3P and TIP4P-Ew share the monomer)."""
    p = params
    o, h1, h2 = _atoms(pos)
    v1 = space.min_image(h1 - o, box)
    v2 = space.min_image(h2 - o, box)
    d1 = torch.sqrt(torch.sum(v1 ** 2, -1) + 1e-12)
    d2 = torch.sqrt(torch.sum(v2 ** 2, -1) + 1e-12)
    e_bond = torch.sum(p.k_bond * ((d1 - p.r_oh) ** 2 + (d2 - p.r_oh) ** 2),
                       dim=-1)
    cos_t = torch.sum(v1 * v2, -1) / torch.clamp(
        torch.linalg.vector_norm(v1, dim=-1)
        * torch.linalg.vector_norm(v2, dim=-1), min=1e-8)
    theta = torch.arccos(torch.clamp(cos_t, -1 + 1e-7, 1 - 1e-7))
    e_angle = torch.sum(p.k_angle * (theta - p.theta0) ** 2, dim=-1)
    return e_bond + e_angle


def tip3p_energy(pos, box, params: TIP3PParams = TIP3PParams()):
    """FLEXIBLE potential energy of an N = 3M atom box [kJ/mol]."""
    return _intra_energy(pos, box, params) \
        + tip3p_energy_rigid(pos, box, params)


def tip3p_energy_rigid(pos, box, params: TIP3PParams = TIP3PParams()):
    """Nonbonded TIP3P energy [kJ/mol] with the damped-shifted-force
    Coulomb, the potential of rigid water: all pairs within the cutoff,
    same-molecule pairs excluded."""
    _atoms(pos)
    n = pos.shape[-2]
    p = params
    dev = pos.device
    same_mol = _same_molecule(n, dev)
    d2_all = space.pairwise_distance2(pos, box) + _eye(n, pos) * 1e9
    pair_ok = (~same_mol) & (d2_all < p.cutoff ** 2)
    r2 = torch.where(pair_ok, d2_all, p.cutoff ** 2)   # no NaN in the grad
    r = torch.sqrt(r2)

    is_o = torch.remainder(torch.arange(n, device=dev), 3) == 0
    oo = is_o[:, None] & is_o[None, :]
    inv6 = (p.sigma_o ** 2 / r2) ** 3
    s6 = (p.sigma_o / p.cutoff) ** 6
    e_lj_pair = 4 * p.eps_o * (inv6 ** 2 - inv6) - 4 * p.eps_o * (s6 ** 2 - s6)
    e_lj = 0.5 * torch.sum(torch.where(pair_ok & oo, e_lj_pair, 0.0),
                           dim=(-2, -1))

    q = atom_charges(n // 3, p, dev, pos.dtype)
    qq = q[:, None] * q[None, :]
    rc = p.cutoff
    e_c_pair = p.coulomb_k * qq * (1.0 / r - 1.0 / rc + (r - rc) / rc ** 2)
    e_coul = 0.5 * torch.sum(torch.where(pair_ok, e_c_pair, 0.0),
                             dim=(-2, -1))
    return e_lj + e_coul


def _switched_oo_lj(pos, box, ew, sigma_o, eps_o, switch_width):
    """Switched LJ energy of the O-O pairs within ew.cutoff."""
    o, _, _ = _atoms(pos)
    m = o.shape[-2]
    d2_oo = space.pairwise_distance2(o, box) + _eye(m, pos) * 1e9
    ok_oo = d2_oo < ew.cutoff ** 2
    return _ewald.switched_lj_energy(d2_oo, ok_oo, sigma_o, eps_o,
                                     ew.cutoff, switch_width)


def tip3p_energy_rigid_ewald(pos, box, ew: _ewald.EwaldParams,
                             params: TIP3PParams = TIP3PParams(),
                             switch_width: float = 1.5):
    """Nonbonded rigid-TIP3P energy under the reference protocol: the full
    Ewald sum (ew) and LJ switched over [cutoff - w, cutoff]."""
    p = params
    n = pos.shape[-2]
    e_lj = _switched_oo_lj(pos, box, ew, p.sigma_o, p.eps_o, switch_width)
    q = atom_charges(n // 3, p, pos.device, pos.dtype)
    return e_lj + _ewald.ewald_energy(pos, q, box,
                                      _same_molecule(n, pos.device), ew)


def tip3p_energy_ewald(pos, box, ew, params: TIP3PParams = TIP3PParams()):
    """FLEXIBLE TIP3P under the reference protocol (harmonic intra terms
    and the Ewald nonbonded energy): the generator's FIRE potential."""
    return _intra_energy(pos, box, params) \
        + tip3p_energy_rigid_ewald(pos, box, ew, params)


def tip3p_forces(pos, box, params: TIP3PParams = TIP3PParams()):
    """Forces [..., N, 3] of the flexible potential, -grad E by autograd."""
    return neg_grad(tip3p_energy, pos, box, params)


def tip3p_forces_rigid(pos, box, params: TIP3PParams = TIP3PParams()):
    """Forces [..., N, 3] of the rigid (nonbonded) potential."""
    return neg_grad(tip3p_energy_rigid, pos, box, params)


def _dense_closure(energy, dsf_forces, box, params, electrostatics):
    """(pos, idx, mask) -> [..., N, 3]: -grad of the Ewald energy, or the
    DSF forces. The list is ignored (at N <= 774 the dense pair matrix is
    the whole work), so the closure carries handles_refresh: Simulation
    skips the mask refresh it does not read and hands it a stack of
    replicas [R, N, 3] in one call."""
    if electrostatics == "ewald":
        ew = _ewald.make_ewald_params(box)

        def force(pos, idx, mask):
            del idx, mask
            return neg_grad(energy, pos, box, ew, params)
    elif electrostatics == "dsf":
        def force(pos, idx, mask):
            del idx, mask
            return dsf_forces(pos, box, params)
    else:
        raise ValueError(f"unknown electrostatics {electrostatics!r}")
    force.handles_refresh = True
    return force


def tip3p_force_fn(box, params: TIP3PParams = TIP3PParams(),
                   rigid: bool = False, electrostatics: str = "dsf"):
    """Dense force closure (pos, idx, mask) -> [..., N, 3] for
    md.simulate.Simulation; electrostatics="ewald" selects the
    reference-protocol potential (make_ewald_params(box): cutoff 10 A)."""
    return _dense_closure(
        tip3p_energy_rigid_ewald if rigid else tip3p_energy_ewald,
        tip3p_forces_rigid if rigid else tip3p_forces, box, params,
        electrostatics)


def water_box(n_molecules: int = 258, box: float = 20.0,
              params: TIP3PParams = TIP3PParams(), seed: int = 0):
    """Start configuration [3 M, 3] float32 numpy: molecules on a cubic
    grid with random orientations from np.random.RandomState(seed), wrapped
    into the box (the JAX package's numpy code, so the two give the same
    bits)."""
    rng = np.random.RandomState(seed)
    per_dim = 1
    while per_dim ** 3 < n_molecules:
        per_dim += 1
    spacing = box / per_dim
    sites = np.array([(i, j, k) for i in range(per_dim)
                      for j in range(per_dim) for k in range(per_dim)],
                     np.float32)
    sel = np.round(np.linspace(0, len(sites) - 1, n_molecules)).astype(int)
    centers = (sites[sel] + 0.5) * spacing

    t0 = params.theta0
    local = np.array([
        [0.0, 0.0, 0.0],
        [params.r_oh * np.sin(t0 / 2), params.r_oh * np.cos(t0 / 2), 0.0],
        [-params.r_oh * np.sin(t0 / 2), params.r_oh * np.cos(t0 / 2), 0.0],
    ], np.float32)

    frames = []
    for c in centers:
        a, b, g = rng.uniform(0, 2 * np.pi, 3)
        ca, sa, cb, sb, cg, sg = (np.cos(a), np.sin(a), np.cos(b),
                                  np.sin(b), np.cos(g), np.sin(g))
        rz = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
        ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
        rz2 = np.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]])
        rot = (rz @ ry @ rz2).astype(np.float32)
        frames.append(local @ rot.T + c)
    pos = np.concatenate(frames, axis=0)
    return np.mod(pos, box).astype(np.float32)


# ---------------------------------------------------------------------------
# TIP4P-Ew (4 sites: O, H, H and the virtual M carrying the O charge)
# ---------------------------------------------------------------------------

class TIP4PEwParams(NamedTuple):
    r_oh: float = 0.9572
    k_bond: float = 450.0 * units.KCAL_TO_KJ
    theta0: float = 104.52 * np.pi / 180.0
    k_angle: float = 55.0 * units.KCAL_TO_KJ
    sigma_o: float = 3.16435
    eps_o: float = 0.16275 * units.KCAL_TO_KJ
    q_m: float = -1.04844
    q_h: float = 0.52422
    r_om: float = 0.125           # M along the HOH bisector
    cutoff: float = 9.0
    coulomb_k: float = 332.0637128 * units.KCAL_TO_KJ


def tip4pew_m_sites(o, h1, h2, box, p):
    """Virtual sites O + r_om * unit(bisector), the bisector made of the
    minimum-image O-H vectors; differentiable, so autograd carries the
    M-site forces onto O and H (OpenMM's virtual-site projection)."""
    b = space.min_image(h1 - o, box) + space.min_image(h2 - o, box)
    b_norm = torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return o + p.r_om * b / torch.clamp(b_norm, min=1e-8)


def tip4p_charge_sites(pos, box, p: TIP4PEwParams):
    """(sites [..., N, 3] ordered M, H, H per molecule, charges [N]) of
    real atoms [..., N, 3] ordered O, H, H: the one layout of the energy,
    Ewald and long-range paths."""
    o, h1, h2 = _atoms(pos)
    m = o.shape[-2]
    msite = tip4pew_m_sites(o, h1, h2, box, p)
    sites = torch.stack([msite, h1, h2], dim=-2).reshape(
        *pos.shape[:-2], 3 * m, 3)
    return sites, _site_charges(m, p.q_m, p.q_h, pos.device, pos.dtype)


def tip4pew_energy(pos, box, params: TIP4PEwParams = TIP4PEwParams()):
    """FLEXIBLE TIP4P-Ew energy (harmonic intra terms and nonbonded)."""
    return _intra_energy(pos, box, params) \
        + tip4pew_energy_rigid(pos, box, params)


def tip4pew_energy_rigid(pos, box, params: TIP4PEwParams = TIP4PEwParams()):
    """Nonbonded TIP4P-Ew energy with the damped-shifted-force Coulomb: LJ
    on O-O pairs and Coulomb between the M, H sites of different
    molecules."""
    p = params
    o, _, _ = _atoms(pos)
    m = o.shape[-2]
    d2_oo = space.pairwise_distance2(o, box) + _eye(m, pos) * 1e9
    ok_oo = d2_oo < p.cutoff ** 2
    r2_oo = torch.where(ok_oo, d2_oo, p.cutoff ** 2)
    inv6 = (p.sigma_o ** 2 / r2_oo) ** 3
    s6 = (p.sigma_o / p.cutoff) ** 6
    e_lj_pair = 4 * p.eps_o * (inv6 ** 2 - inv6) - 4 * p.eps_o * (s6 ** 2 - s6)
    e_lj = 0.5 * torch.sum(torch.where(ok_oo, e_lj_pair, 0.0), dim=(-2, -1))

    sites, q = tip4p_charge_sites(pos, box, p)
    same = _same_molecule(3 * m, pos.device)
    d2_s = space.pairwise_distance2(sites, box) + _eye(3 * m, pos) * 1e9
    ok = (~same) & (d2_s < p.cutoff ** 2)
    r = torch.sqrt(torch.where(ok, d2_s, p.cutoff ** 2))
    rc = p.cutoff
    qq = q[:, None] * q[None, :]
    e_c = p.coulomb_k * qq * (1.0 / r - 1.0 / rc + (r - rc) / rc ** 2)
    e_coul = 0.5 * torch.sum(torch.where(ok, e_c, 0.0), dim=(-2, -1))
    return e_lj + e_coul


def tip4pew_energy_rigid_ewald(pos, box, ew: _ewald.EwaldParams,
                               params: TIP4PEwParams = TIP4PEwParams(),
                               switch_width: float = 1.5):
    """Rigid TIP4P-Ew under the reference protocol: the full Ewald sum on
    the M, H charge sites and the switched O-O LJ."""
    p = params
    e_lj = _switched_oo_lj(pos, box, ew, p.sigma_o, p.eps_o, switch_width)
    sites, q = tip4p_charge_sites(pos, box, p)
    same_mol = _same_molecule(sites.shape[-2], pos.device)
    return e_lj + _ewald.ewald_energy(sites, q, box, same_mol, ew)


def tip4pew_energy_ewald(pos, box, ew,
                         params: TIP4PEwParams = TIP4PEwParams()):
    """FLEXIBLE TIP4P-Ew under the reference protocol (FIRE only)."""
    return _intra_energy(pos, box, params) \
        + tip4pew_energy_rigid_ewald(pos, box, ew, params)


def make_tip4p_recip_force_fn(box: float, n_atoms: int,
                              params: TIP4PEwParams = TIP4PEwParams(),
                              cutoff: float = 10.0,
                              tolerance: float = 1.0e-5,
                              recip_tol: float = 1.0e-7):
    """Closure pos [..., N, 3] (A) -> the k-space Ewald force on the real
    atoms [..., N, 3] (kJ/mol/A) of TIP4P-Ew, the M-site force carried
    onto O and H by autograd through tip4pew_m_sites: the long-range
    channel of the tip4p preset."""
    if n_atoms % 3:
        raise ValueError(f"water takes 3 atoms a molecule, not N={n_atoms}")
    ew = _ewald.make_ewald_params(box, cutoff, tolerance, recip_tol)

    def energy(pos):
        sites, q = tip4p_charge_sites(pos, box, params)
        return _ewald.recip_energy(sites, q, ew)

    def force(pos):
        return neg_grad(energy, pos)
    return force


def tip4pew_forces(pos, box, params: TIP4PEwParams = TIP4PEwParams()):
    return neg_grad(tip4pew_energy, pos, box, params)


def tip4pew_forces_rigid(pos, box, params: TIP4PEwParams = TIP4PEwParams()):
    return neg_grad(tip4pew_energy_rigid, pos, box, params)


def tip4pew_force_fn(box, params: TIP4PEwParams = TIP4PEwParams(),
                     rigid: bool = False, electrostatics: str = "dsf"):
    """TIP4P-Ew's dense force closure, as tip3p_force_fn."""
    return _dense_closure(
        tip4pew_energy_rigid_ewald if rigid else tip4pew_energy_ewald,
        tip4pew_forces_rigid if rigid else tip4pew_forces, box, params,
        electrostatics)


def expand_with_m_sites(pos, forces, box, params: TIP4PEwParams):
    """The 4-site frame layout (O, H, H, M per molecule; the loader drops
    the M rows) of numpy pos and forces [3 M, 3]: M rows carry the derived
    position and zero force. float32 numpy out."""
    m = pos.shape[0] // 3
    o, h1, h2 = pos[0::3], pos[1::3], pos[2::3]
    msite = tip4pew_m_sites(*(torch.as_tensor(a) for a in (o, h1, h2)), box,
                            params).numpy()
    pos4 = np.stack([o, h1, h2, msite], axis=1).reshape(4 * m, 3)
    f = forces.reshape(m, 3, 3)
    f4 = np.concatenate([f, np.zeros((m, 1, 3), f.dtype)], axis=1)
    return pos4.astype(np.float32), f4.reshape(4 * m, 3).astype(np.float32)
