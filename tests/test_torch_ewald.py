"""The port's Ewald electrostatics (gamd_tpu_torch/physics/ewald.py) and the
TIP3P and TIP4P-Ew potentials built on it (physics/water.py) on the CPU,
against the JAX package on the same numpy inputs, at the deployment's
full size: TIP3P-774 and TIP4P-753 (water_box starts, box 20 A, the
Ewald defaults: cutoff 10 A, tolerance 1e-5, about 1,500 k-vectors).

Bars: energies within ENERGY_RTOL of JAX's, compared in float64 in both
packages; forces within FORCE_RTOL of the largest |F|, compared in
float32, the dtype the runs use (the sums run in another order); the Ewald
tables bit for bit. The energies are compared in float64 because an Ewald
total is a sum of terms of some 1e5 kJ/mol (the self and exclusion terms)
that cancel to some 1e3: float32 rounding alone moves it by more than 1e-5
of itself (JAX's own float32 TIP3P-774 total lies 0.03 kJ/mol from its
float64 one, the port's 0.006). JAX's own absolute checks (the NaCl Madelung
constant, the independence of the splitting parameter, the image sum of a
neutral molecule, zero net force) are repeated on the port in float64.
"""

import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import space as jspace
from gamd_tpu.physics import ewald as jewald
from gamd_tpu.physics import water as jw

from gamd_tpu_torch.core import space as tspace
from gamd_tpu_torch.physics import ewald as tewald
from gamd_tpu_torch.physics import water as tw

ENERGY_RTOL = 1e-5      # |E_port - E_jax| / |E_jax|
FORCE_RTOL = 1e-4       # max |F_port - F_jax| / max |F_jax|
BOX = 20.0
N_TIP3P, N_TIP4P = 258, 251     # molecules: 774 and 753 atoms


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for this file's tests, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _start(n_mol, tip4p=False, seed=0, sigma=0.05):
    """water_box's start (TIP4P-Ew's geometry for tip4p), jittered by
    sigma A of seeded normal noise so no pair sits on the grid."""
    params = (jw.TIP3PParams(r_oh=jw.TIP4PEwParams().r_oh,
                             theta0=jw.TIP4PEwParams().theta0)
              if tip4p else jw.TIP3PParams())
    pos = jw.water_box(n_mol, BOX, params, seed=seed)
    noise = np.random.RandomState(seed + 100).randn(*pos.shape)
    return (pos + sigma * noise).astype(np.float32)


def _close_energy(got, want):
    assert abs(float(got) - float(want)) <= ENERGY_RTOL * abs(float(want)), \
        (float(got), float(want))


def _energies_f64(jfn, tfn, arrays, *rest):
    """(port, JAX) energies of the numpy `arrays` cast to float64, each
    package running in float64, with the arguments `rest` after them."""
    got = tfn(*(torch.as_tensor(np.asarray(a, np.float64)) for a in arrays),
              *rest)
    with jax.enable_x64(True):
        want = float(jfn(*(jnp.asarray(np.asarray(a, np.float64))
                           for a in arrays), *rest))
    return got, want


def _close_forces(got, want):
    want = np.asarray(want)
    assert np.isfinite(got).all()
    err = np.abs(np.asarray(got) - want).max()
    assert err <= FORCE_RTOL * np.abs(want).max(), (err, np.abs(want).max())


# -- the tables ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(box=20.0), dict(box=9.4, cutoff=4.5),
                                dict(box=2.0, cutoff=0.99, tolerance=1e-6,
                                     recip_tol=1e-9, coulomb_k=1.0)])
def test_make_ewald_params_bit_for_bit(kw):
    got, want = tewald.make_ewald_params(**kw), jewald.make_ewald_params(**kw)
    assert got.alpha == want.alpha and got.cutoff == want.cutoff
    assert got.coulomb_k == want.coulomb_k
    for a, b in ((got.kvecs, want.kvecs), (got.kfac, want.kfac)):
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert np.all(np.diff(got.kfac) <= 0)


# -- the Ewald terms at TIP3P-774 ------------------------------------------------

@pytest.fixture(scope="module")
def tip3p():
    """(pos [774, 3], charges, same_mol, EwaldParams of both packages)."""
    pos = _start(N_TIP3P, seed=1)
    n = pos.shape[0]
    mol = np.arange(n) // 3
    return dict(pos=pos, q=np.asarray(jw.atom_charges(N_TIP3P,
                                                      jw.TIP3PParams())),
                same=mol[:, None] == mol[None, :],
                jew=jewald.make_ewald_params(BOX),
                tew=tewald.make_ewald_params(BOX))


def test_recip_energy_and_force_match_jax(tip3p):
    """recip_energy and make_recip_force_fn (the long-range channel) at
    TIP3P-774, and a stack of two frames in one call."""
    pos, q = tip3p["pos"], tip3p["q"]
    got, want = _energies_f64(
        lambda p, c: jewald.recip_energy(p, c, tip3p["jew"]),
        lambda p, c: tewald.recip_energy(p, c, tip3p["tew"]), (pos, q))
    _close_energy(got, want)
    want = jax.jit(jewald.make_recip_force_fn(BOX, q))(jnp.asarray(pos))
    fn = tewald.make_recip_force_fn(BOX, q)
    got = fn(_t(pos))
    _close_forces(got.numpy(), want)
    two = fn(torch.stack([_t(pos), _t(pos + 0.1)]))
    assert two.shape == (2, 774, 3)
    np.testing.assert_allclose(two[0].numpy(), got.numpy(), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(want)).max())


def test_ewald_energy_and_forces_match_jax(tip3p):
    """ewald_energy (real, reciprocal, self and exclusion terms) and its
    gradient at TIP3P-774 with the molecules' exclusions."""
    pos, q, same = tip3p["pos"], tip3p["q"], tip3p["same"]
    e_t, e_j = _energies_f64(
        lambda p, c: jewald.ewald_energy(p, c, BOX, jnp.asarray(same),
                                         tip3p["jew"]),
        lambda p, c: tewald.ewald_energy(p, c, BOX, _t(same), tip3p["tew"]),
        (pos, q))
    _close_energy(e_t, e_j)
    f_j = jax.jit(jax.grad(lambda p: -jewald.ewald_energy(
        p, jnp.asarray(q), BOX, jnp.asarray(same), tip3p["jew"])))(
        jnp.asarray(pos))
    args = (_t(q), BOX, _t(same), tip3p["tew"])
    _close_forces(tewald.neg_grad(tewald.ewald_energy, _t(pos),
                                  *args).numpy(), f_j)


def test_switched_lj_energy_matches_jax(tip3p):
    o = tip3p["pos"][0::3]
    cutoff, width = 10.0, 1.5

    def lj(mod, sp, eye):
        def energy(p):
            d2 = sp.pairwise_distance2(p, BOX) + eye(o.shape[0]) * 1e9
            return mod.switched_lj_energy(d2, d2 < cutoff ** 2, 3.15061,
                                          0.636, cutoff, width)
        return energy
    got, want = _energies_f64(
        lj(jewald, jspace, lambda n: jnp.eye(n)),
        lj(tewald, tspace, lambda n: torch.eye(n, dtype=torch.float64)), (o,))
    _close_energy(got, want)


# -- the water potentials under the reference protocol ---------------------------

@pytest.mark.parametrize("model,rigid", [("tip3p", True), ("tip3p", False),
                                         ("tip4p", True), ("tip4p", False)])
def test_water_ewald_energy_and_forces_match_jax(model, rigid):
    """TIP3P-774 and TIP4P-753 Ewald energies and forces (rigid: the
    nonbonded terms; flexible: with the bonds and angles), and the force
    closures (electrostatics="ewald") on one frame and on two."""
    tip4p = model == "tip4p"
    pos = _start(N_TIP4P if tip4p else N_TIP3P, tip4p=tip4p, seed=2)
    name = {("tip3p", True): "tip3p_energy_rigid_ewald",
            ("tip3p", False): "tip3p_energy_ewald",
            ("tip4p", True): "tip4pew_energy_rigid_ewald",
            ("tip4p", False): "tip4pew_energy_ewald"}[(model, rigid)]
    jfn, tfn = getattr(jw, name), getattr(tw, name)
    jew, tew = jewald.make_ewald_params(BOX), tewald.make_ewald_params(BOX)
    jpos = jnp.asarray(pos)
    _close_energy(*_energies_f64(lambda p: jfn(p, BOX, jew),
                                 lambda p: tfn(p, BOX, tew), (pos,)))
    f_j = jax.jit(lambda p: -jax.grad(jfn)(p, BOX, jew))(jpos)
    closure = (tw.tip4pew_force_fn if tip4p else tw.tip3p_force_fn)(
        BOX, rigid=rigid, electrostatics="ewald")
    got = closure(_t(pos), None, None)
    _close_forces(got.numpy(), f_j)
    assert closure.handles_refresh
    two = closure(torch.stack([_t(pos), _t(pos)]), None, None)
    np.testing.assert_allclose(two[1].numpy(), got.numpy(), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(f_j)).max())


@pytest.mark.parametrize("rigid", [True, False])
def test_tip4pew_dsf_energy_and_forces_match_jax(rigid):
    """The damped-shifted-force TIP4P-Ew energies and forces at a cutoff of
    9 A on TIP4P-753."""
    pos = _start(N_TIP4P, tip4p=True, seed=3)
    jpos = jnp.asarray(pos)
    if rigid:
        e_j, f_j = (jw.tip4pew_energy_rigid(jpos, BOX),
                    jax.jit(jw.tip4pew_forces_rigid, static_argnums=1)(
                        jpos, BOX))
        e_t, f_t = (tw.tip4pew_energy_rigid(_t(pos), BOX),
                    tw.tip4pew_forces_rigid(_t(pos), BOX))
    else:
        e_j, f_j = (jw.tip4pew_energy(jpos, BOX),
                    jax.jit(jw.tip4pew_forces, static_argnums=1)(jpos, BOX))
        e_t, f_t = tw.tip4pew_energy(_t(pos), BOX), tw.tip4pew_forces(_t(pos),
                                                                      BOX)
    _close_energy(e_t, e_j)
    _close_forces(f_t.numpy(), f_j)
    closure = tw.tip4pew_force_fn(BOX, rigid=rigid)
    np.testing.assert_array_equal(closure(_t(pos), None, None).numpy(),
                                  f_t.numpy())


# -- TIP4P-Ew's sites and long-range channel ---------------------------------------

def test_tip4p_sites_and_channel_match_jax():
    """tip4pew_m_sites (minimum image across the box), tip4p_charge_sites,
    expand_with_m_sites' O, H, H, M rows and make_tip4p_recip_force_fn,
    at TIP4P-753 with molecules straddling the boundary."""
    p_j, p_t = jw.TIP4PEwParams(), tw.TIP4PEwParams()
    pos = np.mod(_start(N_TIP4P, tip4p=True, seed=4) + 1.3, BOX).astype(
        np.float32)
    o, h1, h2 = pos[0::3], pos[1::3], pos[2::3]
    m_j = jw.tip4pew_m_sites(*(jnp.asarray(a) for a in (o, h1, h2)), BOX, p_j)
    m_t = tw.tip4pew_m_sites(*(_t(a) for a in (o, h1, h2)), BOX, p_t)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=0,
                               atol=1e-5)
    assert np.abs(h1 - o).max() > BOX / 2                 # straddling
    s_j, q_j = jw.tip4p_charge_sites(jnp.asarray(pos), BOX, p_j)
    s_t, q_t = tw.tip4p_charge_sites(_t(pos), BOX, p_t)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0,
                               atol=1e-5)
    assert q_t.numpy().tobytes() == np.asarray(q_j).tobytes()
    forces = np.random.RandomState(5).randn(*pos.shape).astype(np.float32)
    got = tw.expand_with_m_sites(pos, forces, BOX, p_t)
    want = jw.expand_with_m_sites(pos, forces, BOX, p_j)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == (4 * 251, 3)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[0][np.arange(4 * 251) % 4 < 3], pos)
    assert not got[1][3::4].any()
    f_j = jax.jit(jw.make_tip4p_recip_force_fn(BOX, pos.shape[0]))(
        jnp.asarray(pos))
    _close_forces(tw.make_tip4p_recip_force_fn(BOX, pos.shape[0])(
        _t(pos)).numpy(), f_j)


# -- JAX's absolute checks, on the port (float64) ----------------------------------

def _nacl(cells=1):
    box = 2.0 * cells
    coords, charges = [], []
    for i in range(2 * cells):
        for j in range(2 * cells):
            for k in range(2 * cells):
                coords.append((i, j, k))
                charges.append(1.0 if (i + j + k) % 2 == 0 else -1.0)
    return (torch.tensor(coords, dtype=torch.float64),
            torch.tensor(charges, dtype=torch.float64), box)


def test_madelung_constant():
    """E / N = -M_NaCl / 2 per ion (k_e = q = r_nn = 1), tests/test_ewald.py's
    bar."""
    pos, q, box = _nacl()
    ew = tewald.make_ewald_params(box, cutoff=0.99, tolerance=1e-6,
                                  recip_tol=1e-9, coulomb_k=1.0)
    e = float(tewald.ewald_energy(pos, q, box,
                                  torch.zeros((8, 8), dtype=torch.bool), ew))
    assert e / 8 == pytest.approx(-1.747564594633 / 2, rel=5e-5)


def test_alpha_invariance():
    """The total does not depend on the real/reciprocal split
    (tests/test_ewald.py's inputs and bars)."""
    rng = np.random.RandomState(0)
    box, n = 12.0, 30
    pos = torch.as_tensor(rng.uniform(0, box, (n, 3)))
    q = rng.uniform(-1, 1, n)
    q = torch.as_tensor(q - q.mean())
    mol = torch.arange(n) // 3
    same = mol[:, None] == mol[None, :]
    es = [float(tewald.ewald_energy(pos, q, box, same,
                                    tewald.make_ewald_params(
                                        box, cutoff=5.9, tolerance=tol,
                                        recip_tol=1e-10, coulomb_k=1.0)))
          for tol in (1e-4, 1e-5, 1e-6)]
    assert es[0] == pytest.approx(es[2], rel=2e-4)
    assert es[1] == pytest.approx(es[2], rel=2e-5)


def test_matches_direct_lattice_sum_neutral_cluster():
    """One neutral 3-site molecule against its periodic images: the
    cube-truncated image sum less the surface term (tinfoil), 5e-5."""
    box = 10.0
    p = np.array([[5.0, 5.0, 5.0], [5.8, 5.6, 5.0], [4.2, 5.6, 5.0]])
    qn = np.array([-0.8, 0.4, 0.4])
    ew = tewald.make_ewald_params(box, cutoff=4.9, tolerance=1e-6,
                                  recip_tol=1e-10, coulomb_k=1.0)
    e_ewald = float(tewald.ewald_energy(
        torch.as_tensor(p), torch.as_tensor(qn), box,
        torch.ones((3, 3), dtype=torch.bool), ew))
    shells = 14
    rng = np.arange(-shells, shells + 1)
    shifts = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"),
                      -1).reshape(-1, 3) * box
    shifts = shifts[np.abs(shifts).sum(-1) > 0]
    d = np.linalg.norm(p[None, :, None] - p[None, None] - shifts[:, None,
                                                               None], axis=-1)
    e_direct = 0.5 * np.sum(qn[:, None] * qn[None] / d)
    dipole = (qn[:, None] * p).sum(0)
    e_tinfoil = e_direct - 2 * np.pi * np.dot(dipole, dipole) / (3 * box ** 3)
    assert e_ewald == pytest.approx(e_tinfoil, abs=5e-5)


def test_forces_zero_net_and_translation_invariant():
    """tests/test_ewald.py's TIP3P charges on random sites: net force below
    1e-8, the energy unchanged by a translation (1e-10 relative)."""
    rng = np.random.RandomState(1)
    box, m = 15.0, 8
    pos = torch.as_tensor(rng.uniform(0, box, (3 * m, 3)))
    q = tw.atom_charges(m, tw.TIP3PParams(), dtype=torch.float64)
    mol = torch.arange(3 * m) // 3
    same = mol[:, None] == mol[None, :]
    ew = tewald.make_ewald_params(box, cutoff=7.0, tolerance=1e-5,
                                  recip_tol=1e-8)
    f = tewald.neg_grad(tewald.ewald_energy, pos, q, box, same, ew)
    assert float(f.sum(0).abs().max()) < 1e-8
    e0 = float(tewald.ewald_energy(pos, q, box, same, ew))
    e1 = float(tewald.ewald_energy(pos + 1.2345, q, box, same, ew))
    assert e0 == pytest.approx(e1, rel=1e-10)
