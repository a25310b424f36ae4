"""The port's rigid-water constraints on the CPU (md/constraints.py, the
integrators' constraint argument, Simulation(constraint=...)), against
the JAX package on the same numpy inputs: SETTLE, SHAKE and RATTLE on
perturbed molecules, RigidWater's projections on wrapped coordinates and
project_initial; each of the four integrators with RigidWater and the
analytic rigid TIP3P force over 20 steps with no random stream (NVE, NHC,
BAOAB at 0 K, Andersen at collision rate 0); Simulation NVE for 50 steps
from the same positions and velocities. 27 molecules in a 9.4 A box, the
TIP3P cutoff 4.5 A (under half the box)."""

import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.core import units as junits
from gamd_tpu.md import constraints as jc
from gamd_tpu.md import integrators as jinteg
from gamd_tpu.md.simulate import Simulation as JSimulation
from gamd_tpu.physics import water as jw

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.core import units
from gamd_tpu_torch.md import constraints as tc
from gamd_tpu_torch.md import integrators as tinteg
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.physics import water as tw

N_MOL, BOX, CUTOFF = 27, 9.4, 4.5
N = 3 * N_MOL
PROJ_ATOL = 5e-6       # SETTLE / SHAKE / RATTLE, port against JAX (A, A/t0)
TRAJ_ATOL = 1e-4       # positions after 20 or 50 steps (A)
MASSES = np.tile(np.asarray(jw.WATER_MASSES, np.float32), N_MOL)
SYSTEM = dict(n_atoms=N, box=BOX, cutoff=CUTOFF, nbr_capacity=64, skin=0.3)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def start():
    """(pos [N, 3] on the constraints, unwrapped; vel [N, 3] at about
    300 K): JAX's project_initial of a jittered water box."""
    base = jw.water_box(N_MOL, BOX, seed=2)
    rng = np.random.RandomState(2)
    pos = base + rng.normal(0.0, 0.08, base.shape).astype(np.float32)
    pos = np.asarray(jc.RigidWater(N_MOL, BOX).project_initial(
        jnp.asarray(pos)), np.float32)
    sigma = np.sqrt(junits.KB * 300.0 / MASSES)[:, None]
    vel = (sigma * rng.randn(N, 3)).astype(np.float32)
    return pos, vel


def _molecules(pos):
    """Whole molecules [M, 3, 3] of positions [N, 3]."""
    p = pos.reshape(-1, 3, 3)
    return np.concatenate(
        [p[:, :1], p[:, :1] + np.asarray(jax.jit(
            lambda d: jnp.remainder(d + 0.5 * BOX, BOX) - 0.5 * BOX)(
            p[:, 1:] - p[:, :1]))], axis=1).astype(np.float32)


def test_solve3_matches_numpy_and_jax():
    """The batched Cramer solve against numpy's solve (1e-4) and JAX's
    _solve3 mapped over the batch (1e-6)."""
    rng = np.random.RandomState(0)
    a = (rng.randn(50, 3, 3) + 3 * np.eye(3)).astype(np.float32)
    b = rng.randn(50, 3).astype(np.float32)
    got = tc._solve3(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(a, b[..., None])[..., 0],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jax.vmap(jc._solve3)(jnp.asarray(a),
                                            jnp.asarray(b))), atol=1e-6)


def test_settle_shake_rattle_match_jax(start):
    """On whole molecules moved by a drift of up to 0.03 A: SETTLE, its
    correction and SHAKE (60 sweeps) against JAX's within 5e-6 A, each on
    the constraints; RATTLE's velocities within 5e-6 A/t0, with no
    velocity left along any constraint."""
    pos, vel = start
    old = _molecules(pos)
    rng = np.random.RandomState(3)
    new = (old + rng.uniform(-0.03, 0.03, old.shape)).astype(np.float32)
    p = tc.tip3p_rigid_params()
    jp = jc.tip3p_rigid_params()
    assert tuple(p) == tuple(jp)
    got = tc.settle(_t(old), _t(new), p).numpy()
    want = np.asarray(jc.settle(jnp.asarray(old), jnp.asarray(new), jp))
    np.testing.assert_allclose(got, want, atol=PROJ_ATOL)
    np.testing.assert_allclose(
        tc.settle_correction(_t(old), _t(new), p).numpy(),
        np.asarray(jc.settle_correction(jnp.asarray(old), jnp.asarray(new),
                                        jp)), atol=PROJ_ATOL)
    shaken = tc.shake(_t(old), _t(new), p).numpy()
    np.testing.assert_allclose(
        shaken, np.asarray(jc.shake(jnp.asarray(old), jnp.asarray(new), jp)),
        atol=PROJ_ATOL)
    np.testing.assert_allclose(got, shaken, atol=2e-5)
    for mol in (got, shaken):
        d = lambda i, j: np.linalg.norm(mol[:, i] - mol[:, j], axis=-1)
        assert np.abs(d(0, 1) - p.d_oh).max() < 1e-5
        assert np.abs(d(0, 2) - p.d_oh).max() < 1e-5
        assert np.abs(d(1, 2) - p.d_hh).max() < 1e-5

    v = vel.reshape(-1, 3, 3)
    got_v = tc.rattle_velocities(_t(got), _t(v), p).numpy()
    want_v = np.asarray(jc.rattle_velocities(jnp.asarray(got),
                                             jnp.asarray(v), jp))
    np.testing.assert_allclose(got_v, want_v, atol=PROJ_ATOL)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        e = got[:, i] - got[:, j]
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
        assert np.abs(np.sum(e * (got_v[:, i] - got_v[:, j]), -1)).max() \
            < 1e-5


def test_rigid_water_projections_match_jax(start):
    """RigidWater.positions (SETTLE and SHAKE) and velocities on wrapped
    coordinates with molecules split across the box, against JAX's;
    project_initial of a jittered box within 5e-6 A of JAX's with the
    residual under 1e-5 A; n_constraints 3 a molecule."""
    pos, vel = start
    x_ref = np.mod(pos, BOX).astype(np.float32)
    rng = np.random.RandomState(4)
    x_new = (x_ref + 0.02 * vel + rng.normal(0, 0.005, pos.shape)).astype(
        np.float32)
    for method in ("settle", "shake"):
        got = tc.RigidWater(N_MOL, BOX, method=method).positions(
            _t(x_ref), _t(x_new)).numpy()
        want = np.asarray(jc.RigidWater(N_MOL, BOX, method=method).positions(
            jnp.asarray(x_ref), jnp.asarray(x_new)))
        np.testing.assert_allclose(got, want, atol=PROJ_ATOL)
    cst, jcst = tc.RigidWater(N_MOL, BOX), jc.RigidWater(N_MOL, BOX)
    assert cst.n_constraints == jcst.n_constraints == 3 * N_MOL
    np.testing.assert_allclose(
        cst.velocities(_t(x_ref), _t(vel)).numpy(),
        np.asarray(jcst.velocities(jnp.asarray(x_ref), jnp.asarray(vel))),
        atol=PROJ_ATOL)
    jittered = np.mod(jw.water_box(N_MOL, BOX, seed=5)
                      + rng.normal(0, 0.05, pos.shape), BOX).astype(
        np.float32)
    snapped = cst.project_initial(_t(jittered))
    np.testing.assert_allclose(
        snapped.numpy(), np.asarray(jcst.project_initial(
            jnp.asarray(jittered))), atol=PROJ_ATOL)
    assert float(cst.residual(_t(jittered))) > 1e-3
    assert float(cst.residual(snapped)) < 1e-5
    np.testing.assert_allclose(float(cst.residual(snapped)),
                               float(jcst.residual(jnp.asarray(snapped))),
                               atol=1e-6)


def _integrators(name, force_t, force_j, cst_t, cst_j):
    """(port (init, step), JAX (init, step), per-step arguments) of one
    integrator with no random stream: 2 fs, 300 K."""
    dt = 2.0 * units.FS
    m_t, m_j = _t(MASSES), jnp.asarray(MASSES)
    if name == "nve":
        return (tinteg.velocity_verlet(force_t, dt, m_t, constraint=cst_t),
                jinteg.velocity_verlet(force_j, dt, m_j, constraint=cst_j),
                None)
    if name == "nose_hoover":
        freq = 1.0 / units.PS
        return (tinteg.nose_hoover_chain(force_t, dt, m_t, 300.0, freq,
                                         constraint=cst_t),
                jinteg.nose_hoover_chain(force_j, dt, m_j, 300.0, freq,
                                         constraint=cst_j), None)
    if name == "langevin":    # 0 K: the noise has no amplitude
        zeros = np.zeros((N, 3), np.float32)
        return (tinteg.baoab_langevin(force_t, dt, m_t, 0.0, 0.1,
                                      constraint=cst_t),
                jinteg.baoab_langevin(force_j, dt, m_j, 0.0, 0.1,
                                      constraint=cst_j), (zeros, zeros))
    ones = np.ones((N, 3), np.float32)     # rate 0: no collision draws
    return (tinteg.andersen(force_t, dt, m_t, 300.0, 0.0, constraint=cst_t),
            jinteg.andersen(force_j, dt, m_j, 300.0, 0.0, constraint=cst_j),
            ((ones, ones), (ones, ones)))


@pytest.mark.parametrize("name", ["nve", "nose_hoover", "langevin",
                                  "andersen"])
def test_integrators_with_rigid_water_match_jax(start, name):
    """20 steps of each integrator with RigidWater and the analytic rigid
    TIP3P force from the same state: positions within 1e-4 A of JAX's,
    the residual under 1e-5 A."""
    pos, vel = start
    params_t, params_j = tw.TIP3PParams(cutoff=CUTOFF), \
        jw.TIP3PParams(cutoff=CUTOFF)
    force_t = lambda x: tw.tip3p_forces_rigid(x, BOX, params_t)
    force_j = lambda x: jw.tip3p_forces_rigid(x, BOX, params_j)
    cst_t, cst_j = tc.RigidWater(N_MOL, BOX), jc.RigidWater(N_MOL, BOX)
    (init_t, step_t), (init_j, step_j), noise = _integrators(
        name, force_t, force_j, cst_t, cst_j)
    stochastic = noise is not None
    if stochastic:
        st_t = init_t(_t(pos), _t(vel), torch.Generator())
        st_j = init_j(jnp.asarray(pos), jnp.asarray(vel),
                      jax.random.PRNGKey(0))
        n_t = _t(noise[0]) if name == "langevin" else \
            tuple(map(_t, noise[0]))
        n_j = jnp.asarray(noise[1]) if name == "langevin" else \
            tuple(map(jnp.asarray, noise[1]))
        jstep = jax.jit(lambda s: step_j(s, n_j))
        tstep = lambda s: step_t(s, n_t)
    else:
        st_t = init_t(_t(pos), _t(vel))
        st_j = init_j(jnp.asarray(pos), jnp.asarray(vel))
        jstep, tstep = jax.jit(step_j), step_t
    for _ in range(20):
        st_t, st_j = tstep(st_t), jstep(st_j)
    np.testing.assert_allclose(st_t.pos.numpy(), np.asarray(st_j.pos),
                               atol=TRAJ_ATOL)
    np.testing.assert_allclose(st_t.vel.numpy(), np.asarray(st_j.vel),
                               atol=10 * TRAJ_ATOL)
    assert float(cst_t.residual(st_t.pos)) < 1e-5
    assert float(np.abs(st_t.pos.numpy() - pos).max()) > 1e-2


def _nve_run(pos, vel, steps, port=True):
    """Simulation(constraint=RigidWater) NVE on the rigid TIP3P force,
    chunks of 10 steps: the port's (port=True) or JAX's, and the
    Simulation."""
    kw = dict(integrator="nve", n_steps=steps, rebuild_every=10)
    if port:
        sim = Simulation(
            tw.tip3p_force_fn(BOX, tw.TIP3PParams(cutoff=CUTOFF), rigid=True),
            tcfg.get_preset("tip3p", **SYSTEM), tcfg.MDConfig(**kw),
            constraint=tc.RigidWater(N_MOL, BOX), device="cpu")
        return sim.run(sim.init_state(pos, vel=vel), steps), sim
    jsim = JSimulation(
        jw.tip3p_force_fn(BOX, jw.TIP3PParams(cutoff=CUTOFF), rigid=True),
        jcfg.get_preset("tip3p", **SYSTEM), jcfg.MDConfig(**kw),
        constraint=jc.RigidWater(N_MOL, BOX))
    return jsim.run(jsim.init_state(jnp.asarray(pos), vel=jnp.asarray(vel)),
                    steps), jsim


def test_simulation_with_constraint_matches_jax(start):
    """Simulation(constraint=RigidWater) NVE for 50 steps on the rigid
    TIP3P force from the same positions and velocities as JAX's
    Simulation: the degrees of freedom 3N - 3M, the residual under 5e-6
    A, the wrapped positions of steps 10, 20 and 30 within 1e-4 A of
    JAX's and the temperatures within rtol 1e-3.

    From step 30 on the two trajectories part as fast as the dynamics
    parts any two: the port's own run from the start moved by 1e-6 A is
    2.1e-4 A from it at step 50 (the port against JAX: 2.3e-4 A). So at
    step 50 the port is held to JAX within twice that separation,
    measured in the same test."""
    pos, vel = start
    res, sim = _nve_run(pos, vel, 50)
    jres, jsim = _nve_run(pos, vel, 50, port=False)
    assert sim.ndf == jsim.ndf == 3 * N - 3 * N_MOL
    assert float(sim.constraint.residual(res.state.pos)) < 5e-6
    assert res.positions.shape == (5, N, 3)
    gap = np.asarray(res.positions) - np.asarray(jres.positions)
    gap = np.abs(gap - BOX * np.round(gap / BOX))     # across the box edge
    assert float(gap[:3].max()) < TRAJ_ATOL
    np.testing.assert_allclose(res.thermo.temperature.numpy(),
                               np.asarray(jres.thermo.temperature),
                               rtol=1e-3)
    moved, _ = _nve_run(pos + np.float32(1e-6), vel, 50)
    spread = float(np.abs(moved.state.pos.numpy()
                          - res.state.pos.numpy()).max())
    assert 0.0 < spread < 1e-3
    assert float(np.abs(res.state.pos.numpy()
                        - np.asarray(jres.state.pos)).max()) < 2 * spread


def test_run_recorded_with_constraint_matches_jax():
    """Simulation.run_recorded under constrained NHC (8 molecules in an 8 A
    box, the rigid TIP3P force at 4 A), 3 frames every 10 steps from the
    same positions and velocities as JAX's: the frames' wrapped positions
    within 1e-4 A, their velocities within 1e-3 A/t0, the recorded forces
    within 1e-4 of their largest magnitude, the temperatures within rtol
    1e-3, and the end on the constraints."""
    m_mol, box = 8, 8.0
    jp, tp = jw.TIP3PParams(cutoff=4.0), tw.TIP3PParams(cutoff=4.0)
    pos = np.asarray(jc.RigidWater(m_mol, box).project_initial(jnp.asarray(
        jw.water_box(m_mol, box, jp, seed=2))), np.float32)
    masses = np.tile(np.asarray(jw.WATER_MASSES, np.float32), m_mol)
    vel = (np.sqrt(junits.KB * 300.0 / masses)[:, None]
           * np.random.RandomState(5).randn(3 * m_mol, 3)).astype(np.float32)
    md = dict(integrator="nose_hoover", temperature=300.0,
              friction_per_ps=1.0, rebuild_every=5)
    system = dict(n_atoms=3 * m_mol, box=box, cutoff=4.0)
    cst = tc.RigidWater(m_mol, box)
    sim = Simulation(tw.tip3p_force_fn(box, tp, rigid=True),
                     tcfg.get_preset("tip3p", **system), tcfg.MDConfig(**md),
                     constraint=cst, device="cpu")
    jsim = JSimulation(jw.tip3p_force_fn(box, jp, rigid=True),
                       jcfg.get_preset("tip3p", **system),
                       jcfg.MDConfig(**md),
                       constraint=jc.RigidWater(m_mol, box))
    assert sim.ndf == jsim.ndf == 3 * 3 * m_mol - 3 * m_mol
    state, ovf, *frames = sim.run_recorded(
        sim.init_state(pos, vel=vel), 3, 10,
        lambda p: tw.tip3p_forces_rigid(p, box, tp))
    _, jovf, *jframes = jsim.run_recorded(
        jsim.init_state(jnp.asarray(pos), vel=jnp.asarray(vel)), 3, 10,
        jax.jit(lambda p: jw.tip3p_forces_rigid(p, box, jp)))
    assert not ovf and not bool(jovf)
    got, want = [f.numpy() for f in frames], [np.asarray(f) for f in jframes]
    gap = got[0] - want[0]
    assert np.abs(gap - box * np.round(gap / box)).max() < TRAJ_ATOL
    np.testing.assert_allclose(got[1], want[1], atol=10 * TRAJ_ATOL)
    np.testing.assert_allclose(got[2], want[2],
                               atol=TRAJ_ATOL * np.abs(want[2]).max())
    np.testing.assert_allclose(got[3], want[3], rtol=1e-3)
    assert float(cst.residual(state.pos)) < 1e-5
