"""Port parity, no model: configs, periodic geometry, dense neighbour
lists, the k_model overflow rule and the BAOAB integrator, each against the
JAX package on the same numpy inputs (CPU)."""

import dataclasses
import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.core import space as jspace
from gamd_tpu.core import units as junits
from gamd_tpu.md import integrators as jinteg
from gamd_tpu.md.simulate import Simulation as JSimulation
from gamd_tpu.neighbors import dense as jdense
from gamd_tpu.physics import lennard_jones as jlj

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.core import space as tspace
from gamd_tpu_torch.core import units as tunits
from gamd_tpu_torch.md import integrators as tinteg
from gamd_tpu_torch.md.simulate import Simulation as TSimulation
from gamd_tpu_torch.neighbors import dense as tdense
from gamd_tpu_torch.physics import lennard_jones as tlj

BOX = 12.0


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_match_field_by_field(name):
    j, t = jcfg.PRESETS[name], tcfg.PRESETS[name]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    np.testing.assert_array_equal(j.atom_masses(), t.atom_masses())
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)


def test_model_md_configs_and_units_match():
    for jc, tc in [(jcfg.lj_model_config(), tcfg.lj_model_config()),
                   (jcfg.ModelConfig(), tcfg.ModelConfig()),
                   (jcfg.MDConfig(), tcfg.MDConfig()),
                   (jcfg.get_preset("lj", skin=0.5, nbr_capacity=64),
                    tcfg.get_preset("lj", skin=0.5, nbr_capacity=64))]:
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tcfg.lj_model_config().n_rbf == 40
    names = [n for n in dir(junits) if n.isupper()]
    assert names and all(getattr(junits, n) == getattr(tunits, n)
                         for n in names)


def test_min_image_and_wrap_match():
    rng = np.random.RandomState(0)
    dr = rng.uniform(-2 * BOX, 2 * BOX, (500, 3)).astype(np.float32)
    # pairs at exactly +-L/2: the remainder form maps both to -L/2, the
    # round form (half to even) to -L/2 and +L/2.
    dr[:2] = [[BOX / 2, -BOX / 2, 0.0], [-BOX / 2, BOX / 2, BOX]]
    np.testing.assert_allclose(tspace.min_image(_t(dr), BOX).numpy(),
                               np.asarray(jspace.min_image(dr, BOX)),
                               atol=1e-5)
    half = tspace.min_image(_t(dr[:2]), BOX).numpy()
    np.testing.assert_array_equal(half[:, :2], -BOX / 2)
    # The force kernels' round form (CUDA rintf, torch.round and jnp.round
    # all round half to even) keeps +L/2 where the remainder form wraps it.
    rnd = (_t(dr) - BOX * torch.round(_t(dr) / BOX)).numpy()
    ref_rnd = np.asarray(dr - BOX * jnp.round(dr / BOX))
    np.testing.assert_allclose(rnd, ref_rnd, atol=1e-5)
    np.testing.assert_array_equal(rnd[0, :2], [BOX / 2, -BOX / 2])
    pos = rng.uniform(-3 * BOX, 3 * BOX, (200, 3)).astype(np.float32)
    np.testing.assert_allclose(tspace.wrap(_t(pos), BOX).numpy(),
                               np.asarray(jspace.wrap(pos, BOX)), atol=1e-5)


def test_lj_fluid_box_matches():
    jb, jp = jlj.lj_fluid_box(258, 0.5)
    tb, tp = tlj.lj_fluid_box(258, 0.5)
    assert jb == tb and abs(tb - 27.27) < 0.01
    np.testing.assert_array_equal(jp, tp)
    assert tlj.ARGON_MASS == jlj.ARGON_MASS
    assert tlj.LJParams() == tuple(jlj.LJParams())


def _rows_as_sets(idx, mask):
    return [frozenset(r[m].tolist()) for r, m in zip(idx, mask)]


@pytest.mark.parametrize("k_max", [32, 8])
def test_dense_neighbor_list_matches(k_max):
    """Neighbour sets and masks row by row (topk may order ties
    differently), and the overflow flag (k_max=8 overflows, 32 does not)."""
    pos = np.random.RandomState(1).uniform(0, BOX, (64, 3)).astype(
        np.float32)
    ji, jm, jo = jdense.dense_neighbor_list(jnp.asarray(pos), BOX, 5.0,
                                            k_max)
    ti, tm, to = tdense.dense_neighbor_list(_t(pos), BOX, 5.0, k_max)
    assert ti.dtype == torch.int32 and ti.shape == (64, k_max)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert _rows_as_sets(ti.numpy(), tm.numpy()) == _rows_as_sets(
        np.asarray(ji), np.asarray(jm))
    pad = ~tm.numpy()
    rows = np.broadcast_to(np.arange(64)[:, None], pad.shape)
    np.testing.assert_array_equal(ti.numpy()[pad], rows[pad])
    assert bool(to) == bool(jo) == (k_max == 8)


def test_refresh_mask_matches():
    rng = np.random.RandomState(2)
    pos = rng.uniform(0, BOX, (64, 3)).astype(np.float32)
    ji, jm, _ = jdense.dense_neighbor_list(jnp.asarray(pos), BOX, 5.0, 16)
    pos2 = np.mod(pos + 0.35 * rng.randn(64, 3), BOX).astype(np.float32)
    ref = jdense.refresh_mask(jnp.asarray(pos2), BOX, 4.2, ji, jm)
    got = tdense.refresh_mask(_t(pos2), BOX, 4.2, _t(np.asarray(ji)),
                              _t(np.asarray(jm)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < int(np.asarray(jm).sum())


@pytest.mark.parametrize("k_model,overflow", [(8, True), (15, False)])
def test_k_model_slice_and_overflow_rule(k_model, overflow):
    """Nearest k_model slots kept; overflow when a dropped slot is live."""
    system = jcfg.get_preset("lj", n_atoms=64, box=BOX, cutoff=3.0,
                             nbr_capacity=16, skin=0.6)
    tsystem = tcfg.get_preset("lj", n_atoms=64, box=BOX, cutoff=3.0,
                              nbr_capacity=16, skin=0.6)
    md = jcfg.MDConfig(rebuild_every=5)
    pos = np.random.RandomState(3).uniform(0, BOX, (64, 3)).astype(
        np.float32)
    js = JSimulation(lambda p, i, m: jnp.zeros_like(p), system, md,
                     k_model=k_model)
    ts = TSimulation(lambda p, i, m: torch.zeros_like(p), tsystem,
                     tcfg.MDConfig(rebuild_every=5), k_model=k_model,
                     device="cpu")
    ji, jm, jo = js._build_nbrs(jnp.asarray(pos))
    ti, tm, to = ts._build_nbrs(_t(pos))
    assert ti.shape == (64, k_model) and ti.is_contiguous()
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert _rows_as_sets(ti.numpy(), tm.numpy()) == _rows_as_sets(
        np.asarray(ji), np.asarray(jm))
    assert bool(to) == bool(jo) == overflow


@pytest.mark.parametrize("k_model", [None, 16, 24])
def test_build_nbrs_without_slice_matches(k_model):
    """build_nbrs with no k_model, or one at or above the capacity, is the
    full cutoff + skin list of the JAX Simulation."""
    system = jcfg.get_preset("lj", n_atoms=64, box=BOX, cutoff=3.0,
                             nbr_capacity=16, skin=0.6)
    tsystem = tcfg.get_preset("lj", n_atoms=64, box=BOX, cutoff=3.0,
                              nbr_capacity=16, skin=0.6)
    pos = np.random.RandomState(7).uniform(0, BOX, (64, 3)).astype(
        np.float32)
    js = JSimulation(lambda p, i, m: jnp.zeros_like(p), system,
                     jcfg.MDConfig(rebuild_every=5), k_model=k_model)
    ji, jm, jo = js._build_nbrs(jnp.asarray(pos))
    ti, tm, to = tdense.build_nbrs(_t(pos), tsystem, k_model)
    assert ti.shape == (64, 16) and ti.dtype == torch.int32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert _rows_as_sets(ti.numpy(), tm.numpy()) == _rows_as_sets(
        np.asarray(ji), np.asarray(jm))
    assert bool(to) == bool(jo)


def test_baoab_step_matches_with_shared_noise():
    rng = np.random.RandomState(4)
    n = 32
    pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
    vel = (0.05 * rng.randn(n, 3)).astype(np.float32)
    noise = rng.randn(n, 3).astype(np.float32)
    masses = np.full((n,), 39.948, np.float32)
    dt, friction, temp = 2.0 * junits.FS, 25.0 / junits.PS, 100.0

    jinit, jstep = jinteg.baoab_langevin(lambda x: -0.5 * (x - 6.0), dt,
                                         jnp.asarray(masses), temp, friction)
    tinit, tstep = tinteg.baoab_langevin(lambda x: -0.5 * (x - 6.0), dt,
                                         _t(masses), temp, friction)
    js = jstep(jinit(jnp.asarray(pos), jnp.asarray(vel),
                     jax.random.PRNGKey(0)), jnp.asarray(noise))
    ts = tstep(tinit(_t(pos), _t(vel), torch.Generator()), _t(noise))
    for a, b in [(ts.pos, js.pos), (ts.vel, js.vel), (ts.force, js.force)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    ke_t = tinteg.kinetic_energy(ts.vel, _t(masses))
    ke_j = jinteg.kinetic_energy(js.vel, jnp.asarray(masses))
    np.testing.assert_allclose(float(ke_t), float(ke_j), rtol=1e-5)
    np.testing.assert_allclose(
        float(tinteg.temperature(ts.vel, _t(masses))),
        float(jinteg.temperature(js.vel, jnp.asarray(masses))), rtol=1e-5)


def test_maxwell_boltzmann_statistics():
    """Port draws: zero mean and the target temperature, per component
    variance kB T / m, within sampling error at N = 20000."""
    n, temp = 20000, 100.0
    masses = torch.full((n,), 39.948)
    gen = torch.Generator().manual_seed(0)
    vel = tinteg.maxwell_boltzmann_velocities(gen, masses, temp)
    assert vel.shape == (n, 3) and vel.dtype == torch.float32
    t = float(tinteg.temperature(vel, masses))
    assert abs(t - temp) < 0.03 * temp
    sigma = (tunits.KB * temp / 39.948) ** 0.5
    assert abs(float(vel.mean())) < 0.03 * sigma
    np.testing.assert_allclose(vel.std(dim=0).numpy(), sigma, rtol=0.03)


def test_baoab_constants_match():
    system = jcfg.get_preset("lj", skin=0.5, nbr_capacity=64)
    md = jcfg.MDConfig(temperature=100.0, dt_fs=2.0, friction_per_ps=25.0)
    js = JSimulation(lambda p, i, m: p, system, md)
    ts = TSimulation(lambda p, i, m: p, tcfg.get_preset(
        "lj", skin=0.5, nbr_capacity=64), tcfg.MDConfig(
        temperature=100.0, dt_fs=2.0, friction_per_ps=25.0), device="cpu")
    (jc1, jhdt, jc2), (tc1, thdt, tc2) = js._baoab_constants(), \
        ts._baoab_constants()
    np.testing.assert_allclose(tc1, float(jc1), rtol=1e-6)
    assert thdt == jhdt
    np.testing.assert_allclose(tc2.numpy(), np.asarray(jc2), rtol=1e-6)


def test_simulation_chunks_and_refresh_match_jax():
    """7 steps at rebuild_every=5 (a full chunk, then a 2-step remainder)
    with a force that takes the refreshed mask (no handles_refresh), at
    temperature 0 so both runs are deterministic: positions, per-step KE
    and the per-chunk position samples match the JAX Simulation."""
    kw = dict(n_atoms=64, box=BOX, cutoff=4.2, nbr_capacity=16, skin=0.8)
    mdkw = dict(temperature=0.0, dt_fs=2.0, friction_per_ps=25.0,
                rebuild_every=5)

    def jforce(pos, idx, mask):
        # harmonic tether plus a mask-dependent term, so the refresh counts
        return -0.5 * (pos - 6.0) + 0.01 * jnp.sum(mask, axis=1)[:, None]

    def tforce(pos, idx, mask):
        return -0.5 * (pos - 6.0) + 0.01 * torch.sum(mask, dim=1)[:, None]

    js = JSimulation(jforce, jcfg.get_preset("lj", **kw),
                     jcfg.MDConfig(**mdkw))
    ts = TSimulation(tforce, tcfg.get_preset("lj", **kw),
                     tcfg.MDConfig(**mdkw), device="cpu")
    rng = np.random.RandomState(9)
    pos = rng.uniform(0, BOX, (64, 3)).astype(np.float32)
    vel = (0.5 * rng.randn(64, 3)).astype(np.float32)
    rj = js.run(js.init_state(jnp.asarray(pos), vel=jnp.asarray(vel)), 7)
    rt = ts.run(ts.init_state(pos, vel=vel), 7)
    np.testing.assert_allclose(rt.state.pos.numpy(),
                               np.asarray(rj.state.pos), atol=1e-4)
    np.testing.assert_allclose(rt.thermo.kinetic_energy.numpy(),
                               np.asarray(rj.thermo.kinetic_energy),
                               rtol=1e-4)
    assert rt.thermo.temperature.shape == (7,)
    np.testing.assert_allclose(rt.positions.numpy(),
                               np.asarray(rj.positions), atol=1e-4)
    assert rt.positions.shape == (2, 64, 3)
