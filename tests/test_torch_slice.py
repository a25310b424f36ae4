"""The port's first slice end to end on the CPU: Simulation driving
GNNForceField.force_fn(megakernel=True) tracks the JAX Simulation through
the Pallas megakernel (interpret mode) from the same start; and the entry
points refuse to fall back to the CPU when CUDA is asked for."""

import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.md.simulate import Simulation as JSimulation
from gamd_tpu.models.normalizer import stat_from_values
from gamd_tpu.train.forcefield import GNNForceField as JForceField
from gamd_tpu.train.state import build_model, create_train_state

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.ops.mega import mega_forward
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.state import (ForceFieldState, init_params,
                                        params_from_jax, stat_from_jax)

BOX = 12.0
SMALL = dict(encoding_size=32, hidden_dim=32, edge_embedding_dim=32,
             conv_layers=2)
SYSTEM = dict(n_atoms=64, box=BOX, cutoff=4.2, nbr_capacity=16, skin=0.8)
# temperature=0 zeroes the thermostat noise (b * sigma = 0), so both sides
# are deterministic from the same numpy velocities; friction still acts.
MD = dict(integrator="langevin", temperature=0.0, dt_fs=2.0,
          friction_per_ps=25.0, rebuild_every=5)


def _jax_state():
    system = jcfg.get_preset("lj", **SYSTEM)
    cfg = jcfg.ModelConfig(**SMALL)
    state = create_train_state(build_model(cfg, system), system,
                               jcfg.TrainConfig(), 1)
    # Non-trivial scalers, so both denormalisations are exercised.
    return state.replace(force_stat=stat_from_values(0.1, 4.0, 10.0),
                         length_stat=stat_from_values(4.0, 1.5, 10.0))


def _port_state(jstate):
    return ForceFieldState(params=params_from_jax(jstate.params),
                           batch_stats={},
                           force_stat=stat_from_jax(jstate.force_stat),
                           length_stat=stat_from_jax(jstate.length_stat))


def test_slice_tracks_jax_megakernel_md():
    """5 Langevin steps (one neighbour chunk) at temperature 0 from the
    same positions and velocities: positions within the reference's atol
    5e-3 of the JAX megakernel run (bf16 edges on the JAX side)."""
    jstate = _jax_state()
    jsystem = jcfg.get_preset("lj", **SYSTEM)
    jff = JForceField(jstate, jsystem, jcfg.ModelConfig(**SMALL))
    jsim = JSimulation(jff.force_fn(megakernel=True, tile_n=8,
                                    interpret=True), jsystem,
                       jcfg.MDConfig(**MD))

    system = tcfg.get_preset("lj", **SYSTEM)
    ff = GNNForceField(_port_state(jstate), system,
                       tcfg.ModelConfig(**SMALL), device="cpu")
    sim = Simulation(ff.force_fn(megakernel=True), system,
                     tcfg.MDConfig(**MD), device="cpu")

    rng = np.random.RandomState(8)
    pos = rng.uniform(0, BOX, (64, 3)).astype(np.float32)
    vel = (0.05 * rng.randn(64, 3)).astype(np.float32)
    r_j = jsim.run(jsim.init_state(jnp.asarray(pos), vel=jnp.asarray(vel)),
                   5)
    r_t = sim.run(sim.init_state(pos, vel=vel), 5)

    np.testing.assert_allclose(r_t.state.pos.numpy(),
                               np.asarray(r_j.state.pos), atol=5e-3)
    np.testing.assert_allclose(r_t.state.vel.numpy(),
                               np.asarray(r_j.state.vel), atol=5e-3)
    assert isinstance(r_t.overflow, bool)
    assert r_t.overflow == bool(r_j.overflow)
    assert r_t.thermo.temperature.shape == (5,)
    assert r_t.positions.shape == (1, 64, 3)
    np.testing.assert_allclose(r_t.thermo.temperature.numpy(),
                               np.asarray(r_j.thermo.temperature),
                               rtol=1e-2)
    assert float(np.abs(r_t.state.pos.numpy() - pos).max()) > 1e-3


def test_slice_eager_and_megakernel_paths_agree():
    """The erf-gelu eager model path and the tanh-gelu kernel path give the
    same forces through the Simulation-facing (pos, idx, mask) interface,
    within the tanh/erf gelu difference."""
    system = tcfg.get_preset("lj", **SYSTEM)
    ff = GNNForceField(_port_state(_jax_state()), system,
                       tcfg.ModelConfig(**SMALL), device="cpu")
    sim = Simulation(ff.force_fn(), system, tcfg.MDConfig(**MD),
                     device="cpu")
    pos = torch.as_tensor(np.random.RandomState(6).uniform(
        0, BOX, (64, 3)).astype(np.float32))
    idx, mask, _ = sim._build_nbrs(pos)
    eager = sim._force_with(idx, mask)(pos)
    mk_fn = ff.force_fn(megakernel=True)
    assert mk_fn.handles_refresh
    sim_mk = Simulation(mk_fn, system, tcfg.MDConfig(**MD), device="cpu")
    kernel = sim_mk._force_with(idx, mask)(pos)
    assert eager.shape == kernel.shape == (64, 3)
    err = (eager - kernel).abs().max()
    assert float(err) < 0.01 * float(eager.abs().std())


def test_entry_points_raise_without_cuda():
    """The default device is CUDA; without one the entry points raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    system = tcfg.get_preset("lj", **SYSTEM)
    state = _port_state(_jax_state())
    with pytest.raises(RuntimeError, match="CUDA"):
        GNNForceField(state, system, tcfg.ModelConfig(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(lambda p, i, m: p, system, tcfg.MDConfig(**MD))


def test_left_out_paths_name_their_slice():
    """banded_force_fn raises NotImplementedError naming the slice it
    comes with; predict (slice 4) and megastep_fn (slice 2) are in, and
    Simulation refuses megastep_fn under an integrator other than
    Langevin."""
    system = tcfg.get_preset("lj", **SYSTEM)
    ff = GNNForceField(_port_state(_jax_state()), system,
                       tcfg.ModelConfig(**SMALL), device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        ff.banded_force_fn()
    pos = np.random.RandomState(3).uniform(0, BOX, (64, 3))
    assert ff.predict(pos.astype(np.float32)).shape == (64, 3)
    with pytest.raises(ValueError, match="langevin"):
        Simulation(ff.force_fn(), system,
                   tcfg.MDConfig(**{**MD, "integrator": "nose_hoover"}),
                   megastep_fn=ff.megastep_fn(), device="cpu")


def test_mega_forward_rejects_other_devices():
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        mega_forward(x, None, None, None, None, BOX, None, 0.0, 1.0)


def test_megakernel_force_fn_refuses_a_replica_axis():
    """force_fn(megakernel=True) on a [R=2, 258, 3] pos raises the
    replicas-slice NotImplementedError (the JAX force_fn takes [R, N, 3];
    the port's kernel takes one system), before any other check."""
    system = tcfg.get_preset("lj")
    cfg = tcfg.lj_model_config()
    ff = GNNForceField(init_params(cfg, system, seed=0), system, cfg,
                       device="cpu")
    pos = torch.zeros((2, system.n_atoms, 3))
    idx = torch.zeros((2, system.n_atoms, 48), dtype=torch.int32)
    mask = torch.zeros((2, system.n_atoms, 48), dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="replicas slice"):
        ff.force_fn(megakernel=True)(pos, idx, mask)
    with pytest.raises(NotImplementedError, match="replicas slice"):
        mega_forward(torch.zeros((2, 4, 3), device="meta"), None, None,
                     None, None, BOX, None, 0.0, 1.0)
