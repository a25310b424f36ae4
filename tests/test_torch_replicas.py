"""The port's replica path on the CPU against the JAX package: the R axis of
the whole-model forward and the fused window (their plain versions, the
CUDA kernels' references), the per-replica Philox noise, the batched
neighbour search, Simulation.init_replicas / run_replicas under every
integrator and the megastep window, the one-call simulate(), and
tools/bench_replicas.py with --cpu. Each test feeds the same seeded numpy
inputs to the JAX function and to its port and states its tolerance. The
CUDA kernels at R > 1 are held against their plain versions in
tests/test_torch_cuda.py and chip_smoke.py, on the card.
"""

import json
import os
from unittest import mock

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.md import integrators as jinteg
from gamd_tpu.md.simulate import Simulation as JSimulation
from gamd_tpu.md.simulate import simulate as jsimulate
from gamd_tpu.models.gnn import GAMDNet as JGAMDNet
from gamd_tpu.neighbors.dense import dense_neighbor_list as jdense
from gamd_tpu.ops import pallas_model as jmega
from gamd_tpu.physics import lennard_jones as jlj

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.core import units
from gamd_tpu_torch.md import integrators as tinteg
from gamd_tpu_torch.md.simulate import Simulation, simulate
from gamd_tpu_torch.neighbors import dense as tdense
from gamd_tpu_torch.ops import mega as tmega
from gamd_tpu_torch.ops.philox import philox_normal
from gamd_tpu_torch.physics import lennard_jones as tlj
from gamd_tpu_torch.tools import bench_replicas
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.state import init_params, params_from_jax

BOX = 12.0
N, K, CUTOFF = 64, 16, 5.0
R = 2
SMALL = dict(encoding_size=32, hidden_dim=32, edge_embedding_dim=32,
             conv_layers=2)
MASS = 39.948
TEMP = 100.0
DT = 2.0 * units.FS
N_LJ = 32
BOX_LJ, LATTICE = jlj.lj_fluid_box(N_LJ, 0.5)
#: Classical LJ at N=32 in its 13.6 A box: the potential cut inside half
#: the box, the whole system in every list (test_simulate.py's
#: small_lj_system).
LJ_CUTOFF = min(jlj.LJParams().cutoff, BOX_LJ / 2 - 0.01)
LJ32 = dict(n_atoms=N_LJ, box=BOX_LJ, cutoff=LJ_CUTOFF, nbr_capacity=N_LJ,
            skin=1.0)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _replica_inputs(seed=4):
    """The case of tests/test_megakernel.py::test_megakernel_replica_axis
    at widths 32: a frame and the frame shifted by 1.7 A, each with its own
    list, and the small model's packed weights (JAX and port)."""
    cfg = jcfg.ModelConfig(use_layer_norm=True, **SMALL)
    rng = np.random.RandomState(seed)
    pos = jnp.asarray(rng.uniform(0, BOX, (N, 3)).astype(np.float32))
    idx, mask, _ = jdense(pos, BOX, CUTOFF, K)
    params = JGAMDNet(cfg=cfg, species="lj", use_bond=False).init(
        jax.random.PRNGKey(seed), pos[None], idx[None], mask[None], BOX,
        0.5, 2.0, train=False)["params"]
    pos2 = jnp.mod(pos + 1.7, BOX)
    idx2, mask2, _ = jdense(pos2, BOX, CUTOFF, K)
    h0 = np.broadcast_to(np.asarray(params["node_emb"]),
                         (R, N, cfg.encoding_size)).astype(np.float32)
    jmp = jmega.pack_params(params, cfg)
    tmp = tmega.pack_params(params_from_jax(params),
                            tcfg.ModelConfig(use_layer_norm=True, **SMALL))
    return (jmp, tmp, np.asarray(jnp.stack([pos, pos2])),
            np.asarray(jnp.stack([idx, idx2])),
            np.asarray(jnp.stack([mask, mask2])), h0)


# -- the forward and the window ----------------------------------------------

def test_reference_forward_replicas_match_jax():
    """The port's plain forward at R=2 (the CUDA kernel's reference):
    against JAX's fp32 reference_forward on each replica within 1e-5 of
    std(F); against JAX mega_forward at R=2 (interpret mode, f32 edges)
    within that kernel's own fp32 bar, 5e-3 std(F) (test_megakernel.py:84;
    its positions go through bf16 hi/lo gathers); each replica bit for bit
    the port's single-system call."""
    jmp, tmp, pos, idx, mask, h0 = _replica_inputs()
    args = (BOX, None, 0.5, 2.0)
    out = tmega.mega_forward(_t(pos), _t(idx), _t(mask), _t(h0), tmp, *args)
    assert out.shape == (R, N, 3)
    j_kernel = np.asarray(jmega.mega_forward(
        jnp.asarray(pos), jnp.asarray(idx), jnp.asarray(mask),
        jnp.asarray(h0), jmp, *args, tile_n=8, interpret=True,
        f32_edges=True))
    scale = float(np.abs(j_kernel).std())
    assert float(np.abs(out.numpy() - j_kernel).max()) < 5e-3 * scale
    for r in range(R):
        j_ref = np.asarray(jmega.reference_forward(
            jnp.asarray(pos[r]), jnp.asarray(idx[r]), jnp.asarray(mask[r]),
            jnp.asarray(h0[r]), jmp, *args))
        assert float(np.abs(out[r].numpy() - j_ref).max()) < 1e-5 * scale
        one = tmega.mega_forward(_t(pos[r]), _t(idx[r]), _t(mask[r]),
                                 _t(h0[r]), tmp, *args)
        assert torch.equal(out[r], one)


def _window(pos, vel, f0, idx, mask, h0, tmp, masses, c2col, steps, seed):
    return tmega.mega_md_steps(
        pos, vel, f0, idx, mask, h0, tmp, BOX, CUTOFF, 0.5, 2.0, masses,
        n_steps=steps, c1=0.95, hdt=0.01, c2col=c2col,
        seed=torch.tensor([seed], dtype=torch.int32))


def test_window_replicas_without_noise_match_jax_kernel():
    """c2col = 0, 4 steps at R=2: the port's plain window against JAX
    mega_md_steps at R=2 (interpret, f32 edges): pos and vel within the
    reference's atol 2e-4 (test_megakernel.py:253-305), ke [R, steps]
    within rtol 1e-3; the replicas end apart."""
    jmp, tmp, pos, idx, mask, h0 = _replica_inputs(seed=5)
    vel = (0.1 * np.random.RandomState(6).randn(R, N, 3)).astype(np.float32)
    masses = np.full((N,), MASS, np.float32)
    f0 = tmega.reference_forward(_t(pos), _t(idx), _t(mask), _t(h0), tmp,
                                 BOX, CUTOFF, 0.5, 2.0)
    steps = 4
    j = jmega.mega_md_steps(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(f0.numpy()),
        jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(h0), jmp, BOX,
        CUTOFF, 0.5, 2.0, jnp.asarray(masses), n_steps=steps, c1=0.95,
        hdt=0.01, c2col=jnp.zeros((N,)), seed=3, tile_n=8, interpret=True,
        f32_edges=True)
    t = _window(_t(pos), _t(vel), f0, _t(idx), _t(mask), _t(h0), tmp,
                _t(masses), torch.zeros(N), steps, 3)
    for got, ref in zip(t[:2], j[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    assert t[3].shape == (R, steps)
    np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]), rtol=1e-3)
    assert float((t[0][0] - t[0][1]).abs().max()) > 1.0


def test_window_noise_is_keyed_by_replica():
    """With the noise on, replica 0 of an R=2 window is bit for bit the
    single-system window of the same state and seed (its KE within 1e-6:
    the sums run over another tensor shape); replica 1, started
    from the same state, draws other noise (counter word 2 = 1) and ends
    elsewhere; philox_normal at replica 0 is the single-system draw."""
    _, tmp, pos, idx, mask, h0 = _replica_inputs(seed=6)
    pos = np.broadcast_to(pos[:1], pos.shape).copy()
    idx = np.broadcast_to(idx[:1], idx.shape).copy()
    mask = np.broadcast_to(mask[:1], mask.shape).copy()
    vel = np.zeros((R, N, 3), np.float32)
    masses = torch.full((N,), MASS)
    c2col = torch.full((N,), 0.05)
    f0 = tmega.reference_forward(_t(pos), _t(idx), _t(mask), _t(h0), tmp,
                                 BOX, CUTOFF, 0.5, 2.0)
    both = _window(_t(pos), _t(vel), f0, _t(idx), _t(mask), _t(h0), tmp,
                   masses, c2col, 3, 77)
    one = _window(_t(pos[0]), _t(vel[0]), f0[0], _t(idx[0]), _t(mask[0]),
                  _t(h0[0]), tmp, masses, c2col, 3, 77)
    for a, b in zip(both[:3], one[:3]):
        assert torch.equal(a[0], b)
    torch.testing.assert_close(both[3][0], one[3], rtol=1e-6, atol=0.0)
    assert float((both[1][0] - both[1][1]).abs().max()) > 1e-3
    assert torch.equal(philox_normal(77, 2, N, replica=0),
                       philox_normal(77, 2, N))
    assert not torch.equal(philox_normal(77, 2, N, replica=1),
                           philox_normal(77, 2, N))


def test_dense_search_takes_replicas():
    """dense_neighbor_list and build_nbrs on [R, N, 3] give each replica
    the list of its own single-system search, exactly, and one overflow
    flag; the lists equal JAX's."""
    _, _, pos, idx, mask, _ = _replica_inputs()
    t_idx, t_mask, ovf = tdense.dense_neighbor_list(_t(pos), BOX, CUTOFF, K)
    assert t_idx.shape == (R, N, K) and ovf.shape == ()
    np.testing.assert_array_equal(t_idx.numpy(), idx)
    np.testing.assert_array_equal(t_mask.numpy(), mask)
    system = tcfg.get_preset("lj", n_atoms=N, box=BOX, cutoff=CUTOFF - 1.0,
                             skin=1.0, nbr_capacity=K)
    b_idx, b_mask, _ = tdense.build_nbrs(_t(pos), system, k_model=12)
    for r in range(R):
        s_idx, s_mask, _ = tdense.build_nbrs(_t(pos[r]), system, k_model=12)
        assert torch.equal(b_idx[r], s_idx) and torch.equal(b_mask[r], s_mask)


# -- Simulation ---------------------------------------------------------------

def _lj_systems():
    return (jcfg.get_preset("lj", **LJ32), tcfg.get_preset("lj", **LJ32))


def _lj_force_fns():
    params = jlj.LJParams(cutoff=LJ_CUTOFF)
    return (jlj.lj_force_fn(BOX_LJ, params),
            tlj.lj_force_fn(BOX_LJ, tlj.LJParams(cutoff=LJ_CUTOFF)))


def _md(integrator, **kw):
    base = dict(integrator=integrator, temperature=TEMP, dt_fs=2.0,
                friction_per_ps=25.0, chain_length=10, rebuild_every=5)
    base.update(kw)
    return jcfg.MDConfig(**base), tcfg.MDConfig(**base)


@pytest.mark.parametrize("integrator", ["nve", "nose_hoover"])
def test_run_replicas_matches_jax(integrator):
    """30 steps of 3 replicas of classical LJ-32 (rebuild every 5) from
    JAX's init_replicas state carried across as numpy: positions and
    velocities within 5e-5 (test_simulate.py:165-185 holds JAX's replicas
    to its single runs at 5e-5), the NHC chain's xi and vxi within 5e-5 of
    each one's max; thermo [R, steps] and positions [R, chunks, N, 3]."""
    jsys, tsys = _lj_systems()
    jfn, tfn = _lj_force_fns()
    jmd, tmd = _md(integrator)
    jsim = JSimulation(jfn, jsys, jmd)
    sim = Simulation(tfn, tsys, tmd, device="cpu")
    jstates = jsim.init_replicas(jnp.asarray(LATTICE), 3,
                                 rng=jax.random.PRNGKey(9))
    state_type = (tinteg.NoseHooverState if integrator == "nose_hoover"
                  else tinteg.NVEState)
    tstates = state_type(*[torch.as_tensor(np.array(f)) for f in jstates])
    r_j = jsim.run_replicas(jstates, 30)
    r_t = sim.run_replicas(tstates, 30)
    assert r_t.thermo.temperature.shape == (3, 30)
    assert r_t.positions.shape == (3, 6, N_LJ, 3)
    for name in ("pos", "vel"):
        np.testing.assert_allclose(getattr(r_t.state, name).numpy(),
                                   np.asarray(getattr(r_j.state, name)),
                                   atol=5e-5)
    np.testing.assert_allclose(r_t.thermo.kinetic_energy.numpy(),
                               np.asarray(r_j.thermo.kinetic_energy),
                               rtol=1e-4)
    if integrator == "nose_hoover":
        assert r_t.state.xi.shape == (3, 10)
        for name in ("xi", "vxi"):
            ref = np.asarray(getattr(r_j.state, name))
            err = np.abs(getattr(r_t.state, name).numpy() - ref).max()
            assert err <= 5e-5 * np.abs(ref).max(), (name, err)


def _noise_blocks(integrator, gen, chunks, r):
    """The blocks a replica run draws from its generator: per chunk one
    normal block (Langevin), or a uniform and a normal block (Andersen),
    each (rebuild, R, N, 3)."""
    shape = (5, r, N_LJ, 3)
    out = []
    for _ in range(chunks):
        if integrator == "langevin":
            out.extend(torch.randn(shape, generator=gen))
        else:
            u = torch.rand(shape, generator=gen)
            xi = torch.randn(shape, generator=gen)
            out.extend(zip(u, xi))
    return out


@pytest.mark.parametrize("integrator", ["langevin", "andersen"])
def test_stochastic_replica_chunks_match_jax_steps(integrator):
    """10 steps (two chunks) of 2 replicas of classical LJ-32 at 100 K from
    init_replicas: JAX's step function on the [R, N, 3] state, fed the
    noise blocks the port's run drew from its generator (replayed from a
    twin), with the dense LJ force of each replica: positions and
    velocities within 1e-4."""
    jsys, tsys = _lj_systems()
    jmd, tmd = _md(integrator)
    sim = Simulation(_lj_force_fns()[1], tsys, tmd, device="cpu")
    states = sim.init_replicas(LATTICE, 2,
                               rng=torch.Generator().manual_seed(11))
    twin = torch.Generator().manual_seed(11)
    torch.randn((2, N_LJ, 3), generator=twin)      # the velocities' draw
    res = sim.run_replicas(states, 10)
    noise = _noise_blocks(integrator, twin, 2, 2)
    assert torch.equal(twin.get_state(), states.rng.get_state())

    params = jlj.LJParams(cutoff=LJ_CUTOFF)
    jforce = jax.vmap(lambda p: jlj.lj_forces_dense(p, BOX_LJ, params))
    masses = jnp.full((N_LJ,), jlj.ARGON_MASS, jnp.float32)
    if integrator == "langevin":
        init, step = jinteg.baoab_langevin(jforce, DT, masses, TEMP,
                                           friction=2.5)
    else:
        init, step = jinteg.andersen(jforce, DT, masses, TEMP, 2.5)
    js = init(jnp.asarray(states.pos.numpy()),
              jnp.asarray(states.vel.numpy()), jax.random.PRNGKey(0))
    step = jax.jit(step)
    for block in noise:
        arg = (jnp.asarray(block.numpy()) if integrator == "langevin"
               else tuple(jnp.asarray(b.numpy()) for b in block))
        js = step(js, arg)
    np.testing.assert_allclose(res.state.pos.numpy(), np.asarray(js.pos),
                               atol=1e-4)
    np.testing.assert_allclose(res.state.vel.numpy(), np.asarray(js.vel),
                               atol=1e-4)
    assert float((res.state.pos[0] - res.state.pos[1]).abs().max()) > 1e-3


def _small_ff():
    system = tcfg.get_preset("lj", n_atoms=N_LJ, box=BOX_LJ, cutoff=6.0,
                             skin=0.5, nbr_capacity=N_LJ)
    cfg = tcfg.ModelConfig(**SMALL)
    return system, GNNForceField(init_params(cfg, system, seed=0), system,
                                 cfg, device="cpu")


def test_megastep_replicas_run():
    """Simulation(megastep_fn) on 3 replicas of a small seeded GAMD
    (widths 32, 2 layers) at 100 K, 12 steps in windows of 5 and 2: one
    window call a chunk for all replicas (plain version), the shapes of
    run_replicas, finite values, and replicas that diverge."""
    system, ff = _small_ff()
    md = tcfg.MDConfig(integrator="langevin", temperature=TEMP,
                       friction_per_ps=25.0, rebuild_every=5)
    sim = Simulation(ff.force_fn(megakernel=True), system, md,
                     megastep_fn=ff.megastep_fn(), device="cpu")
    states = sim.init_replicas(LATTICE, 3,
                               rng=torch.Generator().manual_seed(3))
    assert states.pos.shape == states.vel.shape == (3, N_LJ, 3)
    calls = []
    window = sim.megastep_fn

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return window(*args, **kw)

    sim.megastep_fn = spy
    res = sim.run_replicas(states, 12)
    assert calls == [(3, N_LJ, 3)] * 3
    assert res.thermo.kinetic_energy.shape == (3, 12)
    assert res.positions.shape == (3, 3, N_LJ, 3)
    assert not res.overflow
    assert bool(torch.isfinite(res.state.pos).all())
    assert bool(torch.isfinite(res.thermo.temperature).all())
    p = res.state.pos
    assert float((p[0] - p[1]).abs().max()) > 1e-3
    assert float((p[1] - p[2]).abs().max()) > 1e-3


def test_eager_force_fn_replicas_match_single_calls():
    """A force function that does not handle the refresh (the eager GAMD)
    is called once per replica with its own refreshed mask: the batched
    force of init_replicas equals per-replica init_state forces; the
    megakernel force takes the stack in one call and agrees with it
    (tanh against exact gelu: 1e-2 of std(F))."""
    system, ff = _small_ff()
    md = tcfg.MDConfig(integrator="nve", rebuild_every=5)
    sim = Simulation(ff.force_fn(), system, md, device="cpu")
    states = sim.init_replicas(LATTICE, 2)
    single = sim.init_state(LATTICE, vel=np.zeros_like(LATTICE))
    for r in range(2):
        torch.testing.assert_close(states.force[r], single.force)
    mk = Simulation(ff.force_fn(megakernel=True), system, md, device="cpu")
    f = mk.init_replicas(LATTICE, 2).force
    scale = float(single.force.abs().std())
    assert float((f - states.force).abs().max()) < 1e-2 * scale


def test_simulate_matches_jax():
    """simulate() on classical LJ-32 under NVE for 20 steps from the same
    velocities: positions within 1e-4 of JAX's simulate(), thermo
    [n_steps]."""
    jsys, tsys = _lj_systems()
    jfn, tfn = _lj_force_fns()
    jmd, tmd = _md("nve", n_steps=20)
    vel = (np.sqrt(units.KB * TEMP / MASS) * np.random.default_rng(2)
           .standard_normal((N_LJ, 3))).astype(np.float32)
    r_j = jsimulate(jfn, jsys, jmd, jnp.asarray(LATTICE),
                    vel=jnp.asarray(vel))
    r_t = simulate(tfn, tsys, tmd, LATTICE, vel=vel, device="cpu")
    assert r_t.thermo.temperature.shape == (20,)
    np.testing.assert_allclose(r_t.state.pos.numpy(),
                               np.asarray(r_j.state.pos), atol=1e-4)


def test_replica_refusals():
    """run_replicas refuses a single-system state; a constraint (and so
    constrained NHC replicas) is refused, naming the water item."""
    jsys, tsys = _lj_systems()
    sim = Simulation(_lj_force_fns()[1], tsys, _md("nve")[1], device="cpu")
    with pytest.raises(ValueError, match="replica state"):
        sim.run_replicas(sim.init_state(LATTICE), 5)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        Simulation(_lj_force_fns()[1], tsys, _md("nose_hoover")[1],
                   device="cpu", constraint=object())


def test_bench_replicas_cpu(capsys):
    """tools.bench_replicas --cpu 2 replicas x 6 steps on a small system
    (LJ-32, GAMD widths 32, 2 layers), under megastep Langevin and
    per-step NHC: the first line names the CPU, the last is the JSON line
    of the JAX script's keys, and no kernel launches."""
    system = tcfg.get_preset("lj", n_atoms=N_LJ, box=BOX_LJ, cutoff=6.0)
    before = tmega.mega_forward.launches, tmega.mega_md_steps.launches
    for integrator in ("langevin", "nose_hoover"):
        with mock.patch.dict(os.environ,
                             {"GAMD_BENCH_INTEGRATOR": integrator}), \
                mock.patch.object(bench_replicas, "get_preset",
                                  lambda name, **kw: tcfg.get_preset(
                                      name, **{**kw, **dict(
                                          n_atoms=N_LJ, box=BOX_LJ,
                                          cutoff=6.0, nbr_capacity=N_LJ)})), \
                mock.patch.object(bench_replicas, "lj_model_config",
                                  lambda: tcfg.ModelConfig(**SMALL)):
            out = bench_replicas.main(["2", "6", "--cpu"])
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 2 and "cpu" in lines[0]
        assert json.loads(lines[-1]) == out
        assert set(out) == {"metric", "value", "unit", "per_replica"}
        assert out["unit"] == "steps/s" and out["value"] > 0
        assert abs(out["value"] - 2 * out["per_replica"]) \
            <= 1e-3 * out["value"] + 0.2
        assert f"{system.n_atoms}-atom" in out["metric"]
    assert (tmega.mega_forward.launches,
            tmega.mega_md_steps.launches) == before
