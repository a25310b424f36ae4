"""The port's second slice on the CPU: the Philox noise, the fused MD window
(mega_md_steps' plain version), Simulation(megastep_fn=...), the checkpoint
reader and the port's bench, each against the JAX package on the same
numpy inputs (the JAX Pallas kernels in interpret mode). The CUDA window
kernel itself is held against its plain version in tests/test_torch_cuda.py
and chip_smoke.py, on the card."""

import dataclasses
import json
import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.md import integrators as jinteg
from gamd_tpu.md.simulate import Simulation as JSimulation
from gamd_tpu.models.normalizer import stat_from_values as jstat_from_values
from gamd_tpu.neighbors.dense import dense_neighbor_list
from gamd_tpu.ops import pallas_model as jmega
from gamd_tpu.physics.lennard_jones import lj_fluid_box
from gamd_tpu.train import checkpoint as jckpt
from gamd_tpu.train.forcefield import GNNForceField as JForceField
from gamd_tpu.train.state import build_model, create_train_state

from gamd_tpu_torch import bench
from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.ops import mega as tmega
from gamd_tpu_torch.ops.philox import philox4x32, philox_normal
from gamd_tpu_torch.train import checkpoint as tckpt
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.msgpack import unpackb
from gamd_tpu_torch.train.state import (ForceFieldState, params_from_jax,
                                        stat_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = os.path.join(REPO, "results", "ckpts")
BOX = 12.0
N, K, CUTOFF, SKIN = 64, 16, 4.2, 0.8
LENGTH_MEAN, LENGTH_STD = 4.0, 1.5
SMALL = dict(encoding_size=32, hidden_dim=32, edge_embedding_dim=32,
             conv_layers=2)
SYSTEM = dict(n_atoms=N, box=BOX, cutoff=CUTOFF, nbr_capacity=K, skin=SKIN)
MASS = 39.948


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _jax_state():
    system = jcfg.get_preset("lj", **SYSTEM)
    cfg = jcfg.ModelConfig(**SMALL)
    state = create_train_state(build_model(cfg, system), system,
                               jcfg.TrainConfig(), 1)
    return state.replace(force_stat=jstat_from_values(0.1, 4.0, 10.0),
                         length_stat=jstat_from_values(LENGTH_MEAN,
                                                       LENGTH_STD ** 2,
                                                       10.0))


def _port_state(jstate):
    return ForceFieldState(params=params_from_jax(jstate.params),
                           batch_stats={},
                           force_stat=stat_from_jax(jstate.force_stat),
                           length_stat=stat_from_jax(jstate.length_stat))


def _window_inputs(seed=0):
    """Small packed weights (JAX and port), a frame, its list, h0 and the
    start velocities, all from one seed."""
    jstate = _jax_state()
    params = jstate.params
    cfg = jcfg.ModelConfig(**SMALL)
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, BOX, (N, 3)).astype(np.float32)
    vel = (0.1 * rng.randn(N, 3)).astype(np.float32)
    idx, mask, _ = dense_neighbor_list(jnp.asarray(pos), BOX, CUTOFF + SKIN,
                                       K)
    h0 = np.broadcast_to(np.asarray(params["node_emb"]),
                         (N, cfg.encoding_size)).astype(np.float32)
    jmp = jmega.pack_params(params, cfg)
    tmp = tmega.pack_params(params_from_jax(params), tcfg.ModelConfig(**SMALL))
    return jmp, tmp, pos, vel, np.asarray(idx), np.asarray(mask), h0


def _baoab_constants(temperature):
    """(c1, hdt, c2col [N], masses [N]) of the port's Simulation at 2 fs and
    25/ps."""
    system = tcfg.get_preset("lj", **SYSTEM)
    md = tcfg.MDConfig(integrator="langevin", temperature=temperature,
                       dt_fs=2.0, friction_per_ps=25.0)
    sim = Simulation(lambda p, i, m: p, system, md, device="cpu")
    c1, hdt, c2col = sim._baoab_constants()
    return c1, hdt, c2col, sim.masses


# -- Philox -------------------------------------------------------------------

@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0), "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(counter, key, expected):
    """Random123's Philox4x32-10 known-answer vectors, exactly."""
    out = philox4x32(torch.tensor(counter), torch.tensor(key))
    assert " ".join(f"{int(w):08x}" for w in out) == expected


def test_philox_normal_statistics():
    """2^16 atoms x 3 axes x 2 steps of draws: |mean| < 0.01 and
    |var - 1| < 0.02 (about 4 and 6 standard errors); the same seed gives
    the same draws, another seed others; a tensor seed gives what its
    value gives."""
    n = 1 << 16
    draws = torch.cat([philox_normal(11, step, n) for step in (0, 1)])
    assert draws.shape == (2 * n, 3) and draws.dtype == torch.float32
    assert abs(float(draws.mean())) < 0.01
    assert abs(float(draws.var()) - 1.0) < 0.02
    assert torch.equal(philox_normal(11, 0, n), draws[:n])
    assert not torch.equal(philox_normal(12, 0, n), draws[:n])
    assert not torch.equal(draws[:n], draws[n:])
    seed = torch.tensor([11], dtype=torch.int32)
    assert torch.equal(philox_normal(seed, 1, n), draws[n:])


# -- the window ---------------------------------------------------------------

def test_window_without_noise_matches_jax_kernel():
    """c2col = 0, 4 steps: the port's plain window against JAX
    mega_md_steps (interpret, f32 edges) on the same inputs. pos and vel
    within the reference's atol 2e-4, ke within rtol 1e-3, forces within
    1e-3 * std(F)."""
    jmp, tmp, pos, vel, idx, mask, h0 = _window_inputs(seed=1)
    masses = np.full((N,), MASS, np.float32)
    c1, hdt, steps = 0.95, 0.01, 4
    f0 = tmega.reference_forward(_t(pos), _t(idx), _t(mask), _t(h0), tmp,
                                 BOX, CUTOFF, LENGTH_MEAN, LENGTH_STD)
    j = jmega.mega_md_steps(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(f0.numpy()),
        jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(h0), jmp, BOX,
        CUTOFF, LENGTH_MEAN, LENGTH_STD, jnp.asarray(masses), n_steps=steps,
        c1=c1, hdt=hdt, c2col=jnp.zeros((N,)), seed=3, tile_n=8,
        interpret=True, f32_edges=True)
    before = tmega.mega_md_steps.launches
    t = tmega.mega_md_steps(
        _t(pos), _t(vel), f0, _t(idx), _t(mask), _t(h0), tmp, BOX, CUTOFF,
        LENGTH_MEAN, LENGTH_STD, _t(masses), n_steps=steps, c1=c1, hdt=hdt,
        c2col=torch.zeros(N), seed=torch.tensor([3], dtype=torch.int32))
    assert tmega.mega_md_steps.launches == before   # CPU: plain version
    for got, ref in zip(t[:2], j[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    f_ref = np.asarray(j[2])
    assert float(np.abs(t[2].numpy() - f_ref).max()) \
        < 1e-3 * float(np.abs(f_ref).std())
    assert t[3].shape == (steps,)
    np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]), rtol=1e-3)
    assert float(np.abs(t[0].numpy() - pos).max()) > 1e-3


def test_window_with_noise_matches_jax_baoab():
    """5 steps at 100 K with the port's Philox noise: the port's plain
    window against JAX baoab_langevin step_fn(state, noise) over JAX
    reference_forward, fed the same philox_normal draws. pos and vel within
    atol 2e-4, so the noise enters at O with the right amplitude."""
    jmp, tmp, pos, vel, idx, mask, h0 = _window_inputs(seed=2)
    c1, hdt, c2col, masses = _baoab_constants(100.0)
    seed, steps = 1234567, 5

    def jforce(x):
        return jmega.reference_forward(x, jnp.asarray(idx),
                                       jnp.asarray(mask), jnp.asarray(h0),
                                       jmp, BOX, CUTOFF, LENGTH_MEAN,
                                       LENGTH_STD)
    init, step = jinteg.baoab_langevin(jforce, 2.0 * hdt,
                                       jnp.asarray(masses.numpy()), 100.0,
                                       friction=25.0 / 10.0)
    st = init(jnp.asarray(pos), jnp.asarray(vel), jax.random.PRNGKey(0))
    for s in range(steps):
        st = step(st, jnp.asarray(philox_normal(seed, s, N).numpy()))

    f0 = torch.as_tensor(np.array(jforce(jnp.asarray(pos))))
    t = tmega.mega_md_steps(
        _t(pos), _t(vel), f0, _t(idx), _t(mask), _t(h0), tmp, BOX, CUTOFF,
        LENGTH_MEAN, LENGTH_STD, masses, n_steps=steps, c1=c1, hdt=hdt,
        c2col=c2col, seed=torch.tensor([seed], dtype=torch.int32))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(st.pos), atol=2e-4)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(st.vel), atol=2e-4)
    ke = 0.5 * float(jnp.sum(jnp.asarray(masses.numpy())[:, None]
                             * st.vel ** 2))
    assert abs(float(t[3][-1]) - ke) < 1e-3 * ke
    # The noise is live: the same window without it ends elsewhere.
    quiet = tmega.md_steps_reference(
        _t(pos), _t(vel), f0, _t(idx), _t(mask), _t(h0), tmp, BOX, CUTOFF,
        LENGTH_MEAN, LENGTH_STD, masses, n_steps=steps, c1=c1, hdt=hdt,
        c2col=torch.zeros(N), seed=seed)
    assert float((quiet[0] - t[0]).abs().max()) > 1e-3


def test_window_thermostat_holds_temperature():
    """Forces exactly 0 (decoder's last affine zeroed), 1,000 plain window
    steps at 100 K, 64 atoms, a fixed Philox seed: the mean temperature over
    steps 100-1,000 is within 100 K +- 5% (about 4 standard errors of the
    mean)."""
    _, tmp, pos, vel, idx, mask, h0 = _window_inputs(seed=3)
    tmp = tmp._replace(wd1=torch.zeros_like(tmp.wd1),
                       bd1=torch.zeros_like(tmp.bd1))
    c1, hdt, c2col, masses = _baoab_constants(100.0)
    _, _, _, ke = tmega.md_steps_reference(
        _t(pos), torch.zeros(N, 3), torch.zeros(N, 3), _t(idx), _t(mask),
        _t(h0), tmp, BOX, CUTOFF, LENGTH_MEAN, LENGTH_STD, masses,
        n_steps=1000, c1=c1, hdt=hdt, c2col=c2col, seed=2024)
    temp = 2.0 * ke / (3 * N * tcfg.units.KB)
    assert abs(float(temp[100:].mean()) - 100.0) < 5.0


# -- Simulation(megastep_fn) --------------------------------------------------

MD0 = dict(integrator="langevin", temperature=0.0, dt_fs=2.0,
           friction_per_ps=25.0, rebuild_every=5)


def test_simulation_megastep_tracks_jax():
    """Temperature 0 (no noise on either side), 10 steps in two windows of
    5: the port's Simulation(megastep_fn) against JAX
    Simulation(megastep_fn) with the Pallas window in interpret mode (bf16
    edges, as test_torch_slice's per-step test): positions within 5e-3."""
    jstate = _jax_state()
    jsystem = jcfg.get_preset("lj", **SYSTEM)
    jff = JForceField(jstate, jsystem, jcfg.ModelConfig(**SMALL))
    jsim = JSimulation(jff.force_fn(megakernel=True, tile_n=8,
                                    interpret=True), jsystem,
                       jcfg.MDConfig(**MD0),
                       megastep_fn=jff.megastep_fn(tile_n=8, interpret=True))
    system = tcfg.get_preset("lj", **SYSTEM)
    ff = GNNForceField(_port_state(jstate), system,
                       tcfg.ModelConfig(**SMALL), device="cpu")
    sim = Simulation(ff.force_fn(megakernel=True), system,
                     tcfg.MDConfig(**MD0), megastep_fn=ff.megastep_fn(),
                     device="cpu")

    rng = np.random.RandomState(8)
    pos = rng.uniform(0, BOX, (N, 3)).astype(np.float32)
    vel = (0.05 * rng.randn(N, 3)).astype(np.float32)
    r_j = jsim.run(jsim.init_state(jnp.asarray(pos), vel=jnp.asarray(vel)),
                   10)
    r_t = sim.run(sim.init_state(pos, vel=vel), 10)
    np.testing.assert_allclose(r_t.state.pos.numpy(),
                               np.asarray(r_j.state.pos), atol=5e-3)
    np.testing.assert_allclose(r_t.state.vel.numpy(),
                               np.asarray(r_j.state.vel), atol=5e-3)
    assert r_t.thermo.temperature.shape == (10,)
    assert r_t.positions.shape == (2, N, 3)
    assert r_t.overflow == bool(r_j.overflow)
    np.testing.assert_allclose(r_t.thermo.temperature.numpy(),
                               np.asarray(r_j.thermo.temperature),
                               rtol=1e-2)


def test_megastep_and_per_step_paths_agree():
    """Temperature 0, 12 steps (windows of 5, 5 and 2): the port's megastep
    path and its per-step megakernel path run the same arithmetic, so
    positions, velocities and KE agree to 1e-5."""
    system = tcfg.get_preset("lj", **SYSTEM)
    ff = GNNForceField(_port_state(_jax_state()), system,
                       tcfg.ModelConfig(**SMALL), device="cpu")
    md = tcfg.MDConfig(**MD0)
    per_step = Simulation(ff.force_fn(megakernel=True), system, md,
                          device="cpu")
    fused = Simulation(ff.force_fn(megakernel=True), system, md,
                       megastep_fn=ff.megastep_fn(), device="cpu")
    rng = np.random.RandomState(4)
    pos = rng.uniform(0, BOX, (N, 3)).astype(np.float32)
    vel = (0.05 * rng.randn(N, 3)).astype(np.float32)
    a = per_step.run(per_step.init_state(pos, vel=vel), 12)
    b = fused.run(fused.init_state(pos, vel=vel), 12)
    torch.testing.assert_close(b.state.pos, a.state.pos, atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(b.state.vel, a.state.vel, atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(b.thermo.kinetic_energy,
                               a.thermo.kinetic_energy, atol=1e-5,
                               rtol=1e-5)
    assert b.positions.shape == (3, N, 3)


# -- refusals -----------------------------------------------------------------

def test_megastep_refusals():
    """megastep_fn refuses a box that is not fixed, expand_edge=False,
    update_edge=True and a long-range channel; Simulation refuses a
    megastep_fn under another integrator; mega_md_steps and megastep_fn
    refuse an ablate name JAX's kernel does not know, mega_md_steps takes
    edge_hilo and f32_edges (the same window: the kernel's bf16 x 3
    products stand for both), and takes the replica axis it once refused:
    an R=2 window
    gives each replica its single-system window (pos, vel, force bit for
    bit on the CPU, ke [R, steps] within 1e-6)."""
    state = _port_state(_jax_state())
    cfg = tcfg.ModelConfig(**SMALL)
    free = tcfg.get_preset("lj", **{**SYSTEM, "box": None})
    with pytest.raises(ValueError, match="fixed scalar box"):
        GNNForceField(state, free, cfg, device="cpu").megastep_fn()
    system = tcfg.get_preset("lj", **SYSTEM)
    ff = GNNForceField(state, system, cfg, device="cpu")
    for swap, match in ((dict(expand_edge=False), "expand_edge"),
                        (dict(update_edge=True), "update_edge"),
                        (dict(longrange="ewald_recip"), "long-range")):
        ff.model_cfg = dataclasses.replace(cfg, **swap)
        with pytest.raises(ValueError, match=match):
            ff.megastep_fn()
    ff.model_cfg = cfg
    with pytest.raises(ValueError, match="langevin"):
        Simulation(ff.force_fn(), system,
                   tcfg.MDConfig(**{**MD0, "integrator": "nve"}),
                   megastep_fn=ff.megastep_fn(), device="cpu")

    _, tmp, pos, vel, idx, mask, h0 = _window_inputs()
    pos2 = np.mod(pos + 1.7, BOX).astype(np.float32)
    idx2, mask2, _ = dense_neighbor_list(jnp.asarray(pos2), BOX,
                                         CUTOFF + SKIN, K)
    two = lambda a, b: torch.stack([_t(a), _t(b)])
    args_r = (two(pos, pos2), two(vel, -vel), two(vel, vel), two(idx, idx2),
              two(mask, mask2), two(h0, h0), tmp, BOX, CUTOFF, 4.0, 1.5,
              torch.full((N,), MASS))
    kw = dict(n_steps=2, c1=0.9, hdt=0.01, c2col=torch.zeros(N), seed=1)
    out_r = tmega.mega_md_steps(*args_r, **kw)
    assert out_r[3].shape == (2, 2)
    for r in range(2):
        one = tmega.mega_md_steps(*[a[r] for a in args_r[:6]],
                                  *args_r[6:], **kw)
        for got, ref in zip(out_r[:3], one[:3]):
            assert torch.equal(got[r], ref)
        torch.testing.assert_close(out_r[3][r], one[3], rtol=1e-6, atol=0.0)
    args = (_t(pos), _t(vel), _t(vel), _t(idx), _t(mask), _t(h0), tmp, BOX,
            CUTOFF, 4.0, 1.5, torch.full((N,), MASS))
    plain = tmega.mega_md_steps(*args, **kw)
    for switch in ("edge_hilo", "f32_edges"):
        for got, ref in zip(tmega.mega_md_steps(*args, **kw, **{switch: True}),
                            plain):
            assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="unknown ablate stage"):
        tmega.mega_md_steps(*args, **kw, ablate=("noise", "tiles"))
    with pytest.raises(ValueError, match="unknown ablate stage"):
        ff.megastep_fn(ablate=("tiles",))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tmega.mega_md_steps(torch.zeros((N, 3), device="meta"), *args[1:],
                            **kw)


# -- the checkpoint reader ----------------------------------------------------

def _same_tree(a, b, path=""):
    """Same keys in the same order, same types, ndarray leaves bit-equal
    (dtype, shape and bytes). Returns the number of leaves."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), path
        return sum(_same_tree(a[k], b[k], f"{path}/{k}") for k in b)
    if isinstance(b, (list, tuple)):
        assert isinstance(a, list) and len(a) == len(b), path
        return sum(_same_tree(x, y, path) for x, y in zip(a, b))
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), path
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
        return 1
    assert type(a) is type(b) and a == b, path
    return 1


@pytest.mark.parametrize("name", ["lj_relabel_latest.msgpack",
                                  "tip3p_rj_best.msgpack"])
def test_msgpack_decoder_matches_flax(name):
    """The port's decoder against flax.serialization.msgpack_restore on a
    committed checkpoint: the same tree, every leaf bit-equal."""
    with open(os.path.join(CKPTS, name), "rb") as f:
        data = f.read()
    assert _same_tree(unpackb(data),
                      flax.serialization.msgpack_restore(data)) > 100


def test_msgpack_decoder_refuses_other_ext_codes():
    """ext type 2 (complex) or any code but 1 raises; so does a truncated
    input."""
    with pytest.raises(ValueError, match="ext type 2"):
        unpackb(b"\xd5\x02ab")
    with pytest.raises(ValueError, match="truncated"):
        unpackb(b"\xa5abc")


def test_load_scaler_matches_jax():
    """load_scaler on the committed LJ scaler.npz: count, mean and m2 equal
    to the JAX package's float32 values."""
    path = os.path.join(CKPTS, "lj_relabel_scaler.npz")
    for got, ref in zip(tckpt.load_scaler(path), jckpt.load_scaler(path)):
        for field in ("count", "mean", "m2"):
            assert getattr(got, field) == float(getattr(ref, field)), field


def test_trained_checkpoint_forces_match_jax():
    """Eager fp32 forces of the port's GNNForceField built from
    load_self_describing(lj_relabel_latest.msgpack) against the JAX
    GNNForceField.force_fn() from its own load_self_describing, on the
    N=258 LJ start frame: max |dF| <= 1e-4 * std(F) (test_torch_model's
    eager tolerance); the configs and scalers read equal."""
    path = os.path.join(CKPTS, "lj_relabel_latest.msgpack")
    jstate, jmodel, jsystem = jckpt.load_self_describing(path)
    state, model_cfg, system = tckpt.load_self_describing(path)
    assert dataclasses.asdict(model_cfg) == dataclasses.asdict(jmodel)
    assert dataclasses.asdict(system) == dataclasses.asdict(jsystem)
    assert state.force_stat == stat_from_jax(jstate.force_stat)
    assert state.length_stat == stat_from_jax(jstate.length_stat)

    _, lattice = lj_fluid_box(system.n_atoms, 0.5)
    pos = np.mod(lattice + np.random.default_rng(0).normal(
        0.0, 0.05, lattice.shape), system.box).astype(np.float32)
    idx, mask, ovf = dense_neighbor_list(jnp.asarray(pos), system.box,
                                         system.cutoff, system.nbr_capacity)
    assert not bool(ovf)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JForceField(jstate, jsystem, jmodel).force_fn()(
            jnp.asarray(pos), idx, mask))
    ff = GNNForceField(state, system, model_cfg, device="cpu")
    got = ff.force_fn()(_t(pos), _t(np.asarray(idx)),
                        _t(np.asarray(mask))).numpy()
    scale = float(np.abs(ref).std())
    assert scale > 0
    assert float(np.abs(got - ref).max()) <= 1e-4 * scale


# -- the port's bench ---------------------------------------------------------

@pytest.mark.parametrize("megastep", ["1", "0"])
def test_bench_prints_bench_py_line(megastep, monkeypatch, capsys):
    """gamd_tpu_torch.bench.main on the CPU with 3 steps and 1 timed run,
    both paths: the last line is one JSON object with bench.py's keys."""
    monkeypatch.setenv("GAMD_BENCH_MEGASTEP", megastep)
    before = tmega.mega_md_steps.launches, tmega.mega_forward.launches
    out = bench.main(steps=3, reps=1, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and "cpu" in lines[0]
    last = json.loads(lines[-1])
    assert last == out
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["unit"] == "steps/s" and last["value"] > 0
    assert (tmega.mega_md_steps.launches,
            tmega.mega_forward.launches) == before
