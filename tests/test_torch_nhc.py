"""Port parity of the integrator slice on the CPU: the Nose-Hoover chain
half-step (the plain version of the CUDA nhc_half_step) against JAX's
_nhc_propagate; the plain chain of nhc_chain_probe against
scripts/probe_nhc_kernel.py's two Pallas kernels in interpret mode, and
the warp kernel's schedule in PyTorch against the plain chain bit for
bit and against the vector kernel;
velocity_verlet, nose_hoover_chain and andersen step functions;
nhc_bath_energies; Simulation under NVE, NHC and Andersen; and
run_recorded. Each test feeds the same seeded numpy inputs to the JAX
function and to its port and states its tolerance. The kernels themselves
are held against their plain versions in tests/test_torch_cuda.py and
chip_smoke.py, on the card.
"""

import functools
import importlib.util
import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.md import integrators as jinteg
from gamd_tpu.md.simulate import Simulation as JSimulation
from gamd_tpu.models.normalizer import stat_from_values
from gamd_tpu.physics import lennard_jones as jlj
from gamd_tpu.train.forcefield import GNNForceField as JForceField
from gamd_tpu.train.state import build_model, create_train_state

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.core import units
from gamd_tpu_torch.md import integrators as tinteg
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.ops import nhc
from gamd_tpu_torch.physics import lennard_jones as tlj
from gamd_tpu_torch.tools import probe_nhc_kernel as tprobe
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.state import (ForceFieldState, params_from_jax,
                                        stat_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 64
M = 10
MASS = 39.948
TEMP = 100.0
FREQ = 2.5                     # 25 / ps in 1/t0
KT = units.KB * TEMP
DT = 2.0 * units.FS
BOX_LJ, LATTICE = jlj.lj_fluid_box(N, 0.5)     # 17.2 A at rho* = 0.5
LJ64 = dict(n_atoms=N, box=BOX_LJ)
SMALL = dict(encoding_size=32, hidden_dim=32, edge_embedding_dim=32,
             conv_layers=2)
#: _nhc_propagate, port against JAX: max |d| / max |x| of each tensor. Both
#: sides run the same float32 operations in the same order; the sums of
#: m v^2 and the exp implementations (XLA's, PyTorch's vectorised one)
#: differ in the last bits, 1.8e-6 of max |g| at most on these cases.
NHC_RTOL = 5e-6


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for this file's tests (small tensors), restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(port, ref, rtol, what=""):
    """max |port - ref| <= rtol * max |ref| for a torch/jax pair."""
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = float(np.abs(port - ref).max())
    scale = float(np.abs(ref).max())
    assert err <= rtol * scale, (what, err, scale)
    return err / scale


def _chain_case(batch, seed=0):
    """Thermal velocities [*batch, N, 3] (slightly hot), argon masses and a
    seeded chain [*batch, M] (numpy float32)."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    sigma = np.sqrt(units.KB * TEMP * 1.1 / MASS)
    vel = (sigma * rng.standard_normal((*lead, N, 3))).astype(np.float32)
    xi = rng.normal(0, 0.1, (*lead, M)).astype(np.float32)
    vxi = rng.normal(0, 0.5, (*lead, M)).astype(np.float32)
    g = (-FREQ**2 + rng.normal(0, 1.0, (*lead, M))).astype(np.float32)
    return vel, xi, vxi, g, np.full(N, MASS, np.float32)


@pytest.mark.parametrize("n_ys,batch,given_ke2", [
    (1, None, False), (3, None, False), (5, None, False),
    (5, 3, False),                 # three independent chains
    (5, None, True), (5, 3, True),  # ke2 supplied from outside
])
def test_nhc_propagate_matches_jax(n_ys, batch, given_ke2):
    """One half-step, N=64, M=10, n_c=5: vel, xi, vxi and g within
    NHC_RTOL of each tensor's max."""
    vel, xi, vxi, g, masses = _chain_case(batch)
    ndf = 3 * N
    q = tinteg.nhc_masses(KT, FREQ, M, ndf)
    ys = tinteg._YS_WEIGHTS[n_ys]
    ke2 = None
    if given_ke2:       # 2 KE of other (e.g. all slabs') velocities
        ke2 = np.asarray(ndf * KT * (1.0 + 0.05 * np.arange(
            1 if batch is None else batch)), np.float32).reshape(
                () if batch is None else (batch,))
    ref = jinteg._nhc_propagate(
        jnp.asarray(vel), jnp.asarray(xi), jnp.asarray(vxi), jnp.asarray(g),
        jnp.asarray(masses), KT, ndf, jnp.asarray(q.numpy()), DT, 5, ys,
        ke2=None if ke2 is None else jnp.asarray(ke2))
    out = tinteg._nhc_propagate(
        torch.as_tensor(vel), torch.as_tensor(xi), torch.as_tensor(vxi),
        torch.as_tensor(g), torch.as_tensor(masses), KT, ndf, q, DT, 5, ys,
        ke2=None if ke2 is None else torch.as_tensor(ke2))
    for name, a, b in zip(("vel", "xi", "vxi", "g"), out, ref):
        _close(a.numpy(), b, NHC_RTOL, name)
    # The wrapper takes the plain version on a CPU tensor.
    wdts = tinteg.nhc_schedule(DT, 5, ys)
    out2 = nhc.nhc_half_step(
        torch.as_tensor(vel), torch.as_tensor(xi), torch.as_tensor(vxi),
        torch.as_tensor(g), torch.as_tensor(masses), KT, ndf, q, wdts,
        ke2=None if ke2 is None else torch.as_tensor(ke2))
    assert all(torch.equal(a, b) for a, b in zip(out, out2))


def test_nhc_schedule_and_masses_round_as_jax():
    """The schedule and the chain masses are JAX's float32 values, bit for
    bit (integrators.py:231-232, 260-263)."""
    ys = tinteg._YS_WEIGHTS[5]
    jw = np.asarray(jnp.asarray(np.tile(np.asarray(ys, np.float64), 5),
                                jnp.float32) * DT / 5)
    np.testing.assert_array_equal(tinteg.nhc_schedule(DT, 5, ys).numpy(), jw)
    q_single = KT / FREQ**2
    jq = np.asarray(jnp.concatenate([jnp.array([192 * q_single]),
                                     jnp.full((M - 1,), q_single)]))
    np.testing.assert_array_equal(tinteg.nhc_masses(KT, FREQ, M, 192)
                                  .numpy(), jq)


def _load_jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_nhc_kernel",
        os.path.join(REPO, "scripts", "probe_nhc_kernel.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def _pallas_probe(form, reps=3):
    """(xi, vxi, g, product of the scales, last ke2) of the probe's Pallas
    kernel of `form` in interpret mode (scalar: _make_kernel_scalar, SMEM;
    warp: _make_kernel_vector, [1, 128] lanes) at `reps` on the probe's
    constants and schedule, as numpy."""
    jp = _load_jax_probe()
    inputs = tprobe.probe_inputs("cpu")
    q = [float(v) for v in inputs["q"]]
    kt, ndf = tprobe.KT, tprobe.NDF
    wdts = jp._schedule(tprobe.DT)
    assert np.array_equal(np.float32(wdts), inputs["wdts"].numpy())
    xi0, vxi0, g0 = (inputs[k].numpy() for k in ("xi", "vxi", "g"))
    ke2 = float(inputs["ke2"][0])
    if form == "scalar":
        call = jp._make_kernel_scalar(wdts, q, kt, ndf, reps, interpret=True)
        outs = call(jnp.asarray(xi0), jnp.asarray(vxi0), jnp.asarray(g0),
                    jnp.asarray([ke2], jnp.float32))
        j_xi, j_vxi, j_g, aux = [np.asarray(o) for o in outs]
        return j_xi, j_vxi, j_g, aux[0], aux[1]
    pad = lambda a: np.pad(a, (0, jp.LANES - M)).reshape(1, jp.LANES)
    call = jp._make_kernel_vector(wdts, q, kt, ndf, reps, interpret=True)
    outs = call(*[jnp.asarray(pad(a).astype(np.float32)) for a in (
        xi0, vxi0, g0, np.array([ke2] + [0.0] * (M - 1), np.float32))])
    j_xi, j_vxi, j_g = [np.asarray(o)[0, :M] for o in outs[:3]]
    return j_xi, j_vxi, j_g, np.asarray(outs[3])[0, 0], \
        np.asarray(outs[3])[0, 1]


def _probe_err(out, pallas):
    """max |d| over xi, vxi, g and the product of the scales, and |d| of
    the last ke2."""
    xi, vxi, g, total, ke2 = (np.asarray(t) for t in out)
    j_xi, j_vxi, j_g, j_total, j_ke2 = pallas
    err = max(float(np.abs(xi - j_xi).max()), float(np.abs(vxi - j_vxi).max()),
              float(np.abs(g - j_g).max()), abs(float(total) - float(j_total)))
    return err, abs(float(ke2) - float(j_ke2))


@pytest.mark.parametrize("form", ["scalar", "warp"])
def test_probe_chain_matches_pallas_probe_kernels(form):
    """nhc_chain_probe's plain chain (both forms compute it) at reps = 3
    against the probe's Pallas kernel of the same form in interpret mode
    (scalar: _make_kernel_scalar, SMEM; warp: _make_kernel_vector, [1,128]
    lanes), on the probe's constants and schedule: within 1e-4 absolute,
    the probe's parity scale, on xi, vxi, g, the product of the scales and
    the final ke2; and the probe's reference (_nhc_propagate on a carrier)
    within the same scale."""
    inputs = tprobe.probe_inputs("cpu")
    out = tprobe.run_form(inputs, form, 3)
    err, ke2_err = _probe_err(out, _pallas_probe(form))
    assert err <= tprobe.PARITY_ATOL, err
    assert ke2_err <= tprobe.PARITY_ATOL * float(inputs["ke2"][0])
    assert tprobe.parity_error(out, tprobe.reference(inputs, 3)) \
        <= tprobe.PARITY_ATOL


def _probe_args(m):
    inputs = tprobe.probe_inputs("cpu", m)
    args = [inputs[k] for k in ("xi", "vxi", "g", "ke2", "q", "kt", "ndf",
                                "wdts")]
    args[3] = args[3].reshape(())
    return args


@pytest.mark.parametrize("reps", [3, 400])
@pytest.mark.parametrize("m", [1, 2, 10, 16])
def test_warp_schedule_is_the_plain_chain_bit_for_bit(m, reps):
    """nhc_probe_warp_reference, the warp kernel's schedule (element j's
    updates masked on [m] vectors, neighbours by a shift, the forward
    sweep's m - 1 exponentials one vector exp before the sweep, the scale
    on element 0 only), equals nhc_probe_reference bit for bit in all five
    outputs at reps 3 and 400 for chains of 1, 2, 10 and 16 on the probe's
    constants: the same float32 operations in the same order."""
    args = _probe_args(m)
    warp = nhc.nhc_probe_warp_reference(*args, reps)
    plain = nhc.nhc_probe_reference(*args, reps)
    assert warp[0].shape == (m,)
    for a, b in zip(warp, plain):
        assert torch.equal(a, b), (m, reps, a, b)


def test_warp_schedule_matches_pallas_vector_kernel():
    """nhc_probe_warp_reference at reps 3 within 1e-4 absolute (the
    probe's parity scale) of _make_kernel_vector in interpret mode on the
    probe's constants, in xi, vxi, g, the product of the scales and the
    last ke2 (the latter relative to ke2)."""
    args = _probe_args(M)
    err, ke2_err = _probe_err(nhc.nhc_probe_warp_reference(*args, 3),
                              _pallas_probe("warp"))
    assert err <= tprobe.PARITY_ATOL, err
    assert ke2_err <= tprobe.PARITY_ATOL * float(args[3])


def test_probe_tool_on_cpu(capsys):
    """tools/probe_nhc_kernel.py --cpu: parity of both forms, no times."""
    results = tprobe.main(["--cpu"])
    assert set(results) == {"scalar", "warp"}
    for entry in results.values():
        assert entry["parity_err"] <= tprobe.PARITY_ATOL
        assert entry["us_per_half_step"] is None
    assert "probe done" in capsys.readouterr().out


def test_nhc_wrappers_refuse_what_they_do_not_take():
    """A meta tensor is neither CPU nor CUDA; the probe's form and reps are
    checked before any device work."""
    x = torch.zeros((4, 3), device="meta")
    chain = torch.zeros(M, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        nhc.nhc_half_step(x, chain, chain, chain, None, KT, 12, None, None)
    inputs = tprobe.probe_inputs("cpu")
    with pytest.raises(ValueError, match="form"):
        tprobe.run_form(inputs, "vector", 3)
    with pytest.raises(ValueError, match="reps"):
        tprobe.run_form(inputs, "scalar", 0)


# -- step functions ---------------------------------------------------------

def _harmonic(k=0.5):
    return (lambda pos: -k * pos), (lambda pos: -k * pos)


def _lj():
    return ((lambda pos: jlj.lj_forces_dense(pos, BOX_LJ)),
            (lambda pos: tlj.lj_forces_dense(pos, BOX_LJ)))


def _lj_start(seed, sigma=0.05):
    rng = np.random.default_rng(seed)
    pos = (LATTICE + rng.normal(0, sigma, LATTICE.shape)).astype(np.float32)
    vel = (np.sqrt(units.KB * TEMP / MASS)
           * rng.standard_normal((N, 3))).astype(np.float32)
    return pos, vel


@pytest.mark.parametrize("integrator", ["nve", "nose_hoover", "andersen"])
@pytest.mark.parametrize("force", ["harmonic", "lj"])
def test_step_functions_match_jax(integrator, force):
    """10 steps of each step function from the same positions and
    velocities (Andersen with the same (u, xi) draws; harmonic k = 0.5,
    or classical LJ at N=64): positions within 1e-4 A, velocities within
    1e-4 A/t0, and the NHC chain within 1e-5 of each tensor's max."""
    jforce, tforce = _harmonic() if force == "harmonic" else _lj()
    pos, vel = _lj_start(seed=1)
    masses = np.full(N, MASS, np.float32)
    jm, tm = jnp.asarray(masses), torch.as_tensor(masses)
    steps = 10
    if integrator == "nve":
        j_init, j_step = jinteg.velocity_verlet(jforce, DT, jm)
        t_init, t_step = tinteg.velocity_verlet(tforce, DT, tm)
        js, ts = j_init(jnp.asarray(pos), jnp.asarray(vel)), \
            t_init(torch.as_tensor(pos), torch.as_tensor(vel))
    elif integrator == "nose_hoover":
        kw = dict(frequency=FREQ, chain_length=M, n_c=5, n_ys=5)
        j_init, j_step = jinteg.nose_hoover_chain(jforce, DT, jm, TEMP, **kw)
        t_init, t_step = tinteg.nose_hoover_chain(tforce, DT, tm, TEMP, **kw)
        js, ts = j_init(jnp.asarray(pos), jnp.asarray(vel)), \
            t_init(torch.as_tensor(pos), torch.as_tensor(vel))
    else:
        j_init, j_step = jinteg.andersen(jforce, DT, jm, TEMP, FREQ)
        t_init, t_step = tinteg.andersen(tforce, DT, tm, TEMP, FREQ)
        js = j_init(jnp.asarray(pos), jnp.asarray(vel), jax.random.PRNGKey(0))
        ts = t_init(torch.as_tensor(pos), torch.as_tensor(vel),
                    torch.Generator().manual_seed(0))
        rng = np.random.default_rng(2)
        noise = [(rng.uniform(size=(N, 3)).astype(np.float32),
                  rng.standard_normal((N, 3)).astype(np.float32))
                 for _ in range(steps)]
    j_step = jax.jit(j_step)
    for i in range(steps):
        if integrator == "andersen":
            u, xi = noise[i]
            js = j_step(js, (jnp.asarray(u), jnp.asarray(xi)))
            ts = t_step(ts, (torch.as_tensor(u), torch.as_tensor(xi)))
        else:
            js, ts = j_step(js), t_step(ts)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), atol=1e-4)
    np.testing.assert_allclose(ts.vel.numpy(), np.asarray(js.vel), atol=1e-4)
    np.testing.assert_allclose(ts.force.numpy(), np.asarray(js.force),
                               atol=1e-3)
    if integrator == "nose_hoover":
        for name in ("xi", "vxi", "g"):
            _close(getattr(ts, name).numpy(), getattr(js, name), 1e-5, name)
        assert not np.allclose(ts.vxi.numpy(), 0.0)
    if integrator == "andersen":
        collided = sum(int((u < DT * FREQ).sum()) for u, _ in noise)
        assert collided > 0


def test_nhc_bath_energies_match_jax():
    """Heat-bath KE and PE of a batch of seeded chains [3, M]: rtol 1e-6."""
    _, xi, vxi, g, _ = _chain_case(3, seed=4)
    ndf = 3 * N
    zeros = np.zeros((3, N, 3), np.float32)
    js = jinteg.NoseHooverState(*(jnp.asarray(zeros),) * 3, jnp.asarray(xi),
                                jnp.asarray(vxi), jnp.asarray(g))
    ts = tinteg.NoseHooverState(*(torch.as_tensor(zeros),) * 3,
                                torch.as_tensor(xi), torch.as_tensor(vxi),
                                torch.as_tensor(g))
    for a, b in zip(tinteg.nhc_bath_energies(ts, TEMP, FREQ, ndf),
                    jinteg.nhc_bath_energies(js, TEMP, FREQ, ndf)):
        assert a.shape == (3,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# -- Simulation -------------------------------------------------------------

def _md(integrator, **kw):
    base = dict(integrator=integrator, temperature=TEMP, dt_fs=2.0,
                friction_per_ps=25.0, rebuild_every=20)
    base.update(kw)
    return jcfg.MDConfig(**base), tcfg.MDConfig(**base)


def _gnn_force_fields():
    """(JAX, port) eager force fields on the same small weights (widths 32,
    2 conv layers) with non-trivial scalers, LJ-64."""
    jsystem = jcfg.get_preset("lj", **LJ64)
    jmodel_cfg = jcfg.ModelConfig(**SMALL)
    state = create_train_state(build_model(jmodel_cfg, jsystem), jsystem,
                               jcfg.TrainConfig(), 1)
    state = state.replace(force_stat=stat_from_values(0.0, 400.0, 10.0),
                          length_stat=stat_from_values(5.5, 1.6, 10.0))
    port_state = ForceFieldState(
        params=params_from_jax(state.params), batch_stats={},
        force_stat=stat_from_jax(state.force_stat),
        length_stat=stat_from_jax(state.length_stat))
    ff = GNNForceField(port_state, tcfg.get_preset("lj", **LJ64),
                       tcfg.ModelConfig(**SMALL), device="cpu")
    return (JForceField(state, jsystem, jmodel_cfg).force_fn(),
            ff.force_fn())


@pytest.mark.parametrize("integrator", ["nve", "nose_hoover"])
@pytest.mark.parametrize("force", ["lj", "gnn"])
def test_simulation_tracks_jax(integrator, force):
    """40 steps with a rebuild every 20 from the same positions and
    velocities, on classical LJ or a small GAMD model (widths 32, 2 conv
    layers) through the weights carried across: positions within 1e-4 A,
    KE per step within rtol 1e-4, the NHC chain within 1e-4 of its max."""
    if force == "lj":
        jfn, tfn = jlj.lj_force_fn(BOX_LJ), tlj.lj_force_fn(BOX_LJ)
    else:
        jfn, tfn = _gnn_force_fields()
    jmd, tmd = _md(integrator)
    jsim = JSimulation(jfn, jcfg.get_preset("lj", **LJ64), jmd)
    sim = Simulation(tfn, tcfg.get_preset("lj", **LJ64), tmd, device="cpu")
    pos, vel = _lj_start(seed=3)
    r_j = jsim.run(jsim.init_state(jnp.asarray(pos), vel=jnp.asarray(vel)),
                   40)
    r_t = sim.run(sim.init_state(pos, vel=vel), 40)
    np.testing.assert_allclose(r_t.state.pos.numpy(),
                               np.asarray(r_j.state.pos), atol=1e-4)
    np.testing.assert_allclose(r_t.thermo.kinetic_energy.numpy(),
                               np.asarray(r_j.thermo.kinetic_energy),
                               rtol=1e-4)
    assert r_t.overflow is False and not bool(r_j.overflow)
    assert r_t.positions.shape == (2, N, 3)
    if integrator == "nose_hoover":
        assert isinstance(r_t.state, tinteg.NoseHooverState)
        for name in ("xi", "vxi", "g"):
            _close(getattr(r_t.state, name).numpy(),
                   getattr(r_j.state, name), 1e-4, name)
    else:
        assert isinstance(r_t.state, tinteg.NVEState)


def test_simulation_draws_noise_only_for_stochastic_integrators():
    """NVE and NHC states carry no generator and a run draws nothing from
    the one that made the velocities; Andersen draws two blocks (uniform
    and normal) a chunk from the state's generator."""
    system = tcfg.get_preset("lj", **LJ64)
    pos, _ = _lj_start(seed=6)
    for integrator in ("nve", "nose_hoover"):
        sim = Simulation(tlj.lj_force_fn(BOX_LJ), system,
                         _md(integrator)[1], device="cpu")
        gen = torch.Generator().manual_seed(5)
        state = sim.init_state(pos, rng=gen)
        assert not hasattr(state, "rng")
        before = gen.get_state()
        sim.run(state, 3)
        assert torch.equal(gen.get_state(), before)
    sim = Simulation(tlj.lj_force_fn(BOX_LJ), system, _md("andersen")[1],
                     device="cpu")
    gen = torch.Generator().manual_seed(5)
    state = sim.init_state(pos, rng=gen)
    assert state.rng is gen
    twin = torch.Generator().manual_seed(5)
    torch.randn((N, 3), generator=twin)          # the velocities' draw
    sim.run(state, 3)
    torch.rand((3, N, 3), generator=twin)
    torch.randn((3, N, 3), generator=twin)
    assert torch.equal(gen.get_state(), twin.get_state())


def test_andersen_simulation_holds_temperature():
    """Simulation under Andersen, the free-particle thermostat run of
    tests/test_integrators.py: 64 weakly bound oscillators (k = 0.5, mass
    12) at 300 K, 2 fs, 25 / ps, 4000 steps; the mean temperature of the
    second half within 10% of the target. The oscillators sit at the
    centre of a 40 A box, so the wrap never acts."""
    box, k = 40.0, 0.5
    system = tcfg.get_preset("lj", n_atoms=N, box=box, cutoff=3.0,
                             nbr_capacity=8, skin=0.5, masses=(12.0,))
    md = tcfg.MDConfig(integrator="andersen", temperature=300.0, dt_fs=2.0,
                       friction_per_ps=25.0, rebuild_every=200)
    centre = box / 2

    def force(posw, idx, mask):
        return -k * (posw - centre)

    sim = Simulation(force, system, md, device="cpu")
    rng = np.random.default_rng(0)
    pos = (centre + rng.standard_normal((N, 3))).astype(np.float32)
    state = sim.init_state(pos, rng=torch.Generator().manual_seed(1))
    temps = sim.run(state, 4000).thermo.temperature
    assert float(temps[2000:].mean()) == pytest.approx(300.0, rel=0.1)


def test_run_recorded_matches_jax():
    """run_recorded under NHC on classical LJ at N=64: 5 frames every 30
    steps with rebuild_every 20, so chunks of 15 (the largest divisor of
    30 up to 20): frame 0 is the start, the frames (positions, velocities,
    recorded forces) within 1e-4 and the temperatures within rtol 1e-4 of
    JAX's run_recorded, and the final state likewise."""
    jmd, tmd = _md("nose_hoover")
    jsim = JSimulation(jlj.lj_force_fn(BOX_LJ), jcfg.get_preset("lj", **LJ64),
                       jmd)
    sim = Simulation(tlj.lj_force_fn(BOX_LJ), tcfg.get_preset("lj", **LJ64),
                     tmd, device="cpu")
    pos, vel = _lj_start(seed=7)
    jrec = jsim.run_recorded(
        jsim.init_state(jnp.asarray(pos), vel=jnp.asarray(vel)), 5, 30,
        lambda p: jlj.lj_forces_dense(p, BOX_LJ))
    calls = []

    def chunk(state, n_steps):
        calls.append(n_steps)
        return Simulation._chunk(sim, state, n_steps)

    sim._chunk = chunk
    trec = sim.run_recorded(sim.init_state(pos, vel=vel), 5, 30,
                            lambda p: tlj.lj_forces_dense(p, BOX_LJ))
    assert calls == [15] * 10
    state, ovf, f_pos, f_vel, f_force, temp = trec
    assert ovf is False and not bool(jrec[1])
    assert f_pos.shape == f_vel.shape == f_force.shape == (5, N, 3)
    assert temp.shape == (5,)
    np.testing.assert_array_equal(f_vel[0].numpy(), vel)
    np.testing.assert_allclose(f_pos[0].numpy(), np.asarray(jrec[2][0]),
                               atol=1e-6)
    for a, b, tol in ((f_pos, jrec[2], 1e-4), (f_vel, jrec[3], 1e-4),
                      (f_force, jrec[4], 1e-3),
                      (state.pos, jrec[0].pos, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)
    np.testing.assert_allclose(temp.numpy(), np.asarray(jrec[5]), rtol=1e-4)
