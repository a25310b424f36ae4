"""Constrained replicas (md/simulate.py, md/constraints.py), the water
generators (physics/generate.py: stack_states, _record_seeds_batched,
generate_water_dataset, generate_tip4p_dataset) and the water protocol's
CLIs (generate_data, train_gamd --longrange --relabel --rigid_jitter,
evaluate, run_md and analyze_rollout on the result) on the CPU, against
the JAX package on the same numpy inputs where JAX can run the piece.

JAX's generators thermalise every seed for 5,000 steps, too slow on this
CPU, so they are held piece by piece from JAX's own state: FIRE on the
Ewald potential from the same start, and the recorded frames of a stacked
constrained state from JAX's starts and velocities. The recording runs
Langevin at zero friction in both packages (the noise term is multiplied
by zero), because a replica state's noise stream cannot be JAX's.
"""

import os
import re

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.md.constraints import RigidWater as JRigidWater
from gamd_tpu.md.simulate import Simulation as JSimulation
from gamd_tpu.physics import ewald as jewald
from gamd_tpu.physics import generate as jgen
from gamd_tpu.physics import water as jw
from gamd_tpu.physics.minimize import fire_minimize as jfire

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.md.constraints import RigidWater
from gamd_tpu_torch.md.simulate import Simulation, stack_states
from gamd_tpu_torch.physics import ewald as tewald
from gamd_tpu_torch.physics import generate as tgen
from gamd_tpu_torch.physics import water as tw
from gamd_tpu_torch.physics.minimize import fire_minimize
from gamd_tpu_torch.tools import (analyze_rollout, evaluate, generate_data,
                                  run_md, train_gamd)
from gamd_tpu_torch.train import checkpoint as tckpt
from gamd_tpu_torch.train.data import TrajectoryDataset

REPLICA_ATOL = 1e-5     # A and A/t0: R=2 in lockstep against single runs
FIRE_ATOL = 1e-4        # A: FIRE on the Ewald potential against JAX's
#: The recording from JAX's stacked state in the npz units, at
#: tests/test_torch_constraints.py's bars for a constrained run_recorded:
#: pos 1e-4 A, vel 1e-3 A/t0 (1 m/s; SETTLE's velocity correction divides
#: a position's rounding by dt), forces 1e-4 of the largest |F|.
RECORD_ATOL = {"pos": 1e-4, "vel": 1e-3 / 1e-3}
FORCE_RTOL = 1e-4
RESIDUAL = 1e-5         # A: SETTLE's constraint residual of a frame
BOX = 20.0
SMALL = dict(n_atoms=81, box=9.4, cutoff=4.2, nbr_capacity=64, skin=0.5)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for this file's tests, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rigid_start(n_mol, box, seed, sigma=0.1):
    """water_box with seeded noise snapped onto the constraints by JAX's
    project_initial, wrapped; float32 numpy."""
    base = jw.water_box(n_mol, box, seed=seed)
    rng = np.random.RandomState(seed)
    p = base + rng.normal(0.0, sigma, base.shape).astype(np.float32)
    p = np.asarray(JRigidWater(n_mol, box).project_initial(jnp.asarray(p)))
    return np.mod(p, box).astype(np.float32)


# -- constrained replicas ---------------------------------------------------------

@pytest.mark.parametrize("integrator", ["nve", "nose_hoover"])
def test_constrained_replicas_equal_single_runs(integrator):
    """R=2 rigid TIP3P-81 replicas of different starts (stack_states of two
    init_state) run in lockstep by run_replicas against each start's own
    run, 20 steps (rebuild every 10): positions and velocities within
    REPLICA_ATOL, the temperatures [R, steps], the residual under
    RESIDUAL."""
    system = tcfg.get_preset("tip3p", **SMALL)
    md = tcfg.MDConfig(integrator=integrator, temperature=300.0, dt_fs=2.0,
                       friction_per_ps=1.0, rebuild_every=10)
    cst = RigidWater(27, SMALL["box"])
    sim = Simulation(tw.tip3p_force_fn(SMALL["box"],
                                       tw.TIP3PParams(cutoff=4.5),
                                       rigid=True),
                     system, md, constraint=cst, device="cpu")
    singles = [sim.init_state(_rigid_start(27, SMALL["box"], seed=s),
                              rng=torch.Generator().manual_seed(s))
               for s in (1, 2)]
    res = sim.run_replicas(stack_states(singles), 20)
    assert res.thermo.temperature.shape == (2, 20)
    for r, single in enumerate(singles):
        one = sim.run(single, 20)
        np.testing.assert_allclose(res.state.pos[r].numpy(),
                                   one.state.pos.numpy(), rtol=0,
                                   atol=REPLICA_ATOL)
        np.testing.assert_allclose(res.state.vel[r].numpy(),
                                   one.state.vel.numpy(), rtol=0,
                                   atol=REPLICA_ATOL)
        np.testing.assert_allclose(res.thermo.temperature[r].numpy(),
                                   one.thermo.temperature.numpy(),
                                   rtol=1e-4)
    assert float(cst.residual(res.state.pos)) < RESIDUAL


def test_constrained_langevin_replicas_from_one_start():
    """init_replicas of one start under Langevin with the constraint: the
    velocities satisfy RATTLE's condition (projected as init_state's), and
    10 lockstep steps keep the residual under RESIDUAL, the replicas
    apart."""
    system = tcfg.get_preset("tip3p", **SMALL)
    md = tcfg.MDConfig(integrator="langevin", temperature=300.0, dt_fs=2.0,
                       friction_per_ps=2.0, rebuild_every=5)
    cst = RigidWater(27, SMALL["box"])
    sim = Simulation(tw.tip3p_force_fn(SMALL["box"],
                                       tw.TIP3PParams(cutoff=4.5),
                                       rigid=True),
                     system, md, constraint=cst, device="cpu")
    states = sim.init_replicas(_rigid_start(27, SMALL["box"], seed=3), 2)
    np.testing.assert_allclose(cst.velocities(states.pos, states.vel)
                               .numpy(), states.vel.numpy(), rtol=0,
                               atol=1e-6)
    res = sim.run_replicas(states, 10)
    assert float(cst.residual(res.state.pos)) < RESIDUAL
    assert float((res.state.pos[0] - res.state.pos[1]).abs().max()) > 1e-3


# -- the generators, piece by piece from JAX's state ------------------------------

def test_fire_on_the_ewald_potential_matches_jax():
    """FIRE, 20 steps at trust radius 0.05 A on the flexible TIP3P Ewald
    forces of generate_water_dataset, from water_box(258, 20 A, seed 0):
    within FIRE_ATOL of JAX's."""
    start = jw.water_box(258, BOX, seed=0)
    jew = jewald.make_ewald_params(BOX)
    jforce = jax.jit(lambda p: -jax.grad(jw.tip3p_energy_ewald)(
        p, BOX, jew, jw.TIP3PParams()))
    want, _ = jfire(jforce, jnp.asarray(start), n_steps=20, max_step=0.05)
    proto = tgen.water_protocol("tip3p", 258, device="cpu")
    got, _ = fire_minimize(proto.minimize_force, _t(start), n_steps=20,
                           max_step=0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FIRE_ATOL)


FRAMES, INTERVAL, N_MOL = 2, 4, 64


@pytest.fixture(scope="module")
def jax_recording(tmp_path_factory):
    """JAX's recording of two seeds' rigid TIP3P-192 Ewald states stacked
    (_stack_states, _record_seeds_batched: FRAMES frames every INTERVAL
    steps, Langevin at zero friction), from rigid starts with JAX's
    PRNGKey(2000 + seed) velocities."""
    system = jcfg.get_preset("tip3p", n_atoms=3 * N_MOL)
    md = jcfg.MDConfig(integrator="langevin", temperature=300.0, dt_fs=2.0,
                       friction_per_ps=0.0, rebuild_every=10)
    sim = JSimulation(jw.tip3p_force_fn(BOX, rigid=True,
                                        electrostatics="ewald"),
                      system, md, constraint=JRigidWater(N_MOL, BOX))
    jew = jewald.make_ewald_params(BOX)
    record = jax.jit(lambda p: -jax.grad(jw.tip3p_energy_rigid_ewald)(
        p, BOX, jew, jw.TIP3PParams()))
    states = [sim.init_state(jnp.asarray(_rigid_start(N_MOL, BOX, seed=s)),
                             rng=jax.random.PRNGKey(2000 + s))
              for s in (0, 1)]
    out = tmp_path_factory.mktemp("jax_water")
    jgen._record_seeds_batched(sim, jgen._stack_states(states), str(out),
                               [0, 1], FRAMES, INTERVAL, record, FRAMES, 0)
    return dict(pos=[np.asarray(st.pos) for st in states],
                vel=[np.asarray(st.vel) for st in states], dir=out)


def test_record_seeds_batched_matches_jax(jax_recording, tmp_path):
    """The port's _record_seeds_batched from JAX's two starts and
    velocities stacked (stack_states), the same Simulation and rigid Ewald
    recorded force, in blocks of one frame: the same files, pos and vel
    within RECORD_ATOL, forces within FORCE_RTOL of their max, frame 0
    the start."""
    system = tcfg.get_preset("tip3p", n_atoms=3 * N_MOL)
    md = tcfg.MDConfig(integrator="langevin", temperature=300.0, dt_fs=2.0,
                       friction_per_ps=0.0, rebuild_every=10)
    sim = Simulation(tw.tip3p_force_fn(BOX, rigid=True,
                                       electrostatics="ewald"),
                     system, md, constraint=RigidWater(N_MOL, BOX),
                     device="cpu")
    ew = tewald.make_ewald_params(BOX)
    record = lambda p: tewald.neg_grad(tw.tip3p_energy_rigid_ewald, p, BOX,
                                       ew)
    states = stack_states([sim.init_state(p, vel=v, rng=torch.Generator())
                           for p, v in zip(jax_recording["pos"],
                                           jax_recording["vel"])])
    tgen._record_seeds_batched(sim, states, str(tmp_path), [0, 1], FRAMES,
                               INTERVAL, record, 1, 0)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(os.listdir(jax_recording["dir"])) == sorted(
        f"data_{s}_{t}.npz" for s in (0, 1) for t in range(FRAMES))
    for name in names:
        with np.load(tmp_path / name) as a, \
                np.load(jax_recording["dir"] / name) as b:
            assert sorted(a) == sorted(b) == ["forces", "pos", "vel"]
            for key in ("pos", "vel", "forces"):
                assert a[key].dtype == b[key].dtype == np.float32
                assert a[key].shape == (3 * N_MOL, 3)
            for key, atol in RECORD_ATOL.items():
                np.testing.assert_allclose(a[key], b[key], rtol=0,
                                           atol=atol, err_msg=name)
            err = np.abs(a["forces"] - b["forces"]).max()
            assert err <= FORCE_RTOL * np.abs(b["forces"]).max(), name
    with np.load(tmp_path / "data_1_0.npz") as z:
        np.testing.assert_array_equal(z["pos"], np.mod(
            jax_recording["pos"][1], BOX))


def test_generators_write_jax_layouts(tmp_path):
    """generate_water_dataset (2 seeds from seed_start 3) and
    generate_tip4p_dataset (1 seed) on the CPU with FIRE, thermalisation
    and frames cut (32 molecules): the file names, float32 arrays, forces
    the rigid Ewald forces of each frame's pos in kJ/mol/nm, SETTLE's
    residual under RESIDUAL; TIP4P's O, H, H, M rows with M where JAX's
    expand_with_m_sites puts it (positions and velocities) and zero force,
    read by TrajectoryDataset without the M rows."""
    cut = dict(frames_per_seed=2, record_interval=2, n_molecules=32,
               minimize_steps=3, thermalize_steps=4, log_every_frames=0,
               frames_per_dispatch=1, device="cpu")
    w3 = tgen.generate_water_dataset(str(tmp_path / "w3"), seeds=2,
                                     seed_start=3, **cut)
    assert sorted(os.listdir(w3)) == sorted(
        f"data_{s}_{t}.npz" for s in (3, 4) for t in range(2))
    ew = tewald.make_ewald_params(BOX)
    cst = RigidWater(32, BOX)
    for name in os.listdir(w3):
        with np.load(os.path.join(w3, name)) as z:
            assert all(z[k].dtype == np.float32 and z[k].shape == (96, 3)
                       for k in ("pos", "vel", "forces"))
            pos = _t(z["pos"])
            want = tewald.neg_grad(tw.tip3p_energy_rigid_ewald, pos, BOX,
                                   ew).numpy() / 0.1
            np.testing.assert_allclose(z["forces"], want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
            assert float(cst.residual(pos)) < RESIDUAL
    w4 = tgen.generate_tip4p_dataset(str(tmp_path / "w4"), seeds=1, **cut)
    assert sorted(os.listdir(w4)) == ["data_0_0.npz", "data_0_1.npz"]
    params = jw.TIP4PEwParams()
    for name in os.listdir(w4):
        with np.load(os.path.join(w4, name)) as z:
            assert all(z[k].dtype == np.float32 and z[k].shape == (128, 3)
                       for k in ("pos", "vel", "forces"))
            real = np.arange(128) % 4 < 3
            pos4, f4 = jw.expand_with_m_sites(z["pos"][real],
                                              z["forces"][real], BOX, params)
            vel4, _ = jw.expand_with_m_sites(
                z["vel"][real], np.zeros((96, 3), np.float32), BOX, params)
            np.testing.assert_allclose(z["pos"], pos4, rtol=0, atol=1e-5)
            np.testing.assert_allclose(z["vel"], vel4, rtol=0, atol=1e-3)
            np.testing.assert_array_equal(z["forces"], f4)
            assert not z["forces"][3::4].any()
            assert float(cst.residual(_t(z["pos"][real]))) < RESIDUAL
    ds = TrajectoryDataset(w4, data_type="tip4p", sample_num=2, seed_num=1)
    assert ds[0]["pos"].shape == (96, 3)


# -- the CLIs, --cpu ----------------------------------------------------------------

def test_water_protocol_clis_on_cpu(tmp_path, capsys):
    """generate_data --system tip3p (2 seeds x 2 frames of TIP3P-774, FIRE
    and thermalisation cut) and --system tip4p (1 seed), then train_gamd
    --system tip3p --longrange --relabel --rigid_jitter --use_pallas on the
    TIP3P frames (widths 16, one layer), evaluate on its checkpoint, run_md
    --megakernel and analyze_rollout --megakernel --classical_baseline --pe
    on it: the files, finite losses, a long-range envelope, finite metrics
    and rollouts, the SETTLE residual; the parser errors of the water
    flags before any work."""
    cut = ["--cpu", "--frames", "2", "--interval", "2", "--minimize_steps",
           "3", "--thermalize_steps", "4", "--dispatch_frames", "2"]
    water = tmp_path / "water_data"
    generate_data.main(["--system", "tip3p", "--seeds", "2", "--out",
                        str(water)] + cut)
    assert len(os.listdir(water)) == 4
    assert "frames/s" in capsys.readouterr().out
    generate_data.main(["--system", "tip4p", "--seeds", "1", "--out",
                        str(tmp_path / "tip4p_data")] + cut)
    with np.load(tmp_path / "tip4p_data" / "data_0_1.npz") as z:
        assert z["pos"].shape == (4 * 251, 3)

    ck = tmp_path / "ck"
    logs = []
    train_gamd.main([
        "--system", "tip3p", "--data_dir", str(tmp_path), "--sample_num",
        "2", "--seed_num", "2", "--max_epoch", "1", "--encoding_size", "16",
        "--hidden_dim", "16", "--edge_embedding_dim", "16", "--conv_layer",
        "1", "--use_layer_norm", "--use_pallas", "--longrange", "--relabel",
        "--rigid_jitter", "--jitter_sigma", "0.02", "--cp_dir", str(ck),
        "--cpu"], log_fn=logs.append)
    assert any(line.startswith("Long-range split") for line in logs)
    losses = [float(x) for x in re.findall(r" loss=([-\d.e]+)",
                                           " ".join(logs))]
    assert len(losses) == 1 and np.isfinite(losses).all()
    path = str(ck / "checkpoint_0.msgpack")
    _, cfg, system = tckpt.load_self_describing(path)
    assert cfg.longrange == "ewald_recip" and system.name == "tip3p"

    metrics = evaluate.main(["--system", "tip3p", "--ckpt", path,
                             "--data_dir", str(water), "--sample_num", "2",
                             "--seed_num", "2", "--cpu"])
    assert metrics["frames"] == 1
    assert all(np.isfinite(np.asarray(v)).all() for v in metrics.values())

    init = str(tmp_path / "start.npy")
    with np.load(water / "data_0_1.npz") as z:
        np.save(init, z["pos"])
    run = run_md.rollout(run_md.build_parser().parse_args([
        "--system", "tip3p", "--ckpt", path, "--megakernel", "--friction",
        "25", "--init_pos", init, "--steps", "3", "--cpu", "--log",
        str(tmp_path / "log.txt")]))
    assert bool(torch.isfinite(run["result"].state.pos).all())
    assert float(run["constraint"].residual(run["result"].state.pos)) \
        < RESIDUAL

    report = analyze_rollout.main([
        "--system", "tip3p", "--ckpt", path, "--data_dir", str(water),
        "--megakernel", "--integrator", "langevin", "--friction", "25",
        "--steps", "40", "--classical_baseline", "--pe", "--cpu",
        "--json_out", str(tmp_path / "r.json")])
    for key in ("rdf_l2", "rdf_l2_vs_classical_rollout", "temperature_mean",
                "classical_temperature_mean", "pe_gnn_mean_kj_mol",
                "pe_classical_mean_kj_mol"):
        assert np.isfinite(report[key]), key
    assert os.path.exists(str(tmp_path / "r.json") + "_pe.tsv")

    base = ["--data_dir", str(tmp_path / "none"), "--cpu", "--cp_dir",
            str(tmp_path / "ck2")]
    for flags in (["--system", "lj", "--longrange"],
                  ["--system", "tip3p", "--longrange", "--no_pack"],
                  ["--system", "tip3p", "--rigid_jitter"],
                  ["--system", "lj", "--rigid_jitter", "--relabel"],
                  ["--system", "tip4p", "--relabel"]):
        with pytest.raises(SystemExit):
            train_gamd.main(flags + base)
    assert not os.path.exists(tmp_path / "ck2")
