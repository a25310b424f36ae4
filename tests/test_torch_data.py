"""LJ data generation, the trajectory dataset and the dataset packer of the
PyTorch port (gamd_tpu_torch.physics.generate, .train.data,
.train.native_io, .tools.generate_data) against the JAX package on the
CPU. Each test feeds the same numpy inputs (or the same files) to both
packages and states its tolerance.

The generator's velocities cannot match JAX's (PRNGKey(1000 + seed)
against a torch generator), so its start lattice is held bit for bit, FIRE
within a tolerance, and the recording from JAX's own initial state. The
JAX oracle of the generator runs once, in a module-scoped fixture, at the
protocol's N = 258 with its steps cut: FIRE_STEPS FIRE steps, FRAMES
frames every INTERVAL steps.
"""

import os
import shutil

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.core import space as jspace
from gamd_tpu.md.simulate import Simulation as JSimulation
from gamd_tpu.physics import generate as jgen
from gamd_tpu.physics import lennard_jones as jlj
from gamd_tpu.physics.minimize import fire_minimize as jfire
from gamd_tpu.train import data as jdata

from gamd_tpu_torch.physics import generate as tgen
from gamd_tpu_torch.physics import lennard_jones as tlj
from gamd_tpu_torch.physics.minimize import fire_minimize
from gamd_tpu_torch.tools import generate_data
from gamd_tpu_torch.train import data as tdata
from gamd_tpu_torch.train import native_io

SEED = 3
FIRE_STEPS, FRAMES, INTERVAL = 20, 3, 5
SAMPLES = 10           # frames a seed of the dataset tests' files
#: FIRE, port against JAX after FIRE_STEPS steps: max |dx| in A. Both run
#: the same float32 steps; the force sums differ in order (XLA's and
#: PyTorch's reductions), and FIRE's power test and norms carry that on.
FIRE_ATOL = 1e-4
#: The recording from JAX's initial state, after FRAMES x INTERVAL NHC
#: steps, in the npz units: pos A, vel m/s (1e-4 A/t0, the run_recorded
#: parity bar of tests/test_torch_nhc.py), forces kJ/mol/nm (1e-3
#: kJ/mol/A there).
RECORD_ATOL = {"pos": 1e-4, "vel": 1e-4 / 1e-3, "forces": 1e-3 * 10.0}


# -- the dataset ------------------------------------------------------------

def _write_frames(d, n_rows, seeds, samples, seed, f64_every=0):
    """Seeded frames data_{s}_{t}.npz in d; every f64_every-th frame's
    arrays float64 (both loaders convert)."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    flat = 0
    for s in range(seeds):
        for t in range(samples):
            dtype = (np.float64 if f64_every and flat % f64_every == 0
                     else np.float32)
            np.savez(d / f"data_{s}_{t}.npz",
                     **{k: rng.randn(n_rows, 3).astype(dtype)
                        for k in ("pos", "vel", "forces")})
            flat += 1
    return str(d)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """{data_type: directory}: 3 seeds x SAMPLES frames of 12 atoms
    (TIP4P: 16 rows, an M site every 4th)."""
    root = tmp_path_factory.mktemp("frames")
    return {"lj": _write_frames(root / "lj", 12, 3, SAMPLES, 0, f64_every=7),
            "tip3p": _write_frames(root / "tip3p", 12, 3, SAMPLES, 1),
            "tip4p": _write_frames(root / "tip4p", 16, 3, SAMPLES, 2)}


def _same_items(a, b):
    assert len(a) == len(b)
    np.testing.assert_array_equal(a.idx, b.idx)
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert sorted(x) == sorted(y)
        for key in x:
            assert x[key].dtype == y[key].dtype
            np.testing.assert_array_equal(x[key], y[key])


@pytest.mark.parametrize("n_total,fraction", [(10, 0.9), (10_000, 0.9),
                                              (7, 0.5), (120, 0.8)])
def test_reference_split_matches_jax(n_total, fraction):
    """The 90/10 split (RandomState(0) shuffle): exact."""
    for a, b in zip(tdata.reference_split(n_total, fraction),
                    jdata.reference_split(n_total, fraction)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("data_type", ["lj", "tip3p", "tip4p"])
@pytest.mark.parametrize("mode,extra", [("train", 0), ("test", 0),
                                        ("train", 1), ("test", 1)])
def test_trajectory_dataset_matches_jax(frames, data_type, mode, extra):
    """Ids, frames (pos, forces; the water one-hot) and batch_iterator's
    batches, shuffled and in order, with and without drop_last: exact.
    TIP4P drops every 4th row; extra_seed_num adds the third seed to the
    train set only."""
    kw = dict(sample_num=SAMPLES, seed_num=2, mode=mode, data_type=data_type,
              extra_seed_num=extra)
    ours = tdata.TrajectoryDataset(frames[data_type], **kw)
    ref = jdata.TrajectoryDataset(frames[data_type], **kw)
    _same_items(ours, ref)
    assert ours.n_atoms == ref.n_atoms == 12
    for bkw in (dict(batch_size=2), dict(batch_size=1, shuffle=False),
                dict(batch_size=3, seed=4, drop_last=False)):
        got = list(tdata.batch_iterator(ours, **bkw))
        want = list(jdata.batch_iterator(ref, **bkw))
        assert len(got) == len(want) > 0
        for x, y in zip(got, want):
            assert sorted(x) == sorted(y)
            for key in x:
                np.testing.assert_array_equal(x[key], y[key])


@pytest.mark.parametrize("data_type", ["lj", "tip4p"])
def test_pack_cache_matches_jax(frames, tmp_path, data_type):
    """The pack cache (the port's native packer where g++ builds it, else
    numpy) holds JAX's cache's arrays bit for bit, its dataset gives JAX's
    items, a second construction reads it back, and a cache of another
    frame count raises ValueError in both packages."""
    kw = dict(sample_num=SAMPLES, seed_num=2, data_type=data_type,
              extra_seed_num=1)
    ours_path, ref_path = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    ours = tdata.TrajectoryDataset(frames[data_type],
                                   pack_cache=ours_path, **kw)
    ref = jdata.TrajectoryDataset(frames[data_type], pack_cache=ref_path,
                                  **kw)
    with np.load(ours_path) as a, np.load(ref_path) as b:
        assert a["pos"].shape == (3 * SAMPLES, 12, 3)
        for key in ("pos", "forces"):
            assert a[key].dtype == b[key].dtype == np.float32
            np.testing.assert_array_equal(a[key], b[key])
    _same_items(ours, ref)
    _same_items(tdata.TrajectoryDataset(frames[data_type],
                                        pack_cache=ours_path, **kw), ref)
    stale = dict(kw, extra_seed_num=0)
    with pytest.raises(ValueError, match="stale"):
        tdata.TrajectoryDataset(frames[data_type], pack_cache=ours_path,
                                **stale)
    with pytest.raises(ValueError, match="stale"):
        jdata.TrajectoryDataset(frames[data_type], pack_cache=ref_path,
                                **stale)


def test_native_packer_matches_numpy_pack(frames, tmp_path):
    """native_io.pack_trajectory (built with g++ into build/gamd_tpu_torch)
    against the numpy pack, bit for bit (float64 frames converted, TIP4P's
    M sites dropped); a compressed archive raises RuntimeError, and the
    dataset then packs with numpy."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native packer cannot build")
    assert native_io.available()
    assert native_io.library_path().exists()
    for data_type in ("lj", "tip4p"):
        ds = tdata.TrajectoryDataset(frames[data_type], sample_num=SAMPLES,
                                     seed_num=3, data_type=data_type)
        got = native_io.pack_trajectory(frames[data_type], 3, SAMPLES, 12,
                                        drop_m_site=data_type == "tip4p")
        want = tdata.pack_numpy(ds, 3 * SAMPLES)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    zipped = tmp_path / "zipped"
    zipped.mkdir()
    rng = np.random.RandomState(5)
    for t in range(2):
        np.savez_compressed(zipped / f"data_0_{t}.npz",
                            pos=rng.randn(6, 3).astype(np.float32),
                            forces=rng.randn(6, 3).astype(np.float32))
    with pytest.raises(RuntimeError, match="failed"):
        native_io.pack_trajectory(str(zipped), 1, 2, 6)
    ds = tdata.TrajectoryDataset(str(zipped), sample_num=2, seed_num=1,
                                 split=(1.0, 0.0),
                                 pack_cache=str(tmp_path / "z.npz"))
    ref = jdata.TrajectoryDataset(str(zipped), sample_num=2, seed_num=1,
                                  split=(1.0, 0.0))
    _same_items(ds, ref)


def test_subtract_from_labels_matches_jax(frames, tmp_path):
    """subtract_from_labels on the pack cache: exact against JAX's, the
    cache on disk unchanged; without the cache both raise ValueError."""
    offset = lambda p: 0.25 * np.asarray(p) - 1.0
    kw = dict(sample_num=SAMPLES, seed_num=3)
    ours = tdata.TrajectoryDataset(frames["lj"],
                                   pack_cache=str(tmp_path / "t.npz"), **kw)
    ref = jdata.TrajectoryDataset(frames["lj"],
                                  pack_cache=str(tmp_path / "j.npz"), **kw)
    ours.subtract_from_labels(offset, chunk=5)
    ref.subtract_from_labels(offset, chunk=5)
    _same_items(ours, ref)
    with np.load(tmp_path / "t.npz") as z:
        np.testing.assert_array_equal(
            z["forces"], tdata.pack_numpy(
                tdata.TrajectoryDataset(frames["lj"], **kw), 3 * SAMPLES)[1])
    for module in (tdata, jdata):
        with pytest.raises(ValueError, match="packed"):
            module.TrajectoryDataset(frames["lj"], **kw).subtract_from_labels(
                offset)


# -- the generator ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 1000])
def test_rotation_and_start_lattice_match_jax(seed):
    """random_rotation_matrix and the start (gamd_tpu/physics/
    generate.py:167-173: rotate about the centre, jitter, wrap): bit for
    bit."""
    a = tgen.random_rotation_matrix(np.random.RandomState(seed))
    b = jgen.random_rotation_matrix(np.random.RandomState(seed))
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    box, lattice = jlj.lj_fluid_box(258, 0.5)
    assert tlj.lj_fluid_box(258, 0.5)[0] == box
    got = tgen.lj_start(seed, tlj.lj_fluid_box(258, 0.5)[1], box)
    assert got.dtype == np.float32 and got.shape == (258, 3)
    np.testing.assert_array_equal(got, _jax_start(seed, lattice, box))


def _jax_start(seed, lattice, box):
    """JAX's start, as generate_lj_dataset computes it (:164-173)."""
    host_rng = np.random.RandomState(seed)
    r_mat = jgen.random_rotation_matrix(host_rng)
    pos = lattice - lattice.mean(axis=0)
    pos = pos @ r_mat + lattice.mean(axis=0)
    pos = pos + host_rng.randn(*pos.shape).astype(np.float32) * 0.005
    return np.array(jspace.wrap(jnp.asarray(pos), box))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's generator at SEED, step by step as generate_lj_dataset runs
    it, cut to FIRE_STEPS, FRAMES and INTERVAL: the start, FIRE's result,
    the initial NHC state and the recorded frames' directory."""
    box, lattice = jlj.lj_fluid_box(258, 0.5)
    system = jcfg.get_preset("lj")
    md = jcfg.MDConfig(integrator="nose_hoover",
                       temperature=system.temperature, dt_fs=system.dt_fs,
                       friction_per_ps=system.friction_per_ps,
                       chain_length=10, chain_mts=5, chain_ys=5,
                       rebuild_every=10)
    sim = JSimulation(jlj.lj_force_fn(box), system, md)
    dense_force = jax.jit(lambda p: jlj.lj_forces_dense(p, box))
    start = _jax_start(SEED, lattice, box)
    pos, _ = jfire(dense_force, jnp.asarray(start), n_steps=FIRE_STEPS)
    state = sim.init_state(pos, rng=jax.random.PRNGKey(1000 + SEED))
    out = tmp_path_factory.mktemp("jax_lj")
    jgen._record_seed(sim, state, str(out), SEED, FRAMES, INTERVAL,
                      dense_force, FRAMES, 0)
    return dict(start=start, fire=np.asarray(pos),
                pos=np.asarray(state.pos), vel=np.asarray(state.vel),
                dir=out)


def test_fire_matches_jax(jax_run):
    """fire_minimize on the dense LJ forces from the same start, FIRE_STEPS
    steps: within FIRE_ATOL of JAX's, and the energy fallen."""
    box = tlj.lj_fluid_box(258, 0.5)[0]
    proto = tgen.lj_protocol(device="cpu")
    start = torch.as_tensor(jax_run["start"])
    pos, force = fire_minimize(proto.record_force, start,
                               n_steps=FIRE_STEPS)
    np.testing.assert_allclose(pos.numpy(), jax_run["fire"], atol=FIRE_ATOL,
                               rtol=0)
    assert float(tlj.lj_energy_dense(pos, box)) < float(
        tlj.lj_energy_dense(start, box))
    assert force.shape == (258, 3) and bool(torch.isfinite(force).all())


def test_record_seed_matches_jax_from_its_state(jax_run, tmp_path):
    """The port's _record_seed from JAX's initial state (its FIRE'd pos and
    its PRNGKey(1000 + seed) velocities; the NHC chain starts at rest in
    both) in blocks of 2 frames against JAX's one block of FRAMES: the same
    files, float32 pos, vel and forces within RECORD_ATOL; frame 0 is the
    start, its vel bit for bit."""
    proto = tgen.lj_protocol(device="cpu")
    state = proto.sim.init_state(jax_run["pos"], vel=jax_run["vel"])
    tgen._record_seed(proto.sim, state, str(tmp_path), SEED, FRAMES,
                      INTERVAL, proto.record_force, 2, 0)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(os.listdir(jax_run["dir"])) == [
        f"data_{SEED}_{t}.npz" for t in range(FRAMES)]
    for t, name in enumerate(names):
        with np.load(tmp_path / name) as a, \
                np.load(jax_run["dir"] / name) as b:
            assert sorted(a) == sorted(b) == ["forces", "pos", "vel"]
            for key, atol in RECORD_ATOL.items():
                assert a[key].dtype == b[key].dtype == np.float32
                assert a[key].shape == (258, 3)
                np.testing.assert_allclose(a[key], b[key], atol=atol,
                                           rtol=0, err_msg=f"{name} {key}")
            if t == 0:
                np.testing.assert_array_equal(a["vel"], b["vel"])


def test_generate_lj_dataset_writes_the_layout(tmp_path):
    """generate_lj_dataset on the CPU (two seeds, FIRE cut to FIRE_STEPS,
    FRAMES frames every INTERVAL steps, blocks of 2): the files, float32
    [258, 3] arrays, frame 0 at the FIRE'd start, each frame's forces the
    dense LJ forces of its pos in kJ/mol/nm, vel in m/s at a temperature
    near the start's; the dataset reads it with its split."""
    out = tgen.generate_lj_dataset(
        str(tmp_path), seeds=2, frames_per_seed=FRAMES,
        record_interval=INTERVAL, minimize_steps=FIRE_STEPS,
        log_every_frames=0, frames_per_dispatch=2, device="cpu")
    proto = tgen.lj_protocol(device="cpu")
    assert sorted(os.listdir(out)) == sorted(
        f"data_{s}_{t}.npz" for s in (0, 1) for t in range(FRAMES))
    for s in (0, 1):
        start = torch.as_tensor(tgen.lj_start(s, proto.lattice, proto.box))
        fired, _ = fire_minimize(proto.record_force, start,
                                 n_steps=FIRE_STEPS)
        for t in range(FRAMES):
            with np.load(os.path.join(out, f"data_{s}_{t}.npz")) as z:
                for key in ("pos", "vel", "forces"):
                    assert z[key].dtype == np.float32
                    assert z[key].shape == (258, 3)
                    assert np.isfinite(z[key]).all()
                pos = torch.as_tensor(z["pos"])
                want = proto.record_force(pos).numpy() / 0.1
                np.testing.assert_allclose(z["forces"], want, rtol=0,
                                           atol=1e-5 * np.abs(want).max())
                ke = 0.5 * tlj.ARGON_MASS * float(
                    ((z["vel"] * 1e-3) ** 2).sum())
                temp = 2.0 * ke / (3 * 258 * 0.00831446261815324)
                assert 10.0 < temp < 400.0
                if t == 0:
                    np.testing.assert_array_equal(
                        z["pos"], torch.remainder(fired, proto.sim.system
                                                  .box).numpy())
    train = tdata.TrajectoryDataset(out, sample_num=FRAMES, seed_num=2)
    test = tdata.TrajectoryDataset(out, sample_num=FRAMES, seed_num=2,
                                   mode="test")
    assert (len(train), len(test)) == (5, 1)


def test_generate_data_cli_on_cpu(tmp_path, monkeypatch, capsys):
    """`generate_data --system lj --cpu` writes the npz layout (FIRE cut
    to FIRE_STEPS here to keep the test short) and reports frames/s; an
    LJ system of other than 258 atoms raises before any work. rpbe,
    refused until the DFT slice, tip3p and tip4p, refused until the water
    slice, reach their generators with the JAX CLI's arguments and the
    port's cuts (recorded here; their runs: tests/test_torch_dft.py and
    tests/test_torch_water_generate.py)."""
    steps = []

    def short_fire(force_fn, pos, n_steps):
        steps.append(n_steps)
        return fire_minimize(force_fn, pos, n_steps=FIRE_STEPS)

    monkeypatch.setattr(tgen, "fire_minimize", short_fire)
    out = tmp_path / "cli"
    generate_data.main(["--cpu", "--out", str(out), "--seeds", "1",
                        "--frames", "2", "--interval", "4",
                        "--dispatch_frames", "1", "--seed_start", "2"])
    assert steps == [2000]
    assert sorted(os.listdir(out)) == ["data_2_0.npz", "data_2_1.npz"]
    with np.load(out / "data_2_1.npz") as z:
        assert sorted(z) == ["forces", "pos", "vel"]
        assert all(z[k].dtype == np.float32 and z[k].shape == (258, 3)
                   for k in z)
    assert "frames/s" in capsys.readouterr().out
    target = tmp_path / "rpbe"
    rpbe = {}
    monkeypatch.setattr(tgen, "generate_rpbe_surrogate",
                        lambda out, **kw: rpbe.update(out=out, **kw))
    generate_data.main(["--cpu", "--system", "rpbe", "--out", str(target),
                        "--frames", "7", "--interval", "3",
                        "--minimize_steps", "11", "--thermalize_steps", "13",
                        "--flexible"])
    assert rpbe == dict(out=str(target), frames_per_box=7,
                        record_interval=3, rigid=False,
                        frames_per_dispatch=250, device=torch.device("cpu"),
                        minimize_steps=11, equil_steps=13)
    assert not target.exists()
    calls = {}
    for name in ("generate_water_dataset", "generate_tip4p_dataset"):
        monkeypatch.setattr(tgen, name, lambda out_dir, _n=name, **kw:
                            calls.setdefault(_n, (out_dir, kw)))
    for system in ("tip3p", "tip4p"):
        generate_data.main(["--cpu", "--system", system, "--out",
                            str(tmp_path / system), "--seeds", "2",
                            "--flexible", "--electrostatics", "dsf",
                            "--seed_start", "4", "--particles", "27"])
    w3, w4 = calls["generate_water_dataset"], calls["generate_tip4p_dataset"]
    assert w3[0] == str(tmp_path / "tip3p") and w3[1]["n_molecules"] == 27
    assert "n_molecules" not in w4[1]          # 251, as the JAX CLI
    for _, kw in (w3, w4):
        assert (kw["seeds"], kw["seed_start"], kw["rigid"],
                kw["electrostatics"]) == (2, 4, False, "dsf")
    with pytest.raises(ValueError, match="258"):
        tgen.generate_lj_dataset(str(tmp_path / "n100"), n_particles=100,
                                 device="cpu")
    assert not (tmp_path / "n100").exists()
