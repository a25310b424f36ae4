"""The DFT system of the port on the CPU against the JAX package on the same
numpy inputs: GAMDNet's update_edge and expand_edge=False with per-frame
boxes, rotate_sample with rotate_box, RealLargeDataset on
md_dataset/RPBE-surrogate.npz, the train and eval steps with per-frame
boxes, predict on results/ckpts/dftlarge_final.msgpack at full width, the
RPBE surrogate's generator, and the four DFT CLIs with --cpu at tiny
sizes. Tolerances are stated at each test; the model's are
tests/test_torch_train.py's plain-model bars (1e-5 of each tensor's
max)."""

import os
from unittest import mock

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.md.constraints import RigidWater as JRigidWater
from gamd_tpu.md.constraints import tip3p_rigid_params as jrigid_params
from gamd_tpu.md.simulate import Simulation as JSimulation
from gamd_tpu.models.gnn import GAMDNet as JGAMDNet
from gamd_tpu.neighbors.dense import dense_neighbor_list as jdense
from gamd_tpu.physics import water as jw
from gamd_tpu.physics.minimize import fire_minimize as jfire
from gamd_tpu.train import augment as jaug
from gamd_tpu.train import loop as jloop
from gamd_tpu.train import checkpoint as jckpt
from gamd_tpu.train.data import RealLargeDataset as JRealLargeDataset
from gamd_tpu.train.forcefield import GNNForceField as JForceField
from gamd_tpu.train.state import build_model as jbuild
from gamd_tpu.train.state import create_train_state as jcreate
from gamd_tpu.train.state import make_optimizer as jmake_optimizer

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.core import units
from gamd_tpu_torch.models.gnn import GAMDNet
from gamd_tpu_torch.physics import generate as tgen
from gamd_tpu_torch.tools import evaluate, generate_data, run_md, train_gamd
from gamd_tpu_torch.train import augment as taug
from gamd_tpu_torch.train import loop as tloop
from gamd_tpu_torch.train.checkpoint import load_self_describing
from gamd_tpu_torch.train.data import RealLargeDataset
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.state import (create_train_state, init_params,
                                        params_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RPBE = os.path.join(ROOT, "md_dataset", "RPBE-surrogate.npz")
DFT_CKPT = os.path.join(ROOT, "results", "ckpts", "dftlarge_final.msgpack")
SMALL = dict(encoding_size=32, hidden_dim=16, edge_embedding_dim=32,
             conv_layers=2, dropout=0.0, flip_dir=True)
MODEL_RTOL = 1e-5      # of each tensor's max: the plain-model bars
PREDICT_RTOL = 1e-4    # of std(F): JAX's fp32 and the port's on the CPU
FIRE_ATOL = 1e-4       # A: the start and FIRE against JAX's
RECORD_ATOL = 1e-4     # A: recorded positions (water_generate's bar)
FORCE_RTOL = 1e-4      # of the largest |F|: recorded forces


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for this file's small products (as
    test_torch_train_loop.py), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _assert_rel(actual, expected, rel, name=""):
    a, b = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(a - b).max())
    assert err <= rel * scale, f"{name}: max |d| {err} > {rel} * {scale}"


def _frames(b=2, n=48, seed=0, boxes=(9.0, 9.6)):
    """B frames of N water atoms uniform in their own boxes (bohr),
    Gaussian labels and the one-hot O feature."""
    rng = np.random.RandomState(seed)
    box = np.asarray(boxes[:b], np.float32)
    pos = np.stack([rng.uniform(0, bx, (n, 3)) for bx in box]).astype(
        np.float32)
    feat = np.tile((np.arange(n) % 3 == 0).astype(np.float32)[None, :, None],
                   (b, 1, 1))
    forces = rng.randn(b, n, 3).astype(np.float32)
    return dict(pos=pos, forces=forces, feat=feat, box_size=box)


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("update_edge,expand_edge", [(True, True),
                                                     (False, False)])
def test_gamdnet_dft_switches_match_jax(update_edge, expand_edge):
    """GAMDNet (water species, flip_dir, widths 32/16/32, 2 layers, N=48,
    K=16, B=2 frames with boxes of their own) with update_edge (each
    layer's edge_layer_norm feeding the next) or expand_edge=False (no RBF
    rows): the parameter tree's shapes are JAX's, init_params' too, and
    the train-mode output and every parameter's gradient of mean |out|
    are within MODEL_RTOL of each tensor's max of JAX's."""
    kw = dict(update_edge=update_edge, expand_edge=expand_edge, **SMALL)
    f = _frames()
    jpos, jbox = jnp.asarray(f["pos"]), jnp.asarray(f["box_size"])
    idx, mask, _ = jax.vmap(lambda p, b: jdense(p, b, 4.0, 16))(jpos, jbox)
    jmodel = JGAMDNet(cfg=jcfg.ModelConfig(**kw), species="water")
    args = (jpos, idx, mask, jbox, 0.3, 1.2)
    # One compiled init, not one compile per eager op (the values are the
    # same draws; both packages are then given these weights).
    params = jax.jit(lambda key: jmodel.init(
        key, *args, node_feat=jnp.asarray(f["feat"])))(
            jax.random.PRNGKey(0))["params"]

    def jloss(p):
        out = jmodel.apply({"params": p}, *args,
                           node_feat=jnp.asarray(f["feat"]), train=True,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.mean(jnp.abs(out)), out

    jgrads, jout = jax.jit(jax.grad(jloss, has_aux=True))(params)
    shapes = lambda tree: jax.tree_util.tree_map(np.shape, tree)
    seeded = init_params(tcfg.ModelConfig(**kw), tcfg.get_preset("dft"))
    assert shapes(seeded.params) == shapes(params)
    if update_edge:
        assert "edge_layer_norm" in params["graph_conv"]["conv_1"]
    net = GAMDNet(tcfg.ModelConfig(**kw), species="water").load_params(
        params_from_jax(params))
    out = net(_t(f["pos"]), _t(np.asarray(idx)), _t(np.asarray(mask)),
              _t(f["box_size"]), 0.3, 1.2, train=True,
              node_feat=_t(f["feat"]))
    torch.mean(torch.abs(out)).backward()
    _assert_rel(out.detach().numpy(), jout, MODEL_RTOL, "out")
    grads = dict(net.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(grads)
    for path, want in flat:
        name = ".".join(k.key for k in path)
        # The last layer's edge_layer_norm feeds no later layer: JAX's
        # gradient is 0, the port's None.
        got = grads[name].grad
        got = np.zeros(np.shape(want)) if got is None else got.numpy()
        _assert_rel(got, want, MODEL_RTOL, name)


# -- augmentation and data -----------------------------------------------------

@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_rotate_sample_rotates_the_box_as_jax(kind):
    """rotate_sample with rotate_box on frames with their own box, no wrap
    (box None), JAX's drawn rotations (seeds such that some rotate): a
    scalar box a frame comes back unchanged, a [3] one as |box r|; pos,
    forces and box within 1e-5 of JAX's, one frame and a batch of
    them; with the identity, the frame as it was."""
    f = _frames(b=1, n=12, seed=3)
    pos, forces = f["pos"][0], f["forces"][0]
    box = np.float32(9.3) if kind == "scalar" else np.asarray(
        [9.3, 8.1, 10.2], np.float32)
    rotated, rs, want = 0, [], []
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        r = np.asarray(jaug.random_flip_rotation(key, prob=0.5))
        rotated += not np.allclose(r, np.eye(3))
        jp, jf, jb = jaug.rotate_sample(key, jnp.asarray(pos),
                                        jnp.asarray(forces), None, prob=0.5,
                                        rotate_box=True,
                                        box_vec=jnp.asarray(box))
        tp, tf, tb = taug.rotate_sample(_t(pos), _t(forces), None, _t(r),
                                        rotate_box=True, box_vec=_t(box))
        for got, exp in ((tp, jp), (tf, jf), (tb, jb)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(exp),
                                       rtol=0, atol=1e-5)
        rs.append(r)
        want.append(np.asarray(jb))
    assert rotated >= 1
    # A batch: every frame with its own rotation and box.
    n = len(rs)
    _, _, tb = taug.rotate_sample(
        _t(np.tile(pos, (n, 1, 1))), _t(np.tile(forces, (n, 1, 1))), None,
        _t(np.stack(rs)), rotate_box=True,
        box_vec=_t(np.stack([box] * n)))
    np.testing.assert_allclose(np.asarray(tb), np.stack(want), rtol=0,
                               atol=1e-5)
    # The identity (a frame whose draw failed): nothing rotates.
    tp, tf, tb = taug.rotate_sample(_t(pos), _t(forces), None,
                                    torch.eye(3), rotate_box=True,
                                    box_vec=_t(box))
    np.testing.assert_allclose(tp.numpy(), pos, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), forces, rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(tb), box, rtol=0, atol=0)


def test_real_large_dataset_matches_jax():
    """RealLargeDataset on md_dataset/RPBE-surrogate.npz: the train, test
    and use_part splits equal JAX's, and items (pos, forces, feat,
    box_size) bit for bit, with their dtypes and shapes, at the first,
    last and seeded frames of each split."""
    for mode, part in (("train", False), ("train", True), ("test", False)):
        ds = RealLargeDataset(RPBE, mode=mode, use_part=part)
        jds = JRealLargeDataset(RPBE, mode=mode, use_part=part)
        np.testing.assert_array_equal(ds.idx, jds.idx)
        assert len(ds) == len(jds) == {"train": 1500 if part else 2700,
                                       "test": 300}[mode]
        picks = [0, len(ds) - 1, *np.random.RandomState(2).randint(
            0, len(ds), 4)]
        for i in picks:
            got, want = ds[int(i)], jds[int(i)]
            assert sorted(got) == sorted(want) == ["box_size", "feat",
                                                   "forces", "pos"]
            for key in want:
                assert got[key].dtype == want[key].dtype == np.float32
                np.testing.assert_array_equal(got[key], want[key])
            assert got["feat"].shape == (192, 1) and got["box_size"].ndim == 0
    with pytest.raises(ValueError, match="mode"):
        RealLargeDataset(RPBE, mode="val")


# -- the train and eval steps --------------------------------------------------

def _dft_system(jax_side):
    cfg = jcfg if jax_side else tcfg
    return cfg.get_preset("dft", n_atoms=48, cutoff=4.0, nbr_capacity=24)


def _jax_ks(state, b, prob):
    """The flip angles' ks [B, 3] (0 where a frame is not rotated) that
    JAX's train step draws at `state`'s rng and step (loop.py:150-170,
    augment.py:21-32)."""
    rng = jax.random.fold_in(state.rng, state.step)
    k_aug = jax.random.split(rng, 4)[0]
    out = []
    for key in jax.random.split(k_aug, b):
        k_apply, k_angles = jax.random.split(key)
        apply = jax.random.uniform(k_apply) < prob
        ks = jax.random.randint(k_angles, (3,), -2, 2).astype(jnp.float32)
        out.append(np.asarray(jnp.where(apply, ks, 0.0)))
    return np.stack(out)


def test_dft_train_and_eval_steps_match_jax():
    """One DFT train step (per-frame [B] boxes, rotate_aug with rotate_box
    on JAX's drawn rotations, prob 0.9 so that frames rotate; jitter and
    dropout 0) and one eval step after it, from JAX's initial weights on
    the same two frames: the loss and each metric at rtol 1e-5, the
    length and force scalers at rtol 1e-5, and the weights after the step
    within test_torch_train_loop.py's step bars (99.9% of elements within
    1e-5, all within 2 lr)."""
    f = _frames()
    jsys, tsys = _dft_system(True), _dft_system(False)
    kw = dict(update_edge=True, **SMALL)
    train_kw = dict(max_epoch=1, batch_size=2, rotate_prob=0.9,
                    jitter_sigma=0.0, lambda_net_force=0.5e-2)
    jtrain = jcfg.TrainConfig(**train_kw)
    jmodel = jbuild(jcfg.ModelConfig(**kw), jsys)
    jstate = jax.jit(lambda: jcreate(jmodel, jsys, jtrain, 1))()
    jparams0 = jstate.params
    ks = _jax_ks(jstate, 2, jtrain.rotate_prob)
    assert np.abs(ks).sum() > 0
    jstep = jloop.make_train_step(jmodel, jsys, jtrain,
                                  jmake_optimizer(jtrain, 1))
    jbatch = {k: jnp.asarray(v) for k, v in f.items()}
    jstate, jm = jstep(jstate, jbatch)
    jeval = jloop.make_eval_step(jmodel, jsys)(jstate, jbatch)

    ttrain = tcfg.TrainConfig(**train_kw)
    state = create_train_state(tcfg.ModelConfig(**kw), tsys, ttrain, 1,
                               device="cpu")
    state.model.load_params(params_from_jax(jparams0), {})
    tbatch = {k: _t(v) for k, v in f.items()}
    step = tloop.make_train_step(state.model, tsys, ttrain)
    with mock.patch.object(taug, "draw_flip_ks",
                           lambda *a, **k: _t(ks)):
        state, m = step(state, tbatch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for stat, jstat in ((state.length_stat, jstate.length_stat),
                        (state.force_stat, jstate.force_stat)):
        for key in ("count", "mean", "m2"):
            np.testing.assert_allclose(float(getattr(stat, key)),
                                       float(getattr(jstat, key)),
                                       rtol=1e-5, err_msg=key)
    diffs = np.concatenate([
        np.abs(np.asarray(_at(state.model.export_params()[0], path))
               - np.asarray(want)).ravel()
        for path, want in jax.tree_util.tree_flatten_with_path(
            jstate.params)[0]])
    assert np.mean(diffs <= 1e-5) >= 0.999 and diffs.max() <= 2 * ttrain.lr
    got = tloop.make_eval_step(state.model, tsys)(state, tbatch)
    for key in ("val_mae", "val_mse"):
        np.testing.assert_allclose(float(got[key]), float(jeval[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(got["val_outlier"]) == float(jeval["val_outlier"])


def _at(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


# -- deployment -----------------------------------------------------------------

def test_predict_on_dftlarge_final_matches_jax():
    """GNNForceField.predict on results/ckpts/dftlarge_final.msgpack (the
    DFT model at full width: 256/128/256, 5 layers, update_edge, 192
    atoms, K=192 at 9.5 bohr) on the first test frame of the surrogate at
    its own box: within PREDICT_RTOL of std(F) of JAX's fp32 predict on
    the CPU."""
    item = RealLargeDataset(RPBE, mode="test")[0]
    # JAX's load_self_describing, its template's init compiled once (run
    # eagerly, every op of a full-width init compiles on its own).
    jmodel_cfg, jsys = jckpt.load_checkpoint_configs(DFT_CKPT)
    template = jax.jit(lambda: jcreate(jbuild(jmodel_cfg, jsys), jsys,
                                       jcfg.TrainConfig(), 1))()
    jstate = jckpt.load_checkpoint(DFT_CKPT, template)
    jff = JForceField(jstate, jsys, jmodel_cfg)
    want = np.asarray(jax.jit(lambda p, b: jff.predict(p, box=b))(
        jnp.asarray(item["pos"]), jnp.asarray(item["box_size"])))
    state, model_cfg, system = load_self_describing(DFT_CKPT)
    assert model_cfg.update_edge and system.box is None
    torch.set_num_threads(4)
    got = GNNForceField(state, system, model_cfg, device="cpu").predict(
        item["pos"], box=item["box_size"]).numpy()
    assert np.abs(got - want).max() <= PREDICT_RTOL * want.std()


# -- the RPBE surrogate --------------------------------------------------------

def test_rpbe_start_and_recording_match_jax():
    """The surrogate's first box (64 molecules at 0.97 of liquid water's
    edge): the start (water_box relaxed by 20 FIRE steps on the flexible
    damped-shifted-force TIP3P, snapped onto the constraints) within
    FIRE_ATOL of JAX's, and two frames every two steps recorded by
    rpbe_protocol's Simulation from JAX's start and velocities at zero
    friction (the noise multiplied by zero, since the streams differ):
    positions within RECORD_ATOL and forces within FORCE_RTOL of the
    largest |F| of JAX's."""
    box = tgen.rpbe_box_sizes(64)[0]
    cutoff = min(6.0, box / 2 - 0.01)
    jparams = jw.TIP3PParams(cutoff=cutoff)
    jstart, _ = jfire(jax.jit(lambda p: jw.tip3p_forces(p, box, jparams)),
                      jnp.asarray(jw.water_box(64, box, jparams, seed=0)),
                      n_steps=20, max_step=0.05)
    jcst = JRigidWater(64, box, jrigid_params(jparams.r_oh, jparams.theta0))
    jstart = jcst.project_initial(jstart)
    proto = tgen.rpbe_protocol(box, friction_per_ps=0.0, device="cpu")
    start = tgen.rpbe_start(proto, 64, 20, seed=0)
    np.testing.assert_allclose(start.numpy(), np.asarray(jstart), rtol=0,
                               atol=FIRE_ATOL)

    system = jcfg.get_preset("tip3p", n_atoms=192, box=box, cutoff=cutoff,
                             nbr_capacity=176)
    md = jcfg.MDConfig(integrator="langevin", temperature=300.0, dt_fs=2.0,
                       friction_per_ps=0.0, rebuild_every=10)
    jsim = JSimulation(jw.tip3p_force_fn(box, jparams, rigid=True), system,
                       md, constraint=jcst)
    jstate = jax.jit(lambda p, key: jsim.init_state(p, rng=key))(
        jstart, jax.random.PRNGKey(4000))
    record = jax.jit(lambda p: jw.tip3p_forces_rigid(p, box, jparams))
    _, _, jpos, _, jforce, _ = jsim.run_recorded(jstate, 2, 2, record)
    state = proto.sim.init_state(_t(np.asarray(jstate.pos)),
                                 vel=_t(np.asarray(jstate.vel)),
                                 rng=torch.Generator())
    _, ovf, pos, _, force, _ = proto.sim.run_recorded(state, 2, 2,
                                                      proto.record_force)
    assert not ovf
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=0,
                               atol=RECORD_ATOL)
    jforce = np.asarray(jforce)
    assert np.abs(force.numpy() - jforce).max() <= FORCE_RTOL * np.abs(
        jforce).max()


def test_rpbe_npz_contract(tmp_path):
    """generate_rpbe_surrogate at a tiny size (3 boxes x 2 frames, 5 FIRE
    and 4 equilibration steps) writes JAX's layout: pos and force float32
    [6, 192, 3] in bohr and Ha/bohr, box [6] float32 in bohr (each box's
    edge over BOHR_TO_ANGSTROM, two frames each), atom_type [6, 192] int32
    O, H, H, and JAX's split (RandomState(0).permutation(6), its first
    max(1, int(0.6)) frames test_idx); the positions wrap into their
    boxes and the rigid molecules keep their O-H lengths."""
    out = tgen.generate_rpbe_surrogate(
        str(tmp_path / "r.npz"), frames_per_box=2, record_interval=2,
        equil_steps=4, minimize_steps=5, log_every_frames=0, device="cpu")
    boxes = tgen.rpbe_box_sizes(64)
    with np.load(out) as z:
        assert sorted(z) == ["atom_type", "box", "force", "pos", "test_idx",
                             "train_idx"]
        assert z["pos"].shape == z["force"].shape == (6, 192, 3)
        assert z["pos"].dtype == z["force"].dtype == np.float32
        assert z["box"].dtype == np.float32
        np.testing.assert_allclose(z["box"], np.repeat(np.float32(boxes), 2)
                                   / units.BOHR_TO_ANGSTROM, rtol=1e-7)
        np.testing.assert_array_equal(
            z["atom_type"], np.tile([1, 2, 2], (6, 64)).astype(np.int32))
        order = np.random.RandomState(0).permutation(6)
        np.testing.assert_array_equal(z["test_idx"], order[:1])
        np.testing.assert_array_equal(z["train_idx"], order[1:])
        pos_a = z["pos"] * units.BOHR_TO_ANGSTROM
        assert (pos_a >= 0).all() and (pos_a <= np.repeat(
            np.float32(boxes), 2)[:, None, None] + 1e-4).all()
        assert np.isfinite(z["force"]).all()


# -- the CLIs -------------------------------------------------------------------

def test_dft_clis_on_cpu(tmp_path, capsys):
    """The DFT loop with --cpu at tiny sizes: generate_data --system rpbe
    (2 frames a box), train_gamd --system dft (widths 16, 2 layers,
    update_edge and --disable_expand_edge, 2 epochs at batch 2) on it, the
    checkpoints at epoch 0 and the last (the DFT cadence, 50) describing
    the DFT system (box None, flip_dir and both switches), evaluate
    --system dft on it (its one test frame, finite metrics), and run_md
    --system
    dft on it (81 atoms, 10 rigid steps: finite, residual under 1e-5 A);
    --banded with dft is JAX's parser error, and --num_device 2 (data
    parallelism, ported since) asks for the cards it names before any
    work."""
    npz = str(tmp_path / "r.npz")
    generate_data.main(["--system", "rpbe", "--cpu", "--out", npz,
                        "--frames", "2", "--interval", "2",
                        "--minimize_steps", "5", "--thermalize_steps", "4"])
    assert "Wrote RPBE surrogate" in capsys.readouterr().out
    ck = tmp_path / "ck"
    tiny = ["--encoding_size", "16", "--hidden_dim", "16",
            "--edge_embedding_dim", "16", "--conv_layer", "2"]
    logs = []
    state = train_gamd.main(["--system", "dft", "--data_dir", npz, "--cpu",
                             "--max_epoch", "2", "--batch_size", "2",
                             "--use_layer_norm", "--update_edge",
                             "--disable_expand_edge", "--cp_dir", str(ck),
                             *tiny], log_fn=logs.append)
    assert sorted(os.listdir(ck)) == ["checkpoint_0.msgpack",
                                      "checkpoint_1.msgpack",
                                      "scaler_0.npz", "scaler_1.npz"]
    assert all(np.isfinite(float(v.split("=")[1]))
               for line in logs if line.startswith("epoch")
               for v in line.split(": ")[1].split(", "))
    _, model_cfg, system = load_self_describing(
        str(ck / "checkpoint_1.msgpack"))
    assert system.box is None and model_cfg.flip_dir
    assert model_cfg.update_edge and not model_cfg.expand_edge
    assert state.model.cfg.update_edge
    metrics = evaluate.main(["--system", "dft", "--ckpt",
                             str(ck / "checkpoint_1.msgpack"),
                             "--data_dir", npz, "--cpu"])
    assert metrics["frames"] == 1
    assert np.isfinite(metrics["force_mae_ev_a"])
    log = tmp_path / "md.txt"
    run_md.main(["--system", "dft", "--ckpt", str(ck / "checkpoint_1.msgpack"),
                 "--cpu", "--steps", "10", "--n_atoms", "81",
                 "--report_every", "5", "--log", str(log)])
    out = capsys.readouterr().out
    residual = float(out.split("constraint residual ")[1].split()[0])
    assert residual < 1e-5
    assert len(log.read_text().splitlines()) == 3
    with pytest.raises(SystemExit):
        run_md.main(["--system", "dft", "--banded", "--cpu"])
    with pytest.raises(RuntimeError, match="--num_device 2 asks for 2"):
        train_gamd.main(["--system", "dft", "--data_dir", npz,
                         "--num_device", "2"])


def test_dft_closure_feeds_the_model_bohr():
    """run_md's DFT force field: the model system holds the atoms in a box
    of 20 A / BOHR_TO_ANGSTROM, the MD system the TIP3P preset at 20 A with
    the model's cutoff in A, K=128 and 25/ps, and its force function's at
    positions in A are force_fn()'s at those positions in bohr."""
    args = run_md.build_parser().parse_args(
        ["--system", "dft", "--n_atoms", "81", "--encoding_size", "16",
         "--hidden_dim", "16", "--edge_embedding_dim", "16", "--conv_layer",
         "1"])
    ff, force_fn, md_system = run_md.load_force_field(args,
                                                      torch.device("cpu"))
    bohr = units.BOHR_TO_ANGSTROM
    assert ff.system.n_atoms == md_system.n_atoms == 81
    assert ff.system.box == pytest.approx(20.0 / bohr)
    assert (md_system.name, md_system.box, md_system.nbr_capacity,
            md_system.friction_per_ps) == ("tip3p", 20.0, 128, 25.0)
    assert md_system.cutoff == pytest.approx(9.5 * bohr)
    pos = torch.as_tensor(np.random.RandomState(0).uniform(
        0, 20.0, (81, 3)).astype(np.float32))
    from gamd_tpu_torch.neighbors.dense import dense_neighbor_list
    idx, mask, _ = dense_neighbor_list(pos, 20.0, md_system.cutoff, 64)
    want = ff.force_fn()(pos * (1.0 / bohr), idx, mask)
    assert torch.equal(force_fn(pos, idx, mask), want)
