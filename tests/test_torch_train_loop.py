"""Port parity of the training loop on the CPU: the msgpack encoder, the
checkpoint writer and reader (each package reads what the other writes),
the eval step, the epoch loop against JAX's train() on JAX's batch
order, checkpoint cadence, best_val.txt, a resumed run bit for bit, the
water train step, and the train and evaluate CLIs with --cpu, at small
sizes (widths 16, 1-2 conv layers, N <= 24 except the CLIs' presets) on
the same numpy inputs through both packages."""

import dataclasses
import functools
import json
import os
import re
from unittest import mock

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.train import checkpoint as jckpt
from gamd_tpu.train import loop as jloop
from gamd_tpu.train.forcefield import GNNForceField as JForceField
from gamd_tpu.train.state import build_model as jbuild
from gamd_tpu.train.state import create_train_state as jcreate
from gamd_tpu.train.state import make_optimizer as jmake_optimizer

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.core import units
from gamd_tpu_torch.parallel.mesh import Mesh
from gamd_tpu_torch.physics import lennard_jones as tlj
from gamd_tpu_torch.tools import evaluate, train_gamd
from gamd_tpu_torch.train import checkpoint as tckpt
from gamd_tpu_torch.train import loop as tloop
from gamd_tpu_torch.train.data import TrajectoryDataset
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.msgpack import packb, unpackb
from gamd_tpu_torch.train.state import (create_train_state, lr_factor,
                                        params_from_jax)

CKPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "results", "ckpts")
TINY = dict(encoding_size=16, hidden_dim=16, edge_embedding_dim=16,
            conv_layers=2)
NO_AUG = dict(rotate_aug=False, jitter_sigma=0.0)
LR = tcfg.TrainConfig().lr
PARAM_ATOL, PARAM_SHARE = 1e-5, 0.999   # test_torch_train.py's bars


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for this file's tests (widths 16: on shared CPUs
    many threads make these small products far slower), restored
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ListDataset:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@functools.lru_cache(maxsize=None)
def lj_frames(n_frames=12, n=24, seed=0):
    """(system kwargs, frames): tests/test_train.py::make_lj_frames's
    synthetic LJ set (the lattice displaced by 0.3 A, exact forces in
    kJ/mol/nm), labelled by the port's LJ forces."""
    params = tlj.LJParams()
    box, pos0 = tlj.lj_fluid_box(n, 0.5, params)
    params = tlj.LJParams(cutoff=min(params.cutoff, box / 2 - 0.01))
    rng = np.random.RandomState(seed)
    frames = []
    for _ in range(n_frames):
        p = (pos0 + rng.randn(*pos0.shape).astype(np.float32) * 0.3) % box
        f = tlj.lj_forces_dense(torch.as_tensor(p, dtype=torch.float32),
                                box, params).numpy()
        frames.append({"pos": p.astype(np.float32),
                       "forces": (f / 0.1).astype(np.float32)})
    system = dict(name="tiny-lj", n_atoms=n, box=float(box),
                  cutoff=float(params.cutoff), nbr_capacity=n, skin=1.0,
                  species="lj", masses=(39.948,), temperature=100.0)
    return system, tuple(frames)


def water_frames(n_frames=4, n=12, seed=6):
    """(system kwargs, frames) of tests/test_train.py:479's water step:
    4 molecules in an 8 A box, uniform positions, Gaussian labels, the
    one-hot O feature."""
    rng = np.random.RandomState(seed)
    feat = (np.arange(n) % 3 == 0).astype(np.float32).reshape(n, 1)
    frames = [{"pos": rng.uniform(0, 8, (n, 3)).astype(np.float32),
               "forces": rng.randn(n, 3).astype(np.float32), "feat": feat}
              for _ in range(n_frames)]
    system = dict(name="tiny-water", n_atoms=n, box=8.0, cutoff=3.0,
                  nbr_capacity=n, skin=0.5, species="water", has_bonds=True,
                  masses=(15.9994, 1.008, 1.008), temperature=300.0)
    return system, frames


def _param_diffs(tree, jax_params):
    out = []
    for path, want in jax.tree_util.tree_flatten_with_path(jax_params)[0]:
        got = tree
        for key in path:
            got = got[key.key]
        out.append(np.abs(np.asarray(got) - np.asarray(want)).ravel())
    return np.concatenate(out)


def _assert_params_close(model, jax_params, n_steps):
    """At least 99.9% of elements within 1e-5 and all within 2 lr per step
    (test_torch_train.py::test_three_train_steps_match_jax's bars)."""
    diffs = _param_diffs(model.export_params()[0], jax_params)
    assert np.mean(diffs <= PARAM_ATOL) >= PARAM_SHARE, np.mean(
        diffs <= PARAM_ATOL)
    assert diffs.max() <= 2 * LR * n_steps, diffs.max()


def _port_state(system, model_cfg, train_cfg, steps_per_epoch, jax_params):
    """A fresh port TrainState on the CPU holding JAX's initial weights."""
    state = create_train_state(model_cfg, system, train_cfg,
                               steps_per_epoch, device="cpu")
    state.model.load_params(params_from_jax(jax_params), {})
    return state


# -- msgpack ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lj_relabel_latest", "tip3p_final"])
def test_packb_round_trips_committed_checkpoints(name):
    """packb(unpackb(b)) == b byte for byte: sorted keys, ints in their
    smallest form, 0-d int32 counts, uint32[2] rng, an empty
    batch_stats."""
    with open(os.path.join(CKPTS, f"{name}.msgpack"), "rb") as f:
        data = f.read()
    assert packb(unpackb(data)) == data


def test_packb_matches_flax_msgpack_serialize():
    """Every kind the encoder takes against flax's msgpack_serialize: ints
    at each width boundary, floats, long str and bin, nested maps (keys
    unsorted on input), lists, 0-d and n-d arrays of several dtypes, a
    torch tensor; a numpy scalar is refused."""
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    arrays = {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
              "i32": np.asarray(7, np.int32), "u32": np.asarray([0, 3],
                                                                np.uint32),
              "b": np.asarray([True, False]), "f64": np.zeros((0,))}
    tree = {"z": ints, "a": {"y": 1.5, "b": -0.0, "n": None, "t": True,
                             "f": False},
            "s": "x" * 40, "S": "y" * 300, "bin": b"\x01" * 300,
            "many": list(range(20)), "map": {f"k{i}": i for i in range(17)},
            "arr": arrays, "empty": {}}
    want = flax.serialization.msgpack_serialize(tree)
    assert packb(tree) == want
    assert packb({"t": torch.arange(4, dtype=torch.float32)}) == \
        flax.serialization.msgpack_serialize(
            {"t": np.arange(4, dtype=np.float32)})
    assert unpackb(want)["z"] == ints
    with pytest.raises(TypeError, match="float32"):
        packb(np.float32(1.0))


# -- checkpoints --------------------------------------------------------------

def test_port_rewrites_a_committed_checkpoint_byte_for_byte(tmp_path):
    """tip3p_final loaded into a port TrainState (load_checkpoint) and saved
    (save_checkpoint): the state's bytes are the file's but for rng (the
    port writes [0, seed]); the meta JSON is JAX's json.dumps of the same
    configs (the file predates the `longrange` field)."""
    path = os.path.join(CKPTS, "tip3p_final.msgpack")
    _, cfg, system = tckpt.load_self_describing(path)
    template = create_train_state(cfg, system, tcfg.TrainConfig(), 1,
                                  seed=5, device="cpu")
    state = tckpt.load_checkpoint(path, template)
    out = str(tmp_path / "re.msgpack")
    tckpt.save_checkpoint(out, state, model_cfg=cfg, system=system)
    with open(path, "rb") as f:
        want = unpackb(f.read())
    with open(out, "rb") as f:
        got = unpackb(f.read())
    assert list(got["state"]["rng"]) == [0, 5]
    want["state"]["rng"] = got["state"]["rng"]
    assert packb(got["state"]) == packb(want["state"])
    jmodel, jsystem = jckpt.load_checkpoint_configs(path)
    assert got["__gamd_meta_json__"] == json.dumps(
        {"model": dataclasses.asdict(jmodel),
         "system": dataclasses.asdict(jsystem)})


def _trained_port_state(kind, n_steps=2):
    """(state, model cfg, system, frames) after n_steps port steps with
    the augmentations on (Adam moments and scalers non-zero)."""
    sys_kw, frames = lj_frames() if kind == "lj" else water_frames()
    system = tcfg.SystemConfig(**sys_kw)
    cfg = tcfg.ModelConfig(**TINY)
    train_cfg = tcfg.TrainConfig(batch_size=2)
    state = create_train_state(cfg, system, train_cfg, 1, seed=4,
                               device="cpu")
    step = tloop.make_train_step(state.model, system, train_cfg)
    for s in range(n_steps):
        batch = {k: torch.as_tensor(np.stack([f[k] for f in frames[2 * s:
                                                                   2 * s + 2]]))
                 for k in frames[0]}
        state, _ = step(state, batch)
    return state, cfg, system, frames


@pytest.mark.parametrize("kind", ["lj", "water"])
def test_jax_reads_a_port_checkpoint(kind, tmp_path):
    """A checkpoint and scaler the port wrote after two steps: JAX's
    load_checkpoint restores them into its TrainState (weights, Adam
    moments and counts, scalers, step) and JAX's load_self_describing and
    GNNForceField predict the port's forces within 1e-5 std(F)."""
    state, cfg, system, frames = _trained_port_state(kind)
    path = str(tmp_path / "c.msgpack")
    tckpt.save_checkpoint(path, state, model_cfg=cfg, system=system)
    tckpt.save_scaler(str(tmp_path / "s.npz"), state)

    jstate, jcfg_, jsys = jckpt.load_self_describing(path)
    assert dataclasses.asdict(jcfg_) == dataclasses.asdict(cfg)
    template = jcreate(jbuild(jcfg_, jsys), jsys, jcfg.TrainConfig(), 1)
    restored = jckpt.load_checkpoint(path, template)
    assert int(restored.step) == 2
    adam, sched = restored.opt_state
    assert int(adam.count) == int(sched.count) == 2
    for name, p in state.model.named_parameters():
        keys = name.split(".")
        mu, nu, w = adam.mu, adam.nu, restored.params
        for key in keys:
            mu, nu, w = mu[key], nu[key], w[key]
        st = state.optimizer.state[p]
        np.testing.assert_array_equal(np.asarray(mu), st["exp_avg"].numpy())
        np.testing.assert_array_equal(np.asarray(nu),
                                      st["exp_avg_sq"].numpy())
        np.testing.assert_array_equal(np.asarray(w), p.detach().numpy())
    for jstat, tstat in ((restored.force_stat, state.force_stat),
                         (restored.length_stat, state.length_stat)):
        assert [float(x) for x in jstat] == [float(x) for x in tstat]
    jforce, jlength = jckpt.load_scaler(str(tmp_path / "s.npz"))
    assert float(jforce.var) == pytest.approx(float(state.force_stat.var),
                                              rel=1e-6)
    assert float(jlength.safe_mean) == pytest.approx(
        float(state.length_stat.safe_mean), rel=1e-6)

    pos = frames[-1]["pos"]
    want = np.asarray(JForceField(jstate, jsys, jcfg_).predict(pos))
    tstate, tcfg_, tsys = tckpt.load_self_describing(path)
    got = GNNForceField(tstate, tsys, tcfg_, device="cpu").predict(
        pos).numpy()
    assert np.abs(got - want).max() <= 1e-5 * want.std()


@functools.lru_cache(maxsize=None)
def jax_runs(tmpdir, precompute):
    """JAX train() over 2 epochs of 8 frames (batch 4, seed 3, no
    augmentation, dropout 0, lr decayed each epoch, a checkpoint every
    epoch into tmpdir), with its logs, its final state and each epoch's
    permutation (jax.random.permutation of the epoch key, as
    make_train_epoch draws it)."""
    sys_kw, frames = lj_frames()
    system = jcfg.SystemConfig(**sys_kw)
    cfg = jcfg.ModelConfig(dropout=0.0, **TINY)
    train_cfg = jcfg.TrainConfig(max_epoch=2, batch_size=4, seed=3,
                                 lr_step_epochs=1, checkpoint_every=1,
                                 precompute_nbrs=precompute, **NO_AUG)
    logs = []
    init = jcreate(jbuild(cfg, system), system, train_cfg, 2)
    final = jloop.train(system, cfg, train_cfg, ListDataset(frames[:8]),
                        ListDataset(frames[8:]), ckpt_dir=tmpdir,
                        log_fn=logs.append)
    rng, perms = jax.random.PRNGKey(train_cfg.seed + 1), []
    for _ in range(2):
        rng, _, k_epoch = jax.random.split(rng, 3)
        perms.append(np.asarray(jax.random.permutation(k_epoch, 8)))
    return logs, init, final, perms


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("jax_train"))


def _logged(logs):
    """{(epoch, name): value} of train()'s log lines."""
    out = {}
    for line in logs:
        m = re.match(r"epoch (\d+)( val)?: (.*)", line)
        if m and "new best" not in line:
            for item in m.group(3).split(", "):
                name, value = item.split("=")
                out[(int(m.group(1)), name)] = float(value)
    return out


@pytest.mark.parametrize("precompute", [False, True])
def test_train_matches_jax_train(jax_dir, precompute):
    """The port's train() from JAX's initial weights, given JAX's batch
    order (epoch_order replaced by JAX's permutations), over the same two
    epochs: every logged epoch and validation metric at rtol 1e-5 (atol
    1e-5, as tests/test_train.py compares JAX's two list paths), the final
    weights within the step bars, with and without precompute_nbrs."""
    logs, init, final, perms = jax_runs(
        os.path.join(jax_dir, str(precompute)), precompute)
    sys_kw, frames = lj_frames()
    system = tcfg.SystemConfig(**sys_kw)
    cfg = tcfg.ModelConfig(dropout=0.0, **TINY)
    train_cfg = tcfg.TrainConfig(max_epoch=2, batch_size=4, seed=3,
                                 lr_step_epochs=1,
                                 precompute_nbrs=precompute, **NO_AUG)
    state = _port_state(system, cfg, train_cfg, 2, init.params)
    order = lambda seed, epoch, n, b: perms[epoch][:n // b * b].reshape(-1, b)
    history, port_logs = [], []
    with mock.patch.object(tloop, "epoch_order", order):
        out = tloop.train(system, cfg, train_cfg, ListDataset(frames[:8]),
                          ListDataset(frames[8:]), state=state,
                          log_fn=port_logs.append, device="cpu",
                          history=history)
    want = _logged(logs)
    assert set(_logged(port_logs)) == set(want) and len(want) == 16
    for (epoch, name), value in want.items():
        np.testing.assert_allclose(history[epoch][name], value, rtol=1e-5,
                                   atol=1e-5, err_msg=f"{name} {epoch}")
    assert out.step == int(final.step) == 4
    _assert_params_close(out.model, final.params, 4)


def test_port_resumes_a_jax_checkpoint_and_steps_like_jax(jax_dir):
    """checkpoint_0 of JAX's train() (two Adam steps, the lr decayed at the
    epoch's end) restored by the port's load_checkpoint and by JAX's; one
    step of each on the same batch: loss at rtol 1e-5, the lr of the
    restored count, Adam's counts, the params after it within the step
    bars and its moments within 1e-5 of each tensor's max."""
    jax_runs(os.path.join(jax_dir, "False"), False)
    path = os.path.join(jax_dir, "False", "checkpoint_0.msgpack")
    sys_kw, frames = lj_frames()
    jsys, tsys = jcfg.SystemConfig(**sys_kw), tcfg.SystemConfig(**sys_kw)
    cfg_kw = dict(dropout=0.0, **TINY)
    train_kw = dict(max_epoch=2, batch_size=4, seed=3, lr_step_epochs=1,
                    **NO_AUG)
    jtrain = jcfg.TrainConfig(**train_kw)
    jmodel = jbuild(jcfg.ModelConfig(**cfg_kw), jsys)
    jstate = jckpt.load_checkpoint(path, jcreate(jmodel, jsys, jtrain, 2))
    tx = jmake_optimizer(jtrain, 2)
    batch = {k: np.stack([f[k] for f in frames[8:12]])
             for k in ("pos", "forces")}
    jnext, jm = jloop.make_train_step(jmodel, jsys, jtrain, tx)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    ttrain = tcfg.TrainConfig(**train_kw)
    template = create_train_state(tcfg.ModelConfig(**cfg_kw), tsys, ttrain,
                                  2, device="cpu")
    state = tckpt.load_checkpoint(path, template)
    assert state.step == 2 and state.scheduler.last_epoch == 2
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        LR * lr_factor(ttrain, 2)(2), rel=1e-7)
    assert lr_factor(ttrain, 2)(2) < 1.0
    step = tloop.make_train_step(state.model, tsys, ttrain)
    state, m = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert state.step == int(jnext.step) == 3
    _assert_params_close(state.model, jnext.params, 1)
    saved = tckpt.train_state_dict(state)
    adam = jnext.opt_state[0]
    assert int(saved["opt_state"]["0"]["count"]) == int(adam.count) == 3
    assert int(saved["opt_state"]["1"]["count"]) == int(
        jnext.opt_state[1].count) == 3
    for key in ("mu", "nu"):
        for path_, want in jax.tree_util.tree_flatten_with_path(
                getattr(adam, key))[0]:
            got = saved["opt_state"]["0"][key]
            for k in path_:
                got = got[k.key]
            want = np.asarray(want)
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), \
                (key, path_)


def test_eval_step_matches_jax(jax_dir):
    """make_eval_step on checkpoint_1 of JAX's run against JAX's
    make_eval_step on the same state and batch of held-out frames (the
    search in the step, and lists given): val_mae and val_mse at rtol
    1e-5, the outlier share exact."""
    jax_runs(os.path.join(jax_dir, "False"), False)
    path = os.path.join(jax_dir, "False", "checkpoint_1.msgpack")
    sys_kw, frames = lj_frames()
    jsys, tsys = jcfg.SystemConfig(**sys_kw), tcfg.SystemConfig(**sys_kw)
    cfg_kw = dict(dropout=0.0, **TINY)
    jmodel = jbuild(jcfg.ModelConfig(**cfg_kw), jsys)
    jstate = jckpt.load_checkpoint(path, jcreate(jmodel, jsys,
                                                 jcfg.TrainConfig(), 1))
    state = tckpt.load_checkpoint(path, create_train_state(
        tcfg.ModelConfig(**cfg_kw), tsys, tcfg.TrainConfig(), 1,
        device="cpu"))
    batch = {k: np.stack([f[k] for f in frames[8:12]])
             for k in ("pos", "forces")}
    want = jloop.make_eval_step(jmodel, jsys)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    step = tloop.make_eval_step(state.model, tsys)
    idx, mask = tloop.precompute_nbrs(tsys, tbatch["pos"])
    for got in (step(state, tbatch),
                step(state, {**tbatch, "idx": idx, "mask": mask})):
        for key in ("val_mae", "val_mse"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=key)
        assert float(got["val_outlier"]) == float(want["val_outlier"])


# -- the epoch loop alone -----------------------------------------------------

def _port_run(ckpt_dir, max_epoch=3, start_epoch=0, state=None,
              checkpoint_every=1, use_layer_norm=True, history=None,
              logs=None):
    """The port's train() over 8 of the LJ frames with every augmentation
    on (rotation, jitter, dropout, drop_edge), 4 held out."""
    sys_kw, frames = lj_frames()
    system = tcfg.SystemConfig(**sys_kw)
    cfg = tcfg.ModelConfig(drop_edge=True, use_layer_norm=use_layer_norm,
                           **TINY)
    train_cfg = tcfg.TrainConfig(max_epoch=max_epoch, batch_size=2, seed=1,
                                 checkpoint_every=checkpoint_every,
                                 start_epoch=start_epoch, jitter_sigma=0.01,
                                 rotate_prob=0.5)
    if state == "resume":
        template = create_train_state(cfg, system, train_cfg, 4,
                                      device="cpu")
        state = tckpt.load_checkpoint(
            os.path.join(ckpt_dir, f"checkpoint_{start_epoch - 1}.msgpack"),
            template)
    return tloop.train(system, cfg, train_cfg, ListDataset(frames[:8]),
                       ListDataset(frames[8:]), ckpt_dir=ckpt_dir,
                       state=state, device="cpu", history=history,
                       log_fn=(logs.append if logs is not None
                               else lambda _: None))


def test_checkpoint_cadence_and_best_val(tmp_path):
    """checkpoint_every=2 over 3 epochs writes checkpoints and scalers 0 and
    2 (the last); best.msgpack, scaler_best.npz and best_val.txt
    ("{val_mae:.8f} epoch={epoch}") follow the lowest val_mae; a run over a
    better best_val.txt leaves it and best.msgpack alone."""
    d = str(tmp_path / "a")
    history, logs = [], []
    _port_run(d, checkpoint_every=2, history=history, logs=logs)
    names = sorted(os.listdir(d))
    assert names == ["best.msgpack", "best_val.txt", "checkpoint_0.msgpack",
                     "checkpoint_2.msgpack", "scaler_0.npz", "scaler_2.npz",
                     "scaler_best.npz"]
    best = min(history, key=lambda r: r["val_mae"])
    with open(os.path.join(d, "best_val.txt")) as f:
        assert f.read() == f"{best['val_mae']:.8f} epoch={best['epoch']}\n"
    assert any(f"epoch {best['epoch']}: new best" in line for line in logs)
    z = np.load(os.path.join(d, "scaler_2.npz"))
    assert sorted(z) == ["count", "length_count", "length_mean",
                         "length_var", "mean", "var"]
    assert all(z[k].shape == (1,) and np.isfinite(z[k]).all() for k in z)

    with open(os.path.join(d, "best_val.txt"), "w") as f:
        f.write("0.00000001 epoch=9\n")
    with open(os.path.join(d, "best.msgpack"), "rb") as f:
        kept = f.read()
    _port_run(d, max_epoch=1)
    with open(os.path.join(d, "best_val.txt")) as f:
        assert f.read() == "0.00000001 epoch=9\n"
    with open(os.path.join(d, "best.msgpack"), "rb") as f:
        assert f.read() == kept


@pytest.mark.parametrize("use_layer_norm", [True, False])
def test_resume_is_bit_for_bit(tmp_path, use_layer_norm):
    """Three epochs straight, against two and a resume from checkpoint_1 at
    start_epoch 2, with rotation, jitter, dropout and drop_edge on (and
    BatchNorm's running stats): epoch 2's metrics and the final checkpoint
    (weights, Adam moments and counts, scalers, step) bit for bit."""
    straight, resumed = str(tmp_path / "s"), str(tmp_path / "r")
    h_straight, h_resumed = [], []
    _port_run(straight, use_layer_norm=use_layer_norm, history=h_straight)
    _port_run(resumed, max_epoch=2, use_layer_norm=use_layer_norm)
    _port_run(resumed, start_epoch=2, state="resume",
              use_layer_norm=use_layer_norm, history=h_resumed)
    strip = lambda h: [{k: v for k, v in r.items() if k != "seconds"}
                       for r in h]
    assert strip(h_resumed) == strip(h_straight[2:])
    with open(os.path.join(straight, "checkpoint_2.msgpack"), "rb") as f:
        want = f.read()
    with open(os.path.join(resumed, "checkpoint_2.msgpack"), "rb") as f:
        assert f.read() == want
    assert h_straight[0]["loss"] != h_straight[2]["loss"]


# -- water ----------------------------------------------------------------------

def test_water_train_steps_match_jax():
    """Three steps of a water model (the one-hot node encoder, the bond
    channel; tests/test_train.py:479's system) without augmentation or
    dropout, batches of two frames, from JAX's initial weights: each
    step's loss at rtol 1e-5 and the weights after three steps within the
    step bars."""
    sys_kw, frames = water_frames(n_frames=6)
    jsys, tsys = jcfg.SystemConfig(**sys_kw), tcfg.SystemConfig(**sys_kw)
    cfg_kw = dict(dropout=0.0, **TINY)
    train_kw = dict(max_epoch=1, batch_size=2, **NO_AUG)
    jtrain = jcfg.TrainConfig(**train_kw)
    jmodel = jbuild(jcfg.ModelConfig(**cfg_kw), jsys)
    assert jmodel.use_bond
    jstate = jcreate(jmodel, jsys, jtrain, 1)
    jstep = jloop.make_train_step(jmodel, jsys, jtrain,
                                  jmake_optimizer(jtrain, 1))
    ttrain = tcfg.TrainConfig(**train_kw)
    state = _port_state(tsys, tcfg.ModelConfig(**cfg_kw), ttrain, 1,
                        jstate.params)
    assert state.model.use_bond and state.model.species == "water"
    step = tloop.make_train_step(state.model, tsys, ttrain)
    for s in range(3):
        batch = {k: np.stack([f[k] for f in frames[2 * s:2 * s + 2]])
                 for k in ("pos", "forces", "feat")}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {s}")
    _assert_params_close(state.model, jstate.params, 3)


# -- the CLIs -------------------------------------------------------------------

def _write_set(root, system_name, n_frames, seed=0):
    """data_0_{t}.npz frames of a preset's start (the LJ lattice, or
    water_box for tip3p) displaced by seeded noise, labelled by the port's
    classical forces in kJ/mol/nm, under root/<lj_data|water_data>."""
    from gamd_tpu_torch.physics import water as tw

    system = tcfg.get_preset(system_name)
    out = os.path.join(root, train_gamd.SUBDIRS[system_name])
    os.makedirs(out)
    rng = np.random.RandomState(seed)
    if system_name == "lj":
        _, base = tlj.lj_fluid_box(system.n_atoms, 0.5)
        sigma, force = 0.1, lambda p: tlj.lj_forces_dense(p, system.box)
    else:
        base = tw.water_box(system.n_atoms // 3, system.box, seed=seed)
        params = tw.TIP3PParams(cutoff=min(9.0, system.box / 2 - 0.01))
        sigma, force = 0.01, lambda p: tw.tip3p_forces(p, system.box,
                                                       params)
    for t in range(n_frames):
        pos = np.mod(base + sigma * rng.randn(*base.shape),
                     system.box).astype(np.float32)
        f = force(torch.as_tensor(pos)).numpy() / units.KJ_MOL_NM_TO_INTERNAL
        np.savez(os.path.join(out, f"data_0_{t}.npz"), pos=pos,
                 vel=np.zeros_like(pos), forces=f.astype(np.float32))
    return out


def test_train_and_evaluate_clis_on_cpu(tmp_path):
    """train_gamd --cpu --use_pallas --relabel on a 20-frame LJ-258 set
    (18 train, 2 test; batch 2, widths 16, one conv layer), then evaluate
    --cpu --use_pallas on its last checkpoint: the file set, finite losses,
    and every metric within 1e-5 of its own size (of 1 for the cosines,
    which lie in [-1, 1] and average near 0 on an untrained model) of the
    same metrics (force_metrics) of JAX's GNNForceField.predict_batch on
    the checkpoint that the port wrote. JAX runs its fp32 XLA model
    (use_pallas=False): the port's plain conv message on the CPU is that
    function, while JAX's Pallas kernel in interpret mode is 2% of std(F)
    from it at this shape."""
    data = _write_set(str(tmp_path), "lj", 20)
    ck = str(tmp_path / "ck")
    logs = []
    state = train_gamd.main([
        "--system", "lj", "--data_dir", str(tmp_path), "--sample_num", "20",
        "--seed_num", "1", "--max_epoch", "2", "--batch_size", "2",
        "--encoding_size", "16", "--hidden_dim", "16",
        "--edge_embedding_dim", "16", "--conv_layer", "1",
        "--use_layer_norm", "--use_pallas", "--relabel",
        "--checkpoint_every", "1", "--cp_dir", ck, "--cpu",
        "--matmul_precision", "highest"], log_fn=logs.append)
    assert state.step == 18
    assert {"checkpoint_0.msgpack", "checkpoint_1.msgpack", "scaler_1.npz",
            "best.msgpack", "best_val.txt", "scaler_best.npz"} <= set(
                os.listdir(ck))
    losses = [float(x) for x in re.findall(r" loss=([-\d.e]+)",
                                           " ".join(logs))]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert any(line.startswith("epoch 1 val: ") for line in logs)

    path = os.path.join(ck, "checkpoint_1.msgpack")
    out = str(tmp_path / "m.json")
    got = evaluate.main(["--system", "lj", "--ckpt", path, "--data_dir",
                         data, "--sample_num", "20", "--seed_num", "1",
                         "--use_pallas", "--cpu", "--json_out", out])
    with open(out) as f:
        assert json.load(f) == got
    ds = TrajectoryDataset(data, mode="test", sample_num=20, seed_num=1)
    items = [ds[i] for i in range(len(ds))]
    jstate, jcfg_, jsys = jckpt.load_self_describing(path, use_pallas=False)
    pred = np.asarray(JForceField(jstate, jsys, jcfg_).predict_batch(
        np.stack([it["pos"] for it in items])))
    to_ev = units.KJ_MOL_NM_TO_EV_A
    want = evaluate.force_metrics(
        pred * to_ev, np.stack([it["forces"] for it in items]) * to_ev)
    assert got["frames"] == want["frames"] == 2
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-5,
                                   atol=1e-5 if "cosine" in key else 0.0,
                                   err_msg=key)


def test_water_cli_trains_on_cpu(tmp_path):
    """train_gamd --system tip3p --cpu --use_pallas --drop_edge on four
    TIP3P-774 frames (water_box displaced, labelled by the flexible TIP3P
    forces; widths 16, one layer, K=96): finite losses, its checkpoint a
    water model with the bond row that the port's run_md path loads."""
    _write_set(str(tmp_path), "tip3p", 4)
    ck = str(tmp_path / "ck")
    logs = []
    train_gamd.main([
        "--system", "tip3p", "--data_dir", str(tmp_path), "--sample_num",
        "4", "--seed_num", "1", "--max_epoch", "1", "--encoding_size", "16",
        "--hidden_dim", "16", "--edge_embedding_dim", "16", "--conv_layer",
        "1", "--use_layer_norm", "--use_pallas", "--drop_edge",
        "--cp_dir", ck, "--cpu"], log_fn=logs.append)
    losses = [float(x) for x in re.findall(r" loss=([-\d.e]+)",
                                           " ".join(logs))]
    assert len(losses) == 1 and np.isfinite(losses).all()
    ff_state, cfg, system = tckpt.load_self_describing(
        os.path.join(ck, "checkpoint_0.msgpack"))
    assert system.name == "tip3p" and cfg.drop_edge
    assert ff_state.params["edge_encoder_w0"].shape[0] == 3 + 1 + 40 + 1
    assert "node_encoder" in ff_state.params


def test_refusals_raise_before_any_work(tmp_path):
    """--num_device above the cards torch finds raises RuntimeError naming
    the count before a file is read (the data directory does not exist),
    and a mesh whose ranks do not split the batch equally raises
    ValueError before any work (data parallelism is ported: its runs are
    tests/test_torch_parallel.py). The DFT flags, refused
    until the DFT slice, are ported: --system dft, --update_edge and
    --disable_expand_edge reach the data (the missing set's
    FileNotFoundError, no checkpoint written), evaluate --system dft
    reaches the checkpoint, and a per-sample-box system (the DFT preset)
    gets a train state (their runs: tests/test_torch_dft.py). The water
    flags, refused until the water slice, are ported: a misuse of them is
    the JAX CLI's parser error, also before a file is read (their runs:
    tests/test_torch_water_generate.py)."""
    base = ["--data_dir", str(tmp_path / "none"), "--cpu", "--cp_dir",
            str(tmp_path / "ck")]
    with pytest.raises(RuntimeError, match="--num_device 2 asks for 2"):
        train_gamd.main(["--num_device", "2", "--data_dir",
                         str(tmp_path / "none"), "--cp_dir",
                         str(tmp_path / "ck")])
    for flags in (["--system", "dft"], ["--update_edge"],
                  ["--disable_expand_edge"]):
        with pytest.raises(FileNotFoundError):
            train_gamd.main(flags + base)
    for flags in (["--system", "tip3p", "--longrange", "--no_pack"],
                  ["--system", "tip3p", "--rigid_jitter"],
                  ["--system", "tip4p", "--relabel"]):
        with pytest.raises(SystemExit):
            train_gamd.main(flags + base)
    assert not os.path.exists(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        evaluate.main(["--system", "dft", "--ckpt", "none", "--data_dir",
                       "none", "--cpu"])
    sys_kw, _ = lj_frames()
    system = tcfg.SystemConfig(**sys_kw)
    mesh = Mesh(group=None, rank=0, world_size=2,
                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="2 equal shares"):
        tloop.train(system, tcfg.ModelConfig(**TINY), tcfg.TrainConfig(),
                    ListDataset([]), mesh=mesh, device="cpu")
    dft_state = create_train_state(tcfg.ModelConfig(**TINY),
                                   tcfg.get_preset("dft"),
                                   tcfg.TrainConfig(), 1, device="cpu")
    assert dft_state.model.species == "water"
