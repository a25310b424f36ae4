"""The analytic long-range channel of the port (train/forcefield.py::
make_longrange_force_fn and GNNForceField on a checkpoint trained with
ModelConfig.longrange = "ewald_recip") and the training that makes such a
checkpoint (train/augment.py's rigid jitter, train/loop.py's step with a
water Ewald relabel_fn less the channel) on the CPU, against the JAX
package on the same numpy inputs.

The checkpoint is the committed results/ckpts/tip3p_rj_best.msgpack (4
conv layers 128 wide, LayerNorm, the bond channel, TIP3P-774 in a 20 A
box, cutoff 4.2 A, K=96), at its own system: the k-space term is of the
20 A box. Bars: the channel within CHANNEL_RTOL of JAX's largest |F|, the
model paths within MODEL_RTOL (tests/test_torch_water.py's bar for
tip3p_final), the megakernel path's plain version within MODEL_RTOL of
JAX's reference_forward plus JAX's channel, its long-range term alone the
channel's. (The megakernel forward and the eager model are two
computations: on this frame JAX's own Pallas forward lies 2.2e-2 std(F)
from JAX's eager model, the port's plain megakernel forward 8.2e-3 from
the port's; each path is held to JAX's counterpart.)
"""

import dataclasses
import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.neighbors.dense import dense_neighbor_list as jdense
from gamd_tpu.neighbors.dense import refresh_mask as jrefresh
from gamd_tpu.neighbors.topology import neighbor_bond_channel
from gamd_tpu.ops import pallas_model as jmega
from gamd_tpu.md.constraints import RigidWater as JRigidWater
from gamd_tpu.physics import water as jw
from gamd_tpu.train import augment as jaug
from gamd_tpu.train import checkpoint as jckpt
from gamd_tpu.train import loop as jloop
from gamd_tpu.train.state import build_model as jbuild
from gamd_tpu.train.state import create_train_state as jcreate
from gamd_tpu.train.state import make_optimizer as jmake_optimizer
from gamd_tpu.train.forcefield import GNNForceField as JForceField
from gamd_tpu.train.forcefield import (
    make_longrange_force_fn as jmake_longrange)

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.tools import train_gamd
from gamd_tpu_torch.train import augment as taug
from gamd_tpu_torch.train import checkpoint as tckpt
from gamd_tpu_torch.train import loop as tloop
from gamd_tpu_torch.train.forcefield import (GNNForceField,
                                             make_longrange_force_fn)
from gamd_tpu_torch.train.state import create_train_state, params_from_jax

CKPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "results", "ckpts")
CHANNEL_RTOL = 1e-4     # max |dF| / max |F|, the k-space force
MODEL_RTOL = 1e-5       # max |dF| / max |F|, a model path against JAX's
JITTER_ATOL = 1e-5      # A: rigid_transform against JAX's, and the O-H
                        # and H-H distances it keeps
PARAM_ATOL, PARAM_SHARE = 1e-5, 0.999   # the train steps' bars
SMALL_MOL, SMALL_BOX = 27, 9.4          # the training step's water box


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for this file's tests, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _frames(n_frames, n_mol, seed, box=20.0, sigma=0.05):
    """[n_frames, 3 n_mol, 3] water_box starts with seeded jitter, wrapped."""
    rng = np.random.RandomState(seed)
    base = jw.water_box(n_mol, box, seed=seed)
    return np.stack([np.mod(base + rng.normal(0.0, sigma, base.shape), box)
                     for _ in range(n_frames)]).astype(np.float32)


@pytest.mark.parametrize("name", ["tip3p", "tip4p"])
def test_make_longrange_force_fn_matches_jax(name):
    """The channel of the tip3p (774 atoms) and tip4p (753) presets on two
    frames: one call of a stack [2, N, 3] against JAX frame by frame."""
    jsys, tsys = jcfg.get_preset(name), tcfg.get_preset(name)
    frames = _frames(2, tsys.n_atoms // 3, seed=11)
    jfn = jax.jit(jmake_longrange(jsys))
    got = make_longrange_force_fn(tsys)(_t(frames))
    assert got.shape == frames.shape
    for i in range(2):
        assert _rel(got[i], jfn(jnp.asarray(frames[i]))) < CHANNEL_RTOL
    with pytest.raises(ValueError, match="unknown longrange"):
        make_longrange_force_fn(tsys, "pme")
    with pytest.raises(ValueError, match="tip3p / tip4p"):
        make_longrange_force_fn(tcfg.get_preset("lj"))


@pytest.fixture(scope="module")
def rj_best():
    """(JAX GNNForceField, port GNNForceField, system) of tip3p_rj_best."""
    path = os.path.join(CKPTS, "tip3p_rj_best.msgpack")
    jstate, jcfg_, jsys = jckpt.load_self_describing(path)
    state, cfg, system = tckpt.load_self_describing(path)
    assert cfg.longrange == jcfg_.longrange == "ewald_recip"
    assert (cfg.conv_layers, cfg.hidden_dim, cfg.use_layer_norm) == (4, 128,
                                                                     True)
    assert (system.name, system.n_atoms, system.box) == ("tip3p", 774, 20.0)
    return (JForceField(jstate, jsys, jcfg_),
            GNNForceField(state, system, cfg, device="cpu"), system,
            GNNForceField(state, system,
                          dataclasses.replace(cfg, longrange=""),
                          device="cpu"))


def test_rj_best_force_fn_and_predict_match_jax(rj_best):
    """force_fn (the model plus the k-space term, kJ/mol/A) and predict
    (dataset units, kJ/mol/nm) against JAX's; the channel's share is
    real (a wrong unit factor would show); the megakernel path's plain
    version plus the term against JAX's reference_forward plus JAX's
    channel, its closure keeping handles_refresh, and its long-range term
    alone (the same weights without the channel) the channel's."""
    jff, ff, system, ff_short = rj_best
    pos = _frames(1, 258, seed=12)[0]
    radius = system.cutoff + system.skin
    idx, mask, ovf = jdense(jnp.asarray(pos), system.box, radius,
                            system.nbr_capacity)
    assert not bool(ovf)
    live = jrefresh(jnp.asarray(pos), system.box, system.cutoff, idx, mask)
    want = np.asarray(jff.force_fn()(jnp.asarray(pos), idx, live))
    got = ff.force_fn()(_t(pos), _t(idx), _t(live))
    assert _rel(got, want) < MODEL_RTOL
    lr = make_longrange_force_fn(system)(_t(pos)).numpy()
    assert np.abs(lr).max() > 0.05 * np.abs(want).max()
    mk = ff.force_fn(megakernel=True)
    assert mk.handles_refresh
    f_mk = mk(_t(pos), _t(idx), _t(mask))
    st, cfg = jff.params, jff.model_cfg
    mp = jmega.pack_params(st, cfg, force_std=max(jff.force_stat.std, 1e-12),
                           force_mean=jff.force_stat.safe_mean,
                           unit=system.force_unit_to_internal)
    ls = jff.length_stat
    l_mean, l_std = float(ls.safe_mean), float(jnp.maximum(ls.std, 1e-12))
    ref = jax.jit(lambda p, i, k: jmega.reference_forward(
        p, i, k, jff._node_h0(), mp, system.box, system.cutoff,
        l_mean, l_std, bond=neighbor_bond_channel(i),
        rbf_gap=cfg.rbf_gap, use_ln=cfg.use_layer_norm,
        conv_act=cfg.conv_activation, mlp_act=cfg.mlp_activation))(
        jnp.asarray(pos), idx, mask)
    ref = np.asarray(ref) + np.asarray(jax.jit(jmake_longrange(jff.system))(
        jnp.asarray(pos)))
    assert _rel(f_mk, ref) < MODEL_RTOL
    term = f_mk - ff_short.force_fn(megakernel=True)(_t(pos), _t(idx),
                                                     _t(mask))
    np.testing.assert_allclose(term.numpy(), lr, rtol=0,
                               atol=MODEL_RTOL * np.abs(want).max())
    p_want = np.asarray(jff.predict(jnp.asarray(pos)))
    p_got = ff.predict(_t(pos))
    assert _rel(p_got, p_want) < MODEL_RTOL
    np.testing.assert_allclose(
        p_got.numpy(), (got.numpy() / system.force_unit_to_internal), rtol=0,
        atol=MODEL_RTOL * np.abs(p_want).max())


def test_rj_best_predict_batch_matches_jax(rj_best):
    """predict_batch of 3 frames (batches of 2, the last padded) against
    JAX's, in dataset units."""
    jff, ff = rj_best[:2]
    frames = _frames(3, 258, seed=13)
    got = ff.predict_batch(_t(frames), batch_size=2)
    want = jff.predict_batch(jnp.asarray(frames), batch_size=2)
    assert got.shape == (3, 774, 3)
    assert _rel(got, want) < MODEL_RTOL


@pytest.mark.parametrize("name", ["tip3p_lr_latest", "tip3p_rj_best",
                                  "tip3p_rj_latest"])
def test_cli_loader_takes_the_longrange_envelopes(name):
    """The deployment CLIs' loader (run_md.load_force_field, which
    analyze_rollout uses; evaluate's is load_self_describing with the same
    force field) takes each committed long-range envelope: predict of one
    frame is the same weights' prediction without the channel plus the
    channel in dataset units (1e-5 of max |F|)."""
    from gamd_tpu_torch.tools import run_md

    path = os.path.join(CKPTS, f"{name}.msgpack")
    args = run_md.build_parser().parse_args(["--system", "tip3p", "--ckpt",
                                             path, "--cpu"])
    ff, _, system = run_md.load_force_field(args, torch.device("cpu"))
    assert ff.model_cfg.longrange == "ewald_recip"
    short = GNNForceField(*tckpt.load_self_describing(path)[:1], system,
                          dataclasses.replace(ff.model_cfg, longrange=""),
                          device="cpu")
    pos = _t(_frames(1, 258, seed=14)[0])
    got = ff.predict(pos)
    want = short.predict(pos) + make_longrange_force_fn(system)(pos) \
        / system.force_unit_to_internal
    assert _rel(got, want) < MODEL_RTOL


def test_rj_best_refusals(rj_best):
    """megastep_fn and banded_force_fn refuse a long-range checkpoint with
    ValueError, as JAX's do."""
    jff, ff = rj_best[:2]
    for fn in (ff.megastep_fn, ff.banded_force_fn):
        with pytest.raises(ValueError, match="long-?range"):
            fn()
    for fn in (jff.megastep_fn, jff.banded_force_fn):
        with pytest.raises(ValueError, match="longrange"):
            fn()


# -- rigid jitter -----------------------------------------------------------------

def _rigid_frames(n_frames, seed, shift=1.3):
    """[n_frames, 81, 3] rigid water (JAX's project_initial of water_box
    with 0.1 A of seeded noise), shifted by `shift` A and wrapped, so that
    molecules straddle the boundary."""
    rng = np.random.RandomState(seed)
    base = jw.water_box(SMALL_MOL, SMALL_BOX, seed=seed)
    cst = JRigidWater(SMALL_MOL, SMALL_BOX)
    out = []
    for _ in range(n_frames):
        p = base + rng.normal(0.0, 0.1, base.shape).astype(np.float32)
        p = np.asarray(cst.project_initial(jnp.asarray(p)))
        out.append(np.mod(p + shift, SMALL_BOX))
    return np.stack(out).astype(np.float32)


def _jax_rigid_draws(key, shape, sigma_t):
    """JAX's rigid_jitter_positions draws of `key` (its split, its default
    sigma_rot)."""
    k_t, k_r = jax.random.split(key)
    return (np.asarray(sigma_t * jax.random.normal(k_t, shape)),
            np.asarray(sigma_t / 0.65 * jax.random.normal(k_r, shape)))


def _geometry(pos, box):
    """O-H1, O-H2, H1-H2 minimum-image distances [..., M, 3] (numpy)."""
    m = pos.reshape(*pos.shape[:-2], -1, 3, 3)
    d = lambda i, j: np.linalg.norm(
        np.remainder(m[..., i, :] - m[..., j, :] + box / 2, box) - box / 2,
        axis=-1)
    return np.stack([d(1, 0), d(2, 0), d(2, 1)], axis=-1)


def test_rigid_transform_matches_jax_scalar_box():
    """rigid_transform of JAX's draws on 3 wrapped frames at a scalar box
    against JAX's rigid_jitter_positions (the molecules made whole from
    their first atom); the distances kept to JITTER_ATOL; the torch draws
    of draw_rigid_jitter have the shape and scales asked for."""
    frames = _rigid_frames(3, seed=21)
    assert np.abs(frames[:, 1::3] - frames[:, 0::3]).max() > SMALL_BOX / 2
    key = jax.random.PRNGKey(5)
    sigma = 0.05
    want = np.asarray(jaug.rigid_jitter_positions(
        key, jnp.asarray(frames), sigma, box=SMALL_BOX))
    dt, omega = _jax_rigid_draws(key, (3, SMALL_MOL, 1, 3), sigma)
    got = taug.rigid_transform(_t(frames), _t(dt), _t(omega), SMALL_BOX)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JITTER_ATOL)
    np.testing.assert_allclose(_geometry(got.numpy(), SMALL_BOX),
                               _geometry(frames, SMALL_BOX), rtol=0,
                               atol=JITTER_ATOL)
    gen = torch.Generator().manual_seed(0)
    tdt, tom = taug.draw_rigid_jitter(gen, _t(frames), 0.2)
    assert tdt.shape == tom.shape == (3, SMALL_MOL, 1, 3)
    assert 0.15 < float(tdt.std()) < 0.25
    assert 0.2 < float(tom.std()) < 0.4


@pytest.mark.parametrize("box_shape", ["B", "B3"])
def test_rigid_transform_per_frame_boxes(box_shape):
    """A [B] or [B, 3] box (three frames in boxes of 9.4, 9.9 and 10.4 A)
    against JAX called frame by frame at each frame's scalar box, each
    frame's draws JAX's of that call's key; the distances kept to
    JITTER_ATOL."""
    boxes = np.array([9.4, 9.9, 10.4], np.float32)
    frames = np.stack([np.mod(f, b) for f, b in zip(
        _rigid_frames(3, seed=22, shift=4.0), boxes)]).astype(np.float32)
    sigma = 0.05
    keys = [jax.random.PRNGKey(10 + b) for b in range(3)]
    draws = [_jax_rigid_draws(k, (SMALL_MOL, 1, 3), sigma) for k in keys]
    dt, omega = (np.stack(d) for d in zip(*draws))
    box = boxes if box_shape == "B" else np.repeat(boxes[:, None], 3, 1)
    got = taug.rigid_transform(_t(frames), _t(dt), _t(omega),
                               torch.as_tensor(box)).numpy()
    for b in range(3):
        want = np.asarray(jaug.rigid_jitter_positions(
            keys[b], jnp.asarray(frames[b]), sigma, box=float(boxes[b])))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=JITTER_ATOL)
        np.testing.assert_allclose(_geometry(got[b], boxes[b]),
                                   _geometry(frames[b], boxes[b]), rtol=0,
                                   atol=JITTER_ATOL)


# -- one long-range, relabel and rigid-jitter training step ------------------------

def _param_diffs(tree, jax_params):
    out = []
    for path, want in jax.tree_util.tree_flatten_with_path(jax_params)[0]:
        got = tree
        for key in path:
            got = got[key.key]
        out.append(np.abs(np.asarray(got) - np.asarray(want)).ravel())
    return np.concatenate(out)


def test_longrange_relabel_rigid_jitter_step_matches_jax(monkeypatch):
    """One step of train_gamd's --longrange --relabel --rigid_jitter
    configuration (widths 16, 2 layers, LayerNorm, no rotation or dropout;
    TIP3P-81 in a 9.4 A box, cutoff 4.2 A, batches of 2 rigid frames)
    from JAX's initial weights, the port's rigid-jitter draws replaced by
    JAX's of each step's key: the relabelled positions and labels (the
    rigid Ewald oracle less the k-space channel, kJ/mol/nm, built by
    train_gamd.make_relabel_fn) within 1e-4 of their max, each loss at
    rtol 1e-5, the weights within 1e-5 for 99.9% and 2 lr for all
    (tests/test_torch_train_loop.py's bars)."""
    sys_kw = dict(n_atoms=3 * SMALL_MOL, box=SMALL_BOX, cutoff=4.2,
                  nbr_capacity=64, skin=0.5)
    jsys, tsys = (jcfg.get_preset("tip3p", **sys_kw),
                  tcfg.get_preset("tip3p", **sys_kw))
    cfg_kw = dict(encoding_size=16, hidden_dim=16, edge_embedding_dim=16,
                  conv_layers=2, dropout=0.0, use_layer_norm=True,
                  longrange="ewald_recip")
    train_kw = dict(max_epoch=1, batch_size=2, rotate_aug=False,
                    jitter_sigma=0.05, rigid_jitter=True)
    jtrain = jcfg.TrainConfig(**train_kw)
    jmodel = jbuild(jcfg.ModelConfig(**cfg_kw), jsys)
    jstate = jcreate(jmodel, jsys, jtrain, 1)
    from gamd_tpu.physics import ewald as jewald
    jew = jewald.make_ewald_params(SMALL_BOX)
    jlr = jmake_longrange(jsys)

    def jrelabel(p):
        return (-jax.grad(jw.tip3p_energy_rigid_ewald)(
            p, SMALL_BOX, jew, jw.TIP3PParams()) - jlr(p)) * 10.0
    jstep = jloop.make_train_step(jmodel, jsys, jtrain,
                                  jmake_optimizer(jtrain, 1),
                                  relabel_fn=jrelabel)
    ttrain = tcfg.TrainConfig(**train_kw)
    state = create_train_state(tcfg.ModelConfig(**cfg_kw), tsys, ttrain, 1,
                               device="cpu")
    state.model.load_params(params_from_jax(jstate.params), {})
    relabel = train_gamd.make_relabel_fn(tsys, longrange=True)
    step = tloop.make_train_step(state.model, tsys, ttrain,
                                 relabel_fn=relabel)

    frames = _rigid_frames(2, seed=23)
    feat = np.broadcast_to(tsys.species_onehot(), (2, 3 * SMALL_MOL, 1))
    for s in range(1):
        rng = jax.random.fold_in(jstate.rng, jstate.step)
        k_jit = jax.random.split(rng, 4)[1]
        draws = _jax_rigid_draws(k_jit, (2, SMALL_MOL, 1, 3), 0.05)
        monkeypatch.setattr(taug, "draw_rigid_jitter",
                            lambda *a, **k: tuple(_t(d) for d in draws))
        batch = {"pos": frames[2 * s:2 * s + 2], "feat": feat,
                 "forces": np.zeros_like(frames[:2])}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: _t(v) for k, v in batch.items()})
        jpos = jnp.asarray(np.mod(frames[2 * s:2 * s + 2], SMALL_BOX))
        jpos = jaug.rigid_jitter_positions(k_jit, jpos, 0.05, box=SMALL_BOX)
        np.testing.assert_allclose(m["pos"].numpy(), np.asarray(jpos),
                                   rtol=0, atol=JITTER_ATOL)
        want = np.asarray(jax.vmap(jrelabel)(jpos))
        got = relabel(m["pos"]).numpy()
        assert _rel(got, want) < 1e-4
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {s}")
    diffs = _param_diffs(state.model.export_params()[0], jstate.params)
    assert np.mean(diffs <= PARAM_ATOL) >= PARAM_SHARE
    assert diffs.max() <= 2 * ttrain.lr
