"""Port parity of the training slice on the CPU: the conv-message function
and its backward, GAMDNet in train mode, the streaming scalers, the LJ
labels, the rotation augmentation, the Adam schedule, and three whole
training steps, each against the JAX package on the same inputs (made with
numpy from a seed). JAX's Pallas kernels run in interpret mode, as
tests/test_ops.py runs them. The CUDA kernels themselves are held against
their plain versions in tests/test_torch_cuda.py and chip_smoke.py, on the
card."""

import contextlib
import functools
import os
from unittest import mock

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.models import normalizer as jnorm
from gamd_tpu.models.gnn import GAMDNet as JGAMDNet
from gamd_tpu.neighbors.dense import dense_neighbor_list as jdense
from gamd_tpu.ops.pallas_mp import (_conv_msg_gather_reference,
                                    fused_conv_gather_message as jfused)
from gamd_tpu.physics import lennard_jones as jlj
from gamd_tpu.train import augment as jaug
from gamd_tpu.train.loop import make_train_step as jmake_train_step
from gamd_tpu.train.state import build_model, create_train_state as jcreate
from gamd_tpu.train.state import make_optimizer as jmake_optimizer

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.models import normalizer as tnorm
from gamd_tpu_torch.models.gnn import GAMDNet
from gamd_tpu_torch.neighbors.dense import dense_neighbor_list
from gamd_tpu_torch.ops.conv_gather import (conv_msg_gather_reference,
                                            fused_conv_gather_message,
                                            source_order)
from gamd_tpu_torch.physics import lennard_jones as tlj
from gamd_tpu_torch.train import augment as taug
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.loop import make_train_step
from gamd_tpu_torch.train.state import (create_train_state, init_params,
                                        lr_factor, make_optimizer,
                                        params_from_jax)

WIDTH = 128
GRAD_NAMES = ("e", "hn", "src_nodes", "dst_code",
              "w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _msg_inputs(rng, n, k, widths=(WIDTH, WIDTH, WIDTH)):
    """e, idx, mask, hn, src_nodes, dst_code and the 8 weights, numpy, as
    tests/test_ops.py::_gather_msg_inputs draws them, at widths (E, H,
    D)."""
    ew, w, dw = widths
    e = rng.randn(n, k, ew).astype(np.float32) * 0.3
    idx = rng.randint(0, n, (n, k)).astype(np.int32)
    mask = rng.rand(n, k) > 0.3
    hn = rng.randn(n, dw).astype(np.float32) * 0.5
    src = rng.randn(n, w).astype(np.float32) * 0.5
    dst = rng.randn(n, w).astype(np.float32) * 0.3
    ws = [rng.randn(*s).astype(np.float32) * 0.08
          for s in [(ew, w), (w,), (w, w), (w,), (w, w), (w,), (w, dw),
                    (dw,)]]
    return e, idx, mask, hn, src, dst, ws


#: (E, H, D) of the DFT model, and the widest the JAX Pallas kernels take
#: in interpret mode: they gather [hn | src] as one table 2 D wide
#: (gamd_tpu/ops/pallas_mp.py:447-450), so they need H = D; at the DFT
#: model's 256/128/256 only JAX's reference computes.
DFT_WIDTHS = (256, WIDTH, 256)
PALLAS_WIDE = (256, 256, 256)


def _assert_rel(actual, expected, rel, name="", floor=1e-30):
    """max |a - b| <= rel * max(max |b|, floor) (a tensor's own scale)."""
    a, b = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    scale = max(float(np.abs(b).max()), floor)
    err = float(np.abs(a - b).max())
    assert err <= rel * scale, f"{name}: max |d| {err} > {rel} * {scale}"


def _precision(exact):
    """(context, torch dtype) of a comparison: fp32, or with `exact` float64
    on both sides (JAX inside jax.enable_x64). The BatchNorm cases take
    float64: the LJ node embedding reaches layer 0's BatchNorm as identical
    rows, whose batch variance is 0, so train mode scales fp32 rounding
    noise by 1/sqrt(eps) = 316 there (and the next layer's nearly equal
    rows amplify it too). Both packages then compute different noise at
    fp32; in float64 the noise is gone and the algorithms are compared."""
    if exact:
        return jax.enable_x64(True), torch.float64
    return contextlib.nullcontext(), torch.float32


def _off_symmetric_point(params, seed):
    """params with seeded BatchNorm scales and biases. At the initial ones
    (scale 1, bias 0) every LJ atom's row stays identical through every
    BatchNorm layer, so in exact arithmetic the gradients of the edge
    pipeline vanish and only rounding noise is left to compare."""
    rng = np.random.RandomState(seed)
    conv = dict(params["graph_conv"])
    for name in [n for n in conv if n.startswith("norm_")]:
        d = np.asarray(conv[name]["bias"]).shape
        conv[name] = {"scale": jnp.asarray(1.0 + 0.1 * rng.randn(*d),
                                           jnp.float32),
                      "bias": jnp.asarray(0.5 * rng.randn(*d), jnp.float32)}
    return {**params, "graph_conv": conv}


# -- the conv-message function --------------------------------------------

@pytest.mark.parametrize("against,widths", [
    pytest.param("reference", (WIDTH,) * 3, id="reference"),
    pytest.param("pallas_interpret", (WIDTH,) * 3, id="pallas_interpret"),
    pytest.param("reference", DFT_WIDTHS, id="reference-256_128_256"),
    pytest.param("pallas_interpret", PALLAS_WIDE,
                 id="pallas_interpret-256_256_256")])
def test_conv_gather_forward_matches_jax(against, widths):
    """The plain forward at n=20, k=8, widths (E, H, D) 128 or the DFT
    model's 256/128/256: within 1e-5 of JAX's fp32 reference; within the
    JAX kernel's own 0.05 of its interpret-mode Pallas kernel (bf16
    operands, tests/test_ops.py:170-190), at 128 and at 256/256/256
    (PALLAS_WIDE: that kernel needs H = D)."""
    e, idx, mask, hn, src, dst, ws = _msg_inputs(np.random.RandomState(6),
                                                 20, 8, widths)
    out = conv_msg_gather_reference(_t(e), _t(idx), _t(mask), _t(hn),
                                    _t(src), _t(dst), *map(_t, ws)).numpy()
    jargs = [jnp.asarray(a) for a in (e, idx, mask, hn, src, dst, *ws)]
    if against == "reference":
        ref = _conv_msg_gather_reference(*jargs)
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    else:
        ref = jfused(*jargs, 8, True)
        np.testing.assert_allclose(out, np.asarray(ref), rtol=0.05,
                                   atol=0.05)


def _torch_grads(e, idx, mask, hn, src, dst, ws):
    """The 12 grads of sum(out * cos(out)) through the port's entry point
    (CPU: autograd through the plain version), batch of one."""
    leaves = [_t(a).requires_grad_(True) for a in (e, hn, src, dst, *ws)]
    te, thn, tsrc, tdst, *tws = leaves
    out = fused_conv_gather_message(te[None], _t(idx)[None], _t(mask)[None],
                                    thn[None], tsrc[None], tdst[None], *tws)
    torch.sum(out * torch.cos(out)).backward()
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("against,rel,widths", [
    pytest.param("reference", 1e-5, (WIDTH,) * 3, id="reference-1e-05"),
    pytest.param("pallas_interpret", 4e-2, (WIDTH,) * 3,
                 id="pallas_interpret-0.04"),
    pytest.param("reference", 1e-5, DFT_WIDTHS,
                 id="reference-1e-05-256_128_256")])
def test_conv_gather_backward_matches_jax(against, rel, widths):
    """The plain backward (autograd) for all 12 grads at widths (E, H, D)
    128 or 256/128/256, against jax.grad of the reference at 1e-5 of each
    tensor's max, and at 128 against the JAX backward kernel in interpret
    mode at its own 4e-2 (tests/test_ops.py:336-366). That kernel cannot
    take 256/128/256 (PALLAS_WIDE), and at 256/256/256 its single-pass
    bf16 products leave a few of w4's gradients past its own 4e-2."""
    e, idx, mask, hn, src, dst, ws = _msg_inputs(np.random.RandomState(12),
                                                 20, 8, widths)
    got = _torch_grads(e, idx, mask, hn, src, dst, ws)
    jidx, jmask = jnp.asarray(idx), jnp.asarray(mask)

    def loss(e_, hn_, src_, dst_, ws_):
        if against == "reference":
            out = _conv_msg_gather_reference(e_, jidx, jmask, hn_, src_,
                                             dst_, *ws_)
        else:
            out = jfused(e_, jidx, jmask, hn_, src_, dst_, *ws_, 8, True)
        return jnp.sum(out * jnp.cos(out))

    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in (e, hn, src, dst)),
        [jnp.asarray(w) for w in ws])
    want = list(g[:4]) + list(g[4])
    for name, a, b in zip(GRAD_NAMES, got, want):
        if against == "reference":
            _assert_rel(a, b, rel, name)
        else:
            np.testing.assert_allclose(a, np.asarray(b), rtol=rel, atol=rel,
                                       err_msg=name)


def test_conv_gather_batched_weight_grads_match_jax_vmap():
    """B=2: the entry point's weight grads are summed over the batch, as
    JAX's vmap of the reference gives them (tests/test_ops.py:369-405);
    within 1e-5 of each tensor's max."""
    rng = np.random.RandomState(13)
    batches = [_msg_inputs(rng, 16, 8) for _ in range(2)]
    stack = lambda j: np.stack([b[j] for b in batches])
    e, idx, mask, hn, src, dst = (stack(j) for j in range(6))
    ws = batches[0][6]

    tws = [_t(w).requires_grad_(True) for w in ws]
    out = fused_conv_gather_message(_t(e), _t(idx), _t(mask), _t(hn),
                                    _t(src), _t(dst), *tws)
    torch.sum(out ** 2).backward()

    def loss(ws_):
        out = jax.vmap(lambda *a: _conv_msg_gather_reference(*a, *ws_))(
            *(jnp.asarray(a) for a in (e, idx, mask, hn, src, dst)))
        return jnp.sum(out ** 2)

    want = jax.grad(loss)([jnp.asarray(w) for w in ws])
    for name, a, b in zip(GRAD_NAMES[4:], tws, want):
        _assert_rel(a.grad.numpy(), b, 1e-5, name)


def test_source_order_lists_live_edges_by_source():
    """The backward's index bookkeeping: keys are the slots' sources sorted
    (m for a masked slot, last), int16 below 2^15 - 1 nodes; order[q] over
    the run of keys equal to j are exactly the live slots i*K+k with
    idx = j, ascending."""
    rng = np.random.RandomState(3)
    m, k = 30, 12
    idx = rng.randint(0, m, (m, k)).astype(np.int32)
    mask = rng.rand(m, k) > 0.4
    order, keys = source_order(_t(idx), _t(mask), m)
    assert order.dtype == torch.int64 and keys.dtype == torch.int16
    order, keys = order.numpy(), keys.numpy()
    flat_idx, flat_mask = idx.reshape(-1), mask.reshape(-1)
    assert bool((np.diff(keys) >= 0).all())
    assert (keys == m).sum() == (~flat_mask).sum()
    for j in range(m):
        want = np.nonzero(flat_mask & (flat_idx == j))[0]
        np.testing.assert_array_equal(order[keys == j], want)
    big = 2 ** 15
    _, keys = source_order(_t(idx), _t(mask), big)
    assert keys.dtype == torch.int32 and int(keys.max()) == big


# -- GAMDNet in train mode --------------------------------------------------

def _model_case(use_layer_norm, seed=14):
    rng = np.random.RandomState(seed)
    n, box = 24, 10.0
    pos = rng.uniform(0, box, (1, n, 3)).astype(np.float32)
    idx, mask, _ = jax.vmap(lambda p: jdense(p, box, 4.5, 8))(
        jnp.asarray(pos))
    kw = dict(encoding_size=WIDTH, hidden_dim=WIDTH,
              edge_embedding_dim=WIDTH, conv_layers=2, dropout=0.0,
              use_layer_norm=use_layer_norm)
    return pos, np.asarray(idx), np.asarray(mask), box, kw


@pytest.mark.parametrize("use_layer_norm", [True, False])
@pytest.mark.parametrize("jax_pallas,tol", [(False, 1e-5), (True, 6e-2)])
def test_gamdnet_train_mode_matches_jax(use_layer_norm, jax_pallas, tol):
    """GAMDNet(use_pallas=True) in train mode (n=24, 2 layers, dropout 0),
    LayerNorm or BatchNorm (its scales and biases seeded, see
    _off_symmetric_point): outputs, every parameter grad of mean |out| and
    the BatchNorm running stats, against JAX use_pallas=False at 1e-5 of
    each tensor's max (BatchNorm in float64, see _precision), and against
    JAX use_pallas=True (interpret mode, bf16 operands, fp32) at the JAX
    6e-2 (tests/test_ops.py:408-445)."""
    pos, idx, mask, box, kw = _model_case(use_layer_norm)
    context, dtype = _precision(not use_layer_norm and not jax_pallas)
    with context:
        pos = jnp.asarray(pos, jnp.float64 if dtype == torch.float64
                          else jnp.float32)
        jmodel = JGAMDNet(cfg=jcfg.ModelConfig(use_pallas=jax_pallas, **kw))
        variables = JGAMDNet(cfg=jcfg.ModelConfig(**kw)).init(
            jax.random.PRNGKey(0), pos, idx, mask, box, 2.0, 0.8)
        params = variables["params"]
        batch_stats = variables.get("batch_stats", {})
        if not use_layer_norm:
            params = _off_symmetric_point(params, seed=1)

        def jloss(p):
            v = {"params": p, **({"batch_stats": batch_stats}
                                 if batch_stats else {})}
            out, upd = jmodel.apply(v, pos, idx, mask, box, 2.0, 0.8,
                                    train=True, mutable=["batch_stats"])
            return jnp.mean(jnp.abs(out)), (out, upd.get("batch_stats", {}))

        jgrads, (jout, jstats) = jax.jit(jax.grad(jloss, has_aux=True))(
            params)

    net = GAMDNet(tcfg.ModelConfig(use_pallas=True, **kw)).load_params(
        params_from_jax(params), params_from_jax(batch_stats)).to(dtype)
    out = net(_t(pos, dtype), _t(idx), _t(mask), box, 2.0, 0.8, train=True)
    torch.mean(torch.abs(out)).backward()
    grads = {name: t.grad for name, t in net.named_parameters()}
    _, new_stats = net.export_params()

    floor = _grad_floor(jgrads)
    check = _assert_rel if not jax_pallas else (
        lambda a, b, rel, name, floor=0: np.testing.assert_allclose(
            a, np.asarray(b), rtol=rel, atol=rel, err_msg=name))
    check(out.detach().numpy(), jout, tol, "out")
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for path, want in flat:
        check(grads[_dotted(path)].numpy(), want, tol, _dotted(path), floor)
    assert len(flat) == len(grads) >= 20
    for path, want in jax.tree_util.tree_flatten_with_path(jstats)[0]:
        check(_params_at(new_stats, path), want, tol, "batch_stats")
    assert bool(new_stats) == (not use_layer_norm)


def _grad_floor(grads):
    """1e-6 of the largest gradient of a model: the scale a gradient that
    vanishes in exact arithmetic is held to (layer 0's BatchNorm scale: its
    LJ rows are identical, so x - mean is 0 and so is d/d scale)."""
    return 1e-6 * max(float(np.abs(np.asarray(g)).max())
                      for g in jax.tree.leaves(grads))


def _dotted(path):
    return ".".join(str(p.key) for p in path)


def _params_at(tree, path):
    return _params_at_keys(tree, [p.key for p in path])


def _params_at_keys(tree, keys):
    for key in keys:
        tree = tree[key]
    return np.asarray(tree)


@pytest.mark.parametrize("draw", ["drop_edge", "dropout"])
def test_train_mode_draws_apply_their_masks(draw):
    """The torch and JAX random streams differ, so the train-mode draws are
    held to their definition: drop_edge ANDs a Bernoulli(0.8) keep into
    each conv layer's mask, edge dropout keeps e / 0.9 where a
    Bernoulli(0.9) draw is set and 0 elsewhere (flax), both drawn in order
    from the generator passed in. Each train-mode result equals the eval
    result on the masks drawn by hand from the same seed (to fp32
    rounding: the two run different op sequences)."""
    pos, idx, mask, box, kw = _model_case(True)
    cfg = tcfg.ModelConfig(**{**kw, "dropout": 0.1 if draw == "dropout"
                              else 0.0, "drop_edge": draw == "drop_edge"})
    system = tcfg.get_preset("lj", n_atoms=pos.shape[1], box=box)
    net = GAMDNet(cfg).load_params(init_params(cfg, system, seed=4).params)
    pos, idx, mask = _t(pos), _t(idx), _t(mask)
    gen = lambda: torch.Generator().manual_seed(11)
    with torch.no_grad():
        if draw == "dropout":
            got = net.encode_edges(pos, idx, box, 2.0, 0.8, train=True,
                                   generator=gen())
            e = net.encode_edges(pos, idx, box, 2.0, 0.8)
            keep = torch.rand(e.shape, generator=gen()) < 0.9
            want = torch.where(keep, e / 0.9, 0.0)
            assert 0.88 < float(keep.float().mean()) < 0.92
        else:
            got = net(pos, idx, mask, box, 2.0, 0.8, train=True,
                      generator=gen())
            g = gen()
            keeps = [torch.rand(mask.shape, generator=g) < 0.8
                     for _ in range(cfg.conv_layers)]
            e = net.encode_edges(pos, idx, box, 2.0, 0.8)
            h = net.node_emb.expand(1, pos.shape[1], -1)
            for layer, keep in enumerate(keeps):
                hn = getattr(net.graph_conv, f"norm_{layer}")(h)
                conv = getattr(net.graph_conv, f"conv_{layer}")
                h = conv(h, hn, e, idx, mask & keep)
            want = net.graph_decoder(h)
            assert 0.75 < float(keeps[0].float().mean()) < 0.85
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# -- scalers, LJ labels, augmentation, optimizer ---------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_scalers_match_jax(masked):
    """update_stat (twice), merge_stats and normalize against JAX, with and
    without a mask: rtol 1e-5 (the mean of near-cancelling values also to
    1e-5 of the values' scale)."""
    rng = np.random.RandomState(5)
    vals = [rng.normal(1.5, 2.0, (2, 16, 8)).astype(np.float32)
            for _ in range(2)]
    mask = rng.rand(2, 16, 8) > 0.3 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    js, ts = jnorm.init_stat(), tnorm.init_stat(torch.device("cpu"))
    for v in vals:
        js = jnorm.update_stat(js, jnp.asarray(v), mask=jm)
        ts = tnorm.update_stat(ts, _t(v), mask=tm)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-5)
    jm2 = jnorm.merge_stats(js, js)
    tm2 = tnorm.merge_stats(ts, ts)
    for a, b in zip(tm2, jm2):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    np.testing.assert_allclose(tnorm.normalize(_t(vals[0]), ts).numpy(),
                               np.asarray(jnorm.normalize(
                                   jnp.asarray(vals[0]), js)),
                               rtol=1e-5, atol=1e-5)
    empty = tnorm.init_stat(torch.device("cpu"))
    assert float(empty.var) == 1.0 and float(empty.safe_mean) == 0.0


def test_lj_energies_and_forces_match_jax():
    """lj_energy_dense, lj_forces_dense (one frame and a batch),
    lj_energy_neighbors and lj_force_fn on a jittered 32-atom lattice in a
    10 A box, against JAX at rtol 1e-5 (forces also 1e-5 of their max)."""
    box, pos = _lattice_frames(1, seed=2)
    params = tlj.LJParams(cutoff=4.99)
    jparams = jlj.LJParams(cutoff=4.99)
    p = pos[0]
    np.testing.assert_allclose(
        float(tlj.lj_energy_dense(_t(p), box, params)),
        float(jlj.lj_energy_dense(jnp.asarray(p), box, jparams)), rtol=1e-5)
    want = np.asarray(jlj.lj_forces_dense(jnp.asarray(p), box, jparams))
    _assert_rel(tlj.lj_forces_dense(_t(p), box, params).numpy(), want, 1e-5)
    batched = tlj.lj_forces_dense(_t(np.stack([p, p])), box, params)
    _assert_rel(batched[1].numpy(), want, 1e-5)
    idx, mask, _ = jdense(jnp.asarray(p), box, 4.99, 31)
    np.testing.assert_allclose(
        float(tlj.lj_energy_neighbors(_t(p), _t(idx), _t(mask), box,
                                      params)),
        float(jlj.lj_energy_neighbors(jnp.asarray(p), idx, mask, box,
                                      jparams)), rtol=1e-5)
    f_nbr = tlj.lj_force_fn(box, params)(_t(p), _t(idx), _t(mask))
    assert bool(torch.isfinite(f_nbr).all())
    _assert_rel(f_nbr.numpy(), np.asarray(jlj.lj_force_fn(box, jparams)(
        jnp.asarray(p), idx, mask)), 1e-5)


def test_rotation_from_ks_matches_jax_for_all_64_triples():
    """rotation_from_ks(ks) against JAX random_flip_rotation with its draws
    set to ks (apply forced on), for every ks in {-2,-1,0,1}^3: the same
    float32 matrices to 1e-7."""
    triples = np.array(np.meshgrid(*[np.arange(-2, 2)] * 3,
                                   indexing="ij")).reshape(3, -1).T
    got = taug.rotation_from_ks(_t(triples)).numpy()
    for ks, r in zip(triples, got):
        with mock.patch.object(jax.random, "randint",
                               lambda *a, _k=ks: jnp.asarray(_k)), \
                mock.patch.object(jax.random, "uniform",
                                  lambda *a: jnp.float32(0.0)):
            want = np.asarray(jaug.random_flip_rotation(
                jax.random.PRNGKey(0), prob=0.3))
        np.testing.assert_allclose(r, want, rtol=0, atol=1e-7,
                                   err_msg=str(ks))


def test_rotate_sample_matches_jax():
    """rotate_sample with JAX's drawn matrix (seeds chosen so some frames
    rotate): positions and forces within 1e-5 of JAX's rotate_sample; and
    rigid_jitter_positions on 3-site groups (below)."""
    box, pos = _lattice_frames(1, seed=4)
    forces = np.random.RandomState(4).randn(*pos[0].shape).astype(np.float32)
    rotated = 0
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        r = np.asarray(jaug.random_flip_rotation(key, prob=0.5))
        rotated += not np.allclose(r, np.eye(3))
        jp, jf, _ = jaug.rotate_sample(key, jnp.asarray(pos[0]),
                                       jnp.asarray(forces), box, prob=0.5)
        tp, tf, _ = taug.rotate_sample(_t(pos[0]), _t(forces), box,
                                       _t(r))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                                   atol=1e-5)
    assert rotated >= 1
    # rigid_jitter_positions, ported since: the first 30 sites as ten
    # 3-site groups, JAX's draws through the port's transform (1e-5), and
    # the port's own draws keep each group's minimum-image distances.
    key, sites = jax.random.PRNGKey(9), pos[0][:30]
    k_t, k_r = jax.random.split(key)
    dt = 0.01 * np.asarray(jax.random.normal(k_t, (10, 1, 3)))
    om = 0.01 / 0.65 * np.asarray(jax.random.normal(k_r, (10, 1, 3)))
    np.testing.assert_allclose(
        taug.rigid_transform(_t(sites), _t(dt), _t(om), box).numpy(),
        np.asarray(jaug.rigid_jitter_positions(key, jnp.asarray(sites), 0.01,
                                               box=box)), rtol=0, atol=1e-5)
    moved = taug.rigid_jitter_positions(torch.Generator().manual_seed(0),
                                        _t(sites), 0.01, box=box).numpy()
    gap = lambda x: np.linalg.norm(np.remainder(
        x.reshape(10, 3, 1, 3) - x.reshape(10, 1, 3, 3) + box / 2, box)
        - box / 2, axis=-1)
    np.testing.assert_allclose(gap(moved), gap(sites), rtol=0, atol=1e-5)


def test_adam_schedule_and_updates_match_optax():
    """The staircase lr at updates 0, T-1, T and 3T (T = steps/epoch x
    lr_step_epochs) and three Adam updates on fixed grads, against optax at
    rtol 1e-5 (parameters within 1e-6 absolute)."""
    cfg = tcfg.TrainConfig(max_epoch=30, lr_step_epochs=5)
    steps_per_epoch = 7
    period = steps_per_epoch * cfg.lr_step_epochs
    jtx = jmake_optimizer(jcfg.TrainConfig(max_epoch=30, lr_step_epochs=5),
                          steps_per_epoch)
    factor = lr_factor(cfg, steps_per_epoch)
    schedule = optax.exponential_decay(
        init_value=cfg.lr, transition_steps=period,
        decay_rate=cfg.lr_total_decay ** (cfg.lr_step_epochs
                                          / cfg.max_epoch), staircase=True)
    for t in (0, period - 1, period, 3 * period):
        np.testing.assert_allclose(cfg.lr * factor(t), float(schedule(t)),
                                   rtol=1e-5)

    rng = np.random.RandomState(9)
    w0 = rng.randn(4, 3).astype(np.float32)
    grads = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    w = torch.nn.Parameter(_t(w0))
    opt, sched = make_optimizer([w], cfg, steps_per_epoch)
    jw, jstate = jnp.asarray(w0), jtx.init(jnp.asarray(w0))
    for g in grads:
        w.grad = _t(g)
        opt.step()
        sched.step()
        upd, jstate = jtx.update(jnp.asarray(g), jstate, jw)
        jw = jw + upd
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw),
                                   rtol=1e-5, atol=1e-6)


# -- three training steps -----------------------------------------------------

BOX, N_ATOMS, CUTOFF, K = 10.0, 32, 4.5, 16
STEP_CFG = dict(encoding_size=WIDTH, hidden_dim=WIDTH,
                edge_embedding_dim=WIDTH, conv_layers=2, dropout=0.0)
TRAIN_CFG = dict(rotate_aug=False, jitter_sigma=0.0)
LJ_CUTOFF = 4.99       # below half the box: one image per pair


def _lattice_frames(n_frames, seed):
    """(box, [F, 32, 3] float32): lj_fluid_box's 32-site lattice scaled
    into the 10 A box, with a seeded 0.1 A Gaussian jitter per frame."""
    box0, lattice = tlj.lj_fluid_box(N_ATOMS, 0.5)
    rng = np.random.default_rng(seed)
    frames = lattice * (BOX / box0) + rng.normal(
        0.0, 0.1, (n_frames,) + lattice.shape)
    return BOX, np.mod(frames, BOX).astype(np.float32)


def _step_batches():
    """Three batches of two frames each (labels replaced by the relabel)."""
    _, frames = _lattice_frames(6, seed=7)
    return [frames[2 * s:2 * s + 2] for s in range(3)]


def _step_system():
    return dict(n_atoms=N_ATOMS, box=BOX, cutoff=CUTOFF, nbr_capacity=K,
                skin=0.0)


@functools.lru_cache(maxsize=None)
def _jax_steps(use_layer_norm, exact=True):
    """Three steps of JAX make_train_step (use_pallas=False, XLA; float64
    with `exact`, see test_three_train_steps_match_jax, else fp32): one
    record per step of the state
    before it (params, batch_stats, Adam mu/nu/count, scalers), its metrics
    and scalers after it, its grads (from Adam's first moment of the same
    step taken from zero moments) and the params and batch_stats after
    it."""
    system = jcfg.get_preset("lj", **_step_system())
    cfg = jcfg.ModelConfig(use_layer_norm=use_layer_norm, **STEP_CFG)
    train_cfg = jcfg.TrainConfig(**TRAIN_CFG)
    context, dtype = _precision(exact)
    jdtype = jnp.float64 if exact else jnp.float32
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    records = []
    with context:
        model = build_model(cfg, system)
        state = jcreate(model, system, train_cfg, 1)
        if not use_layer_norm:
            state = state.replace(params=_off_symmetric_point(state.params,
                                                              seed=2))
        params = jlj.LJParams(cutoff=LJ_CUTOFF)
        tx = jmake_optimizer(train_cfg, 1)
        step = jmake_train_step(model, system, train_cfg, tx,
                                relabel_fn=lambda p: jlj.lj_forces_dense(
                                    p, BOX, params))
        for pos in _step_batches():
            adam = state.opt_state[0]
            before = dict(params=np_tree(state.params),
                          batch_stats=np_tree(state.batch_stats),
                          mu=np_tree(adam.mu), nu=np_tree(adam.nu),
                          count=int(adam.count),
                          stats=[float(x) for x in (*state.force_stat,
                                                    *state.length_stat)])
            batch = {"pos": jnp.asarray(pos, jdtype),
                     "forces": jnp.zeros(pos.shape, jdtype)}
            # The same step from zero Adam moments: its first moment is
            # exactly 0.1 * grad.
            probe, _ = step(state.replace(opt_state=tx.init(state.params)),
                            batch)
            grads = jax.tree.map(lambda mu: np.asarray(mu) / 0.1,
                                 probe.opt_state[0].mu)
            state, m = step(state, batch)
            records.append(dict(
                before=before, grads=grads,
                metrics={k: float(v) for k, v in m.items()},
                stats=[float(x) for x in (*state.force_stat,
                                          *state.length_stat)],
                params=np_tree(state.params),
                batch_stats=np_tree(state.batch_stats)))
    return records


def _port_state(use_layer_norm, use_pallas, before, dtype):
    """A port TrainState on the CPU holding a JAX record's pre-step state:
    weights, BatchNorm running stats, Adam moments and count (the lr
    schedule set to that count), scalers."""
    system = tcfg.get_preset("lj", **_step_system())
    cfg = tcfg.ModelConfig(use_layer_norm=use_layer_norm,
                           use_pallas=use_pallas, **STEP_CFG)
    train_cfg = tcfg.TrainConfig(**TRAIN_CFG)
    state = create_train_state(cfg, system, train_cfg, 1, seed=0,
                               device="cpu")
    state.model.load_params(params_from_jax(before["params"]),
                            params_from_jax(before["batch_stats"]))
    state.model.to(dtype)
    if before["count"]:
        for name, p in state.model.named_parameters():
            path = name.split(".")
            moment = lambda tree: _t(_params_at_keys(tree, path), dtype)
            state.optimizer.state[p] = {
                "step": torch.tensor(float(before["count"])),
                "exp_avg": moment(before["mu"]),
                "exp_avg_sq": moment(before["nu"])}
        state.scheduler.last_epoch = before["count"]
        for group in state.optimizer.param_groups:
            group["lr"] = train_cfg.lr * lr_factor(train_cfg, 1)(
                before["count"])
    stat = lambda v: tnorm.RunningStat(*(torch.tensor(x, dtype=torch.float32)
                                         for x in v))
    lj_params = tlj.LJParams(cutoff=LJ_CUTOFF)
    step = make_train_step(state.model, system, train_cfg,
                           relabel_fn=lambda p: tlj.lj_forces_dense(
                               p, BOX, lj_params))
    return state._replace(force_stat=stat(before["stats"][:3]),
                          length_stat=stat(before["stats"][3:])), step


def _param_diffs(model, jax_params):
    params, _ = model.export_params()
    return np.concatenate([
        np.abs(_params_at(params, path) - np.asarray(want)).ravel()
        for path, want in jax.tree_util.tree_flatten_with_path(
            jax_params)[0]])


@pytest.mark.parametrize("use_layer_norm", [True, False])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_three_train_steps_match_jax(use_layer_norm, use_pallas):
    """The port's make_train_step (n=32, box 10 A, cutoff 4.5 A, K=16,
    widths 128, 2 layers, dropout 0, no rotation, no jitter, LJ relabel,
    batches of two frames) against JAX make_train_step with
    use_pallas=False, the port with use_pallas True (the kernel pair's
    plain version on the CPU) or False, LayerNorm or BatchNorm (seeded
    scales and biases, see _off_symmetric_point), in float64 (see
    _precision; the LayerNorm steps are held at fp32 too, by
    test_three_fp32_train_steps_match_jax).

    Each of the three steps starts from JAX's state before it (weights,
    running stats, Adam moments, scalers): loss, data_loss, net_force and
    force_std at rtol 1e-5, both scalers at 1e-5 (a mean on the scale of
    its values), the running stats at 1e-5, and the params after it at least 99.9% within 1e-5 and every
    element within 2 * lr (Adam's bound for an element whose gradient,
    about 1e-8 of its tensor's max, changes sign under fp32 rounding; JAX
    casts the model's output to fp32 even in float64); the first step's
    grads at 1e-5 of each tensor's max. (Later steps' grads are not held:
    the float32 scalers, summed in another order, may differ by an ulp,
    which the centred edge-length feature turns into 1e-5 of a grad.)
    Three free-running steps from the start: at least 99.9% of elements
    within 1e-5, every element within 2 * lr * 3."""
    _check_three_steps(use_layer_norm, use_pallas, exact=True)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_three_fp32_train_steps_match_jax(use_pallas):
    """test_three_train_steps_match_jax's checks at fp32 on both sides,
    LayerNorm (whose rows are not identical, unlike BatchNorm's at layer 0:
    see _precision), against JAX's fp32 XLA make_train_step."""
    _check_three_steps(True, use_pallas, exact=False)


def _check_three_steps(use_layer_norm, use_pallas, exact):
    """The checks of test_three_train_steps_match_jax, in float64 with
    `exact`, else fp32."""
    records = _jax_steps(use_layer_norm, exact)
    _, dtype = _precision(exact)
    lr = tcfg.TrainConfig().lr
    free, free_step = _port_state(use_layer_norm, use_pallas,
                                  records[0]["before"], dtype)
    for s, (rec, pos) in enumerate(zip(records, _step_batches())):
        batch = {"pos": _t(pos, dtype), "forces": torch.zeros(pos.shape,
                                                              dtype=dtype)}
        state, step = _port_state(use_layer_norm, use_pallas, rec["before"],
                                  dtype)
        state, m = step(state, batch)
        for key in ("loss", "data_loss", "net_force", "force_std"):
            np.testing.assert_allclose(float(m[key]), rec["metrics"][key],
                                       rtol=1e-5, err_msg=f"{key} step {s}")
        assert not bool(m["nbr_overflow"])
        got = [float(x) for x in (*state.force_stat, *state.length_stat)]
        for j, (name, a, b) in enumerate(zip(("count", "mean", "m2") * 2,
                                             got, rec["stats"])):
            # A mean is held on the scale of its values: the force mean
            # cancels (Newton's third law) to rounding noise.
            count, m2 = rec["stats"][3 * (j // 3)], rec["stats"][3 * (j // 3)
                                                                 + 2]
            scale = max(abs(b), np.sqrt(m2 / count)) if name == "mean" \
                else abs(b)
            assert abs(a - b) <= 1e-5 * scale, (name, s, a, b)
        if s == 0:
            grads = {n: t.grad.numpy() for n, t in
                     state.model.named_parameters()}
            floor = _grad_floor(rec["grads"])
            for path, want in jax.tree_util.tree_flatten_with_path(
                    rec["grads"])[0]:
                _assert_rel(grads[_dotted(path)], want, 1e-5, _dotted(path),
                            floor)
        diffs = _param_diffs(state.model, rec["params"])
        assert np.mean(diffs <= 1e-5) >= 0.999, (s, np.mean(diffs <= 1e-5))
        assert diffs.max() <= 2 * lr, (s, diffs.max())
        _, batch_stats = state.model.export_params()
        for path, want in jax.tree_util.tree_flatten_with_path(
                rec["batch_stats"])[0]:
            _assert_rel(_params_at(batch_stats, path), want, 1e-5,
                        "batch_stats")
        free, _ = free_step(free, batch)
    assert free.step == 3
    diffs = _param_diffs(free.model, records[-1]["params"])
    assert np.mean(diffs <= 1e-5) >= 0.999, np.mean(diffs <= 1e-5)
    assert diffs.max() <= 2 * lr * 3


def test_trained_state_hands_off_to_the_force_field():
    """to_forcefield_state() -> GNNForceField.force_fn gives the eager
    forces of the trained module: denormalised eval output in internal
    units, within 1e-5 of each other; the scalers arrive as floats."""
    system = tcfg.get_preset("lj", n_atoms=N_ATOMS, box=BOX, cutoff=CUTOFF,
                             nbr_capacity=K, skin=0.0)
    cfg = tcfg.ModelConfig(use_layer_norm=False, use_pallas=True,
                           drop_edge=True, **{**STEP_CFG, "dropout": 0.1})
    train_cfg = tcfg.TrainConfig(jitter_sigma=0.01)
    state = create_train_state(cfg, system, train_cfg, 1, seed=3,
                               device="cpu")
    lj_params = tlj.LJParams(cutoff=LJ_CUTOFF)
    step = make_train_step(state.model, system, train_cfg,
                           relabel_fn=lambda p: tlj.lj_forces_dense(
                               p, BOX, lj_params))
    for pos in _step_batches():
        state, _ = step(state, {"pos": _t(pos),
                                "forces": torch.zeros(pos.shape)})
    ff_state = state.to_forcefield_state()
    assert all(isinstance(x, float) for x in ff_state.force_stat)
    ff = GNNForceField(ff_state, system, cfg, device="cpu")
    pos = _t(_step_batches()[0][0])
    idx, mask, _ = dense_neighbor_list(pos, BOX, CUTOFF, K)
    got = ff.force_fn()(pos, idx, mask)
    with torch.no_grad():
        pred = state.model(pos[None], idx[None], mask[None], BOX,
                           state.length_stat.safe_mean,
                           state.length_stat.std)[0]
    want = tnorm.denormalize(pred, state.force_stat) \
        * system.force_unit_to_internal
    _assert_rel(got.numpy(), want.numpy(), 1e-5)
