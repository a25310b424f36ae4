"""Port parity of the model and of the force kernel's function: GAMDNet
eval, pack_params, the plain forward and mega_forward on the CPU, each
against the JAX package on the same weights and inputs (CPU; the JAX Pallas
kernel in interpret mode). The CUDA kernel itself is held against its plain
version in tests/test_torch_cuda.py and chip_smoke.py, on the card."""

import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core.config import ModelConfig as JModelConfig
from gamd_tpu.models.gnn import GAMDNet as JGAMDNet
from gamd_tpu.neighbors.dense import dense_neighbor_list, refresh_mask
from gamd_tpu.ops import pallas_model as jmega

from gamd_tpu_torch.core.config import ModelConfig
from gamd_tpu_torch.models.gnn import GAMDNet
from gamd_tpu_torch.ops import mega as tmega
from gamd_tpu_torch.train.state import params_from_jax

BOX = 12.0
N, K, CUTOFF = 64, 16, 5.0
LENGTH_MEAN, LENGTH_STD = 0.5, 2.0
SMALL = dict(encoding_size=32, hidden_dim=32, edge_embedding_dim=32,
             conv_layers=2)


def _setup(seed=0, use_layer_norm=True):
    """Small JAX GAMDNet with its params, positions and neighbour list."""
    jcfg = JModelConfig(use_layer_norm=use_layer_norm, **SMALL)
    model = JGAMDNet(cfg=jcfg)
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, BOX, (N, 3)).astype(np.float32)
    idx, mask, _ = dense_neighbor_list(jnp.asarray(pos), BOX, CUTOFF, K)
    variables = model.init(jax.random.PRNGKey(seed), pos[None], idx[None],
                           mask[None], BOX, LENGTH_MEAN, LENGTH_STD,
                           train=False)
    tcfg = ModelConfig(use_layer_norm=use_layer_norm, **SMALL)
    return model, variables, jcfg, tcfg, pos, np.asarray(idx), \
        np.asarray(mask)


def _jax_forces(model, variables, pos, idx, mask):
    return np.asarray(model.apply(variables, pos[None], idx[None],
                                  mask[None], BOX, LENGTH_MEAN, LENGTH_STD,
                                  train=False)[0])


def _h0(params, n):
    return np.broadcast_to(np.asarray(params["node_emb"]),
                           (n, np.asarray(params["node_emb"]).shape[1]))


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.mark.parametrize("use_layer_norm", [True, False])
def test_gamdnet_eval_matches_jax(use_layer_norm):
    """fp32 eval forward, erf-gelu, LayerNorm eps 1e-6 or eval BatchNorm
    with non-trivial running stats: max |dF| <= 1e-4 * std(F)."""
    model, variables, _, tcfg, pos, idx, mask = _setup(
        seed=1, use_layer_norm=use_layer_norm)
    if not use_layer_norm:
        variables = {"params": variables["params"],
                     "batch_stats": jax.tree.map(
                         lambda x: x + jnp.linspace(0.1, 0.5, x.shape[-1]),
                         variables["batch_stats"])}
    ref = _jax_forces(model, variables, pos, idx, mask)
    net = GAMDNet(tcfg).load_params(
        params_from_jax(variables["params"]),
        params_from_jax(variables.get("batch_stats", {})))
    with torch.no_grad():
        out = net(_t(pos)[None], _t(idx)[None], _t(mask)[None], BOX,
                  LENGTH_MEAN, LENGTH_STD)[0].numpy()
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).std()


@pytest.mark.parametrize("fold", ["plain", "denorm", "batchnorm"])
def test_pack_params_matches_jax(fold):
    """Every field of the port's MegaParams equals JAX's (the TPU-only
    w_src3 prepack has no counterpart): plain, with the force
    denormalisation folded into the decoder, and with BatchNorm folded."""
    model, variables, jcfg, tcfg, *_ = _setup(
        seed=2, use_layer_norm=(fold != "batchnorm"))
    params = variables["params"]
    kw, bs = {}, None
    if fold == "denorm":
        kw = dict(force_std=3.0, force_mean=0.25, unit=2.0)
    if fold == "batchnorm":
        bs = jax.tree.map(lambda x: x + jnp.linspace(0.1, 0.5, x.shape[-1]),
                          variables["batch_stats"])
    ref = jmega.pack_params(params, jcfg, batch_stats=bs, **kw)
    got = tmega.pack_params(params_from_jax(params), tcfg,
                            batch_stats=None if bs is None
                            else params_from_jax(bs), **kw)
    assert set(tmega.MegaParams._fields) == \
        set(jmega.MegaParams._fields) - {"w_src3"}
    for name in tmega.MegaParams._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape and a.dtype == np.float32, name
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=name)


def test_reference_forward_matches_jax():
    """The kernel's plain version against JAX's reference_forward, with
    the mask refreshed at a shorter cutoff: max |dF| <= 1e-4 * std(F)."""
    model, variables, jcfg, tcfg, pos, idx, mask = _setup(seed=3)
    params = variables["params"]
    jmp = jmega.pack_params(params, jcfg, force_std=3.0, force_mean=0.25)
    tmp = tmega.pack_params(params_from_jax(params), tcfg, force_std=3.0,
                            force_mean=0.25)
    h0 = _h0(params, N)
    ref = np.asarray(jmega.reference_forward(
        jnp.asarray(pos), jnp.asarray(idx), jnp.asarray(mask),
        jnp.asarray(h0), jmp, BOX, 4.2, LENGTH_MEAN, LENGTH_STD))
    got = tmega.reference_forward(_t(pos), _t(idx), _t(mask), _t(h0), tmp,
                                  BOX, 4.2, LENGTH_MEAN, LENGTH_STD).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).std()


def _kernel_case(seed, refresh):
    model, variables, jcfg, tcfg, pos, idx, mask = _setup(seed=seed)
    cutoff = None
    if refresh:
        # Move atoms so that some build-time neighbours leave the cutoff.
        rng = np.random.RandomState(seed + 10)
        pos = np.mod(pos + 0.35 * rng.randn(N, 3), BOX).astype(np.float32)
        cutoff = 4.2
        live = refresh_mask(jnp.asarray(pos), BOX, cutoff, jnp.asarray(idx),
                            jnp.asarray(mask))
        assert 0 < int(live.sum()) < int(mask.sum())
    params = variables["params"]
    h0 = _h0(params, N)
    jmp = jmega.pack_params(params, jcfg)
    tmp = tmega.pack_params(params_from_jax(params), tcfg)
    got = tmega.mega_forward(_t(pos), _t(idx, torch.int32), _t(mask),
                             _t(h0), tmp, BOX, cutoff, LENGTH_MEAN,
                             LENGTH_STD).numpy()
    return got, (jnp.asarray(pos), jnp.asarray(idx), jnp.asarray(mask),
                 jnp.asarray(h0), jmp, BOX, cutoff, LENGTH_MEAN, LENGTH_STD)


@pytest.mark.parametrize("refresh", [False, True])
def test_mega_forward_cpu_matches_f32_pallas_kernel(refresh):
    """On a CPU tensor mega_forward runs its plain version; it holds the
    JAX megakernel in fp32-edge interpret mode to 5e-3 * std(F), with and
    without the in-kernel mask refresh."""
    before = tmega.mega_forward.launches
    got, args = _kernel_case(seed=4, refresh=refresh)
    ref = np.asarray(jmega.mega_forward(*args, tile_n=8, interpret=True,
                                        f32_edges=True))
    assert got.shape == (N, 3)
    assert np.abs(got - ref).max() < 5e-3 * np.abs(ref).std()
    assert tmega.mega_forward.launches == before   # no kernel on the CPU


def test_mega_forward_cpu_within_bf16_pallas_floor():
    """Against the JAX megakernel's default bf16 edge pipeline (interpret
    mode): max 0.03 * std(F) and mean 0.01 * std(F)."""
    got, args = _kernel_case(seed=5, refresh=True)
    ref = np.asarray(jmega.mega_forward(*args, tile_n=8, interpret=True))
    err = np.abs(got - ref)
    scale = np.abs(ref).std()
    assert err.max() < 0.03 * scale
    assert err.mean() < 0.01 * scale
