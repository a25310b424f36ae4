"""Weight carrier of the port (in place of gamd_tpu/train/state.py's flax
TrainState): parameters in the flax tree layout as nested dicts of float32
numpy arrays, plus the normaliser statistics a force field needs.
"""

from typing import Any, NamedTuple

import numpy as np

from gamd_tpu_torch.core.config import ModelConfig, SystemConfig
from gamd_tpu_torch.models.normalizer import RunningStat, init_stat


class ForceFieldState(NamedTuple):
    params: Any                  # nested dict, flax tree layout
    batch_stats: Any             # {} for LayerNorm models
    force_stat: RunningStat      # force scaler moments
    length_stat: RunningStat     # edge-length scaler moments


def _lecun_normal(rng, fan_in, fan_out):
    """flax's lecun_normal: truncated (+-2 sigma) normal, variance 1/fan_in."""
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    x = rng.standard_normal((fan_in, fan_out))
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return (x * std).astype(np.float32)


def init_params(model_cfg: ModelConfig, system: SystemConfig,
                seed: int = 0) -> ForceFieldState:
    """Untrained GAMDNet weights drawn from numpy with `seed` (the flax
    initialisers' distributions: lecun-normal kernels, zero biases, unit
    LayerNorm scales, standard-normal node embedding)."""
    if system.species != "lj" or system.has_bonds:
        raise NotImplementedError("the port's water slice is not done yet")
    cfg = model_cfg
    rng = np.random.default_rng(seed)
    d, h, e = cfg.encoding_size, cfg.hidden_dim, cfg.edge_embedding_dim
    zeros = lambda n: np.zeros((n,), np.float32)
    w = lambda i, o: _lecun_normal(rng, i, o)
    params = {
        "edge_encoder_w0": w(3 + 1 + cfg.n_rbf, h),
        "edge_encoder_b0": zeros(h),
        "edge_encoder_w1": w(h, h), "edge_encoder_b1": zeros(h),
        "edge_encoder_w2": w(h, e), "edge_encoder_b2": zeros(e),
        "edge_ln_scale": np.ones((e,), np.float32),
        "edge_ln_bias": zeros(e),
        "node_emb": rng.standard_normal((1, d)).astype(np.float32),
    }
    conv, batch_stats = {}, {}
    for layer in range(cfg.conv_layers):
        conv[f"norm_{layer}"] = {"scale": np.ones((d,), np.float32),
                                 "bias": zeros(d)}
        if not cfg.use_layer_norm:
            batch_stats.setdefault("graph_conv", {})[f"norm_{layer}"] = {
                "mean": zeros(d), "var": np.ones((d,), np.float32)}
        conv[f"conv_{layer}"] = {
            "edge_affine_w1": w(e, h), "edge_affine_b1": zeros(h),
            "edge_affine_w2": w(h, h), "edge_affine_b2": zeros(h),
            "theta_edge_w1": w(h, h), "theta_edge_b1": zeros(h),
            "theta_edge_w2": w(h, d), "theta_edge_b2": zeros(d),
            "phi_dst_w": w(d, h), "phi_dst_b": zeros(h),
            "phi_edge_w": w(d, h), "phi_edge_b": zeros(h),
            "phi_w": w(h, d), "phi_b": zeros(d),
            "src_affine": {"kernel": w(d, h), "bias": zeros(h)},
            "dst_affine": {"kernel": w(d, h), "bias": zeros(h)},
        }
    params["graph_conv"] = conv
    params["graph_decoder"] = {
        "Dense_0": {"kernel": w(d, h), "bias": zeros(h)},
        "Dense_1": {"kernel": w(h, cfg.out_feats),
                    "bias": zeros(cfg.out_feats)},
    }
    return ForceFieldState(params=params, batch_stats=batch_stats,
                           force_stat=init_stat(), length_stat=init_stat())


def params_from_jax(tree):
    """A JAX GAMDNet parameter tree (nested dicts of arrays) as the port's
    nested dict of float32 numpy arrays. Pure numpy: no JAX import."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return np.array(tree, dtype=np.float32)


def stat_from_jax(stat) -> RunningStat:
    """A JAX RunningStat (count, mean, m2 arrays) as the port's floats."""
    return RunningStat(count=float(stat.count), mean=float(stat.mean),
                       m2=float(stat.m2))
