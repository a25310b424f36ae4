"""Training state and weight carrier of the port (gamd_tpu/train/state.py).

* ForceFieldState carries weights to a force field: parameters in the flax
  tree layout as nested dicts of float32 numpy arrays, plus the normaliser
  statistics.
* TrainState is what a train step updates: the GAMDNet module, its Adam
  optimizer and staircase lr schedule, the streaming force and edge-length
  stats (0-d tensors on the device), a torch.Generator on the device for
  every random draw of a step, and the step count.
"""

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from gamd_tpu_torch.core.config import ModelConfig, SystemConfig, TrainConfig
from gamd_tpu_torch.core.device import resolve_device
from gamd_tpu_torch.models.gnn import GAMDNet
from gamd_tpu_torch.models.normalizer import (RunningStat, as_floats,
                                              init_stat)


class ForceFieldState(NamedTuple):
    params: Any                  # nested dict, flax tree layout
    batch_stats: Any             # {} for LayerNorm models
    force_stat: RunningStat      # force scaler moments
    length_stat: RunningStat     # edge-length scaler moments


class TrainState(NamedTuple):
    model: GAMDNet
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    force_stat: RunningStat          # streaming force scaler (tensors)
    length_stat: RunningStat         # streaming edge-length scaler
    generator: torch.Generator       # every random draw of a step
    step: int

    def to_forcefield_state(self) -> ForceFieldState:
        """The trained weights, BatchNorm running stats and scalers as a
        ForceFieldState for GNNForceField (reads the stats on the host)."""
        params, batch_stats = self.model.export_params()
        return ForceFieldState(params=params, batch_stats=batch_stats,
                               force_stat=as_floats(self.force_stat),
                               length_stat=as_floats(self.length_stat))


def lr_factor(train_cfg: TrainConfig, steps_per_epoch: int):
    """t -> lr multiplier of update t (counting from 0): optax's staircase
    exponential_decay, gamma ** (t // (steps_per_epoch * lr_step_epochs))
    with gamma = lr_total_decay ** (lr_step_epochs / max_epoch), the
    reference's StepLR (gamd_tpu/train/state.py:33-44)."""
    epochs = max(train_cfg.max_epoch, 1)
    gamma = train_cfg.lr_total_decay ** (train_cfg.lr_step_epochs / epochs)
    period = max(steps_per_epoch * train_cfg.lr_step_epochs, 1)
    return lambda t: gamma ** (t // period)


def make_optimizer(params, train_cfg: TrainConfig, steps_per_epoch: int):
    """(Adam over `params` at train_cfg.lr, eps 1e-8 as optax.adam, and a
    LambdaLR of lr_factor). Step the scheduler after every optimizer step,
    so update t runs at lr * lr_factor(t), as optax's count."""
    optimizer = torch.optim.Adam(params, lr=train_cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lr_factor(train_cfg, steps_per_epoch))
    return optimizer, scheduler


def create_train_state(model_cfg: ModelConfig, system: SystemConfig,
                       train_cfg: TrainConfig, steps_per_epoch: int,
                       seed: Optional[int] = None, device="cuda"
                       ) -> TrainState:
    """A fresh TrainState on `device` (CUDA unless the caller asks for the
    CPU): init_params(seed) weights, Adam with the staircase schedule,
    empty scalers, and a generator on the device seeded with `seed`
    (train_cfg.seed when None)."""
    dev = resolve_device(device)
    seed = train_cfg.seed if seed is None else seed
    weights = init_params(model_cfg, system, seed=seed)
    model = GAMDNet(model_cfg).load_params(
        weights.params, weights.batch_stats).to(dev)
    optimizer, scheduler = make_optimizer(model.parameters(), train_cfg,
                                          steps_per_epoch)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler,
                      force_stat=init_stat(dev), length_stat=init_stat(dev),
                      generator=generator, step=0)


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
