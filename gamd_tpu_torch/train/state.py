"""Training state and weight carrier of the port (gamd_tpu/train/state.py).

* ForceFieldState carries weights to a force field: parameters in the flax
  tree layout as nested dicts of float32 numpy arrays, plus the normaliser
  statistics.
* TrainState is what a train step updates: the GAMDNet module, its Adam
  optimizer and staircase lr schedule, the streaming force and edge-length
  stats (0-d tensors on the device), a torch.Generator on the device for
  every random draw of a step, the step count, and the seed that
  create_train_state drew the weights with (a checkpoint's `rng` words).
"""

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from gamd_tpu_torch.core.config import ModelConfig, SystemConfig, TrainConfig
from gamd_tpu_torch.core.device import resolve_device
from gamd_tpu_torch.models.gnn import GAMDNet, conv_edge_dims, encoder_inputs
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
    seed: int = 0                    # of create_train_state

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


def build_model(model_cfg: ModelConfig, system: SystemConfig) -> GAMDNet:
    """The GAMDNet of a system (gamd_tpu/train/state.py::build_model): the
    LJ embedding for species "lj", else the water node encoder, with the
    bond channel where the system has bonds."""
    species = "lj" if system.species == "lj" else "water"
    return GAMDNet(model_cfg, species=species, use_bond=system.has_bonds)


def create_train_state(model_cfg: ModelConfig, system: SystemConfig,
                       train_cfg: TrainConfig, steps_per_epoch: int,
                       seed: Optional[int] = None,
                       device="cuda") -> TrainState:
    """A fresh TrainState on `device` (CUDA unless the caller asks for the
    CPU): build_model with init_params(seed) weights (LJ, or water with
    its node encoder and bond row), Adam with the staircase schedule,
    empty scalers, and a generator on the device seeded with `seed`
    (train_cfg.seed when None). A system with per-sample boxes (box None:
    the DFT set) trains as any other: the weights are drawn from their
    shapes alone, so no sample box is needed, unlike JAX's initialisation
    call (gamd_tpu/train/state.py:56-66)."""
    dev = resolve_device(device)
    seed = train_cfg.seed if seed is None else seed
    weights = init_params(model_cfg, system, seed=seed)
    model = build_model(model_cfg, system).load_params(
        weights.params, weights.batch_stats).to(dev)
    optimizer, scheduler = make_optimizer(model.parameters(), train_cfg,
                                          steps_per_epoch)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler,
                      force_stat=init_stat(dev), length_stat=init_stat(dev),
                      generator=generator, step=0, seed=seed)


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
    LayerNorm scales, standard-normal node embedding). A water system
    (species "water") gets the node encoder (a lecun-normal [F, D] kernel
    and a zero bias) instead of the embedding, and with has_bonds the
    encoder's bond row (edge_encoder_w0 is [4 + n_rbf + 1, H]). Without
    cfg.expand_edge the encoder has no RBF rows; with cfg.update_edge each
    conv layer has its edge_layer_norm (unit scale, zero bias) and the
    layers past the first read edges of width D (edge_affine_w1 [D, H])."""
    if system.species not in ("lj", "water"):
        raise ValueError(f"unknown species {system.species!r}")
    cfg = model_cfg
    rng = np.random.default_rng(seed)
    d, h, e = cfg.encoding_size, cfg.hidden_dim, cfg.edge_embedding_dim
    zeros = lambda n: np.zeros((n,), np.float32)
    w = lambda i, o: _lecun_normal(rng, i, o)
    params = {
        "edge_encoder_w0": w(encoder_inputs(cfg, system.has_bonds), h),
        "edge_encoder_b0": zeros(h),
        "edge_encoder_w1": w(h, h), "edge_encoder_b1": zeros(h),
        "edge_encoder_w2": w(h, e), "edge_encoder_b2": zeros(e),
        "edge_ln_scale": np.ones((e,), np.float32),
        "edge_ln_bias": zeros(e),
    }
    if system.species == "lj":
        params["node_emb"] = rng.standard_normal((1, d)).astype(np.float32)
    else:
        params["node_encoder"] = {"kernel": w(cfg.in_node_feats, d),
                                  "bias": zeros(d)}
    conv, batch_stats = {}, {}
    for layer, e in enumerate(conv_edge_dims(cfg)):
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
        if cfg.update_edge:
            conv[f"conv_{layer}"]["edge_layer_norm"] = {
                "scale": np.ones((d,), np.float32), "bias": zeros(d)}
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
