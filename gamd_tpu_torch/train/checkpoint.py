"""Checkpoint reading (port of the read side of
gamd_tpu/train/checkpoint.py): the flax msgpack envelope that carries the
train state with the ModelConfig and SystemConfig as JSON, and the
scaler.npz side-car. Decoded by the port's own train/msgpack.py: no flax,
no msgpack package. Saving comes with the training slice.
"""

import dataclasses
import json

import numpy as np

from gamd_tpu_torch.core.config import ModelConfig, SystemConfig
from gamd_tpu_torch.models.normalizer import RunningStat, stat_from_values
from gamd_tpu_torch.train import msgpack
from gamd_tpu_torch.train.state import ForceFieldState, params_from_jax

_META_KEY = "__gamd_meta_json__"


def _read(path):
    """(state dict, meta dict) of a checkpoint; meta is {} for the legacy
    layout (a bare state dict)."""
    with open(path, "rb") as f:
        restored = msgpack.unpackb(f.read())
    if isinstance(restored, dict) and _META_KEY in restored:
        return restored["state"], json.loads(restored[_META_KEY])
    return restored, {}


def load_checkpoint_meta(path):
    """The embedded {'model': ..., 'system': ...} dict ({} if legacy)."""
    _, meta = _read(path)
    return meta


def _configs(meta):
    model_cfg = ModelConfig(**meta["model"]) if "model" in meta else None
    system = None
    if "system" in meta:
        d = dict(meta["system"])
        d["masses"] = tuple(d["masses"])
        system = SystemConfig(**d)
    return model_cfg, system


def load_checkpoint_configs(path):
    """(ModelConfig, SystemConfig) from an envelope checkpoint; (None,
    None) for a legacy one."""
    return _configs(load_checkpoint_meta(path))


def _stat(d) -> RunningStat:
    return RunningStat(count=float(d["count"]), mean=float(d["mean"]),
                       m2=float(d["m2"]))


def load_self_describing(path, fallback_model_cfg=None, fallback_system=None,
                         **model_overrides):
    """(ForceFieldState, ModelConfig, SystemConfig) from a checkpoint.

    The configs come from the envelope when it has them, else from the
    fallbacks (legacy checkpoints); `model_overrides` (runtime switches
    that keep parameter shapes) apply on top. The state keeps what a force
    field needs: params and batch_stats as float32 numpy trees, and the
    force and edge-length scalers.
    """
    state, meta = _read(path)
    model_cfg, system = _configs(meta)
    model_cfg = fallback_model_cfg if model_cfg is None else model_cfg
    system = fallback_system if system is None else system
    if model_cfg is None or system is None:
        raise ValueError(
            f"{path} is a legacy checkpoint without embedded config; "
            "pass the architecture explicitly")
    if model_overrides:
        model_cfg = dataclasses.replace(model_cfg, **model_overrides)
    ff_state = ForceFieldState(
        params=params_from_jax(state["params"]),
        batch_stats=params_from_jax(state.get("batch_stats") or {}),
        force_stat=_stat(state["force_stat"]),
        length_stat=_stat(state["length_stat"]))
    return ff_state, model_cfg, system


def load_scaler(path):
    """(force, length) RunningStats from a scaler.npz (the JAX package's or
    the reference's key layout)."""
    z = np.load(path)
    force = stat_from_values(
        z["mean"][0], z["var"][0],
        count=float(z["count"][0]) if "count" in z else 1.0)
    if "length_mean" in z:
        length = stat_from_values(
            z["length_mean"][0], z["length_var"][0],
            count=float(z["length_count"][0]) if "length_count" in z
            else 1.0)
    else:
        length = stat_from_values(0.0, 1.0)
    return force, length
