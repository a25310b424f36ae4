"""Checkpoints (port of gamd_tpu/train/checkpoint.py): the flax msgpack
envelope that carries the train state with the ModelConfig and
SystemConfig as JSON, and the scaler.npz side-car. Encoded and decoded by
the port's own train/msgpack.py: no flax, no msgpack package.

The envelope's `state` is the JAX package's TrainState layout, so either
package reads what the other writes: params and batch_stats in the flax
tree layout; opt_state {'0': {count, mu, nu}, '1': {count}}, which is
optax.adam(schedule)'s ScaleByAdamState and ScaleByScheduleState, mu and
nu being torch Adam's exp_avg and exp_avg_sq laid out as the params and
the counts the Adam step; force_stat and length_stat {count, mean, m2}
(0-d float32); rng, PRNGKey(seed)'s raw words [0, seed] (uint32[2]; the
port's random streams are its own); step (0-d int32).
"""

import dataclasses
import json

import numpy as np
import torch

from gamd_tpu_torch.core.config import ModelConfig, SystemConfig
from gamd_tpu_torch.models.normalizer import RunningStat, stat_from_values
from gamd_tpu_torch.train import msgpack
from gamd_tpu_torch.train.state import (ForceFieldState, TrainState,
                                        params_from_jax)

_META_KEY = "__gamd_meta_json__"


def _f32(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                      dtype=np.float32)


def _nest(tree, dotted, value):
    keys = dotted.split(".")
    for key in keys[:-1]:
        tree = tree.setdefault(key, {})
    tree[keys[-1]] = value


def _at(tree, dotted):
    for key in dotted.split("."):
        tree = tree[key]
    return tree


def _adam_count(state: TrainState) -> int:
    """The Adam step of the state (0 before the first update)."""
    steps = [st["step"] for st in state.optimizer.state.values()
             if "step" in st]
    return int(steps[0]) if steps else 0


def train_state_dict(state: TrainState) -> dict:
    """The JAX package's TrainState as flax.serialization.to_state_dict
    gives it (module docstring), from a port TrainState."""
    params, batch_stats = state.model.export_params()
    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    for name, p in state.model.named_parameters():
        st = state.optimizer.state.get(p, {})
        for key, tree in moments.items():
            _nest(tree, name, _f32(st[key]) if key in st
                  else np.zeros(tuple(p.shape), np.float32))
    stat = lambda s: {"count": _f32(s.count), "mean": _f32(s.mean),
                      "m2": _f32(s.m2)}
    count = np.asarray(_adam_count(state), np.int32)
    return {
        "params": params,
        "batch_stats": batch_stats,
        "opt_state": {
            "0": {"count": count, "mu": moments["exp_avg"],
                  "nu": moments["exp_avg_sq"]},
            "1": {"count": np.asarray(state.scheduler.last_epoch,
                                      np.int32)}},
        "force_stat": stat(state.force_stat),
        "length_stat": stat(state.length_stat),
        "rng": np.asarray([0, state.seed], np.uint32),
        "step": np.asarray(state.step, np.int32),
    }


def save_checkpoint(path, state: TrainState, model_cfg=None, system=None):
    """Write the envelope: the train state (train_state_dict) and, where
    given, the ModelConfig and SystemConfig as JSON, byte for byte what
    the JAX package's save_checkpoint writes for the same state."""
    meta = {}
    if model_cfg is not None:
        meta["model"] = dataclasses.asdict(model_cfg)
    if system is not None:
        meta["system"] = dataclasses.asdict(system)
    payload = {"state": train_state_dict(state), _META_KEY: json.dumps(meta)}
    with open(path, "wb") as f:
        f.write(msgpack.packb(payload))
    return path


@torch.no_grad()
def load_checkpoint(path, template: TrainState) -> TrainState:
    """Restore a checkpoint (the envelope or the legacy bare state, written
    by either package) into a fresh TrainState of the same architecture:
    weights and BatchNorm running stats, the Adam moments and step, the lr
    schedule's count (LambdaLR.last_epoch and each group's lr), the
    scalers (0-d float32 on the template's device) and the step. The
    template's generator and seed are kept."""
    sd, _ = _read(path)
    model, optimizer, scheduler = (template.model, template.optimizer,
                                   template.scheduler)
    model.load_params(params_from_jax(sd["params"]),
                      params_from_jax(sd.get("batch_stats") or {}))
    adam, schedule = sd["opt_state"]["0"], sd["opt_state"]["1"]
    count = int(adam["count"])
    for name, p in model.named_parameters():
        optimizer.state.pop(p, None)
        if count:
            moment = lambda tree: torch.as_tensor(
                np.array(_at(tree, name), np.float32), device=p.device)
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": moment(adam["mu"]),
                "exp_avg_sq": moment(adam["nu"])}
    scheduler.last_epoch = int(schedule["count"])
    lrs = [base * fn(scheduler.last_epoch) for base, fn in
           zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(optimizer.param_groups, lrs):
        group["lr"] = lr
    dev = template.force_stat.count.device
    stat = lambda d: RunningStat(*(torch.as_tensor(
        np.float32(d[k]), device=dev) for k in ("count", "mean", "m2")))
    return template._replace(force_stat=stat(sd["force_stat"]),
                             length_stat=stat(sd["length_stat"]),
                             step=int(sd["step"]))


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


def save_scaler(path, state):
    """scaler.npz side-car with the reference's keys (mean=, var=) and the
    JAX package's count and edge-length keys."""
    as_array = lambda x: np.array([float(x)])
    force, length = state.force_stat, state.length_stat
    np.savez(path, mean=as_array(force.safe_mean), var=as_array(force.var),
             count=as_array(force.count),
             length_mean=as_array(length.safe_mean),
             length_var=as_array(length.var),
             length_count=as_array(length.count))
    return path


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
