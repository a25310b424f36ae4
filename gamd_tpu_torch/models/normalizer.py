"""Streaming normalisation statistics (port of
gamd_tpu/models/normalizer.py: RunningStat, init_stat, stat_from_values,
update_stat, merge_stats, normalize, denormalize).

The moments are either plain Python floats (a force field reads them once,
when it is built) or 0-d float32 tensors on the training state's device
(a train step updates them with no host sync). The properties and the
functions take both kinds; `as_floats` converts tensor moments at the
hand-off to a force field.
"""

import math
from typing import NamedTuple

import numpy as np
import torch


class RunningStat(NamedTuple):
    """Scalar running moments (count, mean, M2), sklearn-compatible."""

    count: object
    mean: object
    m2: object

    @property
    def var(self):
        """Biased variance, matching sklearn StandardScaler.var_; 1 while
        the stat is empty."""
        if isinstance(self.count, torch.Tensor):
            return torch.where(self.count > 0,
                               self.m2 / torch.clamp(self.count, min=1.0),
                               1.0)
        return self.m2 / max(self.count, 1.0) if self.count > 0 else 1.0

    @property
    def std(self):
        if isinstance(self.count, torch.Tensor):
            return torch.sqrt(self.var)
        return math.sqrt(self.var)

    @property
    def safe_mean(self):
        """The mean, 0 while the stat is empty."""
        if isinstance(self.count, torch.Tensor):
            return torch.where(self.count > 0, self.mean, 0.0)
        return self.mean if self.count > 0 else 0.0


def init_stat(device=None) -> RunningStat:
    """An empty stat: floats, or 0-d float32 tensors on `device`."""
    if device is None:
        return RunningStat(count=0.0, mean=0.0, m2=0.0)
    zero = lambda: torch.zeros((), dtype=torch.float32, device=device)
    return RunningStat(count=zero(), mean=zero(), m2=zero())


def stat_from_values(mean, var, count=1.0) -> RunningStat:
    """A stat from persisted scaler.npz mean and variance, with the JAX
    package's float32 arithmetic (m2 = var * count in float32)."""
    count, mean, var = (np.float32(count), np.float32(mean),
                        np.float32(var))
    return RunningStat(count=float(count), mean=float(mean),
                       m2=float(var * count))


def as_floats(stat: RunningStat) -> RunningStat:
    """The same moments as Python floats (reads tensors on the host)."""
    return RunningStat(*(float(x) for x in stat))


def merge_stats(a: RunningStat, b: RunningStat) -> RunningStat:
    """Chan et al. parallel combine of two tensor moment sets."""
    n = a.count + b.count
    safe_n = torch.clamp(n, min=1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * b.count / safe_n
    m2 = a.m2 + b.m2 + delta * delta * a.count * b.count / safe_n
    return RunningStat(count=n, mean=torch.where(n > 0, mean, 0.0), m2=m2)


def update_stat(stat: RunningStat, values, mask=None) -> RunningStat:
    """partial_fit: fold a batch of values (any shape; with `mask`, of the
    same shape, only the set entries) into the tensor stat."""
    values = values.to(torch.float32)
    if mask is None:
        n_b = torch.tensor(float(values.numel()), dtype=torch.float32,
                           device=values.device)
        mean_b = torch.sum(values) / torch.clamp(n_b, min=1.0)
        m2_b = torch.sum((values - mean_b) ** 2)
    else:
        m = mask.to(torch.float32)
        n_b = torch.sum(m)
        mean_b = torch.sum(values * m) / torch.clamp(n_b, min=1.0)
        m2_b = torch.sum(m * (values - mean_b) ** 2)
    return merge_stats(stat, RunningStat(count=n_b, mean=mean_b, m2=m2_b))


def normalize(values, stat: RunningStat):
    """(x - mean) / std with the sklearn-compatible biased std."""
    return (values - stat.safe_mean) / torch.clamp(
        torch.as_tensor(stat.std, dtype=torch.float32), min=1e-12)


def denormalize(values, stat: RunningStat):
    """pred * sqrt(var) + mean."""
    return values * stat.std + stat.safe_mean
