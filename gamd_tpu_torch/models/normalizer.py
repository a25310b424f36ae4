"""Streaming normalisation statistics, eval side (port of
gamd_tpu/models/normalizer.py: RunningStat, init_stat, stat_from_values,
denormalize).

The moments are plain Python floats: the port reads them once, when a force
field is built, and never updates them (training is a later slice).
"""

import math
from typing import NamedTuple

import numpy as np


class RunningStat(NamedTuple):
    """Scalar running moments (count, mean, M2), sklearn-compatible."""

    count: float
    mean: float
    m2: float

    @property
    def var(self) -> float:
        """Biased variance, matching sklearn StandardScaler.var_."""
        return self.m2 / max(self.count, 1.0) if self.count > 0 else 1.0

    @property
    def std(self) -> float:
        return math.sqrt(self.var)

    @property
    def safe_mean(self) -> float:
        return self.mean if self.count > 0 else 0.0


def init_stat() -> RunningStat:
    return RunningStat(count=0.0, mean=0.0, m2=0.0)


def stat_from_values(mean, var, count=1.0) -> RunningStat:
    """A stat from persisted scaler.npz mean and variance, with the JAX
    package's float32 arithmetic (m2 = var * count in float32)."""
    count, mean, var = (np.float32(count), np.float32(mean),
                        np.float32(var))
    return RunningStat(count=float(count), mean=float(mean),
                       m2=float(var * count))


def denormalize(values, stat: RunningStat):
    """pred * sqrt(var) + mean."""
    return values * stat.std + stat.safe_mean
