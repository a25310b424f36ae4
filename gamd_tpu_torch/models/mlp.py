"""Activations, a dense layer in the JAX layout, and the MLP of the
decoder (port of gamd_tpu/models/mlp.py; the activation-first variant is
not used by GAMDNet and is not ported).

Weights keep flax's [in, out] layout and names (`kernel`, `bias`), so a
flax parameter tree maps onto a module by name.
"""

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def get_activation(name: str) -> Callable:
    table = {
        "relu": F.relu,
        "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.2),
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "elu": F.elu,
        # exact (erf) form, as flax gelu(approximate=False) and torch's default
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "silu": F.silu,
    }
    if name not in table:
        raise ValueError(
            f"unsupported activation {name!r}; choose from {sorted(table)}")
    return table[name]


class Dense(nn.Module):
    """x @ kernel + bias with kernel [in, out] (flax nn.Dense layout)."""

    def __init__(self, in_feats: int, out_feats: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_feats, out_feats))
        self.bias = nn.Parameter(torch.zeros(out_feats))

    def forward(self, x):
        return x @ self.kernel + self.bias


class MLP(nn.Module):
    """[Linear, act]*(L-1) + [Linear]; the layers are named Dense_0,
    Dense_1, ... as in flax."""

    def __init__(self, in_feats: int, out_feats: int, hidden_dim: int = 128,
                 hidden_layer: int = 3, activation: str = "relu"):
        super().__init__()
        self.act = get_activation(activation)
        dims = [in_feats] + [hidden_dim] * (hidden_layer - 1) + [out_feats]
        self.n_layers = hidden_layer
        for i in range(hidden_layer):
            self.add_module(f"Dense_{i}", Dense(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = self.act(x)
        return x
