"""Activations, a dense layer in the JAX layout, and the MLP of the
decoder (port of gamd_tpu/models/mlp.py; the activation-first variant is
not used by GAMDNet and is not ported).

Weights keep flax's [in, out] layout and names (`kernel`, `bias`), so a
flax parameter tree maps onto a module by name. A compute dtype (flax's
`Dense(dtype=...)`) casts the input, kernel and bias to it; the parameters
stay float32.
"""

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def _bf16(t):
    """t rounded to bf16 and back to float32."""
    return t.to(torch.bfloat16).float()


def _silu_bf16(x):
    """silu of a bf16 tensor as XLA evaluates jax.nn.silu in bf16:
    x * sigmoid(x) with sigmoid = 1 / (1 + exp(-x)), every operation
    rounded to bf16."""
    xf = x.float()
    sig = _bf16(1.0 / _bf16(1.0 + _bf16(torch.exp(-xf))))
    return (xf * sig).to(torch.bfloat16)


def _gelu_bf16(x):
    """Exact gelu of a bf16 tensor as XLA evaluates flax's
    gelu(approximate=False) in bf16: (0.5 x) * erfc(-x * bf16(sqrt(1/2)))
    with 0.5 x and erfc rounded to bf16 and erfc's argument not."""
    xf = x.float()
    tail = _bf16(torch.special.erfc(-xf * 0.70703125))
    return (_bf16(0.5 * xf) * tail).to(torch.bfloat16)


#: Activations whose bf16 evaluation rounds where XLA's does; the others
#: compute in float32 and round once.
_BF16_FORMS = {"silu": _silu_bf16, "gelu": _gelu_bf16}


def get_activation(name: str, dtype=None) -> Callable:
    """The activation `name`; for dtype=torch.bfloat16, its bf16 form
    where the JAX package's rounding differs from one rounding."""
    if dtype == torch.bfloat16 and name in _BF16_FORMS:
        return _BF16_FORMS[name]
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
    """x @ kernel + bias with kernel [in, out] (flax nn.Dense layout); with
    a compute `dtype` all three are cast to it first, as flax does."""

    def __init__(self, in_feats: int, out_feats: int, dtype=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_feats, out_feats))
        self.bias = nn.Parameter(torch.zeros(out_feats))
        self.dtype = dtype

    def forward(self, x):
        if self.dtype is None:
            return x @ self.kernel + self.bias
        return x.to(self.dtype) @ self.kernel.to(self.dtype) \
            + self.bias.to(self.dtype)


class MLP(nn.Module):
    """[Linear, act]*(L-1) + [Linear]; the layers are named Dense_0,
    Dense_1, ... as in flax."""

    def __init__(self, in_feats: int, out_feats: int, hidden_dim: int = 128,
                 hidden_layer: int = 3, activation: str = "relu",
                 dtype=None):
        super().__init__()
        self.act = get_activation(activation, dtype)
        dims = [in_feats] + [hidden_dim] * (hidden_layer - 1) + [out_feats]
        self.n_layers = hidden_layer
        for i in range(hidden_layer):
            self.add_module(f"Dense_{i}", Dense(dims[i], dims[i + 1], dtype))

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = self.act(x)
        return x
