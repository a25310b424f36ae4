"""The thermostat noise of a fused MD window, plain version: Philox4x32-10
and Box-Muller, as csrc/mega_md_steps.cu draws them in the kernel (the same
words; the float transforms here in float64, rounded once to float32).

It takes the place of gamd_tpu/ops/pallas_model.py::_mega_md_kernel's
hash_bits / gaussian (the TPU's on-core PRNG has no Hopper counterpart).
The layout, shared with the kernel:

* key = (seed, 0), counter = (atom, step, replica, 0): one Philox call
  gives the 4 words w0..w3 of one atom of one replica at one step of the
  window (replica 0 draws what a single system draws);
* u1 = ((w >> 8) + 1) * 2^-24 in (0, 1], u2 = (w >> 8) * 2^-24;
* (w0, w1) give the x and y normals as r cos(2 pi u2), r sin(2 pi u2) with
  r = sqrt(-2 ln u1); (w2, w3) give the z normal, the cosine one.

Words are int64 tensors holding 32-bit values. The 32x32-bit products of a
round do not fit in int64 (both multipliers exceed 2^31), so one factor is
split into 16-bit halves and the high and low words are put together
exactly.

The log, sqrt, cos and sin run in float64: in float32 the CPU results
varied in the last bit with the worker thread that computed a chunk (once
a JAX computation had run in the process), so one seed did not always give
the same draws. The kernel's float32 transforms differ from these by about
1e-6 at most.
"""

import math

import torch

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # Weyl key increments
ROUNDS = 10
_TWO_PI = 2.0 * math.pi


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of the 64-bit product a * b, for a 32-bit
    constant a and a tensor b of 32-bit values."""
    p_lo = a * (b & 0xFFFF)                       # < 2^48
    p_hi = a * (b >> 16)                          # < 2^48
    s = p_lo + ((p_hi & 0xFFFF) << 16)            # < 2^49
    return (p_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32(counter, key):
    """Philox4x32-10 of Random123: counter [..., 4] and key [..., 2]
    int64 tensors of 32-bit words (broadcast against each other) ->
    [..., 4] int64 words."""
    counter = torch.as_tensor(counter, dtype=torch.int64) & _MASK32
    key = torch.as_tensor(key, dtype=torch.int64, device=counter.device) \
        & _MASK32
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key.unbind(-1)
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    return torch.stack([c0, c1, c2, c3], dim=-1)


def _uniforms(w):
    """(u1 in (0, 1], u2 in [0, 1)) float64 (exact) from 32-bit words."""
    top = (w >> 8).to(torch.float64)
    return (top + 1.0) * 2.0 ** -24, top * 2.0 ** -24


def philox_normal(seed, step, n: int, device=None, replica: int = 0):
    """[n, 3] float32 standard normals of atoms 0..n-1 of replica
    `replica` at window step `step`, from the window's seed (a Python int
    or a 1-element int32 tensor; a tensor stays on its device and is never
    read on the host)."""
    if isinstance(seed, torch.Tensor):
        device = seed.device if device is None else device
        key0 = seed.reshape(()).to(device=device, dtype=torch.int64)
    else:
        key0 = torch.tensor(int(seed), dtype=torch.int64, device=device)
    atoms = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(atoms)
    counter = torch.stack([atoms, torch.full_like(atoms, int(step)),
                           torch.full_like(atoms, int(replica)), zero],
                          dim=-1)
    key = torch.stack([key0 & _MASK32, torch.zeros_like(key0)])
    w = philox4x32(counter, key)
    u1a, _ = _uniforms(w[:, 0])
    _, u2a = _uniforms(w[:, 1])
    u1b, _ = _uniforms(w[:, 2])
    _, u2b = _uniforms(w[:, 3])
    ra = torch.sqrt(-2.0 * torch.log(u1a))
    rb = torch.sqrt(-2.0 * torch.log(u1b))
    ta, tb = _TWO_PI * u2a, _TWO_PI * u2b
    return torch.stack([ra * torch.cos(ta), ra * torch.sin(ta),
                        rb * torch.cos(tb)], dim=-1).to(torch.float32)
