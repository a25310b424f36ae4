"""The edge featurisation and encoder, positions to the edge embedding: the
host side of gamd_tpu/ops/pallas_encoder.py::fused_edge_encoder and the
wrapper of its Hopper kernel csrc/edge_encoder.cu.

* EncoderParams / encoder_params view a GAMDNet's encoder weights in the
  kernel's layout (w0 split into its geometric and RBF rows, the RBF
  centres), with no copy of the weights.
* edge_encoder_reference is the kernel's plain PyTorch version (tanh-gelu,
  as the TPU kernel; the model's XLA-path encoder is models.gnn.GAMDNet.
  encode_edges, erf-gelu).
* fused_edge_encoder is the entry point, in the JAX entry's argument order:
  a CPU tensor runs the plain version, a CUDA tensor launches the kernel or
  raises. It counts its launches in `fused_edge_encoder.launches`.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from gamd_tpu_torch.core import space
from gamd_tpu_torch.ops.mega import KERNEL_WIDTH, _check, encode_edges

#: Largest grid y and z of a launch: atoms per frame and frames per call.
MAX_GRID_YZ = 65535


class EncoderParams(NamedTuple):
    """The encoder's weights as the kernel reads them (the first ten fields
    of ops.mega.MegaParams, unpadded)."""

    centers: torch.Tensor    # [1, n_rbf] RBF centres
    w_geo: torch.Tensor      # [4, H]: rows 0-2 unit vector, 3 std-dist
    w_rbf: torch.Tensor      # [n_rbf, H]
    b0: torch.Tensor         # [1, H]
    w1: torch.Tensor         # [H, H]
    b1: torch.Tensor         # [1, H]
    w2: torch.Tensor         # [H, E]
    b2: torch.Tensor         # [1, E]
    eln_s: torch.Tensor      # [1, E] edge LayerNorm scale
    eln_b: torch.Tensor      # [1, E]


@functools.lru_cache(maxsize=16)
def _centers(device, low, high, n):
    """[1, n] float32 centres linspace(low, high, n) on `device`, made once
    (as the JAX kernel's, in float64 rounded to float32)."""
    c = np.linspace(low, high, n).astype(np.float32)[None]
    return torch.as_tensor(c, device=device)


def encoder_params(w0, b0, w1, b1, w2, b2, ln_scale, ln_bias, rbf_low=0.0,
                   rbf_high=1.0) -> EncoderParams:
    """EncoderParams over the model's tensors: w0 [4 + n_rbf, H] is the
    first Linear over [unit(3), std(1), rbf(n_rbf)]; the rest as the JAX
    entry takes them. Every field but the centres is a view."""
    n_rbf = w0.shape[0] - 4
    return EncoderParams(
        centers=_centers(w0.device, float(rbf_low), float(rbf_high), n_rbf),
        w_geo=w0[:4], w_rbf=w0[4:], b0=b0[None], w1=w1, b1=b1[None], w2=w2,
        b2=b2[None], eln_s=ln_scale[None], eln_b=ln_bias[None])


def _cutoff2(cutoff):
    """cutoff^2, or inf for cutoff=None (live = the build mask)."""
    return math.inf if cutoff is None else float(cutoff) ** 2


def edge_encoder_reference(pos, idx, build_mask, box, cutoff, length_mean,
                           length_std, w0, b0, w1, b1, w2, b2, ln_scale,
                           ln_bias, rbf_low=0.0, rbf_high=1.0, rbf_gap=0.025,
                           flip_dir=False):
    """Plain version of fused_edge_encoder on [B, N, .] batches: (e
    [B, N, K, E] float32, live [B, N, K] bool), every slot computed."""
    b = torch.arange(pos.shape[0], device=pos.device)[:, None, None]
    rel = space.min_image(pos[b, idx.long()] - pos[:, :, None, :], box)
    d2 = torch.sum(rel * rel, dim=-1)
    dist = torch.sqrt(d2)
    unit = rel / (dist[..., None] + 1e-8)
    if flip_dir:
        unit = -unit
    std = (dist - float(length_mean)) / float(length_std)
    live = build_mask & (d2 < _cutoff2(cutoff))
    params = encoder_params(w0, b0, w1, b1, w2, b2, ln_scale, ln_bias,
                            rbf_low, rbf_high)
    return encode_edges(params, unit, std, None, "gelu", rbf_gap), live


class _EncoderWeights(ctypes.Structure):
    """Mirror of the C struct EncoderWeights (csrc/encode.cuh): one device
    pointer per field of EncoderParams, in the same order."""

    _fields_ = [(name, ctypes.c_void_p) for name in EncoderParams._fields]


def declare(lib):
    """Set argtypes/restype of the library's encoder entry."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gamd_edge_encoder.argtypes = [
        p, p, p, ctypes.POINTER(_EncoderWeights),     # pos idx bmask w
        i, i, i, i, i,                                # n_rbf b n k flip
        f, f, f, f, f,                                # box cut2 lm ls gamma
        p, p, p]                                      # e live stream
    lib.gamd_edge_encoder.restype = ctypes.c_int


def _check_inputs(pos, idx, build_mask, weights):
    """The kernel's checks of a [B, N, .] batch on a CUDA device: float32
    (idx int32, mask bool), contiguous, one device, every width 128, at
    most 128 RBF centres, N and B within a launch's grid."""
    fn = "fused_edge_encoder"
    if pos.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {pos.device}")
    dev = pos.device
    b, n, k = idx.shape
    w = KERNEL_WIDTH
    if not (1 <= b <= MAX_GRID_YZ and 1 <= n <= MAX_GRID_YZ and k >= 1):
        raise ValueError(f"{fn}: B={b}, N={n} must lie in [1, {MAX_GRID_YZ}]"
                         f" and K={k} be at least 1")
    _check(fn, "pos", pos, dev, torch.float32, (b, n, 3))
    _check(fn, "idx", idx, dev, torch.int32, (b, n, k))
    _check(fn, "build_mask", build_mask, dev, torch.bool, (b, n, k))
    w0 = weights[0]
    n_rbf = w0.shape[0] - 4 if w0.ndim == 2 else -1
    if not 1 <= n_rbf <= w:
        raise ValueError(f"{fn}: w0 must have 4 + n_rbf rows with 1 <= "
                         f"n_rbf <= {w}; got shape {tuple(w0.shape)}")
    names = ("w0", "b0", "w1", "b1", "w2", "b2", "ln_scale", "ln_bias")
    for name, t in zip(names, weights):
        shape = (4 + n_rbf, w) if name == "w0" else (
            (w, w) if name in ("w1", "w2") else (w,))
        _check(fn, name, t, dev, torch.float32, shape)
    return b, n, k, n_rbf


def fused_edge_encoder(pos, idx, build_mask, box, cutoff, length_mean,
                       length_std, w0, b0, w1, b1, w2, b2, ln_scale, ln_bias,
                       rbf_low=0.0, rbf_high=1.0, rbf_gap=0.025,
                       flip_dir=False):
    """(e [B, N, K, E] float32, live [B, N, K] bool) of a batch of frames;
    without the leading batch axis ([N, 3], [N, K]) one frame, as the JAX
    entry.

    Args:
        pos: [B, N, 3] float32 wrapped positions.
        idx: [B, N, K] int32 neighbour ids, per frame in [0, N).
        build_mask: [B, N, K] bool; live = build_mask AND d^2 < cutoff^2,
            and cutoff=None passes the build mask through.
        box, cutoff, length_mean, length_std: scalars (a scalar box only).
        w0 [4 + n_rbf, E], b0 [E], w1 [E, E], b1, w2 [E, E], b2, ln_scale,
            ln_bias [E]: the model's encoder weights.

    A CPU `pos` runs edge_encoder_reference. A CUDA `pos` launches
    csrc/edge_encoder.cu (every width 128, n_rbf <= 128) or raises.
    """
    single = pos.ndim == 2
    if single:
        pos, idx, build_mask = pos[None], idx[None], build_mask[None]
    weights = (w0, b0, w1, b1, w2, b2, ln_scale, ln_bias)
    if pos.device.type == "cpu":
        e, live = edge_encoder_reference(
            pos, idx, build_mask, box, cutoff, length_mean, length_std,
            *weights, rbf_low=rbf_low, rbf_high=rbf_high, rbf_gap=rbf_gap,
            flip_dir=flip_dir)
    else:
        b, n, k, n_rbf = _check_inputs(pos, idx, build_mask, weights)
        params = encoder_params(*weights, rbf_low, rbf_high)
        struct = _EncoderWeights(*[t.data_ptr() for t in params])
        dev = pos.device
        e = torch.empty((b, n, k, KERNEL_WIDTH), device=dev,
                        dtype=torch.float32)
        live = torch.empty((b, n, k), device=dev, dtype=torch.bool)
        from gamd_tpu_torch.ops.build import load_library
        err = load_library().gamd_edge_encoder(
            pos.data_ptr(), idx.data_ptr(), build_mask.data_ptr(),
            ctypes.byref(struct), n_rbf, b, n, k, int(flip_dir), float(box),
            _cutoff2(cutoff), float(length_mean), float(length_std),
            1.0 / rbf_gap, e.data_ptr(), live.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused_edge_encoder: CUDA launch failed with "
                               f"cudaError {err}")
        fused_edge_encoder.launches += 1
    return (e[0], live[0]) if single else (e, live)


fused_edge_encoder.launches = 0
