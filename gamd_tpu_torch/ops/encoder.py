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
  e for every slot of a batch of frames and the live mask. A CPU tensor
  runs the plain version, a CUDA tensor launches the kernel or raises. It
  counts its launches in `fused_edge_encoder.launches`.
* live_edge_encoder is the same kernel over the live slots of a layout
  (ops/edge_tiles.py::mask_layout) of one frame, with its plain version
  live_edge_encoder_reference: e's rows of those slots at their slot
  positions, the rest of e never written. The large-N banded force path
  (ops/banded.py) encodes through it on the card. It counts its launches
  in `live_edge_encoder.launches`.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from gamd_tpu_torch.core import space
from gamd_tpu_torch.ops import edge_tiles
from gamd_tpu_torch.ops.mega import (KERNEL_WIDTH, LiveLayout, _check,
                                     encode_edges, layout_capacity)

#: Slots a call may hold in all (B*N*K): the kernel's row ids, rounded up
#: to its 64-row tiles, are int32.
MAX_SLOTS = 2**31 - 64


class EncoderParams(NamedTuple):
    """The encoder's weights as the kernel reads them (the first ten fields
    of ops.mega.MegaParams, unpadded; a MegaParams, padded to 128 RBF rows
    and 8 geometric rows, is read the same way)."""

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
    """Set argtypes/restype of the library's encoder entries."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    weights = ctypes.POINTER(_EncoderWeights)
    lib.gamd_edge_encoder.argtypes = [
        p, p, p, weights,                             # pos idx bmask w
        i, i, i, i, i,                                # n_rbf b n k flip
        f, f, f, f, f,                                # box cut2 lm ls gamma
        p, i, i, i, i,                                # wsplit, the plan
        p, p, p]                                      # e live stream
    lib.gamd_edge_encoder.restype = ctypes.c_int
    lib.gamd_live_edge_encoder.argtypes = [
        p, p, p, p, weights,                          # pos idx slot total w
        i, i, i, i,                                   # n_rbf n k flip
        f, f, f, f,                                   # box lm ls gamma
        p, i, i, i, i,                                # wsplit, the plan
        p, p]                                         # e stream
    lib.gamd_live_edge_encoder.restype = ctypes.c_int


#: Bytes of the split weights (w_rbf, w1, w2 as bf16 hi and lo).
SPLIT_BYTES = 3 * edge_tiles.SPLIT_BYTES


def _launch_scratch(m, k, device):
    """(plan, split-weight scratch) of a call over M atoms of K slots."""
    from gamd_tpu_torch.ops.mxu_probe import sm_count
    plan = edge_tiles.launch_plan(m, k, sm_count(device))
    return plan, torch.empty((SPLIT_BYTES,), device=device,
                             dtype=torch.uint8)


def _check_inputs(pos, idx, build_mask, weights):
    """The kernel's checks of a [B, N, .] batch on a CUDA device: float32
    (idx int32, mask bool), contiguous, one device, every width 128, at
    most 128 RBF centres, B*N*K slots within int32 row ids."""
    fn = "fused_edge_encoder"
    if pos.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {pos.device}")
    dev = pos.device
    b, n, k = idx.shape
    w = KERNEL_WIDTH
    if not (b >= 1 and n >= 1 and k >= 1 and b * n * k <= MAX_SLOTS):
        raise ValueError(f"{fn}: B={b}, N={n}, K={k} must be at least 1 and"
                         f" B*N*K at most {MAX_SLOTS}")
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
    csrc/edge_encoder.cu (every width 128, n_rbf <= 128: the weight split
    and the persistent tiles over every slot) or raises.
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
        plan, wsplit = _launch_scratch(b * n, k, dev)
        from gamd_tpu_torch.ops.build import load_library
        err = load_library().gamd_edge_encoder(
            pos.data_ptr(), idx.data_ptr(), build_mask.data_ptr(),
            ctypes.byref(struct), n_rbf, b, n, k, int(flip_dir), float(box),
            _cutoff2(cutoff), float(length_mean), float(length_std),
            1.0 / rbf_gap, wsplit.data_ptr(), *plan[:4], e.data_ptr(),
            live.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        edge_tiles.raise_on("fused_edge_encoder", err)
        fused_edge_encoder.launches += 1
    return (e[0], live[0]) if single else (e, live)


fused_edge_encoder.launches = 0


def live_edge_encoder_reference(pos, idx, layout: LiveLayout, params,
                                box, length_mean, length_std, rbf_gap=0.025,
                                flip_dir=False, out=None):
    """Plain version of live_edge_encoder: edge_encoder_reference's rows at
    the layout's live slots, with the geometry recomputed from pos and idx
    at those slots as the kernel does (in the package's remainder-form
    minimum image, as edge_encoder_reference; the kernel's round form
    differs from it in the last bit at most). Returns e [N, K, E]: `out`
    (or zeros) with those rows written."""
    n, k = idx.shape
    slots = layout.slot[0, :int(layout.total[0])].long()
    i, j = slots // k, idx.reshape(-1)[slots].long()
    rel = space.min_image(pos[j] - pos[i], box)
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1))
    unit = rel / (dist[..., None] + 1e-8)
    if flip_dir:
        unit = -unit
    std = (dist - float(length_mean)) / float(length_std)
    rows = encode_edges(params, unit, std, None, "gelu", rbf_gap)
    if out is None:
        out = torch.zeros((n, k, rows.shape[-1]), device=pos.device,
                          dtype=torch.float32)
    out.view(n * k, -1)[slots] = rows
    return out


def _check_live(pos, idx, layout, params, n_rbf, out):
    """live_edge_encoder's checks on a CUDA device: float32 pos [N, 3],
    int32 idx [N, K], a layout of one replica of N atoms of K slots,
    the encoder's weights at width 128 with at least n_rbf RBF rows and
    centres (EncoderParams, or a MegaParams' first ten fields), an out of
    [N, K, 128] float32; all contiguous, on one device."""
    fn = "live_edge_encoder"
    if pos.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {pos.device}")
    dev = pos.device
    n, k = idx.shape if idx.ndim == 2 else (0, 0)
    w = KERNEL_WIDTH
    _check(fn, "pos", pos, dev, torch.float32, (n, 3))
    _check(fn, "idx", idx, dev, torch.int32, (n, k))
    shapes = ((1, layout_capacity(n, k)), (1, n), (1, n), (1,))
    for name, t, shape in zip(LiveLayout._fields, layout, shapes):
        _check(fn, f"layout.{name}", t, dev, torch.int32, shape)
    if not 1 <= n_rbf <= w:
        raise ValueError(f"{fn}: n_rbf must lie in [1, {w}], not {n_rbf}")
    rows = dict(centers=(1, max(n_rbf, params.centers.shape[-1])),
                w_geo=(max(4, params.w_geo.shape[0]), w),
                w_rbf=(max(n_rbf, params.w_rbf.shape[0]), w),
                w1=(w, w), w2=(w, w))
    for name in EncoderParams._fields:
        t = getattr(params, name)
        _check(fn, f"params.{name}", t, dev, torch.float32,
               rows.get(name, (1, w)))
    if out is not None:
        _check(fn, "out", out, dev, torch.float32, (n, k, w))
    return n, k


def live_edge_encoder(pos, idx, layout: LiveLayout, params, box,
                      length_mean, length_std, rbf_gap=0.025,
                      flip_dir=False, n_rbf=None, out=None):
    """e [N, K, E] of one frame, whose rows at the layout's live slots are
    the encoder's (edge_encoder_reference's rows there) and whose other
    rows are never written.

    Args:
        pos: [N, 3] float32 positions (any image: the kernel takes the
            round-form minimum image).
        idx: [N, K] int32 neighbour ids in [0, N).
        layout: the live-slot layout of the frame's mask
            (edge_tiles.mask_layout), one replica of N atoms of K slots.
        params: EncoderParams (encoder_params), or a MegaParams, whose
            first ten fields are the same weights padded.
        box, length_mean, length_std, rbf_gap, flip_dir: as
            fused_edge_encoder.
        n_rbf: the RBF rows the product runs over (default: every column
            of params.centers; a MegaParams passes ops.mega._rbf_rows).
        out: [N, K, 128] float32 to write into (default: a new
            torch.empty; zeros on the CPU).

    A CPU `pos` runs live_edge_encoder_reference. A CUDA `pos` launches
    csrc/edge_encoder.cu over the layout (every width 128) or raises.
    """
    if pos.device.type == "cpu":
        return live_edge_encoder_reference(pos, idx, layout, params, box,
                                           length_mean, length_std, rbf_gap,
                                           flip_dir, out)
    n_rbf = params.centers.shape[-1] if n_rbf is None else int(n_rbf)
    n, k = _check_live(pos, idx, layout, params, n_rbf, out)
    dev = pos.device
    if out is None:
        out = torch.empty((n, k, KERNEL_WIDTH), device=dev,
                          dtype=torch.float32)
    plan, wsplit = _launch_scratch(n, k, dev)
    struct = _EncoderWeights(*[getattr(params, name).data_ptr()
                               for name in EncoderParams._fields])
    from gamd_tpu_torch.ops.build import load_library
    err = load_library().gamd_live_edge_encoder(
        pos.data_ptr(), idx.data_ptr(), layout.slot.data_ptr(),
        layout.total.data_ptr(), ctypes.byref(struct), n_rbf, n, k,
        int(flip_dir), float(box), float(length_mean), float(length_std),
        1.0 / rbf_gap, wsplit.data_ptr(), *plan[:4], out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    edge_tiles.raise_on("live_edge_encoder", err)
    live_edge_encoder.launches += 1
    return out


live_edge_encoder.launches = 0
