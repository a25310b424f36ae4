"""Whole-model GAMD forward, positions to forces: the host side of
gamd_tpu/ops/pallas_model.py and the wrapper of its Hopper kernel.

* MegaParams / pack_params re-pack a GAMDNet parameter tree (layer axes
  stacked, eval BatchNorm folded into the node-norm affine, force
  denormalisation folded into the decoder's last affine).
* encode_edges / node_norm / conv_apply / decode_nodes / reference_forward
  are the kernel's plain PyTorch version (tanh-gelu, as the kernel). Their
  edge-level products (the encoder's three, each layer's four) go through
  `_edge_mm`, a plain product; split_bf16_matmul is the kernel's bf16 x 3
  tensor-core arithmetic in plain PyTorch, which a test puts in its place.
* live_edge_layout is the plain version of the kernel's live-edge layout
  (the live slots of each replica compacted atom-major, per-atom offsets
  and counts); mega_layout runs the kernel's layout stage alone on a CUDA
  tensor (counted in `mega_layout.launches`) and live_edge_layout on a
  CPU tensor.
* mega_forward runs csrc/mega_forward.cu on a CUDA tensor and the plain
  version on a CPU tensor, with water's bond channel or without. It
  counts its kernel launches in `mega_forward.launches`.
* md_steps_reference is the plain version of a whole BAOAB Langevin window
  with that forward inside (gamd_tpu/ops/pallas_model.py::mega_md_steps);
  mega_md_steps runs it as csrc/mega_md_steps.cu on a CUDA tensor, one
  library call per window, and counts its calls in
  `mega_md_steps.launches`.

All of them take one system ([N, 3] positions) or R independent replicas
([R, N, 3], with [R, N, K] lists and [R, N, D] h0), as the JAX kernels'
replica grid does; one call covers all replicas.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from gamd_tpu_torch.core import space
from gamd_tpu_torch.ops.philox import philox_normal

#: Every feature width the CUDA kernel takes (encoder, hidden, edge, node).
KERNEL_WIDTH = 128


def _gelu_tanh(x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def _silu(x):
    return x * torch.sigmoid(x)


_ACTS = {"gelu": _gelu_tanh, "silu": _silu}

#: The library's activation codes (csrc/encode.cuh, Act) of the conv and
#: MLP activations.
ACT_CODES = {"silu": 0, "gelu": 1}

#: The benchmark's stage switches, JAX's `ablate` names
#: (gamd_tpu/ops/pallas_model.py:307-317), in the library's order: stage s
#: is ABLATE_STAGES.index(s) + 1, 0 none (csrc/mega.cuh, Ablate). Each
#: replaces a stage by a cheap stand-in of the same shape, so numerics
#: under any of them are meant to be wrong: tools/bench_ablate.py prices a
#: stage as the step time it saves.
ABLATE_STAGES = ("acts", "gather_pos", "rbf", "encmlp", "ln", "nodeops",
                 "gather_conv", "srcaff", "emlp", "repeat", "theta", "agg",
                 "decoder", "noise")
#: The forms the port defines for itself (JAX's depend on its TPU tiling
#: or change the live set; ROADMAP Queue 3): gather_pos reads atom 0's
#: position for every neighbour but keeps the live flags of the true list,
#: repeat adds atom 0's dst to every edge, agg takes each atom's first live
#: edge's message.
PORT_DEFINED = ("gather_pos", "repeat", "agg")


def ablate_set(ablate) -> frozenset:
    """The stage names of `ablate` (a name or an iterable of names) as a
    frozenset; ValueError for a name JAX's kernel does not know."""
    names = frozenset((ablate,) if isinstance(ablate, str) else ablate)
    unknown = sorted(names - set(ABLATE_STAGES))
    if unknown:
        raise ValueError(f"unknown ablate stage(s) {unknown}; the stages "
                         f"are {list(ABLATE_STAGES)}")
    return names


def _half(x):
    return 0.5 * x


def _act(name, ablate=frozenset()):
    """The activation `name` (silu or gelu), or 0.5 x under `acts`."""
    if name not in _ACTS:
        raise ValueError(f"unknown activation {name!r}; the kernels take "
                         f"{sorted(_ACTS)}")
    return _half if "acts" in ablate else _ACTS[name]


def _edge_mm(a, w):
    """An edge-level product of the plain forward (the encoder's RBF and
    MLP products, each layer's W_e1, W_e2, W_t1, W_t2): plain fp32."""
    return a @ w


def split_bf16_matmul(a, w):
    """a @ w as the kernel's tensor cores compute it (csrc/edge_tc.cuh;
    JAX's edge_hilo, gamd_tpu/ops/pallas_model.py:359-381): both float32
    operands split into bf16 hi + lo (lo = bf16(x - hi)), then
    a_hi w_hi + a_hi w_lo + a_lo w_hi with float32 sums; lo x lo is
    dropped. Each product of two bf16 values is exact in float32, so only
    the split's residuals (about 2^-18 of |a||w| a term) and the sums'
    rounding differ from the exact product. Plain PyTorch, for the tests."""
    def split(x):
        hi = x.to(torch.bfloat16)
        lo = (x - hi.float()).to(torch.bfloat16)
        return hi.float(), lo.float()
    a_hi, a_lo = split(a.float())
    w_hi, w_lo = split(w.float())
    return a_hi @ w_hi + a_hi @ w_lo + a_lo @ w_hi


class MegaParams(NamedTuple):
    """GAMDNet weights re-packed for the kernel (layer axes stacked).

    The JAX package's bf16 src-affine prepack (w_src3) is a TPU workaround
    and has no counterpart here.
    """

    # encoder
    centers: torch.Tensor    # [1, 128] RBF centres (zero-padded)
    w_geo: torch.Tensor      # [8, H]: rows 0-2 unit, 3 std-dist, 4 bond
    w_rbf: torch.Tensor      # [128, H] (rows >= n_rbf are zero)
    b0: torch.Tensor         # [1, H]
    w1: torch.Tensor         # [H, H]
    b1: torch.Tensor         # [1, H]
    w2: torch.Tensor         # [H, E]
    b2: torch.Tensor         # [1, E]
    eln_s: torch.Tensor      # [1, E] edge LayerNorm scale
    eln_b: torch.Tensor      # [1, E]
    # conv layers (leading axis L)
    nln_s: torch.Tensor      # [L, 1, D] node norm scale (LN) / folded BN a
    nln_b: torch.Tensor      # [L, 1, D]
    w_src: torch.Tensor      # [L, D, H]
    b_src: torch.Tensor      # [L, 1, H]
    w_dst: torch.Tensor      # [L, D, H]
    b_dst: torch.Tensor      # [L, 1, H]
    w_e1: torch.Tensor       # [L, E, H]
    b_e1: torch.Tensor       # [L, 1, H]
    w_e2: torch.Tensor       # [L, H, H]
    b_e2: torch.Tensor       # [L, 1, H]
    w_t1: torch.Tensor       # [L, H, H]
    b_t1: torch.Tensor       # [L, 1, H]
    w_t2: torch.Tensor       # [L, H, D]
    b_t2: torch.Tensor       # [L, 1, D]
    w_pd: torch.Tensor       # [L, D, H]
    b_pd: torch.Tensor       # [L, 1, H]
    w_pe: torch.Tensor       # [L, D, H]
    b_pe: torch.Tensor       # [L, 1, H]
    w_p: torch.Tensor        # [L, H, D]
    b_p: torch.Tensor        # [L, 1, D]
    # decoder (final affine may fold force denormalisation)
    wd0: torch.Tensor        # [D, H]
    bd0: torch.Tensor        # [1, H]
    wd1: torch.Tensor        # [H, 128] (cols 0-2 live)
    bd1: torch.Tensor        # [1, 128]


def pack_params(params, cfg, batch_stats=None, force_std=None,
                force_mean=None, unit: float = 1.0, device="cpu"):
    """Re-pack a parameter tree (flax layout; numpy or torch leaves) into
    float32 MegaParams on `device`.

    With force_std/force_mean the decoder's last affine absorbs
    `pred * std + mean` and the `unit` conversion. With BatchNorm
    (use_layer_norm=False) the eval normalisation folds into the per-feature
    affine: a = scale/sqrt(var+eps), b = bias - mean*a.
    """
    f32 = lambda a: np.asarray(a, np.float32)
    row = lambda a: f32(a).reshape(1, -1)
    h_dim = cfg.hidden_dim
    n_rbf = cfg.n_rbf if cfg.expand_edge else 0

    w0 = f32(params["edge_encoder_w0"])       # [3+1+n_rbf(+1 bond), H]
    w_geo = np.zeros((8, h_dim), np.float32)
    w_geo[:4] = w0[:4]
    if w0.shape[0] > 4 + n_rbf:               # trailing bond-channel row
        w_geo[4] = w0[4 + n_rbf]
    w_rbf = np.zeros((128, h_dim), np.float32)
    w_rbf[:n_rbf] = w0[4:4 + n_rbf]
    centers = np.zeros((1, 128), np.float32)
    if n_rbf:
        centers[0, :n_rbf] = np.linspace(cfg.rbf_low, cfg.rbf_high, n_rbf)

    gc = params["graph_conv"]
    ln_s, ln_b = [], []
    for layer in range(cfg.conv_layers):
        norm = gc[f"norm_{layer}"]
        if cfg.use_layer_norm:
            ln_s.append(row(norm["scale"]))
            ln_b.append(row(norm["bias"]))
        else:
            stats = batch_stats["graph_conv"][f"norm_{layer}"]
            a = f32(norm["scale"]) / np.sqrt(f32(stats["var"]) + 1e-5)
            ln_s.append(row(a))
            ln_b.append(row(f32(norm["bias"]) - f32(stats["mean"]) * a))

    def stack(fn):
        return np.stack([fn(gc[f"conv_{l}"]) for l in range(cfg.conv_layers)])

    dec = params["graph_decoder"]
    wd1 = f32(dec["Dense_1"]["kernel"])       # [H, 3]
    bd1 = f32(dec["Dense_1"]["bias"])         # [3]
    if force_std is not None:
        scale = np.float32(force_std) * np.float32(unit)
        wd1 = wd1 * scale
        bd1 = bd1 * scale + np.float32(force_mean) * np.float32(unit)
    wd1_pad = np.zeros((h_dim, 128), np.float32)
    wd1_pad[:, :3] = wd1
    bd1_pad = np.zeros((1, 128), np.float32)
    bd1_pad[0, :3] = bd1

    packed = dict(
        centers=centers, w_geo=w_geo, w_rbf=w_rbf,
        b0=row(params["edge_encoder_b0"]),
        w1=f32(params["edge_encoder_w1"]),
        b1=row(params["edge_encoder_b1"]),
        w2=f32(params["edge_encoder_w2"]),
        b2=row(params["edge_encoder_b2"]),
        eln_s=row(params["edge_ln_scale"]),
        eln_b=row(params["edge_ln_bias"]),
        nln_s=np.stack(ln_s), nln_b=np.stack(ln_b),
        w_src=stack(lambda c: f32(c["src_affine"]["kernel"])),
        b_src=stack(lambda c: row(c["src_affine"]["bias"])),
        w_dst=stack(lambda c: f32(c["dst_affine"]["kernel"])),
        b_dst=stack(lambda c: row(c["dst_affine"]["bias"])),
        w_e1=stack(lambda c: f32(c["edge_affine_w1"])),
        b_e1=stack(lambda c: row(c["edge_affine_b1"])),
        w_e2=stack(lambda c: f32(c["edge_affine_w2"])),
        b_e2=stack(lambda c: row(c["edge_affine_b2"])),
        w_t1=stack(lambda c: f32(c["theta_edge_w1"])),
        b_t1=stack(lambda c: row(c["theta_edge_b1"])),
        w_t2=stack(lambda c: f32(c["theta_edge_w2"])),
        b_t2=stack(lambda c: row(c["theta_edge_b2"])),
        w_pd=stack(lambda c: f32(c["phi_dst_w"])),
        b_pd=stack(lambda c: row(c["phi_dst_b"])),
        w_pe=stack(lambda c: f32(c["phi_edge_w"])),
        b_pe=stack(lambda c: row(c["phi_edge_b"])),
        w_p=stack(lambda c: f32(c["phi_w"])),
        b_p=stack(lambda c: row(c["phi_b"])),
        wd0=f32(dec["Dense_0"]["kernel"]),
        bd0=row(dec["Dense_0"]["bias"]),
        wd1=wd1_pad, bd1=bd1_pad,
    )
    return MegaParams(**{k: torch.as_tensor(np.ascontiguousarray(v),
                                            device=device)
                         for k, v in packed.items()})


# ---------------------------------------------------------------------------
# Plain PyTorch version over MegaParams: the kernel's reference.
# ---------------------------------------------------------------------------

def encode_edges(mp: MegaParams, unit, std_dist, bond, mlp_act="gelu",
                 rbf_gap=0.025, ablate=frozenset()):
    """unit [..,3], std_dist [..], bond [..] or None -> e [.., E]. ablate
    (ablate_set) may hold rbf (std_dist in every column of the RBF
    product), encmlp (no w1, w2 and their activations), ln (no
    normalisation; the affine stays) and acts."""
    act = _act(mlp_act, ablate)
    gamma = 1.0 / rbf_gap
    if "rbf" in ablate:
        z = std_dist[..., None].expand(*std_dist.shape, mp.w_rbf.shape[1])
    else:
        diff = std_dist[..., None] - mp.centers[0]
        z = _edge_mm(torch.exp(-gamma * diff * diff), mp.w_rbf)
    z = (z + unit[..., 0:1] * mp.w_geo[0:1] + unit[..., 1:2] * mp.w_geo[1:2]
         + unit[..., 2:3] * mp.w_geo[2:3]
         + std_dist[..., None] * mp.w_geo[3:4] + mp.b0[0])
    if bond is not None:
        z = z + bond[..., None] * mp.w_geo[4:5]
    if "encmlp" not in ablate:
        z = _edge_mm(act(_edge_mm(act(z), mp.w1) + mp.b1[0]), mp.w2) \
            + mp.b2[0]
    if "ln" in ablate:
        return z * mp.eln_s[0] + mp.eln_b[0]
    mean = torch.mean(z, dim=-1, keepdim=True)
    zc = z - mean
    var = torch.mean(zc * zc, dim=-1, keepdim=True)
    return (zc * torch.rsqrt(var + 1e-6)) * mp.eln_s[0] + mp.eln_b[0]


def node_norm(mp: MegaParams, layer, h, use_ln=True):
    if use_ln:
        mean = torch.mean(h, dim=-1, keepdim=True)
        hc = h - mean
        var = torch.mean(hc * hc, dim=-1, keepdim=True)
        h = hc * torch.rsqrt(var + 1e-6)
    return h * mp.nln_s[layer, 0] + mp.nln_b[layer, 0]


def conv_apply(mp: MegaParams, layer, h_own, hn_own, hn_env, e, idx, mask,
               conv_act="silu", ablate=frozenset()):
    """One EdgeGatedConv over a padded list whose indices point into an
    environment array (hn_env; equal to hn_own on one device). ablate
    (ablate_set) may hold gather_conv (every source is row 0 of the
    environment), srcaff (the source code is b_src), emlp (z is e itself),
    repeat (every edge adds row 0's dst), theta (no theta MLP), agg (each
    atom takes its first live slot's message), nodeops (dst = hn, and h +
    act(hn + agg)) and acts."""
    act = _act(conv_act, ablate)
    idx = idx.long()
    if "gather_conv" in ablate:
        idx = torch.zeros_like(idx)
    src_env = hn_env @ mp.w_src[layer] + mp.b_src[layer, 0]
    dst = hn_own if "nodeops" in ablate else \
        hn_own @ mp.w_dst[layer] + mp.b_dst[layer, 0]
    if "emlp" in ablate:
        z = e
    else:
        z = _edge_mm(act(_edge_mm(e, mp.w_e1[layer]) + mp.b_e1[layer, 0]),
                     mp.w_e2[layer]) + mp.b_e2[layer, 0]
    src = mp.b_src[layer, 0] if "srcaff" in ablate else src_env[idx]
    z = z + src + (dst[0:1, None, :] if "repeat" in ablate
                   else dst[:, None, :])
    if "theta" not in ablate:
        z = _edge_mm(act(_edge_mm(act(z), mp.w_t1[layer])
                         + mp.b_t1[layer, 0]),
                     mp.w_t2[layer]) + mp.b_t2[layer, 0]
    msg = torch.where(mask[..., None], hn_env[idx] * z, 0.0)
    if "agg" in ablate:
        first = mask.to(torch.int32).argmax(dim=1)
        agg = msg[torch.arange(msg.shape[0], device=msg.device), first]
    else:
        agg = torch.sum(msg, dim=1)
    if "nodeops" in ablate:
        return h_own + act(hn_own + agg)
    pre = hn_own @ mp.w_pd[layer] + mp.b_pd[layer, 0] \
        + agg @ mp.w_pe[layer] + mp.b_pe[layer, 0]
    return h_own + act(pre) @ mp.w_p[layer] + mp.b_p[layer, 0]


def decode_nodes(mp: MegaParams, h, mlp_act="gelu", ablate=frozenset()):
    """Forces from node rows; under `decoder` h's first three columns."""
    if "decoder" in ablate:
        return h[..., :3]
    act = _act(mlp_act, ablate)
    z = act(h @ mp.wd0 + mp.bd0[0])
    return (z @ mp.wd1 + mp.bd1[0])[..., :3]


def reference_forward(pos, idx, build_mask, h0, mp: MegaParams, box, cutoff,
                      length_mean, length_std, bond=None, rbf_gap=0.025,
                      flip_dir=False, use_ln=True, conv_act="silu",
                      mlp_act="gelu", n_layers=None, ablate=()):
    """Plain version of mega_forward (fp32, tanh-gelu; see models.gnn.
    GAMDNet for the erf-gelu model): one system [N, ...], or replicas
    [R, N, ...], each replica on its own. ablate: the benchmark's stage
    switches (ABLATE_STAGES; gather_pos takes the geometry of every slot
    from atom 0's position, the live mask still from the true list)."""
    ablate = ablate_set(ablate)
    if pos.ndim == 3:
        return torch.stack([reference_forward(
            pos[r], idx[r], build_mask[r], h0[r], mp, box, cutoff,
            length_mean, length_std, None if bond is None else bond[r],
            rbf_gap, flip_dir, use_ln, conv_act, mlp_act, n_layers, ablate)
            for r in range(pos.shape[0])])
    nbr = pos[idx.long()]
    rel = space.min_image(nbr - pos[:, None, :], box)
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1))
    mask = build_mask if cutoff is None else (
        build_mask & (dist * dist < cutoff * cutoff))
    if "gather_pos" in ablate:
        rel = space.min_image(pos[0] - pos[:, None, :], box).expand(
            *idx.shape, 3)
        dist = torch.sqrt(torch.sum(rel * rel, dim=-1))
    unit = rel / (dist[..., None] + 1e-8)
    if flip_dir:
        unit = -unit
    std = (dist - length_mean) / length_std
    e = encode_edges(mp, unit, std, bond, mlp_act, rbf_gap, ablate)
    h = h0
    n_layers = mp.w_src.shape[0] if n_layers is None else n_layers
    for layer in range(n_layers):
        hn = node_norm(mp, layer, h, use_ln and "ln" not in ablate)
        h = conv_apply(mp, layer, h, hn, hn, e, idx, mask, conv_act, ablate)
    return decode_nodes(mp, h, mlp_act, ablate)


def md_steps_reference(pos, vel, force, idx, build_mask, h0,
                       mp: MegaParams, box, cutoff, length_mean, length_std,
                       masses, *, n_steps: int, c1, hdt, c2col, seed,
                       bond=None, rbf_gap=0.025, flip_dir=False, use_ln=True,
                       conv_act="silu", mlp_act="gelu", ablate=()):
    """Plain version of a fused MD window: n_steps of BAOAB Langevin (B A
    O A, force, B) as gamd_tpu/ops/pallas_model.py:815-827, with the noise
    of ops.philox.philox_normal(seed, step, N, replica=r) (zero under the
    `noise` ablation) and the force of reference_forward on the unwrapped
    positions (the window never wraps). One system [N, 3] or replicas
    [R, N, 3] (masses and c2col [N] shared). Returns (pos', vel', force',
    ke) with ke = 1/2 sum m v^2 after each step, [n_steps] (or
    [R, n_steps])."""
    ablate = ablate_set(ablate)
    n = pos.shape[-2]
    dev = pos.device
    reps = range(pos.shape[0]) if pos.ndim == 3 else None
    as_col = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                       device=dev).reshape(-1, 1)
    m = as_col(masses)
    invm = 1.0 / m
    c2 = as_col(c2col)
    x, v, f = pos, vel, force
    kes = []
    for step in range(n_steps):
        v = v + hdt * invm * f                                   # B
        x = x + hdt * v                                          # A
        if "noise" in ablate:
            xi = torch.zeros_like(v)
        elif reps is None:
            xi = philox_normal(seed, step, n, device=dev)
        else:
            xi = torch.stack([philox_normal(seed, step, n, device=dev,
                                            replica=r) for r in reps])
        v = c1 * v + c2 * xi                                     # O
        x = x + hdt * v                                          # A
        f = reference_forward(x, idx, build_mask, h0, mp, box, cutoff,
                              length_mean, length_std, bond, rbf_gap,
                              flip_dir, use_ln, conv_act, mlp_act,
                              ablate=ablate)
        v = v + hdt * invm * f                                   # B
        kes.append(0.5 * torch.sum(m * v * v, dim=(-2, -1)))
    return x, v, f, torch.stack(kes, dim=-1)


# ---------------------------------------------------------------------------
# The kernel's live-edge layout, plain version.
# ---------------------------------------------------------------------------

#: Rows of a tile of the kernel's edge stages (one wgmma M).
TILE_ROWS = 64


class LiveLayout(NamedTuple):
    """The live edges of R replicas (a leading R axis, 1 for one system),
    as the kernel's edge stages walk them.

    slot:   [R, cap] slot id i*K + k of each live edge, atom-major and in
            slot order within an atom; rows past total[r] hold -1 (the
            kernel leaves them unwritten). cap = layout_capacity(N, K).
    offset: [R, N] the atom's first row in its replica's list.
    count:  [R, N] the atom's live edges.
    total:  [R] the replica's live edges.
    """

    slot: torch.Tensor
    offset: torch.Tensor
    count: torch.Tensor
    total: torch.Tensor


def layout_capacity(n, k):
    """Rows a replica's list may take: N*K rounded up to TILE_ROWS."""
    return -(-n * k // TILE_ROWS) * TILE_ROWS


def live_mask(pos, idx, build_mask, box, cutoff):
    """The kernel's live test of every slot ([N, K] or [R, N, K]): the build
    mask and d^2 < cutoff^2 (cutoff None: the build mask alone), with the
    round-form minimum image and d^2 = (x^2 + y^2) + z^2 in float32 --
    the kernel's arithmetic operation for operation, so that the two agree
    bit for bit (reference_forward's remainder-form test can differ in the
    last bit at the cutoff)."""
    f32 = dict(dtype=torch.float32, device=pos.device)
    box_t = torch.tensor(float(box), **f32)   # a tensor: CUDA divides by a
    cut2 = torch.tensor(math.inf if cutoff is None   # scalar as a product
                        else float(cutoff) ** 2, **f32)
    idx = idx.long()
    if pos.ndim == 2:
        nbr = pos[idx]
    else:
        nbr = pos[torch.arange(pos.shape[0], device=pos.device)[:, None,
                                                                 None], idx]
    rel = nbr - pos[..., None, :]
    rel = rel - box_t * torch.round(rel / box_t)
    sq = rel * rel
    d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    return build_mask & (d2 < cut2)


def live_slot_layout(live):
    """The live slots of a bool [N, K] or [R, N, K] mask compacted
    atom-major per replica, with per-atom offsets from an exclusive scan of
    the per-atom counts: a LiveLayout with a leading R axis either way.
    The plain version of the layout stage of both tensor-core edge
    kernels: the whole-model forward's (on live_mask) and the conv
    message's (csrc/conv_tc.cuh, on the aggregation mask)."""
    if live.ndim == 2:
        live = live[None]
    r, n, k = live.shape
    count = live.sum(dim=-1, dtype=torch.int32)
    offset = (torch.cumsum(count, dim=-1) - count).to(torch.int32)
    slot = torch.full((r, layout_capacity(n, k)), -1, dtype=torch.int32,
                      device=live.device)
    for rep in range(r):
        ids = torch.nonzero(live[rep].reshape(-1)).flatten()
        slot[rep, :ids.numel()] = ids.to(torch.int32)
    return LiveLayout(slot, offset, count,
                      count.sum(dim=-1, dtype=torch.int32))


def live_edge_layout(pos, idx, build_mask, box, cutoff):
    """Plain version of the kernel's live-edge layout (its first stage):
    live_slot_layout of live_mask. One system ([N, 3]) or replicas ([R, N,
    3]); a LiveLayout with a leading R axis either way."""
    return live_slot_layout(live_mask(pos, idx, build_mask, box, cutoff))


def layout_tiles(layout: LiveLayout):
    """(replica, first row, rows) of each tile of the kernel's edge
    stages: TILE_ROWS rows of one replica's list, the last one short."""
    return [(rep, row0, min(TILE_ROWS, total - row0))
            for rep, total in enumerate(layout.total.tolist())
            for row0 in range(0, total, TILE_ROWS)]


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/mega_forward.cu, csrc/mega_md_steps.cu) and their
# wrappers.
# ---------------------------------------------------------------------------

class _MegaWeights(ctypes.Structure):
    """Mirror of the C struct MegaWeights: one device pointer per field of
    MegaParams, in the same order."""

    _fields_ = [(name, ctypes.c_void_p) for name in MegaParams._fields]


class _MegaScratch(ctypes.Structure):
    """Mirror of the C struct MegaScratch (csrc/mega.cuh): the forward's
    scratch, one device pointer a field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "live", "slot", "off", "cnt", "total", "e", "msg", "h", "hn", "src",
        "dst", "wsplit")]


#: Returned by the library when the TMA map over the split weights cannot
#: be encoded: this plus the CUresult of cuTensorMapEncodeTiled.
_TMA_MAP_ERROR = 100000


def declare(lib):
    """Set argtypes/restype of the library's C entries."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    weights = ctypes.POINTER(_MegaWeights)
    scratch = ctypes.POINTER(_MegaScratch)
    lib.gamd_mega_forward.argtypes = [
        p, p, p, p, p, weights,                       # pos idx bm bond h0 w
        i, i, i, i, i, i, i,                          # r n k L n_rbf ln flip
        i, i,                                         # conv_act mlp_act
        f, f, f, f, f,                                # box cut2 lm ls gamma
        scratch, p,                                   # scratch out
        p]                                            # stream
    lib.gamd_mega_forward.restype = ctypes.c_int
    lib.gamd_mega_md_steps.argtypes = [
        p, p, p, p, p, p, p, weights,                 # pos vel f idx bm bond
                                                      # h0 w
        p, p, p,                                      # seed masses c2col
        i, i, i, i, i, i, i,                          # r n k L n_rbf ln flip
        i, i, i,                                      # conv_act mlp_act
                                                      # ablated stage
        f, f, f, f, f,                                # box cut2 lm ls gamma
        i, f, f,                                      # n_steps c1 hdt
        scratch,                                      # forward scratch
        p, p, p, p,                                   # pos vel force ke out
        p]                                            # stream
    lib.gamd_mega_md_steps.restype = ctypes.c_int
    lib.gamd_mega_layout.argtypes = [
        p, p, p,                                      # pos idx bmask
        i, i, i,                                      # r n k
        f, f,                                         # box cut2
        scratch, p]                                   # scratch stream
    lib.gamd_mega_layout.restype = ctypes.c_int


def _raise_on(fn, err):
    if err >= _TMA_MAP_ERROR:
        raise RuntimeError(f"{fn}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {err - _TMA_MAP_ERROR}")
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")


@functools.lru_cache(maxsize=None)
def _expected_shapes(n_layers):
    w, L = KERNEL_WIDTH, n_layers
    shapes = {"centers": (1, 128), "w_geo": (8, w), "w_rbf": (128, w),
              "wd1": (w, 128), "bd1": (1, 128)}
    for name in MegaParams._fields:
        if name in shapes:
            continue
        if name.startswith("w"):
            shapes[name] = (L, w, w) if name not in ("w1", "w2", "wd0") \
                else (w, w)
        elif name in ("b0", "b1", "b2", "eln_s", "eln_b", "bd0"):
            shapes[name] = (1, w)
        else:
            shapes[name] = (L, 1, w)
    return shapes


def _check(fn, name, t, device, dtype, shape):
    if not isinstance(t, torch.Tensor) or t.device != device \
            or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        got = (f"{tuple(t.shape)} {t.dtype} on {t.device}, contiguous="
               f"{t.is_contiguous()}") if isinstance(t, torch.Tensor) \
            else type(t).__name__
        raise ValueError(f"{fn}: {name} must be a contiguous "
                         f"{dtype} tensor of shape {tuple(shape)} on "
                         f"{device}; got {got}")


def _check_forward(fn, pos, idx, build_mask, h0, mp, bond, conv_act,
                   mlp_act):
    """The checks both kernels make of the forward's inputs on a CUDA
    device (one system [N, ...] or R replicas [R, N, ...], the same R on
    pos, idx, build_mask, h0 and bond, if given; silu or gelu for each
    activation); returns the library's
    forward arguments that follow from them as (r, n, k, n_layers, weights
    struct, RBF rows, bond pointer or None)."""
    if pos.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {pos.device}")
    for act in (conv_act, mlp_act):
        _act(act)
    dev = pos.device
    if pos.ndim not in (2, 3):
        raise ValueError(f"{fn}: pos must be [N, 3] or [R, N, 3], not "
                         f"{tuple(pos.shape)}")
    lead = tuple(pos.shape[:-2])
    n = pos.shape[-2]
    k = idx.shape[-1]
    n_layers = mp.w_src.shape[0]
    _check(fn, "pos", pos, dev, torch.float32, (*lead, n, 3))
    _check(fn, "idx", idx, dev, torch.int32, (*lead, n, k))
    _check(fn, "build_mask", build_mask, dev, torch.bool, (*lead, n, k))
    _check(fn, "h0", h0, dev, torch.float32, (*lead, n, KERNEL_WIDTH))
    if bond is not None:
        _check(fn, "bond", bond, dev, torch.float32, (*lead, n, k))
    r = lead[0] if lead else 1
    if r < 1:
        raise ValueError(f"{fn}: no replicas in pos {tuple(pos.shape)}")
    _check_slots(fn, k)
    return (r, n, k, n_layers, *_weights(fn, mp, dev),
            None if bond is None else bond.data_ptr())


#: Per MegaParams (keyed by its first tensor): the identity and version of
#: every tensor and the device, with what _weights returns. A call with the
#: same, unchanged tensors skips the 34 checks and the RBF row count.
_CHECKED = WeakIdKeyDictionary()


def _weights(fn, mp: MegaParams, device):
    """(the library's _MegaWeights struct, _rbf_rows) of mp, checked
    against the kernel's shapes on `device`; once per unchanged set of
    tensors."""
    key = (device, tuple((id(t), t._version) for t in mp))
    hit = _CHECKED.get(mp.centers)
    if hit is not None and hit[0] == key:
        return hit[1]
    for name, shape in _expected_shapes(mp.w_src.shape[0]).items():
        _check(fn, f"mp.{name}", getattr(mp, name), device, torch.float32,
               shape)
    found = (_MegaWeights(*[t.data_ptr() for t in mp]), _rbf_rows(mp))
    _CHECKED[mp.centers] = (key, found)
    return found


#: The most slots an atom's list may have: the layout kernel holds the live
#: flags of at least 32 atoms in 16 KB of shared memory.
MAX_SLOTS = 512


def _check_slots(fn, k):
    if not 1 <= k <= MAX_SLOTS:
        raise ValueError(f"{fn}: the CUDA kernel takes 1 to {MAX_SLOTS} "
                         f"slots an atom, not {k}")


def _forward_scratch(r, n, k, n_layers, device):
    """Scratch of one forward of r replicas in one torch.empty (the
    kernels allocate nothing): the live flags and the live-edge layout
    (slot, off, cnt, total), the edge embeddings and messages of the live
    edges (R * cap rows each), the node rows h, hn, src, dst, and the split
    edge-stage weights (bf16). Returns (buffer, _MegaScratch of pointers
    into it, each 256-byte aligned); the buffer must outlive the call."""
    w, a, cap = KERNEL_WIDTH, r * n, layout_capacity(n, k)
    sizes = dict(live=a * k, slot=4 * r * cap, off=4 * a, cnt=4 * a,
                 total=4 * r, e=4 * r * cap * w, msg=4 * r * cap * w,
                 h=4 * a * w, hn=4 * a * w, src=4 * a * w, dst=4 * a * w,
                 wsplit=2 * (3 + 4 * n_layers) * 2 * w * w)
    offsets, total = [], 0
    for name, _ in _MegaScratch._fields_:
        offsets.append(total)
        total += -(-sizes[name] // 256) * 256
    buf = torch.empty((total,), device=device, dtype=torch.uint8)
    base = buf.data_ptr()
    return buf, _MegaScratch(*[base + o for o in offsets])


def _rbf_rows(mp: MegaParams):
    """The RBF rows pack_params filled (1 + the last non-zero row of
    w_rbf; the rows past it are zero padding), which the kernel's RBF
    product runs over. A device read (one sync): _weights keeps it."""
    nonzero = torch.nonzero(mp.w_rbf.abs().sum(dim=1)).flatten()
    return int(nonzero[-1]) + 1 if nonzero.numel() else 0


def _scalars(box, cutoff, length_mean, length_std, rbf_gap):
    """(box, cutoff^2, length mean, length std, RBF gamma) as the library
    takes them."""
    cutoff2 = math.inf if cutoff is None else float(cutoff) ** 2
    return (float(box), cutoff2, float(length_mean), float(length_std),
            1.0 / rbf_gap)


def mega_forward(pos, idx, build_mask, h0, mp: MegaParams, box, cutoff,
                 length_mean, length_std, bond=None, rbf_gap=0.025,
                 flip_dir=False, use_ln=True, conv_act="silu",
                 mlp_act="gelu", edge_hilo=False, f32_edges=False):
    """Forces [N, 3] (or [R, N, 3]) from wrapped positions.

    Args:
        pos:  [N, 3] or [R, N, 3] float32 wrapped positions (R
              independent replicas, one call).
        idx:  [N, K] / [R, N, K] int32 padded neighbour ids (build-time
              lists, indices within the replica).
        build_mask: [N, K] / [R, N, K] bool validity at build time; the
              forward intersects it with the true-cutoff test from `pos`
              (cutoff=None passes it through).
        h0:   [N, D] / [R, N, D] float32 initial node features.
        mp:   MegaParams from pack_params, on pos's device.
        box, cutoff, length_mean, length_std: Python floats.
        bond: None, or [N, K] / [R, N, K] float32 bond channel (water's
              O-H indicator, neighbors.topology.neighbor_bond_channel of
              the build-time list), read at the live slots; each live edge
              adds bond * w_geo[4] to its encoder input. All zeros gives
              the bits of None.
        edge_hilo, f32_edges: the JAX package's precision switches of the
              edge products (single-pass bf16 by default there, bf16 hi +
              lo with edge_hilo, fp32 with f32_edges). The kernel computes
              every edge product as bf16 x 3 with fp32 sums, JAX's
              edge_hilo arithmetic, whichever is set: that is within the
              fp32 bar, 5e-3 std(F), of the fp32 forward.

        conv_act, mlp_act: "silu" or "gelu" (tanh-gelu) each, the
              conv layers' and the encoder and decoder MLPs' activations.

    A CPU `pos` runs reference_forward. A CUDA `pos` launches the kernel
    (every width 128) or raises.
    """
    if pos.device.type == "cpu":
        return reference_forward(pos, idx, build_mask, h0, mp, box, cutoff,
                                 length_mean, length_std, bond, rbf_gap,
                                 flip_dir, use_ln, conv_act, mlp_act)
    r, n, k, n_layers, weights, n_rbf, bond_ptr = _check_forward(
        "mega_forward", pos, idx, build_mask, h0, mp, bond, conv_act,
        mlp_act)

    from gamd_tpu_torch.ops.build import load_library
    lib = load_library()
    buf, scratch = _forward_scratch(r, n, k, n_layers, pos.device)
    out = torch.empty(pos.shape, device=pos.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = lib.gamd_mega_forward(
        pos.data_ptr(), idx.data_ptr(), build_mask.data_ptr(), bond_ptr,
        h0.data_ptr(), ctypes.byref(weights),
        r, n, k, n_layers, n_rbf, int(use_ln), int(flip_dir),
        ACT_CODES[conv_act], ACT_CODES[mlp_act],
        *_scalars(box, cutoff, length_mean, length_std, rbf_gap),
        ctypes.byref(scratch), out.data_ptr(), stream)
    _raise_on("mega_forward", err)
    mega_forward.launches += 1
    return out


mega_forward.launches = 0


def mega_md_steps(pos, vel, force, idx, build_mask, h0, mp: MegaParams,
                  box, cutoff, length_mean, length_std, masses, *,
                  n_steps: int, c1, hdt, c2col, seed, bond=None,
                  rbf_gap=0.025, flip_dir=False, use_ln=True,
                  conv_act="silu", mlp_act="gelu", edge_hilo=False,
                  f32_edges=False, ablate=()):
    """A whole BAOAB Langevin window of n_steps with the forward inside
    (gamd_tpu/ops/pallas_model.py::mega_md_steps).

    Args:
        pos/vel/force: [N, 3] or [R, N, 3] float32 state (R independent
            replicas, one call); positions need not be wrapped (the
            forward takes minimum images) and are not wrapped here.
        idx/build_mask/h0/mp/box/cutoff/length_mean/length_std/bond/
            edge_hilo/f32_edges: as mega_forward; the list and its bond
            channel are fixed for the window.
        masses: [N] float32 (internal units).
        c1: exp(-gamma dt); hdt: dt / 2 (Python floats); c2col: [N] float32
            noise amplitude sigma * sqrt(1 - c1^2), zero for no noise.
        seed: 1-element int32 tensor on the state's device, the Philox key
            of the window's noise (replica r draws with counter word 2 =
            r); it is passed by pointer and never read on the host.

        ablate: the benchmark's stage switches, names of ABLATE_STAGES
            (JAX's), each neutralising its stage as md_steps_reference
            does; the numerics are then meant to be wrong. Unknown names
            raise ValueError. The card takes one name at a time, without a
            bond channel, where the forward picks two weight buffers a
            tile block and 4 atoms a node block (the forms
            tools/bench_ablate.py runs: LJ-258 at R=1 and K up to 65 on an
            H100), and raises NotImplementedError elsewhere.

    Returns (pos', vel', force', ke [n_steps] or [R, n_steps]). A CPU
    `pos` runs md_steps_reference. A CUDA `pos` makes one call of
    csrc/mega_md_steps.cu (as mega_forward) or raises.
    """
    ablate = ablate_set(ablate)
    if pos.device.type == "cpu":
        return md_steps_reference(
            pos, vel, force, idx, build_mask, h0, mp, box, cutoff,
            length_mean, length_std, masses, n_steps=n_steps, c1=c1,
            hdt=hdt, c2col=c2col, seed=seed, bond=bond, rbf_gap=rbf_gap,
            flip_dir=flip_dir, use_ln=use_ln, conv_act=conv_act,
            mlp_act=mlp_act, ablate=ablate)
    fn = "mega_md_steps"
    r, n, k, n_layers, weights, n_rbf, bond_ptr = _check_forward(
        fn, pos, idx, build_mask, h0, mp, bond, conv_act, mlp_act)
    if len(ablate) > 1 or (ablate and bond is not None):
        raise NotImplementedError(
            f"the CUDA {fn} takes one ablated stage at a time and no bond "
            f"channel with it, not {sorted(ablate)} with bond="
            f"{'given' if bond is not None else None}")
    dev = pos.device
    if ablate and not _ablated_forms_fit(r, n, k, dev):
        raise NotImplementedError(
            f"the CUDA {fn}'s ablated forms hold two weight buffers a tile "
            f"block and 4 atoms a node block (the forward's choices for "
            f"LJ-258 at R=1); at R={r}, N={n}, K={k} the forward picks "
            f"others, and a form would change its launches as well as its "
            f"stage")
    stage = ABLATE_STAGES.index(next(iter(ablate))) + 1 if ablate else 0
    _check(fn, "vel", vel, dev, torch.float32, tuple(pos.shape))
    _check(fn, "force", force, dev, torch.float32, tuple(pos.shape))
    _check(fn, "masses", masses, dev, torch.float32, (n,))
    _check(fn, "c2col", c2col, dev, torch.float32, (n,))
    _check(fn, "seed", seed, dev, torch.int32, (1,))
    if int(n_steps) < 1:
        raise ValueError(f"{fn}: n_steps must be at least 1")

    from gamd_tpu_torch.ops.build import load_library
    lib = load_library()
    buf, scratch = _forward_scratch(r, n, k, n_layers, dev)
    outs = [torch.empty(pos.shape, device=dev, dtype=torch.float32)
            for _ in range(3)]
    ke = torch.empty((*pos.shape[:-2], int(n_steps)), device=dev,
                     dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gamd_mega_md_steps(
        pos.data_ptr(), vel.data_ptr(), force.data_ptr(), idx.data_ptr(),
        build_mask.data_ptr(), bond_ptr, h0.data_ptr(),
        ctypes.byref(weights),
        seed.data_ptr(), masses.data_ptr(), c2col.data_ptr(),
        r, n, k, n_layers, n_rbf, int(use_ln), int(flip_dir),
        ACT_CODES[conv_act], ACT_CODES[mlp_act], stage,
        *_scalars(box, cutoff, length_mean, length_std, rbf_gap),
        int(n_steps), float(c1), float(hdt), ctypes.byref(scratch),
        *[t.data_ptr() for t in outs], ke.data_ptr(), stream)
    _raise_on(fn, err)
    mega_md_steps.launches += 1
    return (*outs, ke)


mega_md_steps.launches = 0


def _ablated_forms_fit(r, n, k, dev) -> bool:
    """Whether the forward of r replicas of n atoms of k slots on `dev`
    picks the launch choices the ablated forms hold (csrc/mega_forward.cu:
    tile_buffers two, node_width 4)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = r * -(-n * k // TILE_ROWS)
    return tiles <= 2 * sms and -(-r * n // 4) <= sms


def mega_layout(pos, idx, build_mask, box, cutoff):
    """The kernel's live-edge layout (the forward's first stage) alone: a
    LiveLayout as live_edge_layout returns it, whose rows past a replica's
    total are unwritten (not -1) on the card.

    A CPU `pos` runs live_edge_layout. A CUDA `pos` ([N, 3] or [R, N, 3]
    float32, with int32 idx and bool build_mask of [.., N, K]) launches the
    layout kernel of csrc/mega_forward.cu or raises."""
    if pos.device.type == "cpu":
        return live_edge_layout(pos, idx, build_mask, box, cutoff)
    fn = "mega_layout"
    if pos.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {pos.device}")
    if pos.ndim not in (2, 3):
        raise ValueError(f"{fn}: pos must be [N, 3] or [R, N, 3], not "
                         f"{tuple(pos.shape)}")
    lead = tuple(pos.shape[:-2])
    n, k = pos.shape[-2], idx.shape[-1]
    dev = pos.device
    _check(fn, "pos", pos, dev, torch.float32, (*lead, n, 3))
    _check(fn, "idx", idx, dev, torch.int32, (*lead, n, k))
    _check(fn, "build_mask", build_mask, dev, torch.bool, (*lead, n, k))
    r = lead[0] if lead else 1
    _check_slots(fn, k)
    cap = layout_capacity(n, k)
    i32 = dict(device=dev, dtype=torch.int32)
    out = LiveLayout(torch.empty((r, cap), **i32),
                     torch.empty((r, n), **i32), torch.empty((r, n), **i32),
                     torch.empty((r,), **i32))
    live = torch.empty((r * n * k,), device=dev, dtype=torch.uint8)
    scratch = _MegaScratch(live.data_ptr(), *[t.data_ptr() for t in out])

    from gamd_tpu_torch.ops.build import load_library
    err = load_library().gamd_mega_layout(
        pos.data_ptr(), idx.data_ptr(), build_mask.data_ptr(), r, n, k,
        *_scalars(box, cutoff, 1.0, 1.0, 1.0)[:2], ctypes.byref(scratch),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(fn, err)
    mega_layout.launches += 1
    return out


mega_layout.launches = 0
