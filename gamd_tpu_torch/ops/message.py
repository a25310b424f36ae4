"""The rest of the message-passing op library of gamd_tpu/ops/pallas_mp.py
(beside its production pair, ops/conv_gather.py): the plain versions and
the wrappers of four Hopper kernels, under the JAX names.

| port entry (plain version) | JAX, gamd_tpu/ops/pallas_mp.py | CUDA |
|---|---|---|
| pallas_gather_multiply_aggregate (ops/aggregate.py) | :66 (kernel :49) | csrc/gather_agg.cu |
| fused_edge_mlp_aggregate (_fused_reference) | :166 (:158; kernel :104) | csrc/edge_mlp_agg.cu |
| fused_conv_message (_conv_msg_reference) | :317 (:308; kernel :212) | csrc/conv_msg.cu |
| fused_conv_layer (_conv_layer_reference) | :856 (:841; kernel :735) | csrc/conv_layer.cu |

Each entry takes one graph ([N, K, .]) in the JAX entry's argument order,
without tile_n and interpret. A CPU tensor runs the plain version; a CUDA
tensor launches the kernel or raises (check_inputs: float32, idx int32,
mask bool, contiguous, one device, every width 128 but gather_agg's D).
Each entry counts its kernel launches in `.launches`.

* Precision: the plain versions are fp32 throughout, as JAX's references,
  which they transcribe. The kernels of rows 7-8 (conv_msg.cu,
  conv_layer.cu) run the four edge products on the tensor cores as three
  bf16 passes (csrc/conv_tc.cuh; JAX's kernels run them in single-pass
  bf16) and the node update's three in fp32. `_edge_mm` is the plain
  versions' edge product: fp32, unless a test puts
  ops/mega.py::split_bf16_matmul, the kernels' arithmetic, in its place.
  Rows 9-10 are fp32 FMAs.
* A masked slot adds exactly 0, whatever it holds (the references'
  jnp.where; the TPU kernels multiply by the mask and let a NaN through).
  Gathered ids are read as JAX reads them (aggregate.gather_index).
* Gradients: fused_edge_mlp_aggregate, fused_conv_message and
  fused_conv_layer are KernelFunction's, whose backward is autograd
  through the plain version, as JAX's custom_vjp backwards recompute
  through the reference (:189-196, :344-352, :873-880); idx and mask get
  none. pallas_gather_multiply_aggregate has no VJP in JAX and refuses
  inputs that require grad, on either device.
"""

import ctypes

import torch
import torch.nn.functional as F

from gamd_tpu_torch.ops import edge_tiles
from gamd_tpu_torch.ops.aggregate import (gather_index,
                                          gather_multiply_aggregate)
from gamd_tpu_torch.ops.conv_gather import (EDGE_CHUNK, _library, _ptrs,
                                            _stream)
from gamd_tpu_torch.ops.mega import KERNEL_WIDTH, _check
from gamd_tpu_torch.ops.mxu_probe import sm_count

#: The 8 edge-pipeline weights (edge_affine w1..b2, theta_edge w3..b4) and
#: the 6 of the node update (phi_dst, phi_edge, phi), fused_conv_layer's
#: `weights` in order.
CONV_WEIGHTS = ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")
LAYER_WEIGHTS = CONV_WEIGHTS + ("wpd", "bpd", "wpe", "bpe", "wp", "bp")
_PER_SLOT = ("e", "edge_pre", "h_src", "src_code")
_PER_NODE = ("h", "hn", "src_nodes", "dst_code")
#: Atoms a block of conv_layer.cu's node update may take
#: (csrc/node_fused.cuh NODE_MIN_B, NODE_MAX_B), doubling between them.
UPDATE_MIN_ATOMS, UPDATE_MAX_ATOMS = 4, 16


def _edge_mm(a, w):
    """An edge product of the plain conv message (W1..W4): plain fp32."""
    return a @ w


def update_atoms(n, sms=edge_tiles.H100_SMS):
    """Atoms a block of conv_layer.cu's node update takes for N atoms on a
    card of `sms` SMs: the smallest of 4, 8, 16 whose grid of ceil(N / B)
    blocks fits in one wave (a block an SM), else 16. The C entry
    refuses any other."""
    b = UPDATE_MIN_ATOMS
    while b < UPDATE_MAX_ATOMS and -(-n // b) > sms:
        b *= 2
    return b


def _fused_reference(edge_pre, h_src, mask, w1, b1, w2, b2):
    """out[i] = sum_k where(mask, h_src * theta(edge_pre), 0), theta the
    activation-first silu -> Linear -> silu -> Linear (pallas_mp.py:158)."""
    z = F.silu(F.silu(edge_pre) @ w1 + b1)
    m = z @ w2 + b2
    return torch.sum(torch.where(mask[..., None], h_src * m, 0.0), dim=1)


def _conv_msg_reference(e, h_src, src_code, dst_code, mask,
                        w1, b1, w2, b2, w3, b3, w4, b4):
    """The edge pipeline on pre-gathered rows (pallas_mp.py:308):
    z = silu(e @ w1 + b1) @ w2 + b2 + src_code + dst_code[:, None],
    out[i] = sum_k where(mask, h_src * theta(z), 0); the four products
    through `_edge_mm`."""
    z = _edge_mm(F.silu(_edge_mm(e, w1) + b1), w2) + b2
    z = z + src_code + dst_code[:, None, :]
    z = _edge_mm(F.silu(_edge_mm(F.silu(z), w3) + b3), w4) + b4
    return torch.sum(torch.where(mask[..., None], h_src * z, 0.0), dim=1)


def _conv_layer_reference(e, idx, mask, h, hn, src_nodes, dst_code, weights):
    """One EdgeGatedConv layer (pallas_mp.py:841): the edge pipeline with
    hn and src_nodes gathered at idx, then
    h + silu(hn @ wpd + bpd + agg @ wpe + bpe) @ wp + bp. e may be bf16
    (cast to float32 first)."""
    wpd, bpd, wpe, bpe, wp, bp = weights[8:]
    rows = gather_index(idx, hn.shape[0])
    agg = _conv_msg_reference(e.to(torch.float32), hn[rows], src_nodes[rows],
                              dst_code, mask, *weights[:8])
    pre = hn @ wpd + bpd + agg @ wpe + bpe
    return h + F.silu(pre) @ wp + bp


def declare(lib):
    """Set argtypes/restype of the library's op-library entries."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gamd_gather_agg.argtypes = [p, p, p, p, i, i, i, p, p]
    lib.gamd_edge_mlp_agg.argtypes = [p, p, p, p, p, p, p, i, i, p, p, p]
    lay = ctypes.POINTER(edge_tiles._SlotLayout)
    lib.gamd_conv_msg.argtypes = [
        *[p] * 13,                  # e h_src src_code dst mask w1 ... b4
        i, i, lay, p, p,            # n k layout wsplit part
        i, i, i, i,                 # the plan
        p, p]                       # agg stream
    lib.gamd_conv_layer.argtypes = [
        *[p] * 21,                  # e idx mask h hn src dst w1 ... bp
        i, i, lay, p, p,            # n k layout wsplit part
        i, i, i, i,                 # the plan
        p, i, p, p]                 # agg b out stream
    for fn in (lib.gamd_gather_agg, lib.gamd_edge_mlp_agg, lib.gamd_conv_msg,
               lib.gamd_conv_layer):
        fn.restype = ctypes.c_int


def check_inputs(fn, device, width=KERNEL_WIDTH, **tensors):
    """The kernels' checks of one call's named inputs on `device`: raises
    ValueError on the first a kernel does not take. N and K come from mask
    [N, K] (bool); idx is [N, K] int32; per-slot tensors (e, edge_pre,
    h_src, src_code) are [N, K, width] and per-node ones (h, hn, src_nodes,
    dst_code) [N, width], float32; weights w* are [width, width] and biases
    b* [width]. Every tensor contiguous on `device`."""
    mask = tensors["mask"]
    if mask.ndim != 2:
        raise ValueError(f"{fn}: mask must be [N, K]; got "
                         f"{tuple(mask.shape)}")
    n, k = mask.shape
    for name, t in tensors.items():
        dtype = torch.float32
        if name in ("idx", "mask"):
            dtype = torch.int32 if name == "idx" else torch.bool
            shape = (n, k)
        elif name in _PER_SLOT:
            shape = (n, k, width)
        elif name in _PER_NODE:
            shape = (n, width)
        else:
            shape = (width,) if name.startswith("b") else (width, width)
        _check(fn, name, t, device, dtype, shape)


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _chunk_scratch(n, k, device):
    """aggp [N, ceil(K / 16), 128]: edge_mlp_agg's per-chunk partials."""
    return torch.empty((n, -(-k // EDGE_CHUNK), KERNEL_WIDTH), device=device,
                       dtype=torch.float32)


def _launch_gather_agg(h, e, idx, mask):
    n, d = h.shape
    out = torch.empty((n, d), device=h.device, dtype=torch.float32)
    err = _library().gamd_gather_agg(*_ptrs(h, e, idx, mask), n,
                                     idx.shape[1], d, out.data_ptr(),
                                     _stream(h.device))
    _raise_on(err, "gather_agg")
    pallas_gather_multiply_aggregate.launches += 1
    return out


def _launch_edge_mlp_agg(edge_pre, h_src, mask, *weights):
    n, k, _ = edge_pre.shape
    aggp = _chunk_scratch(n, k, edge_pre.device)
    agg = torch.empty((n, KERNEL_WIDTH), device=edge_pre.device,
                      dtype=torch.float32)
    err = _library().gamd_edge_mlp_agg(
        *_ptrs(edge_pre, h_src, mask, *weights), n, k, aggp.data_ptr(),
        agg.data_ptr(), _stream(edge_pre.device))
    _raise_on(err, "edge_mlp_agg")
    fused_edge_mlp_aggregate.launches += 1
    return agg


def _launch_conv_msg(e, h_src, src_code, dst_code, mask, *weights):
    n, k, _ = e.shape
    dev = e.device
    plan = edge_tiles.launch_plan(n, k, sm_count(dev))
    _buf, layout, block_sum, wsplit, part = edge_tiles.call_scratch(
        n, k, plan, dev)
    agg = torch.empty((n, KERNEL_WIDTH), device=dev, dtype=torch.float32)
    err = _library().gamd_conv_msg(
        *_ptrs(e, h_src, src_code, dst_code, mask, *weights), n, k,
        ctypes.byref(edge_tiles.slot_struct(layout, block_sum)),
        *_ptrs(wsplit, part), *plan[:4], agg.data_ptr(), _stream(dev))
    edge_tiles.raise_on("conv_msg", err)
    fused_conv_message.launches += 1
    return agg


def _launch_conv_layer(e, idx, mask, h, hn, src_nodes, dst_code, *weights):
    n, k, _ = e.shape
    dev = e.device
    sms = sm_count(dev)
    plan = edge_tiles.launch_plan(n, k, sms)
    _buf, layout, block_sum, wsplit, part = edge_tiles.call_scratch(
        n, k, plan, dev)
    agg, out = (torch.empty((n, KERNEL_WIDTH), device=dev,
                            dtype=torch.float32) for _ in range(2))
    err = _library().gamd_conv_layer(
        *_ptrs(e, idx, mask, h, hn, src_nodes, dst_code, *weights), n, k,
        ctypes.byref(edge_tiles.slot_struct(layout, block_sum)),
        *_ptrs(wsplit, part), *plan[:4], agg.data_ptr(),
        update_atoms(n, sms), out.data_ptr(), _stream(dev))
    edge_tiles.raise_on("conv_layer", err)
    fused_conv_layer.launches += 1
    return out


def _conv_layer_plain(e, idx, mask, h, hn, src_nodes, dst_code, *weights):
    return _conv_layer_reference(e, idx, mask, h, hn, src_nodes, dst_code,
                                 weights)


class KernelFunction(torch.autograd.Function):
    """A kernel's forward with its plain version's backward:
    apply(launch, plain, *inputs) returns launch(*inputs), and the backward
    gives each input that needs one its gradient by autograd through
    plain(*inputs), recomputed from the saved inputs. idx and mask (not
    floating point) get none."""

    @staticmethod
    def forward(ctx, launch, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return launch(*inputs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[2:])
                  if need]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted)
                      for i, t in enumerate(inputs)]
            grads = torch.autograd.grad(ctx.plain(*leaves),
                                        [leaves[i] for i in wanted], g,
                                        allow_unused=True)
        out = [None] * len(inputs)
        for i, grad in zip(wanted, grads):
            out[i] = grad
        return (None, None, *out)


def pallas_gather_multiply_aggregate(h, e, idx, mask):
    """out[i] = sum_k mask[i,k] * h[idx[i,k]] * e[i,k] (pallas_mp.py:66).

    h [N, D], e [N, K, D], idx [N, K] int32, mask [N, K] bool -> [N, D],
    any D. A CPU `h` runs ops.aggregate.gather_multiply_aggregate; a CUDA
    one launches csrc/gather_agg.cu or raises. No gradient, as in JAX:
    with grad mode on, an input that requires grad raises ValueError (the
    differentiable form is gather_multiply_aggregate)."""
    fn = "pallas_gather_multiply_aggregate"
    if torch.is_grad_enabled() and (h.requires_grad or e.requires_grad):
        raise ValueError(f"{fn} has no gradient (the JAX entry defines no "
                         "VJP); differentiate gather_multiply_aggregate")
    if h.device.type == "cpu":
        return gather_multiply_aggregate(h, e, idx, mask)
    check_inputs(fn, h.device, width=h.shape[-1], h=h, e=e, idx=idx,
                 mask=mask)
    return _launch_gather_agg(h, e, idx, mask)


def fused_edge_mlp_aggregate(edge_pre, h_src, mask, w1, b1, w2, b2):
    """out[i] = sum_k mask[i,k] * h_src[i,k] * theta(edge_pre[i,k])
    (pallas_mp.py:166). edge_pre [N, K, H], h_src [N, K, D], mask [N, K]
    bool, w1 [H, H], b1 [H], w2 [H, D], b2 [D]. A CPU tensor runs
    _fused_reference; a CUDA one csrc/edge_mlp_agg.cu (H = D = 128) or
    raises."""
    args = (edge_pre, h_src, mask, w1, b1, w2, b2)
    if edge_pre.device.type == "cpu":
        return _fused_reference(*args)
    check_inputs("fused_edge_mlp_aggregate", edge_pre.device,
                 edge_pre=edge_pre, h_src=h_src, mask=mask, w1=w1, b1=b1,
                 w2=w2, b2=b2)
    return KernelFunction.apply(_launch_edge_mlp_agg, _fused_reference,
                                *args)


def fused_conv_message(e, h_src, src_code, dst_code, mask,
                       w1, b1, w2, b2, w3, b3, w4, b4):
    """The edge pipeline of one conv layer on pre-gathered rows
    (pallas_mp.py:317). e [N, K, E], h_src [N, K, D], src_code [N, K, H],
    dst_code [N, H], mask [N, K] bool; edge_affine w1..b2, theta_edge
    w3..b4. A CPU tensor runs _conv_msg_reference; a CUDA one
    csrc/conv_msg.cu (every width 128) or raises."""
    weights = (w1, b1, w2, b2, w3, b3, w4, b4)
    args = (e, h_src, src_code, dst_code, mask, *weights)
    if e.device.type == "cpu":
        return _conv_msg_reference(*args)
    check_inputs("fused_conv_message", e.device, e=e, h_src=h_src,
                 src_code=src_code, dst_code=dst_code, mask=mask,
                 **dict(zip(CONV_WEIGHTS, weights)))
    return KernelFunction.apply(_launch_conv_msg, _conv_msg_reference, *args)


def fused_conv_layer(e, idx, mask, h, hn, src_nodes, dst_code, weights):
    """One whole EdgeGatedConv layer: the edge pipeline with the gathers,
    the node update and the residual (pallas_mp.py:856). e [N, K, E]
    float32 or bf16, idx [N, K] int32, mask [N, K] bool, h (residual) and
    hn [N, D], src_nodes and dst_code [N, H]; `weights` the 14-tuple
    LAYER_WEIGHTS. Returns a new [N, D]; h is not touched. A CPU tensor
    runs _conv_layer_reference; a CUDA one casts e to float32 and launches
    csrc/conv_layer.cu (every width 128) or raises."""
    fn = "fused_conv_layer"
    weights = tuple(weights)
    if len(weights) != len(LAYER_WEIGHTS):
        raise ValueError(f"{fn}: weights must be the 14-tuple "
                         f"{LAYER_WEIGHTS}; got {len(weights)}")
    if e.device.type == "cpu":
        return _conv_layer_reference(e, idx, mask, h, hn, src_nodes,
                                     dst_code, weights)
    e = e.to(torch.float32)
    check_inputs(fn, e.device, e=e, idx=idx, mask=mask, h=h, hn=hn,
                 src_nodes=src_nodes, dst_code=dst_code,
                 **dict(zip(LAYER_WEIGHTS, weights)))
    return KernelFunction.apply(_launch_conv_layer, _conv_layer_plain, e,
                                idx, mask, h, hn, src_nodes, dst_code,
                                *weights)


pallas_gather_multiply_aggregate.launches = 0
fused_edge_mlp_aggregate.launches = 0
fused_conv_message.launches = 0
fused_conv_layer.launches = 0
