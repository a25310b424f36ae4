"""One conv layer's edge pipeline with the neighbour gathers inside, and its
backward: the host side of gamd_tpu/ops/pallas_mp.py:370-727
(fused_conv_gather_message and its custom VJP) and the wrappers of the two
Hopper kernels csrc/conv_msg_gather.cu (the live-edge tensor-core tiles of
csrc/conv_tc.cuh, ops/edge_tiles.py) and csrc/conv_msg_gather_bwd.cu.

* conv_msg_gather_reference is the plain version of the forward on one
  graph, batched_reference on a batch; the plain backward is autograd
  through them. Their four edge products go through `_edge_mm`, a plain
  fp32 product; ops/mega.py::split_bf16_matmul, the kernel's bf16 x 3
  tensor-core arithmetic, is what a test puts in its place.
* ConvMsgGather is the torch.autograd.Function whose forward and backward
  launch the kernels (CUDA tensors only).
* fused_conv_gather_message is the entry point, in the JAX entry's argument
  order, on [B, N, K, .] batches: a CPU tensor runs the plain version, a
  CUDA tensor launches the kernels or raises. It counts its forward and
  backward launches in `fused_conv_gather_message.launches` and
  `.backward_launches`.
"""

import ctypes

import torch
import torch.nn.functional as F

from gamd_tpu_torch.ops import edge_tiles
from gamd_tpu_torch.ops.mega import KERNEL_WIDTH, _check
from gamd_tpu_torch.ops.mxu_probe import sm_count

#: Edges per block of the CUDA-core edge stages (csrc/tile.cuh KC): the
#: backward's and the op library's.
EDGE_CHUNK = 16
#: Per-edge planes of the backward's scratch (csrc/conv_msg_gather_bwd.cu
#: N_ROWS) and its weight-gradient ranges (N_RANGE).
SCRATCH_PLANES = 8
WGRAD_RANGES = 32


def _edge_mm(a, w):
    """An edge product of the plain version (W1..W4): plain fp32."""
    return a @ w


def conv_msg_gather_reference(e, idx, mask, hn, src_nodes, dst_code,
                              w1, b1, w2, b2, w3, b3, w4, b4):
    """agg [N, D] = sum_k where(mask, hn[idx] * theta(z), 0), with
    z = silu(e @ w1 + b1) @ w2 + b2 + src_nodes[idx] + dst_code[:, None]
    and theta(z) = silu(silu(z) @ w3 + b3) @ w4 + b4 (pallas_mp.py:485-492).
    e [N, K, E], idx [N, K], mask [N, K] bool, hn [N, D], src_nodes and
    dst_code [N, H]."""
    idx = idx.long()
    z = _edge_mm(F.silu(_edge_mm(e, w1) + b1), w2) + b2
    z = z + src_nodes[idx] + dst_code[:, None, :]
    z = _edge_mm(F.silu(_edge_mm(F.silu(z), w3) + b3), w4) + b4
    return torch.sum(torch.where(mask[..., None], hn[idx] * z, 0.0), dim=1)


def batched_reference(e, idx, mask, hn, src_nodes, dst_code, *weights):
    """conv_msg_gather_reference on each graph of a [B, N, K, .] batch:
    the plain version of fused_conv_gather_message."""
    return torch.stack([
        conv_msg_gather_reference(e[i], idx[i], mask[i], hn[i],
                                  src_nodes[i], dst_code[i], *weights)
        for i in range(e.shape[0])])


def declare(lib):
    """Set argtypes/restype of the library's conv entries."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gamd_conv_msg_gather.argtypes = [
        p, p, p, p, p, p,                             # e idx mask hn src dst
        p, p, p, p, p, p, p, p,                       # w1 b1 ... w4 b4
        i, i, ctypes.POINTER(edge_tiles._SlotLayout),  # m k layout
        p, p,                                         # wsplit part
        i, i, i, i,                                   # the plan
        p, p]                                         # agg stream
    lib.gamd_conv_msg_gather.restype = ctypes.c_int
    lib.gamd_conv_msg_gather_bwd.argtypes = [
        p, p, p, p, p, p, p,                          # g e idx mask hn src dst
        p, p, p, p, p, p, p, p,                       # w1 b1 ... w4 b4
        p, p, p, p,                                   # w1t ... w4t
        p, p, i, i,                                   # order offsets m k
        p, p, p, p,                                   # scratch
        p, p, p, p, p, p,                             # ge ghn gsrc gdst gw gb
        p]                                            # stream
    lib.gamd_conv_msg_gather_bwd.restype = ctypes.c_int


def _library():
    from gamd_tpu_torch.ops.build import load_library
    return load_library()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def source_order(idx, mask, m):
    """The live edges grouped by source node, for the backward's segmented
    sums: (order [M*K] int32, offsets [M + 1] int32) such that
    order[offsets[j]:offsets[j+1]] are the flat slot ids i*K + k with
    mask[i, k] set and idx[i, k] = j, ascending; offsets[m] is the number of
    live edges. idx/mask are [M, K] with global node ids. Index bookkeeping
    in torch ops, with no host sync."""
    key = torch.where(mask.reshape(-1), idx.reshape(-1).to(torch.int32), m)
    sorted_key, order = torch.sort(key, stable=True)
    nodes = torch.arange(m + 1, device=idx.device, dtype=torch.int32)
    offsets = torch.searchsorted(sorted_key, nodes, out_int32=True)
    return order.to(torch.int32), offsets


class ConvMsgGather(torch.autograd.Function):
    """The kernel pair on one graph of M nodes: forward
    csrc/conv_msg_gather.cu, backward csrc/conv_msg_gather_bwd.cu. Inputs
    as fused_conv_gather_message's after its checks (e [M, K, E], idx
    [M, K] int32 global ids, mask [M, K] bool, all contiguous on one CUDA
    device); idx and mask get no gradient."""

    @staticmethod
    def forward(ctx, e, idx, mask, hn, src_nodes, dst_code, *weights):
        m, k, _ = e.shape
        dev = e.device
        plan = edge_tiles.launch_plan(m, k, sm_count(dev))
        buf, layout, block_sum, wsplit, part = edge_tiles.call_scratch(
            m, k, plan, dev)
        agg = torch.empty((m, KERNEL_WIDTH), device=dev, dtype=torch.float32)
        err = _library().gamd_conv_msg_gather(
            *_ptrs(e, idx, mask, hn, src_nodes, dst_code, *weights), m, k,
            ctypes.byref(edge_tiles.slot_struct(layout, block_sum)),
            *_ptrs(wsplit, part), *plan[:4], agg.data_ptr(), _stream(dev))
        edge_tiles.raise_on("conv_msg_gather", err)
        fused_conv_gather_message.launches += 1
        ctx.save_for_backward(e, idx, mask, hn, src_nodes, dst_code,
                              *weights)
        return agg

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        e, idx, mask, hn, src_nodes, dst_code, *weights = ctx.saved_tensors
        m, k, _ = e.shape
        dev = e.device
        w = KERNEL_WIDTH
        f32 = dict(device=dev, dtype=torch.float32)
        g = g.contiguous()
        w1, w2, w3, w4 = weights[0::2]
        transposed = [t.t().contiguous() for t in (w1, w2, w3, w4)]
        order, offsets = source_order(idx, mask, m)
        rows = torch.empty((SCRATCH_PLANES, m * k, w), **f32)
        gdstp = torch.empty((m, -(-k // EDGE_CHUNK), w), **f32)
        wpart = torch.empty((4, WGRAD_RANGES, w, w), **f32)
        bpart = torch.empty((4, WGRAD_RANGES, w), **f32)
        ge = torch.empty((m, k, w), **f32)
        ghn, gsrc, gdst = (torch.empty((m, w), **f32) for _ in range(3))
        gw = torch.empty((4, w, w), **f32)
        gb = torch.empty((4, w), **f32)
        err = _library().gamd_conv_msg_gather_bwd(
            *_ptrs(g, e, idx, mask, hn, src_nodes, dst_code, *weights,
                   *transposed, order, offsets),
            m, k, *_ptrs(rows, gdstp, wpart, bpart, ge, ghn, gsrc, gdst, gw,
                         gb), _stream(dev))
        if err != 0:
            raise RuntimeError(f"conv_msg_gather_bwd: CUDA launch failed "
                               f"with cudaError {err}")
        fused_conv_gather_message.backward_launches += 1
        weight_grads = [t for pair in zip(gw, gb) for t in pair]
        return (ge, None, None, ghn, gsrc, gdst, *weight_grads)


def _check_inputs(e, idx, mask, hn, src_nodes, dst_code, weights):
    """The kernels' checks of a [B, N, K, .] batch on a CUDA device: every
    width 128, float32 (idx int32, mask bool), contiguous, one device."""
    fn = "fused_conv_gather_message"
    if e.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {e.device}")
    dev = e.device
    b, n, k = idx.shape
    w = KERNEL_WIDTH
    _check(fn, "e", e, dev, torch.float32, (b, n, k, w))
    _check(fn, "idx", idx, dev, torch.int32, (b, n, k))
    _check(fn, "mask", mask, dev, torch.bool, (b, n, k))
    for name, t in (("hn", hn), ("src_nodes", src_nodes),
                    ("dst_code", dst_code)):
        _check(fn, name, t, dev, torch.float32, (b, n, w))
    names = ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")
    for name, t in zip(names, weights):
        shape = (w,) if name.startswith("b") else (w, w)
        _check(fn, name, t, dev, torch.float32, shape)


def fused_conv_gather_message(e, idx, mask, hn, src_nodes, dst_code,
                              w1, b1, w2, b2, w3, b3, w4, b4):
    """agg [B, N, D] of a batch of graphs (gamd_tpu/ops/pallas_mp.py
    fused_conv_gather_message under the model's vmap).

    Args:
        e: [B, N, K, E] edge embeddings; idx [B, N, K] int32 neighbour ids
           (per graph); mask [B, N, K] bool aggregation mask; hn [B, N, D]
           normalised nodes; src_nodes, dst_code [B, N, H].
        w1 [E, H], b1 [H], w2 [H, H], b2, w3 [H, H], b3, w4 [H, D], b4 [D].

    A CPU `e` runs batched_reference (autograd gives the plain
    backward). A CUDA `e` runs ConvMsgGather on one graph of B*N
    nodes with idx offset by b*N, so weight gradients come summed over the
    batch, as under JAX's vmap; every width must be 128, or it raises.
    """
    weights = (w1, b1, w2, b2, w3, b3, w4, b4)
    if e.device.type == "cpu":
        return batched_reference(e, idx, mask, hn, src_nodes, dst_code,
                                 *weights)
    _check_inputs(e, idx, mask, hn, src_nodes, dst_code, weights)
    b, n, k = idx.shape
    flat_idx = idx.reshape(n, k) if b == 1 else (idx + n * torch.arange(
        b, device=idx.device, dtype=torch.int32)[:, None, None]).reshape(
            b * n, k)
    flat = lambda t: t.reshape(b * n, *t.shape[2:])
    agg = ConvMsgGather.apply(flat(e), flat_idx, flat(mask), flat(hn),
                              flat(src_nodes), flat(dst_code), *weights)
    return agg.reshape(b, n, -1)


fused_conv_gather_message.launches = 0
fused_conv_gather_message.backward_launches = 0
