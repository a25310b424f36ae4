"""One conv layer's edge pipeline with the neighbour gathers inside, and its
backward: the host side of gamd_tpu/ops/pallas_mp.py:370-727
(fused_conv_gather_message and its custom VJP) and the wrappers of the two
Hopper kernels csrc/conv_msg_gather.cu and csrc/conv_msg_gather_bwd.cu
(both on the live-edge tensor-core tiles of csrc/conv_tc.cuh,
ops/edge_tiles.py).

* conv_msg_gather_reference is the plain version of the forward on one
  graph, batched_reference on a batch; the plain backward is autograd
  through them. Their four edge products go through `_edge_mm`, a plain
  fp32 product; ops/mega.py::split_bf16_matmul, the kernel's bf16 x 3
  tensor-core arithmetic, is what a test puts in its place.
* conv_msg_gather_backward_reference is the backward as the kernels
  compute it (a reverse sweep over the live edges, the weight gradients
  summed over wgrad_ranges' tile ranges in order), its twelve products
  through `_edge_mm` too. The tests hold it against autograd and JAX.
* ConvMsgGather is the torch.autograd.Function whose forward and backward
  launch the kernels (CUDA tensors only); the backward takes the forward's
  live-edge layout and split weights over.
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
from gamd_tpu_torch.ops.mega import (KERNEL_WIDTH, TILE_ROWS, _check,
                                     live_slot_layout)
from gamd_tpu_torch.ops.mxu_probe import sm_count

#: The backward's compact planes, a tile each (e, z1, a2, z3, then g_s1,
#: g_z2, g_s3, g_m; csrc/conv_msg_gather_bwd.cu N_PLANES), the bytes of a
#: tile of one (64 rows of 128 bf16 hi and lo), and the tile ranges of its
#: weight-gradient sums (N_RANGE).
BWD_PLANES = 8
PLANE_BYTES = edge_tiles.ACTIVATION_BYTES
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


def _dsilu(x):
    """d/dx silu(x) = sigmoid(x) (1 + x (1 - sigmoid(x)))."""
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def wgrad_ranges(total):
    """[(first tile, end tile)] of the WGRAD_RANGES ranges of the
    weight-gradient sums over the ceil(total / 64) tiles of `total` live
    edges: ceil(tiles / WGRAD_RANGES) tiles each, in order, the last ones
    short or empty (csrc/conv_msg_gather_bwd.cu wgrad_tc_kernel)."""
    tiles = -(-total // TILE_ROWS)
    per = -(-tiles // WGRAD_RANGES)
    return [(min(q * per, tiles), min(q * per + per, tiles))
            for q in range(WGRAD_RANGES)]


def conv_msg_gather_backward_reference(g, e, idx, mask, hn, src_nodes,
                                       dst_code, w1, b1, w2, b2, w3, b3, w4,
                                       b4):
    """The backward of conv_msg_gather_reference as the kernels compute it,
    on one graph of M nodes (g [M, D], e [M, K, E], idx [M, K] node ids,
    mask [M, K] bool, the rest as the forward's): the live edges in the
    layout's order (live_slot_layout: atom-major, slot order within an
    atom), their forward recomputed and swept back (pallas_mp.py:588-621)
    with the twelve products through `_edge_mm`; ge 0 at the masked slots;
    gdst, ghn and gsrc summed over the live edges in that order; each
    weight's gradient and bias sum over the tiles of each of wgrad_ranges'
    ranges, the partials added in range order. Returns (ge, ghn, gsrc,
    gdst, gw1, gb1, gw2, gb2, gw3, gb3, gw4, gb4)."""
    m, k, w = e.shape
    lay = live_slot_layout(mask.reshape(m, k).cpu())
    total = int(lay.total[0])
    slots = lay.slot[0, :total].long().to(e.device)
    i, j = slots // k, idx.reshape(-1).long()[slots]
    x = e.reshape(m * k, w)[slots]
    s1 = _edge_mm(x, w1) + b1
    z1 = F.silu(s1)
    z2 = _edge_mm(z1, w2) + b2 + src_nodes[j] + dst_code[i]
    a2 = F.silu(z2)
    s3 = _edge_mm(a2, w3) + b3
    z3 = F.silu(s3)
    msg = _edge_mm(z3, w4) + b4
    g_m = g[i] * hn[j]
    g_s3 = _edge_mm(g_m, w4.t()) * _dsilu(s3)
    g_z2 = _edge_mm(g_s3, w3.t()) * _dsilu(z2)
    g_s1 = _edge_mm(g_z2, w2.t()) * _dsilu(s1)
    ge = torch.zeros((m * k, w), dtype=e.dtype, device=e.device)
    ge[slots] = _edge_mm(g_s1, w1.t())
    zeros = lambda: torch.zeros((m, w), dtype=e.dtype, device=e.device)
    gdst = zeros().index_add_(0, i, g_z2)
    ghn = zeros().index_add_(0, j, g[i] * msg)
    gsrc = zeros().index_add_(0, j, g_z2)
    grads = []
    for act, grad in ((x, g_s1), (z1, g_z2), (a2, g_s3), (z3, g_m)):
        gw = torch.zeros((w, w), dtype=e.dtype, device=e.device)
        gb = torch.zeros((w,), dtype=e.dtype, device=e.device)
        for first, end in wgrad_ranges(total):
            rows = slice(first * TILE_ROWS, min(end * TILE_ROWS, total))
            gw = gw + _edge_mm(act[rows].t(), grad[rows])
            gb = gb + grad[rows].sum(0)
        grads += [gw, gb]
    return (ge.reshape(m, k, w), ghn, gsrc, gdst, *grads)


def backward_scratch(m, k, plan, device):
    """The backward call's scratch in edge_tiles.one_buffer: the compact
    planes [BWD_PLANES, plan.tiles, PLANE_BYTES] uint8 (the live tiles
    written), g_hsrc and g_z2 at every slot [2, M*K, 128] float32 (the live
    slots written), and the weight-gradient and bias partials [4,
    WGRAD_RANGES, 128, 128] and [4, WGRAD_RANGES, 128] float32. Returns
    (planes, rows, wpart, bpart), which keep the buffer alive."""
    w, f32 = KERNEL_WIDTH, torch.float32
    _, v = edge_tiles.one_buffer({
        "planes": ((BWD_PLANES, plan.tiles, PLANE_BYTES), torch.uint8),
        "rows": ((2, m * k, w), f32),
        "wpart": ((4, WGRAD_RANGES, w, w), f32),
        "bpart": ((4, WGRAD_RANGES, w), f32)}, device)
    return v["planes"], v["rows"], v["wpart"], v["bpart"]


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
        p, p, p, p,                                   # b1 ... b4
        i, i, ctypes.POINTER(edge_tiles._SlotLayout),  # m k layout
        p, p, p, p, i,                                # wsplit part order keys
        p, p, p, p,                                   # planes rows wpart bpart
        i, i, i,                                      # the plan
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
    sums: (order [M*K] int64, keys [M*K]) with keys the source of each slot
    (m for a masked one) stably sorted and order the flat slot ids i*K + k
    in that order, so that the live slots with idx = j are order[q] for the
    q with keys[q] = j, ascending; the masked ones come last. keys are
    int16 where m < 2^15 - 1 (half the radix sort's passes of int32), else
    int32. idx/mask are [M, K] with global node ids. Index bookkeeping in
    torch ops, with no host sync; the kernel finds each node's run in keys
    by binary search."""
    dtype = torch.int16 if m < 2 ** 15 - 1 else torch.int32
    key = torch.where(mask.reshape(-1), idx.reshape(-1).to(dtype), m)
    keys, order = torch.sort(key, stable=True)
    return order, keys


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
        # The backward reads the layout and the split weights as this call
        # left them (the saved weights cannot change in place unnoticed)
        # and reuses the partials buffer.
        ctx.scratch = (layout, wsplit, part)
        return agg

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        e, idx, mask, hn, src_nodes, dst_code, *weights = ctx.saved_tensors
        layout, wsplit, part = ctx.scratch
        m, k, _ = e.shape
        dev = e.device
        w = KERNEL_WIDTH
        f32 = dict(device=dev, dtype=torch.float32)
        g = g.contiguous()
        plan = edge_tiles.backward_plan(m, k, sm_count(dev))
        order, keys = source_order(idx, mask, m)
        planes, rows, wpart, bpart = backward_scratch(m, k, plan, dev)
        ge = torch.empty((m, k, w), **f32)
        ghn, gsrc, gdst = (torch.empty((m, w), **f32) for _ in range(3))
        gw = torch.empty((4, w, w), **f32)
        gb = torch.empty((4, w), **f32)
        err = _library().gamd_conv_msg_gather_bwd(
            *_ptrs(g, e, idx, mask, hn, src_nodes, dst_code, *weights[1::2]),
            m, k, ctypes.byref(edge_tiles.slot_struct(layout)),
            *_ptrs(wsplit, part, order, keys), keys.element_size(),
            *_ptrs(planes, rows, wpart, bpart),
            plan.grid, plan.threads, plan.smem,
            *_ptrs(ge, ghn, gsrc, gdst, gw, gb), _stream(dev))
        edge_tiles.raise_on("conv_msg_gather_bwd", err)
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
