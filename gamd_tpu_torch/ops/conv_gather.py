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
  CUDA tensor launches the kernels or raises. The kernels take e's width E
  equal to the message's D, 128 or 256, and the hidden H 128
  (check_widths): width 128 everywhere, and the DFT model's 256 / 128 /
  256, whose weights the split table holds as six 128 x 128 blocks
  (split_blocks). It counts its forward and
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

#: The bytes of a tile of one of the backward's compact planes (64 rows of
#: 128 bf16 hi and lo) and the tile ranges of its weight-gradient sums
#: (csrc/conv_msg_gather_bwd.cu N_RANGE).
PLANE_BYTES = edge_tiles.ACTIVATION_BYTES
WGRAD_RANGES = 32
#: The widths the kernels take: e's (E) equal to the message's (D), one of
#: WIDE_WIDTHS, and the hidden (H) 128.
WIDE_WIDTHS = (KERNEL_WIDTH, 2 * KERNEL_WIDTH)


def split_blocks(e_width=KERNEL_WIDTH, d_width=KERNEL_WIDTH):
    """The 128 x 128 weight blocks of the kernels' split table at e width E
    and message width D (csrc/conv_tc.cuh::split_blocks): W1's E/128 row
    blocks, W2, W3 and W4's D/128 column blocks; 4 at width 128, 6 at the
    DFT model's 256 / 128 / 256."""
    return e_width // KERNEL_WIDTH + 2 + d_width // KERNEL_WIDTH


def bwd_planes(e_width=KERNEL_WIDTH, d_width=KERNEL_WIDTH):
    """The backward's compact planes, a tile each: e's E/128 column blocks,
    z1, a2, z3, then g_s1, g_z2, g_s3 and g_m's D/128 column blocks
    (csrc/conv_msg_gather_bwd.cu); 8 at width 128, 10 at 256 / 128 /
    256."""
    return e_width // KERNEL_WIDTH + d_width // KERNEL_WIDTH + 6


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
    mask [M, K] bool, the rest as the forward's; any widths): the live
    edges in the layout's order (live_slot_layout: atom-major, slot order
    within an atom), their forward recomputed and swept back
    (pallas_mp.py:588-621) with the twelve products through `_edge_mm`; ge
    0 at the masked slots; gdst, ghn and gsrc summed over the live edges in
    that order; each weight's gradient and bias sum over the tiles of each
    of wgrad_ranges' ranges, the partials added in range order. Returns
    (ge, ghn, gsrc, gdst, gw1, gb1, gw2, gb2, gw3, gb3, gw4, gb4)."""
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
    zeros = lambda *shape: torch.zeros(shape, dtype=e.dtype, device=e.device)
    gdst = zeros(m, g_z2.shape[1]).index_add_(0, i, g_z2)
    ghn = zeros(m, g.shape[1]).index_add_(0, j, g[i] * msg)
    gsrc = zeros(m, g_z2.shape[1]).index_add_(0, j, g_z2)
    grads = []
    for act, grad in ((x, g_s1), (z1, g_z2), (a2, g_s3), (z3, g_m)):
        gw = zeros(act.shape[1], grad.shape[1])
        gb = zeros(grad.shape[1])
        for first, end in wgrad_ranges(total):
            rows = slice(first * TILE_ROWS, min(end * TILE_ROWS, total))
            gw = gw + _edge_mm(act[rows].t(), grad[rows])
            gb = gb + grad[rows].sum(0)
        grads += [gw, gb]
    return (ge.reshape(m, k, w), ghn, gsrc, gdst, *grads)


def backward_scratch(m, k, plan, device, e_width=KERNEL_WIDTH,
                     d_width=KERNEL_WIDTH):
    """The backward call's scratch in edge_tiles.one_buffer at e width E
    and message width D: the compact planes [bwd_planes, plan.tiles,
    PLANE_BYTES] uint8 (the live tiles written), g_hsrc [M*K, D] then g_z2
    [M*K, 128] at every slot as rows [(D + 128) / 128, M*K, 128] float32
    (the live slots written; [2, M*K, 128] at width 128), and the
    weight-gradient and bias partials [split_blocks, WGRAD_RANGES, 128,
    128] and [split_blocks, WGRAD_RANGES, 128] float32. Returns (planes,
    rows, wpart, bpart), which keep the buffer alive."""
    w, f32 = KERNEL_WIDTH, torch.float32
    blocks = split_blocks(e_width, d_width)
    _, v = edge_tiles.one_buffer({
        "planes": ((bwd_planes(e_width, d_width), plan.tiles, PLANE_BYTES),
                   torch.uint8),
        "rows": (((d_width + w) // w, m * k, w), f32),
        "wpart": ((blocks, WGRAD_RANGES, w, w), f32),
        "bpart": ((blocks, WGRAD_RANGES, w), f32)}, device)
    return v["planes"], v["rows"], v["wpart"], v["bpart"]


def declare(lib):
    """Set argtypes/restype of the library's conv entries."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gamd_conv_msg_gather.argtypes = [
        p, p, p, p, p, p,                             # e idx mask hn src dst
        p, p, p, p, p, p, p, p,                       # w1 b1 ... w4 b4
        i, i, i, i,                                   # m k E D
        ctypes.POINTER(edge_tiles._SlotLayout),       # layout
        p, p,                                         # wsplit part
        i, i, i, i,                                   # the plan
        p, p]                                         # agg stream
    lib.gamd_conv_msg_gather.restype = ctypes.c_int
    lib.gamd_conv_msg_gather_bwd.argtypes = [
        p, p, p, p, p, p, p,                          # g e idx mask hn src dst
        p, p, p, p,                                   # b1 ... b4
        i, i, i, i,                                   # m k E D
        ctypes.POINTER(edge_tiles._SlotLayout),       # layout
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
    [M, K] int32 global ids, mask [M, K] bool, hn [M, D], all contiguous on
    one CUDA device; E = D, 128 or 256, H 128); idx and mask get no
    gradient."""

    @staticmethod
    def forward(ctx, e, idx, mask, hn, src_nodes, dst_code, *weights):
        m, k, e_w = e.shape
        d_w = hn.shape[1]
        dev = e.device
        plan = edge_tiles.launch_plan(m, k, sm_count(dev))
        buf, layout, block_sum, wsplit, part = edge_tiles.call_scratch(
            m, k, plan, dev, n_weights=split_blocks(e_w, d_w), width=d_w)
        agg = torch.empty((m, d_w), device=dev, dtype=torch.float32)
        err = _library().gamd_conv_msg_gather(
            *_ptrs(e, idx, mask, hn, src_nodes, dst_code, *weights), m, k,
            e_w, d_w, ctypes.byref(edge_tiles.slot_struct(layout, block_sum)),
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
        m, k, e_w = e.shape
        d_w = hn.shape[1]
        dev = e.device
        w = KERNEL_WIDTH
        f32 = dict(device=dev, dtype=torch.float32)
        g = g.contiguous()
        plan = edge_tiles.backward_plan(m, k, sm_count(dev))
        order, keys = source_order(idx, mask, m)
        planes, rows, wpart, bpart = backward_scratch(m, k, plan, dev, e_w,
                                                      d_w)
        ge = torch.empty((m, k, e_w), **f32)
        ghn = torch.empty((m, d_w), **f32)
        gsrc, gdst = (torch.empty((m, w), **f32) for _ in range(2))
        blocks = split_blocks(e_w, d_w)
        gw = torch.empty((blocks, w, w), **f32)
        gb = torch.empty((blocks, w), **f32)
        err = _library().gamd_conv_msg_gather_bwd(
            *_ptrs(g, e, idx, mask, hn, src_nodes, dst_code, *weights[1::2]),
            m, k, e_w, d_w, ctypes.byref(edge_tiles.slot_struct(layout)),
            *_ptrs(wsplit, part, order, keys), keys.element_size(),
            *_ptrs(planes, rows, wpart, bpart),
            plan.grid, plan.threads, plan.smem,
            *_ptrs(ge, ghn, gsrc, gdst, gw, gb), _stream(dev))
        edge_tiles.raise_on("conv_msg_gather_bwd", err)
        fused_conv_gather_message.backward_launches += 1
        return (ge, None, None, ghn, gsrc, gdst,
                *weight_grads(gw, gb, e_w // w))


def weight_grads(gw, gb, e_blocks):
    """(gw1, gb1, gw2, gb2, gw3, gb3, gw4, gb4) from the backward's
    gradients of the split table's blocks, gw [blocks, 128, 128] and gb
    [blocks, 128] (split_blocks' order): gw1 W1's row blocks stacked, gw4
    W4's column blocks side by side; W1's blocks share one bias sum, b1's,
    and W4's are b4's column blocks."""
    eb = e_blocks
    return (gw[:eb].reshape(-1, gw.shape[2]), gb[0], gw[eb], gb[eb],
            gw[eb + 1], gb[eb + 1], torch.cat(tuple(gw[eb + 2:]), dim=1),
            gb[eb + 2:].reshape(-1))


def check_widths(w1, w4):
    """(E, H, D) of the edge weights w1 [E, H] and w4 [H, D]; ValueError,
    naming the widths the kernels take, unless E = D, 128 or 256, and H is
    128 (JAX's kernel reads any width from its refs: the others are a gap
    of the port, ROADMAP)."""
    fn = "fused_conv_gather_message"
    if w1.ndim != 2 or w4.ndim != 2 or w1.shape[1] != w4.shape[0]:
        raise ValueError(f"{fn}: w1 [E, H] and w4 [H, D] expected, got "
                         f"{tuple(w1.shape)} and {tuple(w4.shape)}")
    (e_w, h_w), d_w = w1.shape, w4.shape[1]
    if e_w != d_w or d_w not in WIDE_WIDTHS or h_w != KERNEL_WIDTH:
        raise ValueError(
            f"{fn}: widths E={e_w}, H={h_w}, D={d_w}: the kernels take E "
            f"= D in {WIDE_WIDTHS} and H = {KERNEL_WIDTH}")
    return e_w, h_w, d_w


def _check_inputs(e, idx, mask, hn, src_nodes, dst_code, weights):
    """The kernels' checks of a [B, N, K, .] batch on a CUDA device: the
    widths (check_widths, from w1 and w4), float32 (idx int32, mask bool),
    contiguous, one device."""
    fn = "fused_conv_gather_message"
    if e.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {e.device}")
    e_w, h_w, d_w = check_widths(weights[0], weights[6])
    dev = e.device
    b, n, k = idx.shape
    _check(fn, "e", e, dev, torch.float32, (b, n, k, e_w))
    _check(fn, "idx", idx, dev, torch.int32, (b, n, k))
    _check(fn, "mask", mask, dev, torch.bool, (b, n, k))
    for name, t, width in (("hn", hn, d_w), ("src_nodes", src_nodes, h_w),
                           ("dst_code", dst_code, h_w)):
        _check(fn, name, t, dev, torch.float32, (b, n, width))
    names = ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")
    shapes = ((e_w, h_w), (h_w,), (h_w, h_w), (h_w,), (h_w, h_w), (h_w,),
              (h_w, d_w), (d_w,))
    for name, t, shape in zip(names, weights, shapes):
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
    backward) at any widths. A CUDA `e` runs ConvMsgGather on one graph of
    B*N nodes with idx offset by b*N, so weight gradients come summed over
    the batch, as under JAX's vmap; E = D must be 128 or 256 and H 128
    (the DFT model's 256 / 128 / 256 among them), or it raises
    ValueError before any launch.
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
