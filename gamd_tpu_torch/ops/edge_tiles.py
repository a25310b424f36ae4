"""The live-edge tiles of the conv message on the tensor cores
(csrc/conv_tc.cuh, the kernels behind ops/conv_gather.py's
fused_conv_gather_message and ops/banded.py's banded_conv_message): the
layout of the live slots from the aggregation mask, the tile kernel's
launch plan, and the scratch.

* mask_layout(mask): the layout kernels of csrc/conv_tc.cuh on a CUDA mask
  (counted in `mask_layout.launches`), ops/mega.py::live_slot_layout on a
  CPU one. A mask [..., K] is one graph of M atoms (a batch of B graphs of
  N atoms is M = B*N): a LiveLayout of one replica.
* Plan / launch_plan / check_plan: the tile kernel's launch, computed here
  and refused by the C entries (csrc/conv_tc.cuh::plan_ok) when
  inconsistent; plan_tiles lists the tiles each block takes.
  backward_plan: the backward's tile kernel (csrc/conv_msg_gather_bwd.cu),
  one block an SM.
* one_buffer / call_scratch: a call's scratch in one allocation.
"""

import ctypes
import math
from typing import NamedTuple

import torch

from gamd_tpu_torch.ops.mega import (KERNEL_WIDTH, TILE_ROWS, LiveLayout,
                                     _check, layout_capacity,
                                     live_slot_layout)

#: SMs of an H100 SXM, the card the plans are checked against on the CPU.
H100_SMS = 132
#: Threads of a tile block: two warpgroups.
TILE_THREADS = 256
#: Atoms a block of the layout's count kernel takes, a warp each
#: (csrc/conv_tc.cuh COUNT_ATOMS): the per-block sums are ceil(M / 8).
COUNT_ATOMS = 8
#: Bytes of one split weight (hi and lo bf16, 128 x 128 each) and of the
#: tile's activations (64 rows of 128, hi and lo bf16): csrc/edge_tc.cuh.
SPLIT_BYTES = 2 * 2 * KERNEL_WIDTH * KERNEL_WIDTH
ACTIVATION_BYTES = 2 * 2 * TILE_ROWS * KERNEL_WIDTH
#: Shared memory a block may take on Hopper.
MAX_SMEM = 232448
#: The weights of the edge stage (W1..W4).
N_WEIGHTS = 4
#: Dynamic shared memory of the backward's tile block: two weight buffers,
#: the activations and the fp32 tile of g_z2 (csrc/conv_msg_gather_bwd.cu
#: BWD_SMEM), so one block an SM.
BACKWARD_SMEM = 2 * SPLIT_BYTES + 2 * ACTIVATION_BYTES + 1024
#: Tiles (of the capacity, ceil(M*K / 64)) up to which a block keeps two
#: weight buffers (a block an SM); past it one, so that two blocks share an
#: SM and hide each other's waits.
TWO_BUFFER_TILES = 4 * H100_SMS


class Plan(NamedTuple):
    """A launch of conv_tile_kernel: `grid` persistent blocks of `threads`
    threads with `smem` bytes of dynamic shared memory and `nbuf` weight
    buffers, over at most `tiles` tiles of 64 live edges (the layout's
    capacity; the live ones are counted on the card)."""
    grid: int
    threads: int
    smem: int
    nbuf: int
    tiles: int


def tile_smem(nbuf):
    """Dynamic shared memory of a tile block with `nbuf` weight buffers:
    the buffers, the activations and 1,024 bytes to align them
    (csrc/edge_tc.cuh::smem_bytes)."""
    return nbuf * SPLIT_BYTES + ACTIVATION_BYTES + 1024


def launch_plan(m, k, sms=H100_SMS):
    """The tile kernel's launch for M atoms of K slots on a card of `sms`
    SMs: two weight buffers (a block an SM) up to TWO_BUFFER_TILES tiles of
    capacity, one (two blocks an SM) past it; a persistent grid of the
    least of the tiles and the blocks the card holds at once."""
    tiles = -(-m * k // TILE_ROWS)
    nbuf = 2 if tiles <= TWO_BUFFER_TILES else 1
    return Plan(min(tiles, (3 - nbuf) * sms), TILE_THREADS, tile_smem(nbuf),
                nbuf, tiles)


def check_plan(plan, m, k, sms=H100_SMS):
    """Raises ValueError unless `plan` is one the C entries take for this
    shape: 256 threads, one or two weight buffers with their shared memory,
    the layout's capacity in tiles, and a grid of 1 to the least of the
    tiles and the blocks the card holds at once."""
    tiles = -(-m * k // TILE_ROWS)
    ok = (plan.threads == TILE_THREADS and plan.nbuf in (1, 2)
          and plan.smem == tile_smem(plan.nbuf) <= MAX_SMEM
          and plan.tiles == tiles
          and 1 <= plan.grid <= min(tiles, (3 - plan.nbuf) * sms))
    if not ok:
        raise ValueError(f"conv tiles: inconsistent plan {plan} for M={m}, "
                         f"K={k} on {sms} SMs (launch_plan gives "
                         f"{launch_plan(m, k, sms)})")


def backward_plan(m, k, sms=H100_SMS):
    """The backward tile kernel's launch for M atoms of K slots on a card
    of `sms` SMs: two weight buffers and BACKWARD_SMEM, a persistent grid
    of the least of the capacity's tiles and the SMs (the C entry refuses
    any other)."""
    tiles = -(-m * k // TILE_ROWS)
    return Plan(min(tiles, sms), TILE_THREADS, BACKWARD_SMEM, 2, tiles)


def plan_tiles(plan, total):
    """[(block, first row, rows)] of the tiles a launch computes for
    `total` live edges: block b takes tiles b, b + grid, ...; the last
    tile short."""
    n_tiles = -(-total // TILE_ROWS)
    return [(b, t * TILE_ROWS, min(TILE_ROWS, total - t * TILE_ROWS))
            for b in range(plan.grid) for t in range(b, n_tiles, plan.grid)]


class _SlotLayout(ctypes.Structure):
    """Mirror of the C struct SlotLayout (csrc/conv_tc.cuh)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "slot", "off", "cnt", "total", "block_sum")]


def declare(lib):
    """Set argtypes/restype of the library's layout entry."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gamd_mask_layout.argtypes = [p, i, i, ctypes.POINTER(_SlotLayout),
                                     p]
    lib.gamd_mask_layout.restype = ctypes.c_int


def slot_struct(layout: LiveLayout, block_sum=None):
    """The C SlotLayout over a LiveLayout of one replica (and the layout
    kernels' per-block scratch, which the tile kernels do not read)."""
    return _SlotLayout(*[t.data_ptr() for t in layout],
                       0 if block_sum is None else block_sum.data_ptr())


def one_buffer(specs, device):
    """Views of one torch.empty for specs {name: (shape, dtype)}, in order,
    each 256-byte aligned: (buffer, {name: view}). The kernels allocate
    nothing; the buffer must outlive the call."""
    nbytes = {name: math.prod(shape) * dtype.itemsize
              for name, (shape, dtype) in specs.items()}
    offsets, total = {}, 0
    for name, size in nbytes.items():
        offsets[name] = total
        total += -(-size // 256) * 256
    buf = torch.empty((total,), device=device, dtype=torch.uint8)
    return buf, {name: buf[offsets[name]:offsets[name] + nbytes[name]]
                 .view(dtype).view(shape)
                 for name, (shape, dtype) in specs.items()}


def call_scratch(m, k, plan, device, layout=True, n_weights=N_WEIGHTS,
                 width=KERNEL_WIDTH):
    """A call's scratch in one_buffer: with `layout`, the live-edge layout
    (slot [1, cap], offset and count [1, M], total [1]) and the layout
    kernels' per-block sums; `n_weights` split 128 x 128 weight blocks
    (bf16 hi and lo: the conv message's four, six at the DFT widths,
    ops/conv_gather.py::split_blocks; theta_edge's two); each tile's head
    and tail partials [tiles, 2, width] fp32 (width the message's, 128 or
    256). Returns (buffer, LiveLayout or None, block sums or None, split
    weights, partials)."""
    i32 = torch.int32
    specs = {"wsplit": ((n_weights * SPLIT_BYTES,), torch.uint8),
             "part": ((plan.tiles, 2, width), torch.float32)}
    if layout:
        specs.update(slot=((1, layout_capacity(m, k)), i32),
                     offset=((1, m), i32), count=((1, m), i32),
                     total=((1,), i32),
                     block_sum=((-(-m // COUNT_ATOMS),), i32))
    buf, v = one_buffer(specs, device)
    if not layout:
        return buf, None, None, v["wsplit"], v["part"]
    lay = LiveLayout(v["slot"], v["offset"], v["count"], v["total"])
    return buf, lay, v["block_sum"], v["wsplit"], v["part"]


def raise_on(fn, err):
    """The C entries' return: 0, a cudaError_t, or 100000 + a CUresult."""
    if err >= 100000:
        raise RuntimeError(f"{fn}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {err - 100000}")
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")


def mask_layout(mask):
    """The live-edge layout of a bool mask [..., K], whose leading axes are
    one graph of M atoms: a LiveLayout of one replica (slot [1, cap],
    offset and count [1, M], total [1]), whose rows past total are -1 on
    the CPU and unwritten on the card.

    A CPU mask runs live_slot_layout; a CUDA mask (contiguous) launches the
    layout kernels of csrc/conv_tc.cuh or raises."""
    k = mask.shape[-1]
    if mask.device.type == "cpu":
        return live_slot_layout(mask.reshape(-1, k))
    fn = "mask_layout"
    if mask.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {mask.device}")
    m = mask.numel() // k
    _check(fn, "mask", mask, mask.device, torch.bool, tuple(mask.shape))
    i32 = dict(device=mask.device, dtype=torch.int32)
    layout = LiveLayout(torch.empty((1, layout_capacity(m, k)), **i32),
                        torch.empty((1, m), **i32),
                        torch.empty((1, m), **i32), torch.empty((1,), **i32))
    block_sum = torch.empty((-(-m // COUNT_ATOMS),), **i32)

    from gamd_tpu_torch.ops.build import load_library
    err = load_library().gamd_mask_layout(
        mask.data_ptr(), m, k, ctypes.byref(slot_struct(layout, block_sum)),
        torch.cuda.current_stream(mask.device).cuda_stream)
    raise_on(fn, err)
    mask_layout.launches += 1
    return layout


mask_layout.launches = 0
