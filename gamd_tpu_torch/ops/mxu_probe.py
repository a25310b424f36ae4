"""The tensor-core probe's loop: the plain versions of the five stage
bodies of scripts/bench_mxu.py and the wrapper of their Hopper kernel,
csrc/mxu_probe.cu.

Each body is one stage of the megakernel's forward at the LJ-258 shapes,
run `iters` times with the accumulator carried from iteration to
iteration and returned after the loop (bench_mxu.py::loop_kernel):

* "peak" (peak_body, bench_mxu.py:150): a, w [512, 512] bf16; four chained
  bf16 products with fp32 accumulation, each rounded to bf16, then
  acc * 0.5 + x;
* "gather_mm" (gmm_body :185): a prebuilt bf16 one-hot [rows, n_pad] times
  the hi and lo node tables nh, nl [n_pad, 128] bf16;
* "gather_full" (gfull_body :215): the one-hot built from idx [rows, 1]
  int32, the two gathers, and the hi/lo source affine with ws [128, 128]
  fp32 split into bf16 hi and lo;
* "edge_mlp" (emlp_body :247): e [rows, 128] bf16 through four products
  with bf16(w), w [128, 128] fp32, and silu;
* "repeat" (rep_body :264): dst [tile_n, 128] fp32 broadcast k times along
  the rows.

Every body reads the carry through a keep-alive term scaled by 1e-30 and
the salt [8, 128] fp32 (salt[0, 0]), as JAX's: numerically void, it keeps
each iteration dependent on the last. The plain versions read JAX's global
acc[0:1, :] (acc[0, 0]); the kernel's blocks each read their own tile's
first row, except repeat's threads, which each carry the global row 0 of
their column (its recurrence needs nothing but itself and dst[0]). They
agree because the term rounds away. repeat_chain runs that row-0
recurrence alone on one thread, so that its dependent sequence (a
multiply and three adds an iteration, repeat's bound) can be timed on the
card.

The plain versions compute each bf16 product as a float32 matmul of
bf16-valued tensors (exact products, float32 sums; TF32 off on the card)
and round to bf16 where JAX's .astype(bf16) rounds. mxu_loop is the entry:
a CPU tensor runs the plain version; a CUDA tensor makes one launch of
loop_kernel<Body> or raises, counted in mxu_loop.launches[body].

The kernel's launch plan (launch_plan: CTAs, cluster size, rows and
columns a CTA, threads, shared bytes) is computed here from the body's
split (SPLIT) and passed to the C entry, which recomputes it and refuses
one that differs; check_plan is the same check in Python. plan_tiles
lists the output tile each CTA writes.
"""

import contextlib
import ctypes
import math
from typing import NamedTuple

import torch

from gamd_tpu_torch.ops.mega import _check

#: Bodies, by their code in the C entry.
BODIES = {"peak": 0, "gather_mm": 1, "gather_full": 2, "edge_mlp": 3,
          "repeat": 4}
ROW_TILE = 32    # rows of the kernel's row tile: rows must be a multiple
PEAK_N = 512     # the peak chain's [512, 512]
WIDTH = 128      # every other stage's width
KEEP = 1e-30     # the keep-alive scale
PAD = 8          # bf16 elements of row padding in shared memory
MAX_SMEM = 232448        # a block's shared memory on Hopper
MAX_THREADS = {"peak": 128, "gather_mm": 1024, "gather_full": 512,
               "edge_mlp": 512, "repeat": 64}
#: Each body's split (csrc/mxu_probe.cu's SPLIT): CTAs a cluster, columns
#: a CTA, rows a CTA. peak: 64-row wgmma tiles; gather_mm's and repeat's
#: rows a CTA (None) follow from the SM count (repeat: 2 PER, a thread's
#: PER rows of one column lying in one dst row).
SPLIT = {"peak": (8, 64, 64), "gather_mm": (1, 32, None),
         "gather_full": (4, 32, 32), "edge_mlp": (2, 64, 32),
         "repeat": (1, 32, None)}
#: Rows a thread of the repeat kernel may hold (csrc/mxu_probe.cu
#: repeat_per), the largest tried first; it must divide k.
REPEAT_PER = (8, 4, 2, 1)
H100_SMS = 132


class Plan(NamedTuple):
    """A launch of loop_kernel<Body>: `ctas` CTAs in clusters of `cluster`,
    each `threads` threads with `smem` bytes of dynamic shared memory,
    owning `tile_rows` rows and `cols` columns of the output."""
    ctas: int
    cluster: int
    tile_rows: int
    cols: int
    threads: int
    smem: int


def _smem(body, cols, tile_rows, n_pad):
    """The dynamic shared bytes of a CTA (csrc/mxu_probe.cu's
    Body::smem_bytes)."""
    if body == "peak":
        return 1024 + 16 + 3 * (PEAK_N // 64) * tile_rows * 128 + cols * 4
    if body == "edge_mlp":
        return 16 + (WIDTH * (cols + PAD) + 2 * (WIDTH // cols) * ROW_TILE
                     * (cols + PAD)) * 2 + cols * 4
    if body == "gather_full":
        return 16 + (2 * n_pad * (cols + PAD) + 2 * WIDTH * (cols + PAD)
                     + 2 * (WIDTH // cols) * ROW_TILE
                     * (2 * cols + 3 * PAD)) * 2 + 16
    if body == "gather_mm":
        return (tile_rows * (n_pad + PAD) + 2 * n_pad * (cols + PAD)) * 2 \
            + 2 * (tile_rows // ROW_TILE) * cols * 4
    return 0   # repeat: the loop runs in registers


def _derived(body, rows, n_pad, tile_rows):
    """(ctas, threads, smem) of the body's split with `tile_rows` rows a
    CTA."""
    cluster, cols, _ = SPLIT[body]
    if body == "gather_mm":
        ctas = -(-rows // tile_rows) * (WIDTH // cols)
        threads = (tile_rows // 16) * (cols // 16) * 32
    elif body == "repeat":
        ctas = rows // tile_rows * (WIDTH // cols)
        threads = MAX_THREADS[body]
    elif body == "peak":
        ctas, threads = rows // tile_rows * cluster, MAX_THREADS[body]
    else:
        ctas = rows // ROW_TILE * cluster
        threads = 2 * (cols // 16) * 32
    return ctas, threads, _smem(body, cols, tile_rows, n_pad)


def _repeat_rows(k):
    """The rows a CTA repeat takes at factor k: 2 PER, PER in REPEAT_PER
    dividing k."""
    threads = MAX_THREADS["repeat"]
    return [threads // 32 * per for per in REPEAT_PER if k % per == 0]


def check_plan(body, plan, rows, n_pad=0, k=1):
    """Raises ValueError unless `plan` is a plan the C entry launches for
    this shape: the body's split (gather_mm: any positive multiple of 32
    rows a CTA; repeat: 2 PER rows, PER in REPEAT_PER dividing k and the
    rows a multiple of 2 PER) and the CTAs, threads and shared bytes it
    gives, within the card's limits."""
    cluster, cols, tile_rows = SPLIT[body]
    why = None
    if (plan.cluster, plan.cols) != (cluster, cols):
        why = f"{body} takes clusters of {cluster} CTAs of {cols} columns"
    elif tile_rows is not None and plan.tile_rows != tile_rows:
        why = f"{body} takes {tile_rows} rows a CTA"
    elif body == "repeat" and (plan.tile_rows not in _repeat_rows(k)
                               or rows % plan.tile_rows):
        why = f"repeat at k={k} and {rows} rows takes rows a CTA in " \
              f"{[t for t in _repeat_rows(k) if rows % t == 0]}, not " \
              f"{plan.tile_rows}"
    elif body != "repeat" and (plan.tile_rows <= 0
                               or plan.tile_rows % ROW_TILE):
        why = f"tile_rows {plan.tile_rows} not a positive multiple of " \
              f"{ROW_TILE}"
    else:
        want = _derived(body, rows, n_pad, plan.tile_rows)
        got = (plan.ctas, plan.threads, plan.smem)
        if got != want:
            why = f"(ctas, threads, smem) {got} where the split gives {want}"
        elif plan.threads > MAX_THREADS[body]:
            why = f"{plan.threads} threads, more than {MAX_THREADS[body]}"
        elif plan.smem > MAX_SMEM:
            why = f"{plan.smem} shared bytes, more than {MAX_SMEM}"
    if why is not None:
        raise ValueError(f"mxu_loop: inconsistent {body} plan {plan}: {why}")


def launch_plan(body, rows, n_pad=0, sms=H100_SMS, k=1):
    """The kernel's launch for `body` at `rows` output rows, `n_pad` table
    rows and broadcast factor `k` on a card of `sms` SMs, checked by
    check_plan. peak, edge_mlp and gather_full: SPLIT's. gather_mm: no
    cluster, 32 columns and 32 T rows a CTA, T the least that keeps the
    CTAs within `sms` (T = 1 at 768 rows, 6 at 6,144), bounded by the
    threads and the shared memory a CTA can have. repeat: 64 threads, 32
    columns and 2 PER rows a CTA, PER the largest of REPEAT_PER that
    divides k and keeps the CTAs at `sms` or more (one wave at least: PER
    8 and 192 CTAs at 768 rows and k 48), else 1."""
    cluster, cols, tile_rows = SPLIT[body]
    if body == "repeat":
        fits = [t for t in _repeat_rows(k) if rows % t == 0]
        full = [t for t in fits if rows // t * (WIDTH // cols) >= sms]
        tile_rows = full[0] if full else fits[-1]
    elif tile_rows is None:
        row_tiles = -(-rows // ROW_TILE)
        t = max(1, math.ceil(row_tiles * (WIDTH // cols) / sms))
        t_max = MAX_THREADS[body] // (2 * (cols // 16) * 32)
        while t_max > 1 and _smem(body, cols, t_max * ROW_TILE,
                                  n_pad) > MAX_SMEM:
            t_max -= 1
        tile_rows = ROW_TILE * max(1, min(t, t_max, row_tiles))
    ctas, threads, smem = _derived(body, rows, n_pad, tile_rows)
    plan = Plan(ctas, cluster, tile_rows, cols, threads, smem)
    check_plan(body, plan, rows, n_pad, k)
    return plan


def plan_tiles(body, plan, rows):
    """[(row0, rows, col0, cols)] of the output each CTA writes, in CTA
    order (csrc/mxu_probe.cu's block-to-tile mapping)."""
    tiles = []
    for b in range(plan.ctas):
        if body in ("gather_mm", "repeat"):
            slices = WIDTH // plan.cols
            row0, col0 = (b // slices) * plan.tile_rows, \
                (b % slices) * plan.cols
        else:
            row0 = (b // plan.cluster) * plan.tile_rows
            col0 = (b % plan.cluster) * plan.cols
        tiles.append((row0, max(0, min(plan.tile_rows, rows - row0)), col0,
                      plan.cols))
    return tiles


def _bf(t):
    """t rounded to bf16, as float32."""
    return t.to(torch.bfloat16).float()


@contextlib.contextmanager
def fp32_matmul():
    """float32 matmuls in full float32 on the card (TF32 off) while
    entered; the setting before is restored."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _keep_bf16(acc, salt):
    """bf16(acc[0:1] 1e-30) + bf16(salt[0, 0] 1e-30), rounded to bf16."""
    return _bf(_bf(acc[0:1] * KEEP) + _bf(salt[0, 0] * KEEP))


def peak_reference(a, w, salt, iters):
    """Plain peak_body loop: [512, 512] fp32."""
    a32, w32 = a.float(), w.float()
    acc = torch.zeros((PEAK_N, PEAK_N), device=a.device)
    with fp32_matmul():
        for _ in range(iters):
            x = _bf(a32 + _keep_bf16(acc, salt))
            for _ in range(4):
                x = _bf(x @ w32)
            acc = acc * 0.5 + x
    return acc


def gather_mm_reference(onehot, nh, nl, salt, iters):
    """Plain gmm_body loop: [rows, 128] fp32."""
    oh, nh32, nl32 = onehot.float(), nh.float(), nl.float()
    acc = torch.zeros((onehot.shape[0], WIDTH), device=onehot.device)
    with fp32_matmul():
        for _ in range(iters):
            nh_eff = _bf(nh32 + _keep_bf16(acc, salt))
            acc = acc * 0.5 + oh @ nh_eff + oh @ nl32
    return acc


def gather_full_reference(idx, nh, nl, ws, salt, iters):
    """Plain gfull_body loop: [rows, 128] fp32."""
    nh32, nl32 = nh.float(), nl.float()
    iota = torch.arange(nh.shape[0], device=idx.device)[None, :]
    ws_hi = _bf(ws)
    ws_lo = _bf(ws - ws_hi)
    acc = torch.zeros((idx.shape[0], WIDTH), device=idx.device)
    with fp32_matmul():
        for _ in range(iters):
            shift = (acc[0, 0] * KEEP + salt[0, 0] * KEEP).to(torch.int32)
            oh = (iota == idx + shift).float()
            ghi, glo = oh @ nh32, oh @ nl32
            src = (_bf(ghi) @ ws_hi + _bf(ghi) @ ws_lo) + _bf(glo) @ ws_hi
            acc = acc * 0.5 + src + ghi + glo
    return acc


def _silu(x):
    return x * torch.sigmoid(x)


def edge_mlp_reference(e, w, salt, iters):
    """Plain emlp_body loop: [rows, 128] fp32."""
    e32, wb = e.float(), _bf(w)

    def mm(x):
        return _bf(x) @ wb

    acc = torch.zeros((e.shape[0], WIDTH), device=e.device)
    with fp32_matmul():
        for _ in range(iters):
            x = e32 + acc[0:1] * KEEP + salt[0, 0] * KEEP
            z = _silu(mm(x))
            z = mm(z)
            z = _silu(mm(_silu(z)))
            z = mm(z)
            acc = acc * 0.5 + z
    return acc


def repeat_reference(dst, k, salt, iters):
    """Plain rep_body loop: [tile_n k, 128] fp32."""
    acc = torch.zeros((dst.shape[0] * k, WIDTH), device=dst.device)
    for _ in range(iters):
        acc = acc * 0.5 + torch.repeat_interleave(
            dst + acc[0:1] * KEEP + salt[0, 0] * KEEP, k, dim=0)
    return acc


def repeat_chain_reference(d0, salt, reps):
    """Plain version of repeat_chain: `reps` steps of repeat_reference's
    row-0 recurrence from 0, elementwise over d0 (dst[0], any shape) with
    the 0-d salt (salt[0, 0]); repeat_reference(dst, k, salt, reps)[0] is
    repeat_chain_reference(dst[0], salt[0, 0], reps), bit for bit."""
    acc = torch.zeros_like(d0)
    for _ in range(reps):
        acc = acc * 0.5 + (d0 + acc * KEEP + salt * KEEP)
    return acc


def repeat_chain(d0, salt, reps):
    """`reps` steps of the repeat body's row-0 recurrence on one thread
    (csrc/mxu_probe.cu's repeat_chain_kernel), each waiting on the last
    through a multiply and three adds, from the 0-d float32 d0 and salt:
    the carry (0-d). Timed on the card, reps steps give the latency of the
    dependent sequence that bounds every iteration of the repeat kernel
    (tools/bench_mxu.py::repeat_chain_bound).

    A CPU d0 runs repeat_chain_reference; a CUDA d0 makes one launch or
    raises."""
    fn = "repeat_chain"
    if int(reps) < 1:
        raise ValueError(f"{fn}: reps must be at least 1, not {reps}")
    if d0.device.type == "cpu":
        return repeat_chain_reference(d0, salt, int(reps))
    if d0.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {d0.device}")
    out = torch.empty(1, device=d0.device, dtype=torch.float32)
    from gamd_tpu_torch.ops.build import load_library
    err = load_library().gamd_repeat_chain(
        int(reps), float(d0), float(salt), out.data_ptr(),
        torch.cuda.current_stream(d0.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")
    return out[0]


def mxu_loop_reference(body, inputs, salt, iters, k=1):
    """The plain version of mxu_loop."""
    if body == "peak":
        return peak_reference(*inputs, salt, iters)
    if body == "gather_mm":
        return gather_mm_reference(*inputs, salt, iters)
    if body == "gather_full":
        return gather_full_reference(*inputs, salt, iters)
    if body == "edge_mlp":
        return edge_mlp_reference(*inputs, salt, iters)
    return repeat_reference(*inputs, k, salt, iters)


def output_rows(body, inputs, k=1):
    """Rows of the body's carry."""
    if body == "peak":
        return PEAK_N
    if body == "repeat":
        return inputs[0].shape[0] * k
    return inputs[0].shape[0]


def declare(lib):
    """Set argtypes/restype of the library's probe-loop entry."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gamd_mxu_loop.argtypes = [i, p, p, p, p, p,      # body, in0-3, salt
                                  i, i, i, i, p,         # rows n_pad k iters
                                  i, i, i, i, i, i,      # out; the plan
                                  p]                     # stream
    lib.gamd_mxu_loop.restype = ctypes.c_int
    lib.gamd_repeat_chain.argtypes = [i, ctypes.c_float, ctypes.c_float, p,
                                      p]
    lib.gamd_repeat_chain.restype = ctypes.c_int


def _expected(body, inputs, k):
    """{name: (dtype, shape)} of the body's inputs, and (rows, n_pad)."""
    bf, f32 = torch.bfloat16, torch.float32
    if body == "peak":
        shape = (PEAK_N, PEAK_N)
        return [("a", bf, shape), ("w", bf, shape)], PEAK_N, 0
    if body == "repeat":
        tile_n = inputs[0].shape[0] if inputs[0].ndim == 2 else 0
        return [("dst", f32, (tile_n, WIDTH))], tile_n * k, 0
    rows = inputs[0].shape[0] if inputs[0].ndim == 2 else 0
    if body == "edge_mlp":
        return [("e", bf, (rows, WIDTH)), ("w", f32, (WIDTH, WIDTH))], \
            rows, 0
    n_pad = inputs[1].shape[0] if inputs[1].ndim == 2 else 0
    table = (n_pad, WIDTH)
    head = (("onehot", bf, (rows, n_pad)) if body == "gather_mm"
            else ("idx", torch.int32, (rows, 1)))
    tail = [] if body == "gather_mm" else [("ws", f32, (WIDTH, WIDTH))]
    return [head, ("nh", bf, table), ("nl", bf, table), *tail], rows, n_pad


def mxu_loop(body, inputs, salt, iters, k=1):
    """`iters` iterations of one stage body; the carry after the loop.

    Args:
        body: one of BODIES.
        inputs: the body's tensors, in the order of the module docstring
            (peak (a, w); gather_mm (onehot, nh, nl); gather_full (idx,
            nh, nl, ws); edge_mlp (e, w); repeat (dst,)).
        salt: [8, 128] float32; salt[0, 0] enters the keep-alive term.
        iters: iterations in the call (>= 0).
        k: the repeat body's broadcast factor.

    Returns [512, 512] (peak) or [rows, 128] float32. A CPU `salt` runs
    the plain version; a CUDA `salt` makes one launch of
    csrc/mxu_probe.cu's loop kernel for the body (rows a multiple of 32,
    n_pad of 32) or raises.
    """
    fn = "mxu_loop"
    if body not in BODIES:
        raise ValueError(f"{fn}: body must be one of {sorted(BODIES)}, not "
                         f"{body!r}")
    if int(iters) < 0:
        raise ValueError(f"{fn}: iters must be >= 0, not {iters}")
    if salt.device.type == "cpu":
        return mxu_loop_reference(body, inputs, salt, int(iters), k)
    if salt.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {salt.device}")
    dev = salt.device
    _check(fn, "salt", salt, dev, torch.float32, (8, WIDTH))
    specs, rows, n_pad = _expected(body, inputs, int(k))
    if len(inputs) != len(specs):
        raise ValueError(f"{fn}: {body} takes {len(specs)} inputs "
                         f"{[name for name, *_ in specs]}, not "
                         f"{len(inputs)}")
    for (name, dtype, shape), t in zip(specs, inputs):
        _check(fn, name, t, dev, dtype, shape)
    if rows <= 0 or rows % ROW_TILE or n_pad % ROW_TILE:
        raise ValueError(f"{fn}: {body} needs rows a positive multiple of "
                         f"{ROW_TILE} and n_pad a multiple of {ROW_TILE};"
                         f" got rows {rows}, n_pad {n_pad}")
    plan = launch_plan(body, rows, n_pad, sm_count(dev), int(k))
    width = PEAK_N if body == "peak" else WIDTH
    out = torch.empty((rows, width), device=dev, dtype=torch.float32)
    ptrs = [t.data_ptr() for t in inputs] + [None] * (4 - len(inputs))
    from gamd_tpu_torch.ops.build import load_library
    err = load_library().gamd_mxu_loop(
        BODIES[body], *ptrs, salt.data_ptr(), rows, n_pad, int(k),
        int(iters), out.data_ptr(), *plan,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")
    mxu_loop.launches[body] += 1
    return out


mxu_loop.launches = dict.fromkeys(BODIES, 0)


def sm_count(device):
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count
