"""The tensor-core probe on the card: the port of scripts/bench_mxu.py,
with its flags, defaults, shapes, printed lines and collapse check.

Each stage is one call of ops.mxu_probe.mxu_loop, the hand-written CUDA
loop kernel csrc/mxu_probe.cu running `iters` iterations of one stage of
the megakernel's forward body at the LJ-258 shapes (tile_n 16, k 48, D
128, n_pad 384) with the accumulator carried through the loop:

  peak          four chained bf16 [512,512]@[512,512] products
  gather_mm     the one-hot gather products, one-hot prebuilt, at
                M = tile_n k rows
  gather_mm_8M  the same at 8 M rows
  gather_full   the compare one-hot build, the gathers and the hi/lo
                source affine
  edge_mlp      four 128-wide bf16 products with silu
  repeat        the k-broadcast of the dst rows
  forward       20 chained calls of ops.mega.mega_forward (the port's
                whole forward, seeded GAMD-small on the LJ-258 lattice),
                each call's positions moved by 1e-7 of the last forces

Per stage it prints microseconds per iteration (one call's device time
by CUDA events, median of 5 calls with a fresh salt each, over iters),
the achieved TFLOP/s of the exact FLOP count, and the blocks the kernel
runs on the card's SMs. The calibration line holds the loop to the
script's check: the peak stage's time per iteration at iters and iters/4
must agree within 0.8-1.25, and the peak must not claim more than the
card's dense bf16 rate of 989 TFLOP/s, or the line says LOOP-COLLAPSED.

    python3 -m gamd_tpu_torch.tools.bench_mxu [--iters 200] [--tile_n 16]
        [--k 48] [--n 258]

Needs a CUDA card; `--cpu` runs the plain versions on the CPU and prints
parity, not times: each stage's carry against the geometric sum
acc <- acc / 2 + X of its one-iteration output X (which is what the loop
computes when the keep-alive terms round away), and the forward chain's
forces finite.
"""

import argparse
import itertools
import statistics
import zlib

import numpy as np
import torch

from gamd_tpu_torch.ops.mxu_probe import (BLOCK_ROWS, PEAK_N, THREADS,
                                          WIDTH, mxu_loop, output_rows)

#: The card's dense bf16 rate (H100 SXM data sheet), the calibration's
#: ceiling.
PEAK_BF16_TFLOPS = 989.0
CALIB_BAND = (0.8, 1.25)
PARITY_RTOL = 1e-5
#: max |kernel - plain| / max |plain| of each body at a few iterations (the
#: card checks): the one-hot products and the broadcast are exact in fp32;
#: the hi/lo affine sums fp32 products in another order; the chains round
#: each product to bf16, where a flipped rounding moves an element by a
#: bf16 ulp.
KERNEL_RTOL = {"peak": 1e-2, "gather_mm": 0.0, "gather_full": 1e-5,
               "edge_mlp": 1e-2, "repeat": 0.0}
TIMED_CALLS = 5
SPIN_CYCLES = 2_000_000   # the spin before each timed call (~1 ms)
FORWARD_CALLS = 20


def flops_per_iter(body, rows, n_pad):
    """The products' FLOP in one iteration of a stage (2 per multiply-
    add): the gathers' one-hot products count in full."""
    if body == "peak":
        return 4 * 2 * PEAK_N ** 3
    if body == "gather_mm":
        return 2 * 2 * rows * n_pad * WIDTH
    if body == "gather_full":
        return 2 * 2 * rows * n_pad * WIDTH + 3 * 2 * rows * WIDTH * WIDTH
    if body == "edge_mlp":
        return 4 * 2 * rows * WIDTH * WIDTH
    return 0


def stage_inputs(args, device):
    """{label: (body, inputs, k)} with the JAX script's RandomState(0)
    draws in its order, on `device`."""
    tile_n, k = args.tile_n, args.k
    rows = tile_n * k
    n_pad = -(-args.n // 128) * 128
    rng = np.random.RandomState(0)

    def bf(x):
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=device).to(torch.bfloat16)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    a = bf(rng.randn(512, 512) * 0.04)
    w = bf(rng.randn(512, 512) * 0.04)
    onehot = bf(rng.randint(0, n_pad, (rows, 1)) == np.arange(n_pad)[None])
    nh = bf(rng.randn(n_pad, WIDTH))
    nl = bf(rng.randn(n_pad, WIDTH) * 1e-3)
    onehot8 = bf(rng.randint(0, n_pad, (8 * rows, 1))
                 == np.arange(n_pad)[None])
    idx_col = torch.as_tensor(rng.randint(0, args.n, (rows, 1)),
                              dtype=torch.int32, device=device)
    ws = f32(rng.randn(WIDTH, WIDTH))
    e = bf(rng.randn(rows, WIDTH))
    w1 = f32(rng.randn(WIDTH, WIDTH))
    dst = f32(rng.randn(tile_n, WIDTH))
    return {"peak": ("peak", (a, w), 1),
            "gather_mm": ("gather_mm", (onehot, nh, nl), 1),
            "gather_mm_8M": ("gather_mm", (onehot8, nh, nl), 1),
            "gather_full": ("gather_full", (idx_col, nh, nl, ws), 1),
            "edge_mlp": ("edge_mlp", (e, w1), 1),
            "repeat": ("repeat", (dst,), k)}


def salts(label, device):
    """A fresh [8, 128] salt per call, from a generator seeded by label."""
    gen = np.random.RandomState(zlib.crc32(label.encode()) & 0xffff)
    return lambda: torch.as_tensor(gen.randn(8, 128).astype(np.float32),
                                   device=device)


def call_ms(fn, make_args, calls=TIMED_CALLS):
    """Median of `calls` single-call device times (CUDA events, ms), each
    call with fresh arguments made before its start event, after one
    untimed call. A spin kernel (torch.cuda._sleep, about a millisecond)
    keeps the card busy while the host records the start event and issues
    the call, so that the host's time in the wrapper (tens of us: checks,
    allocations, ctypes) does not enter the interval."""
    fn(*make_args())
    times = []
    for _ in range(calls):
        args = make_args()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls):
    """Device time (ms) of `calls` calls of fn, the same work as one probe
    call of `calls` iterations: captured once in a CUDA graph and replayed
    (CUDA events, median of 3 after one untimed replay), so that the
    host's ~20 us a PyTorch call does not enter. The library yardstick of
    a probe form."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return call_ms(graph.replay, tuple, calls=3)


def time_stage(label, body, inputs, k, iters, device):
    """(us per iteration, ms per call) of one stage at `iters`."""
    salt = salts(label, device)
    ms = call_ms(lambda s: mxu_loop(body, inputs, s, iters, k),
                 lambda: (salt(),))
    return ms * 1e3 / iters, ms


def parity(label, body, inputs, k, iters, device):
    """max |carry - geometric sum of one iteration's output| / max
    |carry|, the carry at `iters`."""
    salt = salts(label, device)()
    out = mxu_loop(body, inputs, salt, iters, k)
    one = mxu_loop(body, inputs, salt, 1, k)
    geo = torch.zeros_like(one)
    for _ in range(iters):
        geo = geo * 0.5 + one
    return float((out - geo).abs().max()) / max(float(out.abs().max()),
                                                 1e-30)


def forward_setup(k, device):
    """(fwd(pos) -> forces, start positions): seeded GAMD-small on the
    LJ-258 lattice, the K=64 list at cutoff + 0.5 A with its live slots
    first, sliced to k (bench_mxu.py:287-305)."""
    from gamd_tpu_torch.core.config import get_preset, lj_model_config
    from gamd_tpu_torch.neighbors.dense import dense_neighbor_list
    from gamd_tpu_torch.ops.mega import mega_forward, pack_params
    from gamd_tpu_torch.physics.lennard_jones import lj_fluid_box
    from gamd_tpu_torch.train.state import init_params

    system = get_preset("lj", nbr_capacity=64)
    cfg = lj_model_config()
    params = init_params(cfg, system, seed=0).params
    mp = pack_params(params, cfg, device=device)
    _, pos0 = lj_fluid_box(system.n_atoms, 0.5)
    pos = torch.as_tensor(pos0, dtype=torch.float32, device=device)
    idx, mask, _ = dense_neighbor_list(pos, system.box,
                                       system.cutoff + 0.5, 64)
    order = torch.argsort((~mask).to(torch.int32), dim=1,
                          stable=True)[:, :k]
    idx = torch.gather(idx, 1, order).contiguous()
    mask = torch.gather(mask, 1, order).contiguous()
    h0 = torch.as_tensor(np.asarray(params["node_emb"], np.float32),
                         device=device).expand(system.n_atoms,
                                               WIDTH).contiguous()

    @torch.no_grad()
    def fwd(p):
        return mega_forward(p, idx, mask, h0, mp, system.box, system.cutoff,
                            1.0, 0.5)

    return fwd, pos


def forward_chain(fwd, pos, calls=FORWARD_CALLS):
    """`calls` forwards, each from the last positions + 1e-7 forces; the
    last forces."""
    f = None
    for _ in range(calls):
        f = fwd(pos)
        pos = pos + 1e-7 * f
    return f


def parse_args(argv=None):
    """The script's flags: --iters 200 --tile_n 16 --k 48 --n 258 --cpu."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--tile_n", type=int, default=16)
    ap.add_argument("--k", type=int, default=48)
    ap.add_argument("--n", type=int, default=258)
    ap.add_argument("--cpu", action="store_true",
                    help="the plain versions on the CPU: parity only")
    return ap.parse_args(argv)


def main(argv=None):
    """Runs the probe; returns {"stages": {label: {...}}, "calibration":
    {...} or None, "forward": {...}} (times None with --cpu)."""
    args = parse_args(argv)
    from gamd_tpu_torch.core.device import resolve_device
    dev = resolve_device("cpu" if args.cpu else "cuda")
    on_card = dev.type == "cuda"
    if on_card:
        from gamd_tpu_torch.core.device import card_line
        print(card_line(), flush=True)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_pad = -(-args.n // 128) * 128
    stages = {}
    calibration = None
    for label, (body, inputs, k) in stage_inputs(args, dev).items():
        rows = output_rows(body, inputs, k)
        flops = flops_per_iter(body, rows, n_pad)
        entry = {"body": body, "rows": rows, "flops_per_iter": flops,
                 "blocks": rows // BLOCK_ROWS}
        if not on_card:
            err = parity(label, body, inputs, k, args.iters, dev)
            entry["parity"] = err
            print(f"{label:14s} parity {err:.3e} (the carry at iters "
                  f"{args.iters} against the geometric sum of one "
                  f"iteration's output; tolerance {PARITY_RTOL})",
                  flush=True)
            stages[label] = entry
            continue
        us, ms = time_stage(label, body, inputs, k, args.iters, dev)
        tf = flops / (us * 1e-6) / 1e12 if flops else 0.0
        entry.update(us_per_iter=us, ms=ms, tflops=tf)
        print(f"{label:14s} {us:9.2f} us/iter   {tf:7.1f} TFLOP/s   "
              f"({entry['blocks']} blocks x {THREADS} threads on {sms} "
              "SMs)", flush=True)
        stages[label] = entry
        if label == "peak":
            it_q = max(1, args.iters // 4)
            us_q, ms_q = time_stage("peak_quarter", body, inputs, k, it_q,
                                    dev)
            print(f"{'peak_quarter':14s} {us_q:9.2f} us/iter   "
                  f"{flops / (us_q * 1e-6) / 1e12:7.1f} TFLOP/s", flush=True)
            ratio = us_q / us
            ok = CALIB_BAND[0] < ratio < CALIB_BAND[1] \
                and tf <= PEAK_BF16_TFLOPS
            tag = "OK" if ok else "LOOP-COLLAPSED (numbers invalid)"
            calibration = {"ratio": ratio, "peak_tflops": tf, "tag": tag,
                           "quarter_iters": it_q, "quarter_ms": ms_q}
            print(f"calibration: per-iter(quarter)/per-iter(full) = "
                  f"{ratio:.2f} peak-stage {tf:.0f} TFLOP/s vs "
                  f"{PEAK_BF16_TFLOPS:.0f} dense bf16 peak [{tag}]",
                  flush=True)
    fwd, pos = forward_setup(args.k, dev)
    if on_card:
        ms = call_ms(lambda p: forward_chain(fwd, p),
                     _distinct_positions(pos))
        forward = {"us_per_call": ms * 1e3 / FORWARD_CALLS,
                   "calls": FORWARD_CALLS}
        print(f"{'forward':14s} {forward['us_per_call']:9.2f} us/call  "
              f"(chained, {FORWARD_CALLS} calls a timing)", flush=True)
    else:
        f = forward_chain(fwd, pos)
        forward = {"finite": bool(torch.isfinite(f).all()),
                   "max_abs_force": float(f.abs().max())}
        print(f"{'forward':14s} {FORWARD_CALLS} chained calls, forces "
              f"finite {forward['finite']}, max |F| "
              f"{forward['max_abs_force']:.4e}", flush=True)
    return {"stages": stages, "calibration": calibration,
            "forward": forward}


def _distinct_positions(pos):
    """Arguments of successive timed forward chains: pos + 1e-5 r."""
    count = itertools.count(1)
    return lambda: (pos + 1e-5 * next(count),)


if __name__ == "__main__":
    main()
