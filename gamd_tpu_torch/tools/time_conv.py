"""Times of the conv message on the card at the shapes its paths run:
fused_conv_gather_message (csrc/conv_msg_gather.cu) on the LJ-258 start
frame of the slice with the deployment's list (K=96 at 7.5 A; B=1 as the
deployment's MD and the training step, B=16 as predict_batch), its
backward (csrc/conv_msg_gather_bwd.cu, through autograd on the same
inputs with a seeded cotangent: the events time includes the wrapper's
sort of the live slots by source and its other preparation; the device
time by kernel, exclusive; the backward launches a call), and
banded_conv_message
(csrc/banded_msg.cu) on layer 0 of tools/bench_large.py's LJ fluid with
the seeded GAMD-small at N=258, 4,096 and 10,000 (the dense list at 8.0 A
below 1,025 atoms, the cell list above; K=96; the auto band). Row 3's e,
node rows and weights are seeded (the live slots are the frame's); each
time is the median of single calls by CUDA events after warm-up calls,
beside the device time a call (torch.profiler over 20 calls, each kernel's
exclusive time); where banded_conv_message takes a live-edge layout, also
over a layout made once, as the force path makes it. It uses only the public API, so it can time another
tree's package: put that tree first on PYTHONPATH and run this file by its
path.

    python3 -m gamd_tpu_torch.tools.time_conv

Prints the card line, then one JSON line. Needs a CUDA card.
"""

import inspect
import json

import numpy as np
import torch

from gamd_tpu_torch.core.device import card_line
from gamd_tpu_torch.neighbors.cell_list import cell_list_neighbor_list
from gamd_tpu_torch.neighbors.dense import dense_neighbor_list
from gamd_tpu_torch.ops import banded
from gamd_tpu_torch.ops.conv_gather import fused_conv_gather_message
from gamd_tpu_torch.tools.bench_large import (banded_layer_inputs, lj_large,
                                              seeded_force_field)
from gamd_tpu_torch.tools.lj_slice import lj_slice
from gamd_tpu_torch.tools.profile_step import exclusive_times, traced_spans
from gamd_tpu_torch.tools.time_forward import median_ms

WIDTH, K = 128, 96
DEPLOY_CUTOFF = 7.5           # the LJ checkpoint's cutoff (A)
BANDED_SIZES = (258, 4096, 10_000)


def kernel_us(fn, calls=20):
    """{kernel short name: exclusive device us a call} of fn over `calls`
    traced calls (profile_step.traced_spans)."""
    kernels, _ = exclusive_times(traced_spans(fn, calls))
    return {name: v["us"] / calls for name, v in kernels.items()}


def device_us(fn, calls=20):
    """Device time of fn's kernels a call (us), each kernel's exclusive
    time."""
    return sum(kernel_us(fn, calls).values())


def backward_entry(args, dev):
    """Row 4 on row 3's inputs: the backward of one forward (its graph
    kept), timed by CUDA events (median of 20 calls) and by kernel on the
    device, with the backward launches a call."""
    leaves = [t.clone().requires_grad_(True) for t in (args[0], *args[3:])]
    e, hn, src, dst, *ws = leaves
    out = fused_conv_gather_message(e, args[1], args[2], hn, src, dst, *ws)
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(7))
    call = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)
    before = fused_conv_gather_message.backward_launches
    call()
    launches = fused_conv_gather_message.backward_launches - before
    kernels = kernel_us(call)
    return {"ms": median_ms(call, 20), "device_us": sum(kernels.values()),
            "kernels": {k: round(v, 3) for k, v in kernels.items()},
            "launches_a_call": launches}


def gather_inputs(dev, b):
    """Row 3's inputs [B, 258, 96, ...]: the slice's start frame and its
    list at 7.5 A (the same frame in every graph), seeded e, node rows and
    weights."""
    system, _, _, _, pos = lj_slice(dev, seed=0)
    idx, mask, _ = dense_neighbor_list(pos, system.box, DEPLOY_CUTOFF, K)
    n = system.n_atoms
    rng = np.random.default_rng(3)
    t = lambda *s, scale: torch.as_tensor(
        (rng.standard_normal(s) * scale).astype(np.float32), device=dev)
    tile = lambda x: x.expand(b, *x.shape).contiguous()
    inputs = (t(b, n, K, WIDTH, scale=0.3), tile(idx.int()), tile(mask),
              t(b, n, WIDTH, scale=0.5), t(b, n, WIDTH, scale=0.5),
              t(b, n, WIDTH, scale=0.3))
    weights = [t(*s, scale=0.08) for s in [(WIDTH, WIDTH), (WIDTH,)] * 4]
    return inputs + tuple(weights), int(mask.sum()) * b


def banded_inputs(dev, n):
    """Row 6's inputs on layer 0 at N atoms (banded_layer_inputs)."""
    system, pos = lj_large(n, K, dev)
    search = cell_list_neighbor_list if n > 1024 else dense_neighbor_list
    idx, mask, ovf = search(pos, system.box, system.cutoff + system.skin, K)
    if bool(ovf):
        raise RuntimeError(f"neighbour overflow at N={n}")
    args = banded_layer_inputs(seeded_force_field(system, dev), pos, idx,
                               mask, 0)
    return args, int(args[2].sum())


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("time_conv needs a CUDA card")
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    line = {"card": card}
    with torch.no_grad():
        for b in (1, 16):
            args, live = gather_inputs(dev, b)
            call = lambda: fused_conv_gather_message(*args)
            line[f"conv_msg_gather_b{b}"] = {
                "live": live, "ms": median_ms(call, 20),
                "device_us": device_us(call)}
            with torch.enable_grad():
                line[f"conv_msg_gather_bwd_b{b}"] = {
                    "live": live, **backward_entry(args, dev)}
        given = "layout" in inspect.signature(
            banded.banded_conv_message).parameters
        for n in BANDED_SIZES:
            args, live = banded_inputs(dev, n)
            call = lambda: banded.banded_conv_message(*args)
            entry = {"live": live, "ms": median_ms(call, 20),
                     "device_us": device_us(call)}
            if given:   # the force path's call: the layout made once
                from gamd_tpu_torch.ops.edge_tiles import mask_layout
                layout = mask_layout(args[2])
                call = lambda: banded.banded_conv_message(*args,
                                                          layout=layout)
                entry.update(ms_layout_given=median_ms(call, 20),
                             device_us_layout_given=device_us(call))
            line[f"banded_msg_n{n}"] = entry
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
