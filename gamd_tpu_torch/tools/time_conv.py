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
over a layout made once, as the force path makes it. The op library's
four kernels (ops/message.py: conv_layer, conv_msg, edge_mlp_agg and
gather_agg, rows 7-10) are timed at chip_smoke.py phase 29's inputs
(conv_inputs and op_inputs: layer 0 of the seeded GAMD-small on the
training slice's start frame, K=96), with conv_msg_gather on the same
inputs beside them as row 8's edge work by node id (events ms, device us
a call and by kernel, exclusive). Rows 3-4 at the DFT model's widths
(256/128/256; keys conv_msg_gather_dft_b1, _b4 and their _bwd_ twins)
run on layer 0 of a seeded DFT model (dft_inputs) over the first
training frames of md_dataset/RPBE-surrogate.npz, each at its own box,
K=192 at 9.5 bohr; a tree whose package predates those widths skips
them. It uses only names that the package has had since these kernels
were ported, so it can time another tree's package: put that tree first
on PYTHONPATH and run this file by its path.

    python3 -m gamd_tpu_torch.tools.time_conv [--save PATH]

Prints the card line, then one JSON line; --save also writes each timed
forward's output and the backward's gradients (torch.save), so that two
trees' results can be compared bit for bit. Needs a CUDA card.
"""

import inspect
import json
import sys
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from gamd_tpu_torch.core import space
from gamd_tpu_torch.core.config import get_preset
from gamd_tpu_torch.core.device import card_line
from gamd_tpu_torch.models.normalizer import init_stat, update_stat
from gamd_tpu_torch.neighbors.cell_list import cell_list_neighbor_list
from gamd_tpu_torch.neighbors.dense import dense_neighbor_list
from gamd_tpu_torch.ops import banded, conv_gather, message
from gamd_tpu_torch.ops.conv_gather import fused_conv_gather_message
from gamd_tpu_torch.tools.bench_large import (banded_layer_inputs, lj_large,
                                              seeded_force_field)
from gamd_tpu_torch.tools.lj_slice import lj_slice
from gamd_tpu_torch.tools.lj_train_slice import lj_train_slice
from gamd_tpu_torch.tools.profile_step import exclusive_times, traced_spans
from gamd_tpu_torch.tools.time_forward import median_ms
from gamd_tpu_torch.train.loop import edge_distances, search_batch
from gamd_tpu_torch.train.state import create_train_state

WIDTH, K = 128, 96
DEPLOY_CUTOFF = 7.5           # the LJ checkpoint's cutoff (A)
BANDED_SIZES = (258, 4096, 10_000)
RPBE = "md_dataset/RPBE-surrogate.npz"
DFT_BATCHES = (1, 4)          # frames of the DFT-width calls


def kernel_us(fn, calls=20):
    """{kernel short name: exclusive device us a call} of fn over `calls`
    traced calls (profile_step.traced_spans)."""
    kernels, _ = exclusive_times(traced_spans(fn, calls))
    return {name: v["us"] / calls for name, v in kernels.items()}


def device_us(fn, calls=20):
    """Device time of fn's kernels a call (us), each kernel's exclusive
    time."""
    return sum(kernel_us(fn, calls).values())


def backward_entry(args, dev, outputs=None, name=None):
    """Row 4 on row 3's inputs: the backward of one forward (its graph
    kept), timed by CUDA events (median of 20 calls) and by kernel on the
    device, with the backward launches a call; the gradients kept in
    outputs[name] where given."""
    leaves = [t.clone().requires_grad_(True) for t in (args[0], *args[3:])]
    e, hn, src, dst, *ws = leaves
    out = fused_conv_gather_message(e, args[1], args[2], hn, src, dst, *ws)
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(7))
    call = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)
    before = fused_conv_gather_message.backward_launches
    grads = call()
    launches = fused_conv_gather_message.backward_launches - before
    if outputs is not None:
        outputs[name] = [t.cpu() for t in grads]
    kernels = kernel_us(call)
    return {"ms": median_ms(call, 20), "device_us": sum(kernels.values()),
            "kernels": {k: round(v, 3) for k, v in kernels.items()},
            "launches_a_call": launches}


class ConvCase(NamedTuple):
    """One conv layer's real inputs (batch of one graph)."""
    args: tuple          # e, idx, mask, hn, src, dst and the 8 edge weights
    live: int            # live edges
    h: torch.Tensor      # the layer's input [1, N, D], its residual
    phi: list            # phi_dst, phi_edge, phi weights and biases
    frame: tuple         # (pos [1, N, 3], length mean, length std)


def conv_inputs(dev):
    """The conv kernels' real inputs at the training slice, from
    init_params(seed=0) GAMD-small, the dense list at 7.5 A with K=96 and
    the edge-length scaler fitted on the frame: layer 0's on the start
    frame (the encoded edges, hn, src and dst codes; every row of hn is the
    node embedding) and layer 1's on frame 1 (the lattice displaced by
    0.1 A, after one conv layer, so that rows differ). Returns a ConvCase
    for each."""
    sl = lj_train_slice(dev)
    system = sl.system
    model = create_train_state(sl.model_cfg, system, sl.train_cfg, 1,
                               seed=0, device=dev).model
    cases = []
    for frame, layer in ((0, 0), (1, 1)):
        pos = space.wrap(sl.batches[frame]["pos"], system.box)
        idx, mask, ovf = search_batch(pos, system.box, system.cutoff,
                                      system.nbr_capacity)
        if bool(ovf):
            raise RuntimeError("neighbour overflow at the training frame")
        stat = update_stat(init_stat(dev), edge_distances(pos, idx,
                                                          system.box),
                           mask=mask)
        block = model.graph_conv
        with torch.no_grad():
            e = model.encode_edges(pos, idx, system.box, stat.safe_mean,
                                   stat.std)
            h = model.node_emb.expand(1, system.n_atoms, -1)
            for below in range(layer):
                h = getattr(block, f"conv_{below}")(
                    h, getattr(block, f"norm_{below}")(h), e, idx, mask)
            conv = getattr(block, f"conv_{layer}")
            hn = getattr(block, f"norm_{layer}")(h)
            src, dst = conv.src_affine(hn), conv.dst_affine(hn)
        weights = [t.detach() for t in (
            conv.edge_affine_w1, conv.edge_affine_b1, conv.edge_affine_w2,
            conv.edge_affine_b2, conv.theta_edge_w1, conv.theta_edge_b1,
            conv.theta_edge_w2, conv.theta_edge_b2)]
        phi = [t.detach() for t in (conv.phi_dst_w, conv.phi_dst_b,
                                    conv.phi_edge_w, conv.phi_edge_b,
                                    conv.phi_w, conv.phi_b)]
        cases.append(ConvCase((e, idx, mask, hn, src, dst, *weights),
                              int(mask.sum()), h, phi,
                              (pos, stat.safe_mean, stat.std)))
    return cases


def dft_inputs(dev, b, seed=0):
    """Rows 3-4's real inputs at the DFT model's widths: layer 0 of
    train_gamd --system dft's model (dft_model_config: 256/128/256, 5
    layers, flip_dir; init_params(seed)) on the first b training frames of
    md_dataset/RPBE-surrogate.npz, each wrapped into its own box, the
    dense lists at 9.5 bohr with K=192, the edge-length scaler fitted on
    the frames: (e, idx, mask, hn, src, dst and the 8 edge weights, the
    live edges)."""
    from gamd_tpu_torch.core.config import dft_model_config
    from gamd_tpu_torch.train.data import RealLargeDataset
    from gamd_tpu_torch.train.state import build_model, init_params

    system = get_preset("dft")
    cfg = dft_model_config()
    items = [RealLargeDataset(RPBE, mode="train")[i] for i in range(b)]
    t = lambda key: torch.as_tensor(np.stack([it[key] for it in items]),
                                    device=dev)
    box = t("box_size")
    pos = space.wrap(t("pos"), space.frame_box(box, t("pos")))
    idx, mask, ovf = search_batch(pos, box, system.cutoff,
                                  system.nbr_capacity)
    if bool(ovf):
        raise RuntimeError("neighbour overflow at the DFT frames")
    stat = update_stat(init_stat(dev), edge_distances(pos, idx, box),
                       mask=mask)
    weights = init_params(cfg, system, seed=seed)
    model = build_model(cfg, system).load_params(weights.params).to(dev)
    with torch.no_grad():
        e = model.encode_edges(pos, idx, box, stat.safe_mean, stat.std)
        hn = model.graph_conv.norm_0(model.node_encoder(t("feat")))
        conv = model.graph_conv.conv_0
        src, dst = conv.src_affine(hn), conv.dst_affine(hn)
    ws = [p.detach() for p in (
        conv.edge_affine_w1, conv.edge_affine_b1, conv.edge_affine_w2,
        conv.edge_affine_b2, conv.theta_edge_w1, conv.theta_edge_b1,
        conv.theta_edge_w2, conv.theta_edge_b2)]
    return (e, idx, mask, hn, src, dst, *ws), int(mask.sum())


def op_inputs(case):
    """The op library's inputs on one graph of a ConvCase, flat in each
    entry's argument order, {op: (inputs, kernel, plain)}: the conv
    pair's own e, idx, mask, hn, src, dst and weights, and from them
    h_src = hn[idx], src_code = src[idx], edge_pre = edge_affine(e) +
    src_code + dst and the gate theta(edge_pre)."""
    e, idx, mask, hn, src, dst = (t[0] for t in case.args[:6])
    w8 = list(case.args[6:])
    w1, b1, w2, b2, w3, b3, w4, b4 = w8
    with torch.no_grad():
        rows = idx.long()
        h_src, src_code = hn[rows], src[rows]
        edge_pre = F.silu(e @ w1 + b1) @ w2 + b2 + src_code + dst[:, None]
        gate = F.silu(F.silu(edge_pre) @ w3 + b3) @ w4 + b4
    h = case.h[0].contiguous()
    return {
        "gather_agg": ((hn, gate, idx, mask),
                       message.pallas_gather_multiply_aggregate,
                       message.gather_multiply_aggregate),
        "edge_mlp_agg": ((edge_pre, h_src, mask, w3, b3, w4, b4),
                         message.fused_edge_mlp_aggregate,
                         message._fused_reference),
        "conv_msg": ((e, h_src, src_code, dst, mask, *w8),
                     message.fused_conv_message,
                     message._conv_msg_reference),
        "conv_layer": ((e, idx, mask, h, hn, src, dst, *w8, *case.phi),
                       lambda *a: message.fused_conv_layer(*a[:7], a[7:]),
                       message._conv_layer_plain),
    }


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


def timed(call, outputs, name):
    """{"ms", "device_us", "kernels"} of call (events ms, the median of 20
    single calls; device us a call and by kernel, exclusive), its output
    kept in outputs[name]."""
    kernels = kernel_us(call)
    outputs[name] = call().cpu()
    return {"ms": median_ms(call, 20), "device_us": sum(kernels.values()),
            "kernels": {k: round(v, 3) for k, v in kernels.items()}}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    save = argv[argv.index("--save") + 1] if "--save" in argv else None
    if not torch.cuda.is_available():
        raise RuntimeError("time_conv needs a CUDA card")
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    line = {"card": card}
    outputs = {}
    with torch.no_grad():
        case = conv_inputs(dev)[0]
        calls = {name: (lambda kernel=kernel, inputs=inputs: kernel(*inputs))
                 for name, (inputs, kernel, _) in op_inputs(case).items()}
        calls["conv_msg_gather"] = lambda: fused_conv_gather_message(
            *case.args)
        for name, call in calls.items():
            line[f"op_{name}"] = {"live": case.live,
                                  **timed(call, outputs, f"op_{name}")}
        for b in (1, 16):
            args, live = gather_inputs(dev, b)
            call = lambda: fused_conv_gather_message(*args)
            line[f"conv_msg_gather_b{b}"] = {
                "live": live, "ms": median_ms(call, 20),
                "device_us": device_us(call)}
            outputs[f"conv_msg_gather_b{b}"] = call().cpu()
            with torch.enable_grad():
                line[f"conv_msg_gather_bwd_b{b}"] = {
                    "live": live, **backward_entry(
                        args, dev, outputs, f"conv_msg_gather_bwd_b{b}")}
        if hasattr(conv_gather, "check_widths"):   # trees with the widths
            for b in DFT_BATCHES:
                args, live = dft_inputs(dev, b)
                call = lambda: fused_conv_gather_message(*args)
                line[f"conv_msg_gather_dft_b{b}"] = {
                    "live": live, "ms": median_ms(call, 20),
                    "device_us": device_us(call)}
                outputs[f"conv_msg_gather_dft_b{b}"] = call().cpu()
                with torch.enable_grad():
                    line[f"conv_msg_gather_bwd_dft_b{b}"] = {
                        "live": live, **backward_entry(
                            args, dev, outputs,
                            f"conv_msg_gather_bwd_dft_b{b}")}
        given = "layout" in inspect.signature(
            banded.banded_conv_message).parameters
        for n in BANDED_SIZES:
            args, live = banded_inputs(dev, n)
            call = lambda: banded.banded_conv_message(*args)
            entry = {"live": live, "ms": median_ms(call, 20),
                     "device_us": device_us(call)}
            outputs[f"banded_msg_n{n}"] = call().cpu()
            if given:   # the force path's call: the layout made once
                from gamd_tpu_torch.ops.edge_tiles import mask_layout
                layout = mask_layout(args[2])
                call = lambda: banded.banded_conv_message(*args,
                                                          layout=layout)
                entry.update(ms_layout_given=median_ms(call, 20),
                             device_us_layout_given=device_us(call))
            line[f"banded_msg_n{n}"] = entry
    if save:
        torch.save(outputs, save)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
