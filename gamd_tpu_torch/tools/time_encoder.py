"""Times of the edge encoder (row 5 of the port's kernel table), the lane
gather (row 15) and the large-N banded MD step on the card, at the shapes
their paths run:

* fused_edge_encoder (csrc/edge_encoder.cu) on LJ-258 frames of the
  committed checkpoint's deployment (its weights, its list K=96 at 7.5 A +
  1.25 A, the 7.5 A cutoff), B=1 as the deployment's MD and B=16 as
  predict_batch: CUDA events (median of 20 single calls) and the device
  time a call (tools/time_conv.py::device_us: torch.profiler over 20
  calls, each kernel's exclusive time);
* lane_gather (csrc/gather_forms.cu) at widths 384 and 128 on
  tools/probe_gather.py's inputs at iters 2,000: us an iteration (median of
  5 calls by CUDA events, over iters);
* the banded MD step of tools/bench_large.py at N=4,096 and 10,000: steps/s
  of 100 Langevin steps after 20 warm-up steps (host clock), the device
  time a step over 20 traced steps and the edge encoder's share of it (its
  kernels, profile_step.ENCODER_KERNELS, where the tree has them), and
  bench_large's own rows (--gnn_banded_sizes 4096 10000 --steps 400).

It uses only the public API, so it can time another tree's package: put
that tree first on PYTHONPATH and run this file by its path.

    python3 -m gamd_tpu_torch.tools.time_encoder [--save PATH]

Prints the card line, then one JSON line; --save also writes (torch.save)
fused_edge_encoder's outputs at B=1 and 16, so that two trees' results
can be compared bit for bit. Needs a CUDA card.
"""

import json
import sys
import time

import numpy as np
import torch

from gamd_tpu_torch.core import space
from gamd_tpu_torch.core.device import card_line
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.neighbors.dense import build_nbrs
from gamd_tpu_torch.ops.encoder import fused_edge_encoder
from gamd_tpu_torch.physics.lennard_jones import lj_fluid_box
from gamd_tpu_torch.tools import bench_large, probe_gather, profile_step
from gamd_tpu_torch.tools.bench_large import (LARGE_MD, lj_large,
                                              seeded_force_field)
from gamd_tpu_torch.tools.profile_step import exclusive_times, traced_spans
from gamd_tpu_torch.tools.time_conv import device_us
from gamd_tpu_torch.tools.time_forward import median_ms
from gamd_tpu_torch.train.checkpoint import load_self_describing

CKPT = "results/ckpts/lj_relabel_latest.msgpack"
LANE_ITERS = 2000
LARGE_SIZES = (4096, 10_000)
LARGE_K = 96
WARM_STEPS, TIMED_STEPS, TRACED_STEPS = 20, 100, 20


def encoder_inputs(dev):
    """The deployment's encoder call: (call(b, fn=fused_edge_encoder), live
    edges of the first frame), fn on b of 16 jittered LJ-258 frames with
    the checkpoint's lists and weights."""
    state, cfg, system = load_self_describing(CKPT)
    p = state.params
    weights = [torch.as_tensor(p[name], device=dev) for name in (
        "edge_encoder_w0", "edge_encoder_b0", "edge_encoder_w1",
        "edge_encoder_b1", "edge_encoder_w2", "edge_encoder_b2",
        "edge_ln_scale", "edge_ln_bias")]
    kw = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high,
              rbf_gap=cfg.rbf_gap, flip_dir=cfg.flip_dir)
    scales = (state.length_stat.safe_mean, max(state.length_stat.std, 1e-12))
    _, lattice = lj_fluid_box(system.n_atoms, 0.5)
    frames = lattice[None] + np.random.default_rng(10).normal(
        0.0, 0.1, (16, *lattice.shape))
    pos = space.wrap(torch.as_tensor(frames.astype(np.float32), device=dev),
                     system.box)
    lists = [build_nbrs(f, system) for f in pos]
    idx = torch.stack([t[0] for t in lists])
    mask = torch.stack([t[1] for t in lists])

    def call(b, fn=fused_edge_encoder):
        return fn(pos[:b], idx[:b], mask[:b], system.box, system.cutoff,
                  *scales, *weights, **kw)

    return call, int(call(1)[1].sum())


def large_n(dev, n):
    """Steps/s and device time a step of the banded MD at n atoms."""
    system, pos = lj_large(n, LARGE_K, dev)
    sim = Simulation(seeded_force_field(system, dev).banded_force_fn(),
                     system, LARGE_MD, nbr_method="cell", device=dev)
    st = sim.init_state(pos, rng=torch.Generator(dev).manual_seed(16))
    warm = sim.run(st, WARM_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(warm.state, TIMED_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    kernels, _ = exclusive_times(traced_spans(
        lambda: sim.run(res.state, TRACED_STEPS), 1))
    step_us = sum(v["us"] for v in kernels.values()) / TRACED_STEPS
    names = getattr(profile_step, "ENCODER_KERNELS", ())
    enc_us = sum(v["us"] for k, v in kernels.items()
                 if k in names) / TRACED_STEPS
    return {"steps_per_s": TIMED_STEPS / seconds,
            "device_us_per_step": step_us,
            "encoder_us_per_step": enc_us if names else None,
            "finite": bool(torch.isfinite(res.state.pos).all())}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    save = argv[argv.index("--save") + 1] if "--save" in argv else None
    if not torch.cuda.is_available():
        raise RuntimeError("time_encoder needs a CUDA card")
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    line = {"card": card}
    with torch.no_grad():
        call, live = encoder_inputs(dev)
        if save:
            torch.save({f"encoder_b{b}": [t.cpu() for t in call(b)]
                        for b in (1, 16)}, save)
        for b in (1, 16):
            line[f"encoder_b{b}"] = {
                "live_edges_frame0": live,
                "device_us": device_us(lambda: call(b)),
                "ms": median_ms(lambda: call(b), 20)}
        idx, tbl = probe_gather.probe_inputs()
        for form in probe_gather.LANE_FORMS:
            x = probe_gather.form_inputs(form, idx, tbl, dev)
            ms = median_ms(lambda: probe_gather.call(x, form, LANE_ITERS), 5)
            line[form] = {"ms": ms, "us_per_iter": ms * 1e3 / LANE_ITERS}
        for n in LARGE_SIZES:
            line[f"large_n_{n}"] = large_n(dev, n)
        line["bench_large"] = bench_large.main(
            ["--sizes", "4096", "--gnn_size", "0", "--gnn_banded_sizes",
             *[str(n) for n in LARGE_SIZES], "--steps", "400"])
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
