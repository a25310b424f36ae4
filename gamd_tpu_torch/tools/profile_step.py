"""Where the time of the port's MD step goes on the card, on six paths:
per step (one mega_forward per force call) and megastep (one
mega_md_steps call per 20-step window), both on the slice (GAMD-small,
seeded weights, Langevin at 100 K, K=64 built and sliced to 48, rebuild
every 20 steps); and deploy, the LJ deployment (the trained weights of
results/ckpts/lj_relabel_latest.msgpack on the eager use_pallas +
use_pallas_encoder path: one edge_encoder and four conv_msg_gather
launches per force call, K=96 at 7.5 + 1.25 A, Langevin at 100 K and
25/ps, rebuild every 20 steps); and banded, the large-N path at N=10,000
(tools/bench_large.py's LJ fluid and seeded GAMD-small on
GNNForceField.banded_force_fn: one live-edge layout and four banded_msg
calls per force call, the cell list at 7.5 + 0.5 A with K=96, rebuilt
every 20 steps); and nhc,
the per-step path under the Nose-Hoover chain (the slice's system and
weights, nose_hoover at 100 K and 25/ps with M=10, n_c = n_ys = 5: one
mega_forward and two nhc_half_step launches a step); and replicas, the
megastep path with 8 replicas of the slice in lockstep (init_replicas and
run: one mega_md_steps call a window for all of them; a step is one step
of every replica).

For each path it runs from the slice's start frame after a
warm-up, times 40 steps (two windows) on the host clock without the
profiler, then runs the same 40 steps from the same state again traced
with torch.profiler. Prints the card line, then one JSON line per path:
device time per kernel name (summed over the traced window, with launch
counts: each kernel's span, which under programmatic dependent launch
includes its wait for the kernel before it; and each kernel's exclusive
time, what it adds to the device's busy time beyond the spans before
it), wall time per step of both windows, the device's busy time (the
union of the spans) and idle share of each window (1 - busy time / wall
time; the profiler's own host cost inflates the traced one), and the gaps
between the device's busy stretches in the traced window: per step in
all, split at 20 us into
short ones (the device's own turnaround from one queued launch to the
next) and long ones (the device waiting for the host), with the long
ones counted by the activities on either side. On the megastep path it
also gives the host time of each window call of the untraced run (the
call returns once its launches are queued). On the banded path it also
gives the banded message's device time per step (BANDED_KERNELS: the
live-edge layout, the weight splits, the edge tiles and the fix-ups) and
its share of the step's device time, the same of the edge encoder over
the live slots (ENCODER_KERNELS: its weight split and tiles), and the
cell list's time per
rebuild (CUDA events, median of 10 builds at the start frame), whose
PyTorch kernels the breakdown otherwise mixes with the model's.

Each path's line also gives the exclusive device time per step of the
whole-model forward's stages (FORWARD_STAGES: weight split, live flags
and layout, encoder, edge stage, node stages).

    python3 -m gamd_tpu_torch.tools.profile_step [path ...]

runs the named paths (all six without one). Needs a CUDA card; it raises
without one.
"""

import dataclasses
import json
import re
import sys
import time

import numpy as np
import torch

from gamd_tpu_torch.core.config import MDConfig
from gamd_tpu_torch.core.device import card_line
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.ops.banded import banded_conv_message
from gamd_tpu_torch.ops.encoder import fused_edge_encoder
from gamd_tpu_torch.ops.mega import mega_forward, mega_md_steps
from gamd_tpu_torch.ops.nhc import nhc_half_step
from gamd_tpu_torch.tools.bench_large import (LARGE_MD, lj_large,
                                              seeded_force_field)
from gamd_tpu_torch.tools.lj_slice import K_MODEL, lj_slice
from gamd_tpu_torch.train.checkpoint import load_self_describing
from gamd_tpu_torch.train.forcefield import GNNForceField

STEPS = 40    # steps per window: two neighbour-rebuild chunks
PATHS = ("per_step", "megastep", "deploy", "banded", "nhc", "replicas")
REPLICAS = 8                                       # the replicas path's R
CKPT = "results/ckpts/lj_relabel_latest.msgpack"   # the deploy path's weights
BANDED_N, BANDED_K = 10_000, 96                    # the banded path's system
SHORT_GAP_US = 20.0


#: The whole-model forward's kernels (csrc/mega_forward.cu) by the stage
#: each runs: short name -> stage.
FORWARD_STAGES = {
    "split_weights_kernel": "weight split",
    "live_kernel": "live-edge layout",
    "layout_kernel": "live-edge layout",
    "encode_tile_kernel": "encoder (tensor cores)",
    "edge_tile_kernel": "edge stage (tensor cores)",
    "node_fused_kernel[B=4]": "node stages",
    "node_fused_kernel[B=8]": "node stages",
    "node_fused_kernel[B=16]": "node stages",
}


#: The conv message's kernels (csrc/conv_tc.cuh) by short name: rows 3
#: (conv_msg_gather.cu, GatherSrc), 6 (banded_msg.cu, BandSrc), 8
#: (conv_msg.cu, PreSrc), 7 (conv_layer.cu, ClampedSrc, then its node
#: update by atoms a block) and 9 (edge_mlp_agg.cu, PreSrc with the stage
#: policy ThetaStages).
CONV_KERNELS = ("mask_count_kernel", "mask_slots_kernel",
                "split_conv_weights_kernel", "conv_tile_kernel[GatherSrc]",
                "conv_tile_kernel[BandSrc]", "conv_tile_kernel[PreSrc]",
                "conv_tile_kernel[ClampedSrc]",
                "conv_tile_kernel[PreSrc,ThetaStages]", "tile_fixup_kernel",
                "conv_update_kernel[B=4]", "conv_update_kernel[B=8]",
                "conv_update_kernel[B=16]")
#: The conv backward's kernels (csrc/conv_msg_gather_bwd.cu, row 4); the
#: layout and the split weights are the forward's.
CONV_BWD_KERNELS = ("dead_rows_kernel", "conv_bwd_tile_kernel[GatherSrc]",
                    "source_sum_kernel", "tile_fixup_kernel",
                    "wgrad_tc_kernel", "wgrad_sum_kernel")
#: Those of the banded path (row 6 and its per-call layout).
BANDED_KERNELS = ("mask_count_kernel", "mask_slots_kernel",
                  "split_conv_weights_kernel", "conv_tile_kernel[BandSrc]",
                  "tile_fixup_kernel")
#: The edge encoder's kernels (csrc/edge_encoder.cu, row 5): the weight
#: split and the tiles over every slot (AllSlots, fused_edge_encoder) or
#: over a layout's live slots (LiveSlots, live_edge_encoder).
ENCODER_KERNELS = ("split_encoder_weights_kernel",
                   "encoder_tile_kernel[AllSlots]",
                   "encoder_tile_kernel[LiveSlots]")


def short_name(kernel: str) -> str:
    """A readable name for a device kernel: this repo's kernels by their
    own name (the tile kernels with their source policy, and a stage
    policy other than the conv message's; node_fused_kernel and
    conv_update_kernel with their atoms a block, B, whatever benchmark
    form and activations node_fused_kernel takes), PyTorch's by the kernel template and
    the op it runs."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    base = re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()
    rest = name[len(name.split("<", 1)[0]):]
    rows = re.search(r"\b(ClampedSrc|PreSrc|GatherSrc|BandSrc|AllSlots|"
                     r"LiveSlots)\b", rest)
    if rows:   # conv_tile_kernel's, encoder_tile_kernel's
        stages = ",ThetaStages" if re.search(r"\bThetaStages\b", rest) \
            else ""
        return f"{base}[{rows.group(1)}{stages}]"
    width = re.match(r"<(\d+)(?:, ?\d+)*>", rest)   # B, then form, acts
    if base in ("node_fused_kernel", "conv_update_kernel") and width:
        return f"{base}[B={width.group(1)}]"
    ops = re.findall(r"(\w+_kernel_cuda|\w+Functor|\w+_cuda_out)", rest)
    return f"{base}[{ops[-1]}]" if ops else (base or kernel[:60])


def forward_stages(kernels: dict, calls: int) -> dict:
    """Device us per call of each stage of the whole-model forward
    (FORWARD_STAGES), from kernel_times' {short name: {"us", "count"}}."""
    stages = {}
    for name, stage in FORWARD_STAGES.items():
        if name in kernels:
            stages[stage] = stages.get(stage, 0.0) + kernels[name]["us"]
    return {k: round(v / calls, 3) for k, v in stages.items()}


def on_device(evt) -> bool:
    """A device activity of a profiler run (a kernel, copy or memset); user
    annotations such as Optimizer.step's, which span other kernels and the
    gaps between them, are not."""
    return evt.device_type == torch.autograd.DeviceType.CUDA \
        and not getattr(evt, "is_user_annotation", False)


def device_spans(prof) -> list:
    """(start us, end us, short name) of every device activity, by start."""
    return sorted((e.time_range.start, e.time_range.end, short_name(e.name))
                  for e in prof.events() if on_device(e))


def traced_spans(fn, calls, tries=3) -> list:
    """device_spans of `calls` calls of fn in one torch.profiler session
    (device activity only), after an untraced call. Now and then a
    session delivers no device activity at all; such a session is run
    again, up to `tries` sessions. [] if none saw any."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = device_spans(prof)
        if spans:
            return spans
    return []


def exclusive_times(spans) -> tuple:
    """Device time as a partition of the busy time: each activity gets what
    it adds beyond the latest end before it (the running frontier), so
    overlapping spans (a kernel started early by programmatic dependent
    launch, waiting for the one before it) are not counted twice. Returns
    ({short name: {"us", "count"}}, [(gap us, name before, name after)]
    between an activity and the frontier before it)."""
    kernels, gaps = {}, []
    frontier, last = None, None
    for start, end, name in spans:
        if frontier is not None:
            gaps.append((max(0.0, start - frontier), last, name))
        entry = kernels.setdefault(name, {"us": 0.0, "count": 0})
        entry["us"] += max(0.0, end - (start if frontier is None
                                       else max(start, frontier)))
        entry["count"] += 1
        if frontier is None or end >= frontier:
            frontier, last = end, name
    return kernels, gaps


def kernel_times(prof) -> dict:
    """{short name: {"us": device time summed, "count": launches}} of the
    device activities a torch.profiler run saw."""
    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = evt.cuda_time_total
        if on_device(evt) and dev_us > 0:
            entry = kernels.setdefault(short_name(evt.key),
                                       {"us": 0.0, "count": 0})
            entry["us"] += dev_us
            entry["count"] += evt.count
    return kernels


def _simulation(dev, path: str):
    if path == "banded":
        system, pos = lj_large(BANDED_N, BANDED_K, dev)
        ff = seeded_force_field(system, dev)
        return Simulation(ff.banded_force_fn(), system, LARGE_MD,
                          nbr_method="cell", device=dev), pos
    sl = lj_slice(dev)
    if path == "deploy":
        state, model_cfg, system = load_self_describing(
            CKPT, use_pallas=True, use_pallas_encoder=True)
        ff = GNNForceField(state, system, model_cfg, device=dev)
        md = MDConfig(integrator="langevin", temperature=system.temperature,
                      dt_fs=system.dt_fs, friction_per_ps=25.0,
                      rebuild_every=20)
        return Simulation(ff.force_fn(), system, md, device=dev), sl.pos
    ff = GNNForceField(sl.state, sl.system, sl.model_cfg, device=dev)
    md = dataclasses.replace(sl.md, integrator="nose_hoover") \
        if path == "nhc" else sl.md
    sim = Simulation(ff.force_fn(megakernel=True), sl.system, md,
                     k_model=K_MODEL,
                     megastep_fn=(ff.megastep_fn()
                                  if path in ("megastep", "replicas")
                                  else None),
                     device=dev)
    return sim, sl.pos


def profile(dev, path: str) -> dict:
    """The breakdown of one path (see the module docstring)."""
    megastep = path in ("megastep", "replicas")
    sim, pos = _simulation(dev, path)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    start = (sim.init_replicas(pos, REPLICAS, rng=gen) if path == "replicas"
             else sim.init_state(pos, rng=gen))
    state = sim.run(start, STEPS).state                         # warm-up
    rng_state = gen.get_state()
    enqueue = []      # host seconds of each window call (megastep path)
    if megastep:
        window = sim.megastep_fn

        def timed_window(*args, **kwargs):
            t = time.perf_counter()
            out = window(*args, **kwargs)
            enqueue.append(time.perf_counter() - t)
            return out
        sim.megastep_fn = timed_window
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(state, STEPS)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    if megastep:
        sim.megastep_fn = window
    gen.set_state(rng_state)
    launches = (mega_forward.launches + fused_edge_encoder.launches,
                mega_md_steps.launches, banded_conv_message.launches,
                nhc_half_step.launches)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sim.run(state, STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = kernel_times(prof)
    exclusive, gap_list = exclusive_times(device_spans(prof))
    gaps = [g for g, _, _ in gap_list]
    short = [g for g in gaps if g < SHORT_GAP_US]
    sites = {}        # long gaps by the activities on either side
    for g, a, b in gap_list:
        if g >= SHORT_GAP_US:
            site = sites.setdefault(f"{a} -> {b}", [0, 0.0])
            site[0] += 1
            site[1] += g
    total = sum(k["us"] for k in exclusive.values())
    if total <= 0:
        raise RuntimeError("torch.profiler saw no device time on this "
                           "machine; time with CUDA events instead")
    ranked = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["us"]))
    banded = {}
    if path == "banded":
        banded_us = sum(v["us"] for k, v in exclusive.items()
                        if k in BANDED_KERNELS)
        encoder_us = sum(v["us"] for k, v in exclusive.items()
                         if k in ENCODER_KERNELS)
        banded = {"banded_msg_us_per_step": banded_us / STEPS,
                  "banded_msg_device_share": banded_us / total,
                  "encoder_us_per_step": encoder_us / STEPS,
                  "encoder_device_share": encoder_us / total,
                  "cell_list_ms_per_build": cell_list_ms(sim, pos),
                  "rebuild_every": sim.md.rebuild_every}
    return {
        "path": path,
        "replicas": REPLICAS if path == "replicas" else 1,
        "steps": STEPS,
        "force_calls": (mega_forward.launches + fused_edge_encoder.launches
                        - launches[0]),
        "window_calls": mega_md_steps.launches - launches[1],
        "banded_msg_launches": banded_conv_message.launches - launches[2],
        "nhc_half_step_launches": nhc_half_step.launches - launches[3],
        **banded,
        "device_us_per_step": total / STEPS,
        "wall_ms_per_step": wall_plain * 1e3 / STEPS,
        "device_idle_share": 1.0 - total / (wall_plain * 1e6),
        "wall_ms_per_step_traced": wall * 1e3 / STEPS,
        "device_idle_share_traced": 1.0 - total / (wall * 1e6),
        "gap_us_per_step": sum(gaps) / STEPS,
        "short_gap_us_per_step": sum(short) / STEPS,
        "short_gaps": len(short),
        "short_gap_median_us": float(np.median(short)) if short else 0.0,
        "long_gap_us_per_step": (sum(gaps) - sum(short)) / STEPS,
        "long_gaps": len(gaps) - len(short),
        "long_gap_sites": {k: [n, round(us, 1)] for k, (n, us) in sorted(
            sites.items(), key=lambda kv: -kv[1][1])[:8]},
        "host_enqueue_ms_per_window": (
            [round(t * 1e3, 3) for t in enqueue] if megastep else None),
        "kernels_us_per_step": {k: round(v["us"] / STEPS, 3)
                                for k, v in ranked.items()},
        "kernels_exclusive_us_per_step": {
            k: round(v["us"] / STEPS, 3) for k, v in sorted(
                exclusive.items(), key=lambda kv: -kv[1]["us"])},
        "forward_stages_us_per_step": forward_stages(exclusive, STEPS),
        "kernel_launches": {k: v["count"] for k, v in ranked.items()},
    }


def cell_list_ms(sim, pos) -> float:
    """Median of 10 neighbour-list builds of `sim` at `pos` (the cell list
    at cutoff + skin), in ms by CUDA events, after one untimed build."""
    sim._build_nbrs(pos)
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sim._build_nbrs(pos)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None):
    paths = (sys.argv[1:] if argv is None else argv) or PATHS
    unknown = set(paths) - set(PATHS)
    if unknown:
        raise ValueError(f"profile_step: no path {sorted(unknown)}; the "
                         f"paths are {PATHS}")
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    for path in paths:
        print(json.dumps({"card": card, **profile(dev, path)}), flush=True)


if __name__ == "__main__":
    main()
