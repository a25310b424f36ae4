"""Where the time of the port's LJ training step goes on the card, on the
kernel path (use_pallas=True: the conv layers' edge pipeline through the
CUDA kernel pair) and the plain path (use_pallas=False: the same step in
PyTorch ops).

For each path it builds the training slice (tools/lj_train_slice.py:
LJ-258, GAMD-small, K=96, rotation, jitter, dropout, LJ relabel, 4 frames),
runs 4 warm-up steps, times 20 steps on the host clock without the
profiler, then traces 20 more with torch.profiler. Prints the card line,
then one JSON line per path: wall ms per step (untraced and traced),
device time per step and per kernel name (with launch counts), and the
device's idle share (1 - device time / wall time).

    python3 -m gamd_tpu_torch.tools.profile_train

Needs a CUDA card; it raises without one.
"""

import json
import time

import torch

from gamd_tpu_torch.core.device import card_line
from gamd_tpu_torch.ops.conv_gather import fused_conv_gather_message
from gamd_tpu_torch.tools.lj_train_slice import lj_train_slice
from gamd_tpu_torch.tools.profile_step import kernel_times
from gamd_tpu_torch.train.loop import make_train_step
from gamd_tpu_torch.train.state import create_train_state

WARMUP, STEPS = 4, 20


def profile(dev, use_pallas: bool) -> dict:
    sl = lj_train_slice(dev, use_pallas=use_pallas)
    state = create_train_state(sl.model_cfg, sl.system, sl.train_cfg,
                               len(sl.batches), seed=0, device=dev)
    step = make_train_step(state.model, sl.system, sl.train_cfg,
                           relabel_fn=sl.relabel_fn)

    def run(state, n):
        for _ in range(n):
            state, metrics = step(state, sl.batches[state.step
                                                     % len(sl.batches)])
        return state, metrics

    state, _ = run(state, WARMUP)
    torch.cuda.synchronize()
    launches = (fused_conv_gather_message.launches,
                fused_conv_gather_message.backward_launches)
    t0 = time.perf_counter()
    state, _ = run(state, STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = run(state, STEPS)
        torch.cuda.synchronize()
        wall_traced = time.perf_counter() - t0
    kernels = kernel_times(prof)
    total = sum(k["us"] for k in kernels.values())
    if total <= 0:
        raise RuntimeError("torch.profiler saw no device time on this "
                           "machine; time with CUDA events instead")
    ranked = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["us"]))
    return {
        "path": "kernel" if use_pallas else "plain",
        "steps": STEPS,
        "conv_launches": [fused_conv_gather_message.launches - launches[0],
                          fused_conv_gather_message.backward_launches
                          - launches[1]],
        "loss_last": float(metrics["loss"]),
        "wall_ms_per_step": wall * 1e3 / STEPS,
        "wall_ms_per_step_traced": wall_traced * 1e3 / STEPS,
        "device_us_per_step": total / STEPS,
        "device_idle_share": 1.0 - total / (wall * 1e6),
        "device_idle_share_traced": 1.0 - total / (wall_traced * 1e6),
        "kernels_us_per_step": {k: round(v["us"] / STEPS, 3)
                                for k, v in ranked.items()},
        "kernel_launches": {k: v["count"] for k, v in ranked.items()},
    }


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    for use_pallas in (True, False):
        print(json.dumps({"card": card, **profile(dev, use_pallas)}),
              flush=True)


if __name__ == "__main__":
    main()
