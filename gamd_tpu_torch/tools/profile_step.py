"""Where the time of the port's LJ-258 MD step goes on the card.

Runs the first slice (GAMD-small, seeded weights, Langevin at 100 K, K=64
built and sliced to 48, rebuild every 20 steps) after a warm-up, times a
window of 40 steps on the host clock without the profiler, then runs the
same 40 steps from the same state again traced with torch.profiler.
Prints the card line, then one JSON line: device time per kernel name
(summed over the traced window, with launch counts), wall time per step
of both windows, and the device's idle share of each window (1 - device
time / wall time; the profiler's own host cost inflates the traced one).

    python3 -m gamd_tpu_torch.tools.profile_step

Needs a CUDA card; it raises without one.
"""

import json
import re
import subprocess
import time

import torch

from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.ops.mega import mega_forward
from gamd_tpu_torch.tools.lj_slice import K_MODEL, lj_slice
from gamd_tpu_torch.train.forcefield import GNNForceField

STEPS = 40    # steps per window: two neighbour-rebuild chunks


def short_name(kernel: str) -> str:
    """A readable name for a device kernel: this repo's kernels by their
    own name, PyTorch's by the kernel template and the op it runs."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    base = re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()
    rest = name[len(name.split("<", 1)[0]):]
    ops = re.findall(r"(\w+_kernel_cuda|\w+Functor|\w+_cuda_out)", rest)
    return f"{base}[{ops[-1]}]" if ops else (base or kernel[:60])


def _simulation(dev):
    sl = lj_slice(dev)
    ff = GNNForceField(sl.state, sl.system, sl.model_cfg, device=dev)
    sim = Simulation(ff.force_fn(megakernel=True), sl.system, sl.md,
                     k_model=K_MODEL, device=dev)
    return sim, sl.pos


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)

    sim, pos = _simulation(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    state = sim.run(sim.init_state(pos, rng=gen), STEPS).state  # warm-up
    rng_state = gen.get_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(state, STEPS)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    gen.set_state(rng_state)
    launches = mega_forward.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sim.run(state, STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = evt.cuda_time_total
        if evt.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            entry = kernels.setdefault(short_name(evt.key),
                                       {"us": 0.0, "count": 0})
            entry["us"] += dev_us
            entry["count"] += evt.count
    total = sum(k["us"] for k in kernels.values())
    if total <= 0:
        raise RuntimeError("torch.profiler saw no device time on this "
                           "machine; time with CUDA events instead")
    ranked = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["us"]))
    result = {
        "card": card,
        "steps": STEPS,
        "force_calls": mega_forward.launches - launches,
        "device_us_per_step": total / STEPS,
        "wall_ms_per_step": wall_plain * 1e3 / STEPS,
        "device_idle_share": 1.0 - total / (wall_plain * 1e6),
        "wall_ms_per_step_traced": wall * 1e3 / STEPS,
        "device_idle_share_traced": 1.0 - total / (wall * 1e6),
        "kernels_us_per_step": {k: round(v["us"] / STEPS, 3)
                                for k, v in ranked.items()},
        "kernel_launches": {k: v["count"] for k, v in ranked.items()},
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
