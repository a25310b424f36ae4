"""Times of the whole-model forward and the fused MD window on the card, at
one system and at R replicas: mega_forward ms a call and mega_md_steps ms
a 20-step window on the LJ-258 slice (GAMD-small, seeded weights, the
start frame with K=48; at R the start frame and R - 1 copies jittered by a
seeded 0.05 A, each with its own list, as chip_smoke.py phases 35-36).
CUDA events, the median of single calls after warm-up calls. It uses only
the public API of gamd_tpu_torch.ops.mega, so it can time another tree's
package: put that tree first on PYTHONPATH and run this file by its path.

    python3 -m gamd_tpu_torch.tools.time_forward [R]

Prints the card line, then one JSON line. Needs a CUDA card.
"""

import json
import sys

import numpy as np
import torch

from gamd_tpu_torch.core import space
from gamd_tpu_torch.core.device import card_line
from gamd_tpu_torch.md.integrators import maxwell_boltzmann_velocities
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.neighbors.dense import build_nbrs
from gamd_tpu_torch.ops.mega import mega_forward, mega_md_steps, pack_params
from gamd_tpu_torch.tools.lj_slice import K_MODEL, lj_slice


def median_ms(fn, reps, warmup=3):
    """Median of `reps` single-call device times (CUDA events), in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    replicas = int(argv[0]) if argv else 8
    if not torch.cuda.is_available():
        raise RuntimeError("time_forward needs a CUDA card")
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    system, model_cfg, md, state, pos = lj_slice(dev, seed=0)
    n = system.n_atoms
    mp = pack_params(state.params, model_cfg, force_std=state.force_stat.std,
                     force_mean=state.force_stat.safe_mean,
                     unit=system.force_unit_to_internal, device=dev)
    h0 = torch.as_tensor(state.params["node_emb"], device=dev).expand(
        n, model_cfg.encoding_size).contiguous()
    scalars = (system.box, system.cutoff, state.length_stat.safe_mean,
               state.length_stat.std)
    sim = Simulation(lambda p, i, m: p, system, md, device=dev)
    c1, hdt, c2col = sim._baoab_constants()
    seed = torch.tensor([20261017], dtype=torch.int32, device=dev)
    gen = np.random.default_rng(35)
    frames = torch.stack([pos] + [space.wrap(pos + torch.as_tensor(
        gen.normal(0.0, 0.05, pos.shape).astype(np.float32), device=dev),
        system.box) for _ in range(replicas - 1)])
    line = {"card": card, "replicas": replicas,
            "window_steps": md.rebuild_every}
    for r, p in ((1, pos), (replicas, frames)):
        idx, mask, ovf = build_nbrs(p, system, K_MODEL)
        if bool(ovf):
            raise RuntimeError("neighbour overflow")
        hh = h0 if r == 1 else h0.expand(r, -1, -1).contiguous()
        args = (p, idx, mask, hh, mp, *scalars)
        kw = dict(rbf_gap=model_cfg.rbf_gap)
        force = mega_forward(*args, **kw)
        vel = maxwell_boltzmann_velocities(
            torch.Generator(dev).manual_seed(2), sim.masses, md.temperature,
            n_replicas=None if r == 1 else r)
        wkw = dict(n_steps=md.rebuild_every, c1=c1, hdt=hdt,
                   c2col=c2col.contiguous(), seed=seed, **kw)
        line[f"forward_ms_r{r}"] = median_ms(
            lambda: mega_forward(*args, **kw), 20)
        line[f"window_ms_r{r}"] = median_ms(
            lambda: mega_md_steps(p, vel, force, idx, mask, hh, mp, *scalars,
                                  sim.masses, **wkw), 10)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
