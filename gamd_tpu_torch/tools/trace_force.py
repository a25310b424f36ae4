"""Trace the port's GNN force call and print the device time a step by
kernel (port of scripts/trace_force.py).

Builds GNNForceField on LJ-258 (K=64 at 7.5 + 0.5 A, GAMD-small, seeded
weights) with the compute dtype given and, with the word `pallas`, every
conv layer through the CUDA kernel conv_msg_gather (row 3); runs
`--calls` force calls (200, as the JAX script's scan) under
utils.profiling.profile_trace, which writes the Chrome trace to `--logdir`;
then prints the total device time and the top 35 kernels by device time a
step, with their launches (utils.profiling.kernel_times: the parse that
tools/profile_step.py and profile_train.py share). `bfloat16 pallas` meets
the model's refusal (the conv kernels compute in float32), as a
NotImplementedError with its message.

    python3 -m gamd_tpu_torch.tools.trace_force [float32|bfloat16] [pallas]

It runs on the CUDA card (its name and power limit printed first);
`--cpu` runs the plain versions on the CPU, where the profiler sees no
device, and the table lists host time a step by op instead.
"""

import argparse
import tempfile

import torch

TOP = 35


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("words", nargs="*",
                        help="the dtype (float32 or bfloat16) and, for the "
                             "conv kernel, the word pallas")
    parser.add_argument("--calls", type=int, default=200)
    parser.add_argument("--logdir", default=None,
                        help="where the Chrome trace goes (default: a new "
                             "temporary directory)")
    parser.add_argument("--cpu", action="store_true")
    return parser


def host_times(prof) -> dict:
    """{op: {"us": self host time summed, "count": calls}} of a profiler
    run's CPU ops."""
    return {evt.key: {"us": evt.self_cpu_time_total, "count": evt.count}
            for evt in prof.key_averages() if evt.self_cpu_time_total > 0}


def main(argv=None) -> dict:
    """Traces and prints; returns {"use_pallas", "dtype", "where" (device
    or host), "us_per_step", "kernels": {name: {"us", "count"}}}."""
    args = build_parser().parse_args(argv)
    words = [w for w in args.words if w != "pallas"]
    dtype = words[0] if words else "float32"
    use_pallas = "pallas" in args.words

    from gamd_tpu_torch.core.config import get_preset, lj_model_config
    from gamd_tpu_torch.core.device import card_line, resolve_device
    from gamd_tpu_torch.neighbors.dense import dense_neighbor_list
    from gamd_tpu_torch.physics import lennard_jones as lj
    from gamd_tpu_torch.tools.run_md import pin_fp32
    from gamd_tpu_torch.train.forcefield import GNNForceField
    from gamd_tpu_torch.train.state import init_params
    from gamd_tpu_torch.utils.profiling import kernel_times, profile_trace

    dev = resolve_device("cpu" if args.cpu else "cuda")
    pin_fp32()
    if dev.type == "cuda":
        print(card_line(), flush=True)
    system = get_preset("lj", skin=0.5, nbr_capacity=64)
    model_cfg = lj_model_config(compute_dtype=dtype, use_pallas=use_pallas)
    print("use_pallas:", use_pallas, flush=True)
    ff = GNNForceField(init_params(model_cfg, system, seed=0), system,
                       model_cfg, device=dev)
    _, pos0 = lj.lj_fluid_box(system.n_atoms, 0.5)
    pos = torch.as_tensor(pos0, device=dev)
    idx, mask, _ = dense_neighbor_list(pos, system.box,
                                       system.cutoff + system.skin,
                                       system.nbr_capacity)
    force = ff.force_fn()

    def run(p):
        for _ in range(args.calls):
            p = p + 1e-9 * force(p, idx, mask)
        return p

    run(pos)
    logdir = args.logdir or tempfile.mkdtemp(prefix="gamd_trace_")
    with profile_trace(logdir) as prof:
        run(pos)
    where = "device" if dev.type == "cuda" else "host"
    kernels = kernel_times(prof) if dev.type == "cuda" else host_times(prof)
    if dev.type == "cuda" and not kernels:
        raise RuntimeError("torch.profiler saw no device time on this "
                           "machine; time with CUDA events instead")
    items = sorted(kernels.items(), key=lambda kv: -kv[1]["us"])
    total = sum(v["us"] for v in kernels.values())
    n = args.calls
    print(f"trace: {logdir}/trace.json", flush=True)
    print(f"total {where} time: {total / 1e3:.2f} ms over {n} steps "
          f"-> {total / n:.1f} us/step", flush=True)
    for name, v in items[:TOP]:
        print(f"{v['us'] / n:9.2f} us/step  x{v['count']:6d}  {name[:90]}",
              flush=True)
    return {"use_pallas": use_pallas, "dtype": dtype, "where": where,
            "us_per_step": total / n, "kernels": dict(items[:TOP])}


if __name__ == "__main__":
    main()
