"""The Nose-Hoover chain (NHC) inside a kernel, on the card: the port of
scripts/probe_nhc_kernel.py, with its constants and its parity check.

The TPU probe asked which representation of the chain lowers (SMEM
scalars or [1, 128] lane vectors). Here both forms of csrc/nhc_chain.cu's
probe kernel (ops.nhc.nhc_chain_probe) build, and the probe asks which is
faster for a chain that is sequential by nature: "scalar", one thread
holding the chain in registers, or "warp", lane j holding element j, the
vector work across lanes and one lane crossing a step of each sweep.

For each form it runs `reps` NHC half-steps of a chain of M = 10 with
n_c = n_ys = 5 (kT 0.8314 kJ/mol, ndf 771, dt 0.01 t0, frequency 5 / t0,
a seeded chain, ke2 = 1.07 ndf kT threaded through the square of each
half-step's scale) and prints
  * parity at reps = 3 against the plain chain: the probe's reference,
    md.integrators._nhc_propagate applied 3 times to one unit-velocity
    carrier whose mass is ke2 / 3 (max abs error over xi, vxi, g and the
    product of the scales; the probe's own scale is 1e-4);
  * microseconds per half-step at --reps (default 400): one call's device
    time, CUDA events, median of 20, over reps;
  * the chain's bound (chain_bound): the latency of its dependent
    sequence, n_c n_ys (M - 1) backward steps (expf and the kick) and as
    many forward steps (the kick and the IEEE division), each step's
    latency timed on one thread (ops.nhc.chain_latency; CUDA events over
    two chain lengths, so that the launch cancels).
The kernel's schedule is the probe's (float64 weights * dt / n_c, rounded
to float32); the reference's is _nhc_propagate's (float32 throughout).

    python3 -m gamd_tpu_torch.tools.probe_nhc_kernel [--reps 400]

Needs a CUDA card; `--cpu` runs the plain version on the CPU and checks
parity only (no times).
"""

import argparse

import numpy as np
import torch

from gamd_tpu_torch.md.integrators import _YS_WEIGHTS, _nhc_propagate
from gamd_tpu_torch.ops.nhc import (FORMS, LATENCY_OPS, chain_latency,
                                    chain_latency_reference, nhc_chain_probe)

M = 10          # chain length (the reference's default)
N_C = 5         # MTS subdivisions
N_YS = 5        # Yoshida-Suzuki order
KT, NDF, DT, FREQ = 0.8314, 771.0, 0.01, 5.0
KE2 = NDF * KT * 1.07   # slightly hot
PARITY_REPS = 3
PARITY_ATOL = 1e-4   # the probe's parity scale
TIMED_CALLS = 20
LATENCY_REPS = 20_000   # chained steps of the shorter latency call
CHECK_REPS = 32         # chained steps of the latency kernel's check
CHECK_ATOL = 1e-5       # its |kernel - plain version| (x of order 1)


def probe_schedule():
    """The probe's [n_c * n_ys] schedule: python floats w * dt / n_c."""
    ys = _YS_WEIGHTS[N_YS]
    return [float(w) * DT / N_C for _ in range(N_C) for w in ys]


def probe_inputs(device, m=M):
    """The probe's chain: {xi, vxi, g [m], ke2 [1], q [m], kt, ndf, wdts}
    (float32 tensors on `device`), from numpy seed 0; a chain of another
    length m than the probe's M takes the probe's constants."""
    q_single = KT / FREQ**2
    q = [NDF * q_single] + [q_single] * (m - 1)
    rng = np.random.default_rng(0)
    xi0 = rng.normal(0, 0.1, m).astype(np.float32)
    vxi0 = rng.normal(0, 0.5, m).astype(np.float32)
    g0 = np.full(m, -(FREQ**2), np.float32)
    ke2 = np.array([KE2], np.float32)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {"xi": f32(xi0), "vxi": f32(vxi0), "g": f32(g0), "ke2": f32(ke2),
            "q": f32(q), "kt": KT, "ndf": NDF, "wdts": f32(probe_schedule())}


def reference(inputs, reps):
    """(xi, vxi, g, product of the scales) of the probe's reference:
    _nhc_propagate applied `reps` times to a unit-velocity carrier of mass
    ke2 / 3, whose mass takes the square of each scale (float64 product of
    the scales, as the probe's)."""
    dev = inputs["xi"].device
    vel = torch.ones((1, 3), device=dev)
    masses = torch.full((1,), KE2 / 3.0, device=dev)
    xi, vxi, g = inputs["xi"], inputs["vxi"], inputs["g"]
    total = 1.0
    for _ in range(reps):
        vel2, xi, vxi, g = _nhc_propagate(
            vel, xi, vxi, g, masses, KT, NDF, inputs["q"], DT, N_C,
            _YS_WEIGHTS[N_YS])
        s = float(vel2[0, 0] / vel[0, 0])
        total *= s
        masses = masses * s * s
    return xi, vxi, g, total


def run_form(inputs, form, reps):
    """nhc_chain_probe of `form` at `reps`: (xi, vxi, g, total, ke2)."""
    keys = ("xi", "vxi", "g", "ke2", "q", "kt", "ndf", "wdts")
    return nhc_chain_probe(*[inputs[k] for k in keys], reps=reps, form=form)


def parity_error(out, ref):
    """The probe's parity: max abs error over xi, vxi, g and the total."""
    xi, vxi, g, total, _ = out
    r_xi, r_vxi, r_g, r_total = ref
    return max(float((xi - r_xi).abs().max()),
               float((vxi - r_vxi).abs().max()),
               float((g - r_g).abs().max()), abs(float(total) - r_total))


def time_call_ms(fn, calls=TIMED_CALLS):
    """Median device time of one call of fn (CUDA events), in ms, after 3
    untimed calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def chain_bound(device, reps=LATENCY_REPS):
    """The latency of the chain's dependent sequence on the card: {"ns":
    {op: ns a step}, "us_per_half_step": n_c n_ys (M - 1) (backward +
    forward), "max_abs_err": the largest |kernel - plain version| of
    CHECK_REPS steps of each op on the card}. A step's latency is
    (t(2 reps) - t(reps)) / reps of one launch each (CUDA events, median
    of 5), so the launch's own time cancels. The sequence left out (g[0]'s
    division and the scale's expf a substep, the ends of the sweeps) makes
    it a lower bound."""
    x = torch.tensor(0.5, device=device)
    ns, err = {}, 0.0
    for op in LATENCY_OPS:
        got = chain_latency(op, CHECK_REPS, x)
        err = max(err, float((got - chain_latency_reference(
            op, CHECK_REPS, x)).abs()))
        t1, t2 = [time_call_ms(lambda n=n: chain_latency(op, n, x), calls=5)
                  for n in (reps, 2 * reps)]
        ns[op] = (t2 - t1) * 1e6 / reps
    steps = N_C * N_YS * (M - 1)
    return {"ns": ns, "us_per_half_step":
            steps * (ns["backward"] + ns["forward"]) / 1e3,
            "max_abs_err": err}


def main(argv=None):
    """Runs the probe; returns {form: {"parity_err", "us_per_half_step",
    "ms_per_call"}} (the times None with --cpu) and, on the card,
    "chain_bound": chain_bound's result."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=400)
    ap.add_argument("--cpu", action="store_true",
                    help="the plain version on the CPU: parity only")
    args = ap.parse_args(argv)
    from gamd_tpu_torch.core.device import resolve_device
    dev = resolve_device("cpu" if args.cpu else "cuda")
    if dev.type == "cuda":
        from gamd_tpu_torch.core.device import card_line
        print(card_line(), flush=True)
    inputs = probe_inputs(dev)
    ref = reference(inputs, PARITY_REPS)
    results = {}
    for form in FORMS:
        err = parity_error(run_form(inputs, form, PARITY_REPS), ref)
        print(f"[{form}] reps={PARITY_REPS} parity max-abs-err {err:.3e} "
              f"(scale {PARITY_ATOL})", flush=True)
        entry = {"parity_err": err, "us_per_half_step": None,
                 "ms_per_call": None}
        if dev.type == "cuda":
            ms = time_call_ms(lambda: run_form(inputs, form, args.reps))
            entry.update(ms_per_call=ms,
                         us_per_half_step=ms * 1e3 / args.reps)
            print(f"[{form}] reps={args.reps}: {ms * 1e3:.1f} us/call -> "
                  f"{ms * 1e3 / args.reps:.3f} us per NHC half-step (CUDA "
                  f"events, median of {TIMED_CALLS})", flush=True)
        results[form] = entry
    if dev.type == "cuda":
        bound = chain_bound(dev)
        results["chain_bound"] = bound
        print("chain latency on one thread (ns a step): " + ", ".join(
            f"{op} {v:.2f}" for op, v in bound["ns"].items())
            + f" -> the chain's dependent sequence {N_C * N_YS} x "
            f"{M - 1} x (backward + forward) = "
            f"{bound['us_per_half_step']:.3f} us per half-step; kernel vs "
            f"plain over {CHECK_REPS} steps max |d| {bound['max_abs_err']:.3e}"
            f" (tolerance {CHECK_ATOL})", flush=True)
    print("probe done", flush=True)
    return results


if __name__ == "__main__":
    main()
