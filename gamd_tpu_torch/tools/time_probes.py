"""Times of the sublane gather (row 16 of the port's kernel table), of the
Nose-Hoover chain probe's two forms (rows 18-19) and of the tensor-core
probe's repeat body (row 11) on the card, each beside its bound:

* sublane_gather (csrc/gather_forms.cu) on tools/probe_gather.py's inputs
  at iters 200 (the script's max(200, iters // 10) at its default 2,000):
  one call's device time by CUDA events (bench_mxu.call_ms: median of 5,
  the card kept busy while the host issues the call), over iters; its
  share of the bound, each gathered value read once at 128 bytes a clock
  an SM (smem_bound: the card's SMs at its largest SM clock); and
  index_select of the same rows, iters calls replayed from a CUDA graph
  (bench_mxu.graph_ms);
* nhc_chain_probe (csrc/nhc_chain.cu), both forms, at reps 400 on
  tools/probe_nhc_kernel.py's chain: median of 20 calls, over reps; whether
  the warp form's five outputs equal the scalar form's bit for bit; and
  tools.probe_nhc_kernel.chain_bound (the latency of the chain's dependent
  sequence) measured in the same process, each form's share of it;
* mxu_loop("repeat") (csrc/mxu_probe.cu) on tools/bench_mxu.py's inputs
  at iters 200 and 2,000 (bench_mxu.time_stage: median of 5, the card
  kept busy while the host issues the call): us an iteration at each and
  between them, and, where the package has it, bench_mxu.
  repeat_chain_bound (the latency of row 0's dependent sequence, which
  bounds an iteration) measured in the same process.

It uses only the public API, so it can time another tree's package: put
that tree first on PYTHONPATH and run this file by its path.

    python3 -m gamd_tpu_torch.tools.time_probes [--save PATH]

Prints the card line, then one JSON line; --save also writes (torch.save)
the outputs of the kernels that share the two sources, so that two trees'
results can be compared bit for bit: both probe forms at reps 3 and 400,
nhc_half_step on chip_smoke.py phase 18's three cases (nhc_case), and the
lane (both widths), sublane and transpose forms at iters 2 (the carry and
the last result), and every mxu_loop stage of bench_mxu at iters 2 with a
seeded salt (repeat also at iters 200). Needs a CUDA card.
"""

import argparse
import json

import numpy as np
import torch

from gamd_tpu_torch.core import units
from gamd_tpu_torch.core.device import card_line, max_sm_clock_hz
from gamd_tpu_torch.md import integrators as integ
from gamd_tpu_torch.ops import gather_probe, mxu_probe, nhc
from gamd_tpu_torch.tools import bench_mxu, probe_gather, probe_nhc_kernel
from gamd_tpu_torch.tools.bench_mxu import call_ms, graph_ms

SUBLANE_ITERS = 200
SUBLANE_CALLS = 5
NHC_REPS = 400
NHC_CALLS = 20
#: Bytes an SM's shared memory (and L1) delivers a clock: 32 banks of 4.
SMEM_BYTES_PER_CLOCK = 128
#: chip_smoke.py phase 18's nhc_half_step cases: (N, chains or None).
NHC_SHAPES = ((258, None), (10_000, None), (258, 3))
#: The repeat body's iterations a call (bench_mxu's default, and ten times
#: it for the time an iteration between the two).
REPEAT_ITERS = (200, 2000)


def nhc_case(dev, n, r, m=10, seed=18):
    """Phase 18's inputs: thermal argon velocities at 100 K ([r,] n, 3,
    10% hot), a seeded chain ([r,] m) and the chain's constants of the MD
    path (100 K, 25 / ps, 2 fs, n_c = n_ys = 5, ndf = 3n)."""
    rng = np.random.default_rng(seed)
    lead = () if r is None else (r,)
    kt = units.KB * 100.0
    freq = 25.0 / units.PS
    vel = np.sqrt(kt * 1.1 / 39.948) * rng.standard_normal((*lead, n, 3))
    chain = (rng.normal(0, 0.1, (*lead, m)), rng.normal(0, 0.5, (*lead, m)),
             -freq**2 + rng.normal(0, 1.0, (*lead, m)))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    ndf = 3 * n
    return {"vel": f32(vel), "chain": tuple(f32(c) for c in chain),
            "masses": f32(np.full(n, 39.948)), "kt": kt, "ndf": ndf,
            "q": integ.nhc_masses(kt, freq, m, ndf, dev),
            "wdts": integ.nhc_schedule(2.0 * units.FS, 5,
                                       integ._YS_WEIGHTS[5], dev)}


def smem_bound(iters, dev):
    """(least ms of one call of a lane form or the sublane form, GB/s):
    the 256 x 13,056 four-byte values an iteration read once from shared
    memory, at the card's SMs x SMEM_BYTES_PER_CLOCK x its largest SM
    clock (nvidia-smi)."""
    values = probe_gather.ROWS * probe_gather.LANES
    rate = (torch.cuda.get_device_properties(dev).multi_processor_count
            * SMEM_BYTES_PER_CLOCK * max_sm_clock_hz())
    return iters * 4 * values / rate * 1e3, rate / 1e9


def time_sublane(dev):
    """{"ms", "us_per_iter", "share_of_bound", "bound_ms",
    "index_select_ms"} at SUBLANE_ITERS."""
    idx, tbl = probe_gather.probe_inputs()
    x = probe_gather.form_inputs("sublane", idx, tbl, dev)
    bound, _ = smem_bound(SUBLANE_ITERS, dev)
    ms = call_ms(lambda: gather_probe.sublane_gather(
        x["idx"], x["tbl"], SUBLANE_ITERS), tuple, calls=SUBLANE_CALLS)
    _, lib = probe_gather.library_call("sublane", x)
    return {"iters": SUBLANE_ITERS, "ms": ms,
            "us_per_iter": ms * 1e3 / SUBLANE_ITERS,
            "share_of_bound": bound / ms, "bound_ms": bound,
            "index_select_ms": graph_ms(lib, SUBLANE_ITERS)}


def time_nhc(dev):
    """{form: {"ms", "us_per_half_step", "share_of_chain_bound"},
    "warp_equals_scalar", "chain_bound"} at NHC_REPS."""
    inputs = probe_nhc_kernel.probe_inputs(dev)
    outs, out = {}, {"reps": NHC_REPS}
    bound = probe_nhc_kernel.chain_bound(dev)
    for form in nhc.FORMS:
        outs[form] = probe_nhc_kernel.run_form(inputs, form, NHC_REPS)
        ms = call_ms(lambda: probe_nhc_kernel.run_form(inputs, form,
                                                       NHC_REPS),
                     tuple, calls=NHC_CALLS)
        us = ms * 1e3 / NHC_REPS
        out[form] = {"ms": ms, "us_per_half_step": us,
                     "share_of_chain_bound": bound["us_per_half_step"] / us}
    out["warp_equals_scalar"] = all(
        torch.equal(a, b) for a, b in zip(outs["warp"], outs["scalar"]))
    out["chain_bound"] = bound
    return out


def time_repeat(dev):
    """{"ms": {iters: ms}, "us_per_iter": {iters: us}, "us_per_iter_between",
    "chain"} of mxu_loop("repeat") at REPEAT_ITERS on bench_mxu's inputs;
    "chain" is repeat_chain_bound's result, or None in a tree without
    it."""
    _, inputs, k = bench_mxu.stage_inputs(bench_mxu.parse_args([]),
                                          dev)["repeat"]
    ms = {n: bench_mxu.time_stage("repeat", "repeat", inputs, k, n, dev)[1]
          for n in REPEAT_ITERS}
    lo, hi = REPEAT_ITERS
    bound = getattr(bench_mxu, "repeat_chain_bound", None)
    return {"ms": ms, "us_per_iter": {n: t * 1e3 / n for n, t in ms.items()},
            "us_per_iter_between": (ms[hi] - ms[lo]) * 1e3 / (hi - lo),
            "chain": bound(dev) if bound else None}


def outputs(dev):
    """{name: CPU tensor} of the outputs --save writes."""
    out = {}
    inputs = probe_nhc_kernel.probe_inputs(dev)
    for form in nhc.FORMS:
        for reps in (3, 400):
            res = probe_nhc_kernel.run_form(inputs, form, reps)
            for key, t in zip(("xi", "vxi", "g", "total", "ke2"), res):
                out[f"probe_{form}_{reps}_{key}"] = t
    for n, r in NHC_SHAPES:
        case = nhc_case(dev, n, r)
        res = nhc.nhc_half_step(case["vel"], *case["chain"], case["masses"],
                                case["kt"], case["ndf"], case["q"],
                                case["wdts"])
        for key, t in zip(("vel", "xi", "vxi", "g"), res):
            out[f"nhc_half_step_{n}_{r}_{key}"] = t
    idx, tbl = probe_gather.probe_inputs()
    for form in probe_gather.GATHER_FORMS:
        x = probe_gather.form_inputs(form, idx, tbl, dev)
        carry, g = probe_gather.call(x, form, 2, product=True)
        out[f"{form}_carry"], out[f"{form}_result"] = carry, g
    salt = torch.randn((8, 128), device=dev,
                       generator=torch.Generator(dev).manual_seed(31))
    stages = bench_mxu.stage_inputs(bench_mxu.parse_args([]), dev)
    for label, (body, inputs, k) in stages.items():
        for iters in (2, 200) if body == "repeat" else (2,):
            out[f"mxu_{label}_{iters}"] = mxu_probe.mxu_loop(
                body, inputs, salt, iters, k)
    return {k: t.detach().cpu() for k, t in out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save", help="write the outputs here (torch.save)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_probes needs a CUDA card")
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    line = {"card": card, "sublane": time_sublane(dev),
            "nhc": time_nhc(dev), "repeat": time_repeat(dev)}
    if args.save:
        torch.save(outputs(dev), args.save)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
