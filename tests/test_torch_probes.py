"""The port's tensor-core probes against the JAX package's probe scripts
(CPU): each stage body of scripts/bench_mxu.py's loop kernel and each
one-hot form of scripts/probe_gather.py, run as the scripts define them
(Pallas in interpret mode), against the plain versions of
ops.mxu_probe.mxu_loop and ops.gather_probe.onehot_gather; the two port
tools with --cpu; the launch counters. The CUDA kernels themselves are
held against the plain versions in tests/test_torch_cuda.py and
chip_smoke.py, on the card.

The scripts are loaded by file path. bench_mxu.py's stage bodies are
closures inside its main(): its module-level `timed` is replaced by a
recorder that calls each stage's jitted pallas_call once with a zero salt
and stops main() before its forward stage.
"""

import functools
import importlib.util
import json
import os
import sys

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gamd_tpu_torch.ops import gather_probe, mxu_probe
from gamd_tpu_torch.tools import bench_mxu, probe_gather

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT_ARGV = ["--cpu", "--iters", "2", "--tile_n", "8", "--k", "8",
               "--n", "64"]
#: max |port - JAX| / max |JAX| of each stage. The one-hot products and the
#: broadcast are exact in fp32; the chains round each bf16 product, and a
#: rounding that flips with the summation order moves an element by a bf16
#: ulp (measured: peak 3.6e-3, gather_full 2.1e-7, edge_mlp 5.6e-5 at
#: these inputs). Such flips are rare, so the mean error of those stages
#: is held to MEAN_RTOL of max |JAX| as well (measured: peak 7.8e-6,
#: gather_full 1.0e-8, edge_mlp 2.6e-7; a chain that skipped the bf16
#: roundings would be at 5.2e-4).
STAGE_RTOL = {"peak": 1e-2, "peak_quarter": 1e-2, "gather_mm": 0.0,
              "gather_mm_8M": 0.0, "gather_full": 1e-2, "edge_mlp": 1e-2,
              "repeat": 0.0}
MEAN_RTOL = 1e-4
STAGE_BODY = {"peak": "peak", "peak_quarter": "peak",
              "gather_mm": "gather_mm", "gather_mm_8M": "gather_mm",
              "gather_full": "gather_full", "edge_mlp": "edge_mlp",
              "repeat": "repeat"}


def _load_script(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Stop(Exception):
    """Ends bench_mxu.py's main() after its repeat stage."""


@pytest.fixture(scope="module")
def jax_stages():
    """{label: (inputs as numpy, output as numpy, iters)} of bench_mxu.py's
    stages, run in interpret mode at SCRIPT_ARGV with a zero salt."""
    script = _load_script("bench_mxu")
    recorded = {}

    def timed(fn, args, iters, label, flops_per_iter, reps=5):
        out = fn(*args, jnp.zeros((8, 128), jnp.float32))
        recorded[label] = ([np.asarray(a.astype(jnp.float32))
                            if a.dtype == jnp.bfloat16 else np.asarray(a)
                            for a in args],
                           np.asarray(out), iters)
        if label == "repeat":
            raise _Stop
        return 1.0

    script.timed = timed
    argv = sys.argv
    sys.argv = ["bench_mxu.py", *SCRIPT_ARGV]
    try:
        with pytest.raises(_Stop):
            script.main()
    finally:
        sys.argv = argv
    return recorded


def _port_inputs(label, arrays):
    """The recorded inputs as the port's tensors: bf16 where the script's
    are bf16, else as recorded."""
    body = STAGE_BODY[label]
    bf16_slots = {"peak": (0, 1), "gather_mm": (0, 1, 2),
                  "gather_full": (1, 2), "edge_mlp": (0,), "repeat": ()}
    return tuple(torch.tensor(a).to(torch.bfloat16)
                 if i in bf16_slots[body] else torch.tensor(a)
                 for i, a in enumerate(arrays))


@pytest.mark.parametrize("label", list(STAGE_RTOL))
def test_mxu_stage_matches_bench_mxu_script(jax_stages, label):
    """Each stage's carry: the port's plain loop against the script's
    Pallas body in interpret mode, same inputs, zero salt."""
    arrays, ref, iters = jax_stages[label]
    body = STAGE_BODY[label]
    k = int(SCRIPT_ARGV[SCRIPT_ARGV.index("--k") + 1])
    out = mxu_probe.mxu_loop(body, _port_inputs(label, arrays),
                             torch.zeros((8, 128)), iters, k).numpy()
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    if STAGE_RTOL[label] == 0.0:
        assert np.array_equal(out, ref), (label, err)
    else:
        scale = np.abs(ref).max()
        assert err <= STAGE_RTOL[label] * scale, (label, err)
        assert np.abs(out - ref).mean() <= MEAN_RTOL * scale, label


def test_bench_mxu_script_stages_are_all_recorded(jax_stages):
    assert set(jax_stages) == set(STAGE_RTOL)


def _jax_onehot_call(script, form, iters, x):
    """probe_gather.py's pallas_call for `form`, in interpret mode, on the
    port's inputs x (as numpy); returns the carry [8, 128]."""
    full = pl.BlockSpec(memory_space=pltpu.VMEM)
    out_sd = jax.ShapeDtypeStruct((8, 128), jnp.float32)
    idx = jnp.asarray(x["idx"].numpy())
    if form == "int8_int8":
        tbl = jnp.asarray(x["tbl"].numpy())
    else:
        tbl = jnp.asarray(x["tbl"].float().numpy()).astype(jnp.bfloat16)
    band = gather_probe.band_of(form)
    if band is not None:
        kern = functools.partial(script.kernel_onehot_banded, iters=iters,
                                 band=band)
        fn = pl.pallas_call(
            kern, out_shape=out_sd,
            in_specs=[full, pl.BlockSpec(memory_space=pltpu.SMEM), full],
            out_specs=full,
            scratch_shapes=[pltpu.VMEM((script.ROWS, band), jnp.bfloat16)],
            interpret=True)
        return np.asarray(fn(idx, jnp.asarray(x["starts"].numpy()), tbl))
    if form == "bf16":
        kern = functools.partial(script.kernel_onehot, iters=iters)
        oh = jnp.bfloat16
    else:
        kern = functools.partial(script.kernel_onehot_int8, iters=iters,
                                 tbl_int8=form == "int8_int8")
        oh = jnp.int8
    fn = pl.pallas_call(
        kern, out_shape=out_sd, in_specs=[full, full], out_specs=full,
        scratch_shapes=[pltpu.VMEM((script.ROWS, script.N_PAD), oh)],
        interpret=True)
    return np.asarray(fn(idx, tbl))


@pytest.mark.parametrize("form", list(gather_probe.FORMS))
def test_onehot_form_matches_probe_gather_script(form):
    """The carry at iters 2 on the script's inputs: within 1e-5 of iters
    sum |T[idx]| of the script's kernel in interpret mode (the two sum
    13,056 x 256 products in another order; measured at most 1.5e-9 of
    it), bit for bit for int8 x int8, whose sums are exact integers."""
    script = _load_script("probe_gather")
    assert (script.ROWS, script.N_PAD, script.N_LIVE, script.LANES) == (
        probe_gather.ROWS, probe_gather.N_PAD, probe_gather.N_LIVE,
        probe_gather.LANES)
    idx, tbl = probe_gather.probe_inputs()
    x = probe_gather.form_inputs(form, idx, tbl, "cpu")
    ref = _jax_onehot_call(script, form, 2, x)
    out = probe_gather.call(x, form, 2).numpy()
    _, scale = probe_gather.gathered(x)
    if form == "int8_int8":
        assert np.array_equal(out, ref)
    else:
        assert np.abs(out - ref).max() <= 1e-5 * 2 * scale
    assert np.all(out == out[0, 0])


def test_probe_gather_inputs_are_the_scripts():
    """probe_inputs draws the script's idx and table: RandomState(0), idx
    first."""
    rng = np.random.RandomState(0)
    idx, tbl = probe_gather.probe_inputs()
    assert np.array_equal(idx, rng.randint(0, 258, (13056, 1)))
    assert np.array_equal(tbl, rng.randn(384, 256).astype(np.float32))


def test_onehot_product_is_the_gathered_rows():
    """product=True returns the last iteration's product: the table rows
    at idx, for a full and a banded form."""
    idx, tbl = probe_gather.probe_inputs()
    for form in ("bf16", "band208"):
        x = probe_gather.form_inputs(form, idx, tbl, "cpu")
        _, g = probe_gather.call(x, form, 1, product=True)
        assert torch.equal(g, x["tbl"].float()[x["idx"][:, 0].long()])


def test_bench_mxu_cpu_run(capsys):
    """`bench_mxu --cpu` at a small size: every stage's carry is the
    geometric sum of its one-iteration output (1e-5), the forward chain is
    finite, no times, and no kernel launches."""
    before = dict(mxu_probe.mxu_loop.launches)
    res = bench_mxu.main(["--cpu", "--iters", "4", "--tile_n", "8", "--k",
                          "8", "--n", "64"])
    assert set(res["stages"]) == {"peak", "gather_mm", "gather_mm_8M",
                                  "gather_full", "edge_mlp", "repeat"}
    for label, entry in res["stages"].items():
        assert entry["parity"] <= bench_mxu.PARITY_RTOL, label
        assert "us_per_iter" not in entry
    assert res["calibration"] is None and res["forward"]["finite"]
    assert mxu_probe.mxu_loop.launches == before
    printed = capsys.readouterr().out
    assert "forward" in printed and "parity" in printed


def test_probe_gather_cpu_run(capsys):
    """`probe_gather --cpu --iters 2`: one JSON line per variant, the five
    one-hot forms status OK on parity, the four forms of slice 9 the
    script's error shape, the SUMMARY line last; no kernel launches."""
    before = dict(gather_probe.onehot_gather.launches)
    res = probe_gather.main(["--cpu", "--iters", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    variants = [json.loads(line) for line in lines if line.startswith("{")]
    assert len(variants) == 9 == len(res)
    for key, _, form in probe_gather.VARIANTS:
        if form is None:
            assert res[key]["error"] == probe_gather.NOT_PORTED
            assert "parity" not in res[key]
        else:
            assert res[key]["status"] == "OK", res[key]
    assert "int8" in res["onehot_int8_mixed"]["note"]
    assert lines[-1].startswith("SUMMARY ")
    assert set(json.loads(lines[-1][8:])) == {
        key for key, _, _ in probe_gather.VARIANTS}
    assert gather_probe.onehot_gather.launches == before


def test_launch_counters_are_keyed_by_body_and_form():
    assert set(mxu_probe.mxu_loop.launches) == set(mxu_probe.BODIES)
    assert set(gather_probe.onehot_gather.launches) == set(
        gather_probe.FORMS)


def test_probe_entries_refuse_unknown_bodies_and_forms():
    with pytest.raises(ValueError, match="body"):
        mxu_probe.mxu_loop("conv", (), torch.zeros((8, 128)), 2)
    idx, tbl = probe_gather.probe_inputs()
    x = probe_gather.form_inputs("bf16", idx, tbl, "cpu")
    with pytest.raises(ValueError, match="form"):
        gather_probe.onehot_gather(x["idx"], x["tbl"], 2, "lane_384")
    with pytest.raises(ValueError, match="starts"):
        gather_probe.onehot_gather(x["idx"], x["tbl"], 2, "band256")
