"""The port's tensor-core probes against the JAX package's probe scripts
(CPU): each stage body of scripts/bench_mxu.py's loop kernel and each
one-hot, lane, sublane and transpose form of scripts/probe_gather.py, run
as the scripts define them (Pallas in interpret mode), against the plain
versions of ops.mxu_probe.mxu_loop and ops.gather_probe's onehot_gather,
lane_gather, sublane_gather and transpose_probe; the two port tools with
--cpu; the launch counters; the launch plans of the mxu, one-hot and
sublane kernels (coverage, shared bytes, one wave, refusals); the repeat
kernel's recurrence transcribed in PyTorch, bit for bit the plain loop.
The CUDA kernels themselves are held against the plain versions in
tests/test_torch_cuda.py and chip_smoke.py, on the card.

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
    _, scale = probe_gather.gathered(x, form)
    if form == "int8_int8":
        assert np.array_equal(out, ref)
    else:
        assert np.abs(out - ref).max() <= 1e-5 * 2 * scale
    assert np.all(out == out[0, 0])


def _jax_gather_form_call(script, form, iters):
    """probe_gather.py's pallas_call for a lane, sublane or transpose form,
    in interpret mode, on the script's own inputs (idxb, the 8-fold repeat
    of each block's indices, and the table and its transpose); returns the
    carry [8, 128]."""
    full = pl.BlockSpec(memory_space=pltpu.VMEM)
    out_sd = jax.ShapeDtypeStruct((8, 128), jnp.float32)
    idx, tbl = probe_gather.probe_inputs()
    idxb = jnp.asarray(np.repeat(idx.reshape(script.N_BLOCKS, script.EB), 8,
                                 axis=0))
    tblt = jnp.asarray(np.ascontiguousarray(tbl.T[:, :script.N_PAD]))
    if form in probe_gather.LANE_FORMS:
        kern = functools.partial(script.kernel_lane, iters=iters,
                                 width=probe_gather.LANE_FORMS[form])
        args = (idxb, tblt)
    elif form == "sublane":
        kern = functools.partial(script.kernel_sublane, iters=iters)
        args = (idxb, jnp.asarray(tbl))
    else:
        kern = functools.partial(script.kernel_transpose, iters=iters)
        args = (tblt,)
    fn = pl.pallas_call(kern, out_shape=out_sd, in_specs=[full] * len(args),
                        out_specs=full, interpret=True)
    return np.asarray(fn(*args))


@pytest.mark.parametrize("form", list(probe_gather.GATHER_FORMS))
def test_gather_form_matches_probe_gather_script(form):
    """The lane (both widths), sublane and transpose forms' plain versions
    at iters 2 on the script's inputs: the carry within 1e-5 of iters x
    the sum of the magnitudes of one iteration's result (iters sum |T[idx]|,
    or 34 sums of |T| for the transpose) of the script's kernel in
    interpret mode, which sums the same fp32 values in another order; every
    carry element the total."""
    script = _load_script("probe_gather")
    assert (script.EB, script.N_BLOCKS) == (probe_gather.EB,
                                            probe_gather.N_BLOCKS)
    idx, tbl = probe_gather.probe_inputs()
    x = probe_gather.form_inputs(form, idx, tbl, "cpu")
    ref = _jax_gather_form_call(script, form, 2)
    out = probe_gather.call(x, form, 2).numpy()
    _, scale = probe_gather.gathered(x, form)
    assert out.shape == ref.shape == (8, 128)
    assert np.abs(out - ref).max() <= 1e-5 * 2 * scale
    assert np.all(out == out[0, 0])


def test_gather_form_products_are_numpy_indexing():
    """product=True returns the last iteration's result, bit for bit the
    numpy gather or transpose of the script's table: TT[:, idx] for both
    lane widths, T[idx] for the sublane form, TT.T for the transpose."""
    idx, tbl = probe_gather.probe_inputs()
    tblt = np.ascontiguousarray(tbl.T)
    expected = {"lane384": tblt[:, idx[:, 0]], "lane128x3": tblt[:, idx[:, 0]],
                "sublane": tbl[idx[:, 0]], "transpose": tblt.T}
    for form, want in expected.items():
        x = probe_gather.form_inputs(form, idx, tbl, "cpu")
        _, g = probe_gather.call(x, form, 1, product=True)
        assert g.dtype == torch.float32 and g.shape == want.shape, form
        assert np.array_equal(g.numpy(), want), form


def test_gather_form_wrappers_refuse_what_they_do_not_take():
    """A lane width other than 384 or 128, width 128 on a table that is not
    384 wide, negative iters, no transposes, a device other than cuda or
    cpu."""
    idx, tbl = probe_gather.probe_inputs()
    x = probe_gather.form_inputs("lane384", idx, tbl, "cpu")
    with pytest.raises(ValueError, match="width"):
        gather_probe.lane_gather(x["idx"], x["tbl"], 2, width=256)
    with pytest.raises(ValueError, match="n_pad 384"):
        gather_probe.lane_gather(x["idx"], x["tbl"][:, :256], 2, width=128)
    with pytest.raises(ValueError, match="iters"):
        gather_probe.sublane_gather(x["idx"], torch.as_tensor(tbl), -1)
    with pytest.raises(ValueError, match="copies"):
        gather_probe.transpose_probe(x["tbl"], 2, copies=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gather_probe.transpose_probe(torch.zeros((256, 384), device="meta"),
                                     2)


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
    """`probe_gather --cpu --iters 2`: one JSON line per variant, all nine
    status OK on parity (the four forms of slice 9, once printed as "not
    ported yet", included), the SUMMARY line last; no kernel launches."""
    before = (dict(gather_probe.onehot_gather.launches),
              dict(gather_probe.lane_gather.launches),
              gather_probe.sublane_gather.launches,
              gather_probe.transpose_probe.launches)
    res = probe_gather.main(["--cpu", "--iters", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    variants = [json.loads(line) for line in lines if line.startswith("{")]
    assert len(variants) == 9 == len(res)
    for key, _, form in probe_gather.VARIANTS:
        assert res[key]["status"] == "OK", res[key]
        assert "error" not in res[key]
    assert "int8" in res["onehot_int8_mixed"]["note"]
    assert lines[-1].startswith("SUMMARY ")
    assert set(json.loads(lines[-1][8:])) == {
        key for key, _, _ in probe_gather.VARIANTS}
    assert (dict(gather_probe.onehot_gather.launches),
            dict(gather_probe.lane_gather.launches),
            gather_probe.sublane_gather.launches,
            gather_probe.transpose_probe.launches) == before


def test_launch_counters_are_keyed_by_body_and_form():
    assert set(mxu_probe.mxu_loop.launches) == set(mxu_probe.BODIES)
    assert set(gather_probe.onehot_gather.launches) == set(
        gather_probe.FORMS)
    assert set(gather_probe.lane_gather.launches) == set(
        gather_probe.LANE_WIDTHS)


def test_probe_entries_refuse_unknown_bodies_and_forms():
    with pytest.raises(ValueError, match="body"):
        mxu_probe.mxu_loop("conv", (), torch.zeros((8, 128)), 2)
    idx, tbl = probe_gather.probe_inputs()
    x = probe_gather.form_inputs("bf16", idx, tbl, "cpu")
    with pytest.raises(ValueError, match="form"):
        gather_probe.onehot_gather(x["idx"], x["tbl"], 2, "lane_384")
    with pytest.raises(ValueError, match="starts"):
        gather_probe.onehot_gather(x["idx"], x["tbl"], 2, "band256")


# -- the kernels' launch plans (ops/mxu_probe.py, ops/gather_probe.py) -------

#: (body, rows, n_pad, k) of every shape the tools and the card tests run:
#: bench_mxu's defaults (768 rows, 8 x 768, n_pad 384, k 48) and the
#: ragged 96-row cases (gather_mm also 6,112 rows, its last CTA's last
#: tile empty; repeat 2 dst rows at k 48).
MXU_SHAPES = [("peak", 512, 0, 1), ("gather_mm", 768, 384, 1),
              ("gather_mm", 6144, 384, 1), ("gather_mm", 96, 384, 1),
              ("gather_mm", 6112, 384, 1), ("gather_full", 768, 384, 1),
              ("gather_full", 96, 384, 1), ("edge_mlp", 768, 0, 1),
              ("edge_mlp", 96, 0, 1), ("repeat", 768, 0, 48),
              ("repeat", 96, 0, 48)]
#: The SM counts of an H100 SXM and an H100 PCIe.
SM_COUNTS = (132, 114)
ONEHOT_SHAPES = [(form, rows, band_tile)
                 for form in gather_probe.FORMS
                 for rows, band_tile in ((13056, 1632), (96, 32), (64, 32))]


def _mxu_plans():
    for body, rows, n_pad, k in MXU_SHAPES:
        for sms in SM_COUNTS:
            plan = mxu_probe.launch_plan(body, rows, n_pad, sms, k)
            yield pytest.param(body, rows, n_pad, k, sms, plan,
                               id=f"{body}-{rows}-{sms}sm")


@pytest.mark.parametrize("body,rows,n_pad,k,sms,plan", list(_mxu_plans()))
def test_mxu_plan_covers_the_output_once(body, rows, n_pad, k, sms, plan):
    """Every element of the [rows, width] carry is written by exactly one
    CTA, and the plan is one the entry takes."""
    mxu_probe.check_plan(body, plan, rows, n_pad, k)
    width = mxu_probe.PEAK_N if body == "peak" else mxu_probe.WIDTH
    hits = np.zeros((rows, width), np.int32)
    for row0, n, col0, cols in mxu_probe.plan_tiles(body, plan, rows):
        hits[row0:row0 + n, col0:col0 + cols] += 1
    assert (hits == 1).all()
    assert plan.ctas % plan.cluster == 0


@pytest.mark.parametrize("body,rows,n_pad,k,sms,plan", list(_mxu_plans()))
def test_mxu_plan_fits_a_block(body, rows, n_pad, k, sms, plan):
    """Shared memory within Hopper's 232,448 bytes a block (none for
    repeat, whose loop runs in registers), threads within the body's
    bound, and gather_mm's persistent CTAs within the SMs unless one more
    row tile a CTA would not fit (6,144 rows on 114 SMs: 128 CTAs of six
    tiles)."""
    assert 0 <= plan.smem <= 232448
    assert (plan.smem == 0) == (body == "repeat")
    assert 0 < plan.threads <= mxu_probe.MAX_THREADS[body]
    assert plan.threads % 32 == 0
    if body == "gather_mm" and plan.ctas > sms:
        assert mxu_probe._smem(body, plan.cols, plan.tile_rows + 32,
                               n_pad) > 232448


def test_mxu_default_plans_fill_the_card():
    """At the script's shapes the plans run 48-128 CTAs at once (the first
    form ran 16-24 blocks; edge_mlp's cluster of 2 measured faster than
    4), peak in 8 clusters of 8 on 64-row tiles, gather_mm at 8 x 768 rows
    on persistent CTAs of six row tiles, no more CTAs than SMs; repeat on
    192 CTAs of two warps, 8 rows a thread, without shared memory."""
    got = {(body, rows): mxu_probe.launch_plan(body, rows, n_pad, 132, k)
           for body, rows, n_pad, k in MXU_SHAPES}
    assert got["peak", 512][:4] == (64, 8, 64, 64)
    assert got["gather_mm", 768].ctas == 96
    assert got["gather_mm", 6144][:3] == (128, 1, 192)
    assert got["gather_full", 768][:2] == (96, 4)
    assert got["edge_mlp", 768][:2] == (48, 2)
    assert got["repeat", 768] == (192, 1, 16, 32, 64, 0)


def _bad_mxu_plans():
    good = mxu_probe.launch_plan("peak", 512, 0, 132)
    yield "peak", 512, 0, good._replace(ctas=good.ctas + 8), "ctas"
    yield "peak", 512, 0, good._replace(smem=good.smem - 16), "smem"
    yield "peak", 512, 0, good._replace(threads=256), "threads"
    yield "peak", 512, 0, good._replace(cluster=16, cols=32), "cluster"
    yield "peak", 512, 0, good._replace(cluster=4, cols=128, ctas=32), \
        "cluster 8"
    yield "peak", 512, 0, good._replace(tile_rows=32, ctas=128), "64 rows"
    mm = mxu_probe.launch_plan("gather_mm", 768, 384, 132)
    yield "gather_mm", 768, 384, mm._replace(cluster=2), "cluster"
    yield "gather_mm", 768, 384, mm._replace(cols=64, ctas=48), "cols"
    yield "gather_mm", 768, 384, mm._replace(tile_rows=48), "tile_rows"
    yield "gather_mm", 768, 384, mm._replace(tile_rows=288, ctas=12,
                                             threads=1152), "threads"
    yield "gather_mm", 768, 768, mxu_probe.launch_plan(
        "gather_mm", 768, 384, 132), "n_pad"
    yield "gather_full", 768, 384, mxu_probe.launch_plan(
        "gather_full", 768, 384, 132)._replace(cluster=8, cols=16), "cols"
    em = mxu_probe.launch_plan("edge_mlp", 768, 0, 132)
    yield "edge_mlp", 768, 0, em._replace(ctas=96 * 2), "ctas"
    yield "repeat", 768, 0, mxu_probe.launch_plan(
        "repeat", 768, 0, 132)._replace(cols=64), "repeat"
    yield "repeat", 768, 0, mxu_probe.Plan(24, 1, 32, 128, 256, 512), \
        "the first form's split"


@pytest.mark.parametrize("body,rows,n_pad,plan,why", list(_bad_mxu_plans()))
def test_mxu_inconsistent_plan_is_refused(body, rows, n_pad, plan, why):
    """check_plan, the C entry's check in Python, refuses a plan that is
    not the body's split, whose fields disagree with it, or that exceeds
    the card's limits."""
    with pytest.raises(ValueError, match="inconsistent"):
        mxu_probe.check_plan(body, plan, rows, n_pad)


# -- the repeat body's redesign: its split and its recurrence -----------------

@pytest.mark.parametrize("rows,k", [(768, 48), (96, 48), (6144, 48),
                                    (768, 12), (64, 8), (96, 3)])
@pytest.mark.parametrize("sms", SM_COUNTS)
def test_repeat_plan_is_a_wave_of_rows_sharing_their_dst_row(rows, k, sms):
    """repeat's plan fills at least one wave of the SMs wherever 2-row CTAs
    do, each thread's PER rows lie in one dst row (PER divides k), PER is
    the largest of 8, 4, 2, 1 that keeps the wave, and the plan covers the
    carry once."""
    plan = mxu_probe.launch_plan("repeat", rows, 0, sms, k)
    mxu_probe.check_plan("repeat", plan, rows, 0, k)
    per = plan.tile_rows // (plan.threads // 32)
    assert per in mxu_probe.REPEAT_PER and k % per == 0
    assert plan.ctas == rows // plan.tile_rows * 4
    if rows * 128 // 64 >= sms:
        assert plan.ctas >= sms
    for bigger in mxu_probe.REPEAT_PER:
        if bigger > per and k % bigger == 0 and rows % (2 * bigger) == 0:
            assert rows // (2 * bigger) * 4 < sms, bigger
    hits = np.zeros((rows, 128), np.int32)
    for row0, n, col0, cols in mxu_probe.plan_tiles("repeat", plan, rows):
        hits[row0:row0 + n, col0:col0 + cols] += 1
        assert all((r + per - 1) // k == r // k
                   for r in range(row0, row0 + n, per))
    assert (hits == 1).all()


def test_repeat_plan_refuses_rows_that_straddle_dst_rows():
    """A plan whose thread rows (PER) do not divide k, the first form's
    split (24 blocks of 256 threads on 32-row tiles), another thread count
    or shared memory: refused for the shape the kernel would read
    wrongly."""
    good = mxu_probe.launch_plan("repeat", 768, 0, 132, 48)
    mxu_probe.check_plan("repeat", good, 768, 0, 48)
    bad = [(good, 12), (good, 1),
           (mxu_probe.Plan(24, 1, 32, 128, 256, 512), 48),
           (good._replace(threads=128), 48), (good._replace(smem=512), 48),
           (good._replace(tile_rows=32, ctas=96), 48),
           (good._replace(ctas=good.ctas + 4), 48)]
    for plan, k in bad:
        with pytest.raises(ValueError, match="inconsistent"):
            mxu_probe.check_plan("repeat", plan, 768, 0, k)


def _repeat_kernel_transcription(dst, k, salt, iters, plan):
    """The repeat kernel's arithmetic in PyTorch, CTA by CTA of the plan
    (csrc/mxu_probe.cu RepeatBody<PER>): each thread carries row 0 of its
    column and PER rows of one dst row; per iteration keep = carry0 1e-30,
    x = (d + keep) + salt 1e-30 once a thread, carry0 = carry0 0.5 + ((d0
    + keep) + salt 1e-30), each row acc 0.5 + x; every operation rounded
    to float32 on its own."""
    rows = dst.shape[0] * k
    per = plan.tile_rows // (plan.threads // 32)
    out = torch.full((rows, 128), float("nan"))
    salt_term = salt[0, 0] * mxu_probe.KEEP
    for row0, _, col0, cols in mxu_probe.plan_tiles("repeat", plan, rows):
        c = slice(col0, col0 + cols)
        for w in range(plan.threads // 32):
            r = row0 + w * per
            d0, d = dst[0, c], dst[r // k, c]
            carry0 = torch.zeros(cols)
            acc = torch.zeros((per, cols))
            for _ in range(iters):
                keep = carry0 * mxu_probe.KEEP
                x = (d + keep) + salt_term
                carry0 = carry0 * 0.5 + ((d0 + keep) + salt_term)
                acc = acc * 0.5 + x
            out[r:r + per, c] = acc
    return out


@pytest.mark.parametrize("tile_n,k,iters", [(4, 8, 7), (2, 48, 3),
                                            (3, 12, 200)])
def test_repeat_kernel_recurrence_is_the_plain_loop_bit_for_bit(tile_n, k,
                                                                 iters):
    """The kernel's recurrence (row 0 carried in registers, one broadcast
    value a thread), transcribed over the plan's CTAs, equals
    repeat_reference bit for bit on seeded values, and the row-0 chain
    alone (repeat_chain, its plain version on the CPU) equals its row 0."""
    rng = np.random.default_rng(tile_n * k + iters)
    dst = torch.as_tensor(rng.standard_normal((tile_n, 128)).astype(
        np.float32))
    salt = torch.as_tensor(rng.standard_normal((8, 128)).astype(np.float32))
    plan = mxu_probe.launch_plan("repeat", tile_n * k, 0, 132, k)
    want = mxu_probe.repeat_reference(dst, k, salt, iters)
    got = _repeat_kernel_transcription(dst, k, salt, iters, plan)
    assert torch.equal(got, want)
    assert torch.equal(mxu_probe.repeat_chain_reference(
        dst[0], salt[0, 0], iters), want[0])
    before = dict(mxu_probe.mxu_loop.launches)
    assert float(mxu_probe.repeat_chain(dst[0, 5], salt[0, 0], iters)) == \
        float(want[0, 5])
    assert torch.equal(mxu_probe.mxu_loop("repeat", (dst,), salt, iters, k),
                       want)
    assert mxu_probe.mxu_loop.launches == before
    with pytest.raises(ValueError, match="reps"):
        mxu_probe.repeat_chain(dst[0, 0], salt[0, 0], 0)


@pytest.mark.parametrize("form,rows,band_tile", ONEHOT_SHAPES)
def test_onehot_plan_covers_every_row_and_lane_once(form, rows, band_tile):
    """Every (edge row, table lane) of an iteration's product is computed
    by exactly one unit of one CTA; at most one wave (ctas <= SMs)."""
    plan = gather_probe.launch_plan(form, rows, 384, 132)
    gather_probe.check_plan(form, plan, rows, 384)
    assert plan.ctas <= 132
    hits = np.zeros((rows, gather_probe.LANES), np.int32)
    for _, row0, n, lane0, lanes in gather_probe.plan_units(plan, rows):
        hits[row0:row0 + n, lane0:lane0 + lanes] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("form,rows,band_tile", ONEHOT_SHAPES)
def test_onehot_plan_fits_a_block(form, rows, band_tile):
    """Shared memory within 232,448 bytes: the whole table resident in the
    form's type (bf16 2 bytes a value, int8 1), and the tail."""
    plan = gather_probe.launch_plan(form, rows, 384, 132)
    assert 0 < plan.smem <= 232448
    value_bytes = 1 if form == "int8_int8" else 2
    assert plan.smem == 1024 + 384 * 256 * value_bytes + 128
    assert plan.threads == 256


def test_onehot_default_plan_is_one_wave():
    """At probe_gather's shapes: 132 persistent CTAs on an H100's 132 SMs
    over 204 row tiles of 64 rows (the first form: 816 blocks in 6.2
    waves), a fewer count on a smaller card or a shorter stream."""
    plan = gather_probe.launch_plan("bf16", 13056, 384, 132)
    assert (plan.ctas, plan.units) == (132, 204)
    assert gather_probe.launch_plan("bf16", 13056, 384, 114).ctas == 114
    assert gather_probe.launch_plan("bf16", 96, 384, 132).ctas == 2


def _bad_onehot_plans():
    good = gather_probe.launch_plan("bf16", 13056, 384, 132)
    yield good._replace(ctas=0), "no CTA"
    yield good._replace(ctas=133), "more CTAs than SMs"
    yield good._replace(smem=good.smem - 1024), "smem"
    yield good._replace(threads=128), "threads"
    yield good._replace(units=good.units + 1), "units"
    yield gather_probe.launch_plan("bf16", 13056, 256, 132), "n_pad"
    yield gather_probe.launch_plan("int8_int8", 13056, 384, 132), "form"


@pytest.mark.parametrize("plan,why", list(_bad_onehot_plans()))
def test_onehot_inconsistent_plan_is_refused(plan, why):
    """check_plan, the C entry's check in Python, refuses a plan that is
    not launch_plan's for the shape (no CTA or more than the SMs, other
    shared bytes, threads or row tiles)."""
    with pytest.raises(ValueError, match="inconsistent"):
        gather_probe.check_plan("bf16", plan, 13056, 384)


#: (rows, n_pad) of the sublane plans: probe_gather.py's stream and
#: table, a small one, two ragged streams (the last block of a slice
#: short) and one longer than a wave holds.
SUBLANE_SHAPES = [(13056, 384), (32, 32), (100, 384), (13001, 384),
                  (4 * 13056, 384)]


@pytest.mark.parametrize("rows,n_pad", SUBLANE_SHAPES)
def test_sublane_plan_covers_every_edge_and_lane_once(rows, n_pad):
    """Every (edge, table lane) of an iteration is gathered by exactly one
    thread of one block (sublane_cover walks the kernel's blocks, threads
    and edges), and the plan is its own check's."""
    plan = gather_probe.sublane_plan(rows, n_pad, 132)
    gather_probe.check_sublane_plan(plan, rows, n_pad, 132)
    assert (gather_probe.sublane_cover(plan, rows) == 1).all()


@pytest.mark.parametrize("rows,n_pad", SUBLANE_SHAPES)
def test_sublane_plan_fits_a_block(rows, n_pad):
    """A block's slice (n_pad rows x 64 lanes of fp32) within 232,448
    bytes, 256 threads; the blocks an SM holds fit its 233,472 bytes and
    the 512 threads the kernel's launch bounds leave registers for; at
    most 16 edges a thread (the kernel's registers)."""
    plan = gather_probe.sublane_plan(rows, n_pad, 132)
    assert 0 < plan.smem == 4 * n_pad * 64 <= 232448
    assert plan.threads == 256
    per_sm = gather_probe.sublane_blocks_per_sm(n_pad)
    assert per_sm >= 1
    assert per_sm * (plan.smem + plan.threads // 8 + 1024) <= 233472
    assert per_sm * plan.threads <= 512
    assert gather_probe.SUBLANE_AT_ONCE <= plan.span <= 256


def test_sublane_default_plan_is_one_wave():
    """At probe_gather's shapes on 132 SMs: 64-lane slices (96 KB, two
    blocks an SM), 66 blocks on each of the 4 slices, 198 edges a block:
    264 blocks, one wave. A stream of four times the rows needs more edges
    a block than a thread holds: 256 a block, more than one wave."""
    plan = gather_probe.sublane_plan(13056, 384, 132)
    assert plan == gather_probe.SublanePlan(66, 198, 256, 98304)
    assert gather_probe.sublane_blocks_per_sm(384) == 2
    assert plan.per_slice * 4 == 2 * 132
    long = gather_probe.sublane_plan(4 * 13056, 384, 132)
    assert long.span == 256 and long.per_slice * 4 > 2 * 132
    assert gather_probe.sublane_plan(32, 32, 132).per_slice == 2


def _bad_sublane_plans():
    good = gather_probe.sublane_plan(13056, 384, 132)
    yield good._replace(per_slice=good.per_slice + 1), "blocks a slice"
    yield good._replace(span=good.span - 1), "edges a block"
    yield good._replace(threads=128), "threads"
    yield good._replace(smem=good.smem - 1024), "smem"
    yield gather_probe.sublane_plan(13056, 384, 114), "another card's"
    yield gather_probe.sublane_plan(13056, 256, 132), "n_pad"
    yield gather_probe.sublane_plan(13000, 384, 132), "rows"


@pytest.mark.parametrize("plan,why", list(_bad_sublane_plans()))
def test_sublane_inconsistent_plan_is_refused(plan, why):
    """check_sublane_plan, the C entry's check in Python, refuses a plan
    that is not sublane_plan's for the shape (other blocks a slice, edges
    a block, threads or shared bytes, another card's, another table's or
    another stream's plan); sublane_plan refuses a table whose slice does
    not fit a block."""
    with pytest.raises(ValueError, match="inconsistent"):
        gather_probe.check_sublane_plan(plan, 13056, 384, 132)
    with pytest.raises(ValueError, match="fits a block"):
        gather_probe.sublane_plan(13056, 1024, 132)
