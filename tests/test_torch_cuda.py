"""The CUDA kernels mega_forward and mega_md_steps (one system and R
replicas; the forward's live-edge layout stage alone through mega_layout),
the conv-message pair (conv_msg_gather forward and backward; the live-edge
layout from the mask alone through mask_layout), edge_encoder,
banded_msg, nhc_half_step, nhc_chain_probe (both forms), the
op library's gather_agg, edge_mlp_agg, conv_msg and conv_layer, and the
probes' mxu_loop (five bodies), onehot_gather (five forms), lane_gather
(two widths), sublane_gather and transpose_probe against their plain
PyTorch versions, on a Hopper card (capability 9.x); Simulation's replica
path on the card; mega_forward and mega_md_steps with the water model's
bond channel, the eager water model through conv_msg_gather, and the
rigid-water constraints with TF32 allowed; the window under each of the
benchmark's `ablate` stage switches, mega_forward and the window under
the silu/gelu activation pairs, and the banded path's water bond channel
(live_edge_encoder's BOND form, banded_force_fn against mega_forward); the
epoch loop's use_pallas steps (the conv-message pair) against the plain
path for one epoch, and a checkpoint written and read back on the card;
the TIP4P-Ew generator's protocol on the card (PyTorch and no kernel:
it is here for its 90 s, which chip_smoke.py's phases leave out); the
tools nve_drift_probe (rigid TIP3P NVE at 27 molecules) and
analyze_pair_bias (lj_distill_best on generated LJ frames).
Without one every test here skips.

On the card (which has no JAX) run this file without the JAX package's
conftest:  python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py
"""

import ctypes
import dataclasses
import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gamd_tpu_torch.core import units
from gamd_tpu_torch.core.config import MDConfig, ModelConfig, get_preset
from gamd_tpu_torch.md import integrators as integ
from gamd_tpu_torch.md.constraints import RigidWater
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.neighbors.cell_list import cell_list_neighbor_list
from gamd_tpu_torch.neighbors.dense import (build_nbrs, dense_neighbor_list,
                                            refresh_mask)
from gamd_tpu_torch.neighbors.topology import neighbor_bond_channel
from gamd_tpu_torch.ops import (banded, edge_tiles, gather_probe, message,
                                mxu_probe, nhc)
from gamd_tpu_torch.ops import mega as mega_module
from gamd_tpu_torch.ops.conv_gather import (batched_reference,
                                            fused_conv_gather_message)
from gamd_tpu_torch.ops.encoder import (edge_encoder_reference,
                                        encoder_params, fused_edge_encoder,
                                        live_edge_encoder,
                                        live_edge_encoder_reference)
from gamd_tpu_torch.ops.mega import (live_edge_layout, md_steps_reference,
                                     mega_forward, mega_layout,
                                     mega_md_steps, pack_params,
                                     reference_forward)
from gamd_tpu_torch.physics.lennard_jones import lj_fluid_box
from gamd_tpu_torch.physics.water import water_box
from gamd_tpu_torch.tools import (bench_mxu, probe_gather, probe_nhc_kernel,
                                  profile_step)
from gamd_tpu_torch.tools.bench_large import (banded_layer_inputs, lj_large,
                                              seeded_force_field)
from gamd_tpu_torch.train.checkpoint import load_self_describing
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.state import init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX = 12.0
TOLERANCE = 5e-3      # max |dF| / std(F), the reference's fp32 tolerance
WINDOW_ATOL = 2e-4    # pos (A) and vel (A/t0), the reference's megastep atol


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device of capability 9.x (H100)")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("the kernel is built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, n, k, use_ln=True, layers=2, seed=0):
    cfg = ModelConfig(conv_layers=layers, use_layer_norm=use_ln)
    system = get_preset("lj", n_atoms=n, box=BOX, cutoff=4.2,
                        nbr_capacity=k, skin=0.8)
    state = init_params(cfg, system, seed=seed)
    bs = state.batch_stats
    if not use_ln:
        rng = np.random.default_rng(seed)
        for stats in bs["graph_conv"].values():
            stats["mean"] += rng.uniform(-0.2, 0.2, stats["mean"].shape)
            stats["var"] += rng.uniform(0.1, 0.5, stats["var"].shape)
    mp = pack_params(state.params, cfg, batch_stats=bs, force_std=2.0,
                     force_mean=0.1, unit=0.1, device=dev)
    pos = torch.as_tensor(np.random.default_rng(seed + 1).uniform(
        0, BOX, (n, 3)).astype(np.float32), device=dev)
    idx, mask, _ = dense_neighbor_list(pos, BOX, 5.0, k)
    h0 = torch.as_tensor(state.params["node_emb"], device=dev).expand(
        n, cfg.encoding_size).contiguous()
    return (pos, idx, mask, h0, mp, BOX, 4.2, 4.0, 1.2)


@pytest.mark.parametrize("n,k,use_ln,flip", [
    (64, 16, True, False),     # full node blocks
    (66, 20, True, True),      # ragged last tile and node block, flip_dir
    (64, 16, False, False),    # BatchNorm folded into the node affine
])
def test_kernel_matches_plain_version(cuda, n, k, use_ln, flip):
    args = _case(cuda, n, k, use_ln=use_ln)
    before = mega_forward.launches
    out = mega_forward(*args, use_ln=use_ln, flip_dir=flip)
    ref = reference_forward(*args, use_ln=use_ln, flip_dir=flip)
    torch.cuda.synchronize()
    assert mega_forward.launches == before + 1
    assert out.shape == (n, 3) and bool(torch.isfinite(out).all())
    err = float((out - ref).abs().max())
    assert err < TOLERANCE * float(ref.abs().std())


def test_kernel_with_rbf_centres_in_both_column_halves(cuda):
    """80 RBF centres (gap 0.0125): the RBF product's depth crosses into
    the second 64-column half of the tile, which the second warpgroup
    writes; within 5e-3 std(F) of reference_forward."""
    cfg = ModelConfig(conv_layers=2, use_layer_norm=True, rbf_gap=0.0125)
    assert cfg.n_rbf == 80
    system = get_preset("lj", n_atoms=64, box=BOX, cutoff=4.2,
                        nbr_capacity=16, skin=0.8)
    state = init_params(cfg, system, seed=3)
    mp = pack_params(state.params, cfg, force_std=2.0, force_mean=0.1,
                     unit=0.1, device=cuda)
    pos = torch.as_tensor(np.random.default_rng(4).uniform(
        0, BOX, (64, 3)).astype(np.float32), device=cuda)
    idx, mask, _ = dense_neighbor_list(pos, BOX, 5.0, 16)
    h0 = torch.as_tensor(state.params["node_emb"], device=cuda).expand(
        64, cfg.encoding_size).contiguous()
    args = (pos, idx, mask, h0, mp, BOX, 4.2, 4.0, 1.2)
    out = mega_forward(*args, rbf_gap=0.0125)
    ref = reference_forward(*args, rbf_gap=0.0125)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) < TOLERANCE * float(
        ref.abs().std())


def test_kernel_rejects_what_it_does_not_take(cuda):
    pos, idx, mask, h0, mp, *rest = _case(cuda, 64, 16)
    before = mega_forward.launches
    with pytest.raises(ValueError, match="idx"):
        mega_forward(pos, idx.long(), mask, h0, mp, *rest)
    with pytest.raises(ValueError, match="pos"):
        mega_forward(pos.t().contiguous().t(), idx, mask, h0, mp, *rest)
    with pytest.raises(ValueError, match="h0"):
        mega_forward(pos, idx, mask, h0[:, :64].contiguous(), mp, *rest)
    with pytest.raises(ValueError, match="bond"):
        mega_forward(pos, idx, mask, h0, mp, *rest,
                     bond=torch.zeros(idx.shape[0], idx.shape[1] + 1,
                                      device=cuda))
    with pytest.raises(ValueError, match="activation"):
        mega_forward(pos, idx, mask, h0, mp, *rest, conv_act="relu")
    assert mega_forward.launches == before


def _edge_case(dev, k=20):
    """_case(66, k) with the layout's edge cases: atom 3 with no live edge
    (build mask off), atom 5 with all k slots live (its list atoms 6 ..
    6 + k - 1, moved to within 2 A of it), build-time slots past the true
    cutoff, random dead slots."""
    pos, idx, mask, *rest = _case(dev, 66, k)
    rng = np.random.default_rng(5)
    p = pos.cpu().numpy()
    p[6:6 + k] = np.mod(p[5] + rng.uniform(-1.1, 1.1, (k, 3)), BOX)
    ids = np.stack([rng.choice(np.delete(np.arange(66), i), k,
                               replace=False) for i in range(66)])
    ids[5] = np.arange(6, 6 + k)
    live = rng.uniform(size=(66, k)) < 0.8
    live[3] = False
    live[5] = True
    return (torch.as_tensor(p, device=dev),
            torch.as_tensor(ids.astype(np.int32), device=dev),
            torch.as_tensor(live, device=dev), *rest)


_LAYOUT_CASES = {
    "n64": lambda dev: _case(dev, 64, 16),
    "ragged": lambda dev: _case(dev, 66, 20),
    "edge_cases": _edge_case,
    "replicas": lambda dev: _replica_case(dev),
}


@pytest.mark.parametrize("case", list(_LAYOUT_CASES))
def test_layout_kernel_equals_plain_layout(cuda, case):
    """The forward's first stage alone (mega_layout, one launch): per-atom
    offsets and counts, the replica totals and each replica's compacted
    slot ids equal live_edge_layout's exactly (rows past a total are
    unwritten on the card)."""
    pos, idx, mask, h0, mp, box, cutoff, *_ = _LAYOUT_CASES[case](cuda)
    before = mega_layout.launches
    got = mega_layout(pos, idx, mask, box, cutoff)
    want = live_edge_layout(pos, idx, mask, box, cutoff)
    torch.cuda.synchronize()
    assert mega_layout.launches == before + 1
    assert torch.equal(got.offset, want.offset)
    assert torch.equal(got.count, want.count)
    assert torch.equal(got.total, want.total)
    for r, total in enumerate(want.total.tolist()):
        assert torch.equal(got.slot[r, :total], want.slot[r, :total])
    if case == "edge_cases":
        assert int(got.count[0, 3]) == 0 and int(got.count[0, 5]) == 20


@pytest.mark.parametrize("k", [16, 20])
def test_kernel_on_layout_edge_cases(cuda, k):
    """The forward on the layout's edge cases (an atom with no live edge,
    one with all k live; k=20 not a multiple of 16): within 5e-3 std(F)
    of reference_forward."""
    args = _edge_case(cuda, k)
    out = mega_forward(*args)
    ref = reference_forward(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) < TOLERANCE * float(
        ref.abs().std())


def test_mega_forward_is_run_to_run_identical(cuda):
    """Two calls on the same inputs give the same bits (no atomics; sums
    in fixed orders)."""
    args = _case(cuda, 66, 20)
    first = mega_forward(*args)
    second = mega_forward(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_forward_at_full_width_with_trained_weights(cuda):
    """LJ-258 with the trained GAMD-small weights of results/ckpts/
    lj_relabel_latest.msgpack (4 layers, widths 128, 40 RBF centres; the
    nearest 48 of a K=96 list), through GNNForceField.force_fn(
    megakernel=True): within 5e-3 std(F) of reference_forward on the
    same packed weights."""
    state, model_cfg, system = load_self_describing(os.path.join(
        REPO, "results", "ckpts", "lj_relabel_latest.msgpack"))
    ff = GNNForceField(state, system, model_cfg, device=cuda)
    _, lattice = lj_fluid_box(system.n_atoms, 0.5)
    pos = torch.as_tensor(np.mod(lattice + np.random.default_rng(1).normal(
        0.0, 0.05, lattice.shape), system.box).astype(np.float32),
        device=cuda)
    idx, mask, ovf = build_nbrs(pos, system, 48)
    assert not bool(ovf)
    before = mega_forward.launches
    out = ff.force_fn(megakernel=True)(pos, idx, mask)
    torch.cuda.synchronize()
    assert mega_forward.launches == before + 1
    mp = pack_params(state.params, model_cfg,
                     force_std=state.force_stat.std,
                     force_mean=state.force_stat.safe_mean,
                     unit=system.force_unit_to_internal, device=cuda)
    h0 = torch.as_tensor(state.params["node_emb"], device=cuda).expand(
        system.n_atoms, model_cfg.encoding_size).contiguous()
    ref = reference_forward(pos, idx, mask, h0, mp, system.box,
                            system.cutoff, state.length_stat.safe_mean,
                            state.length_stat.std,
                            rbf_gap=model_cfg.rbf_gap)
    assert float((out - ref).abs().max()) < TOLERANCE * float(
        ref.abs().std())


def _window_constants(dev, n, temperature):
    """(c1, hdt, c2col [N], masses [N]) of an LJ Simulation at 2 fs and
    25/ps on `dev`."""
    system = get_preset("lj", n_atoms=n, box=BOX, cutoff=4.2)
    md = MDConfig(integrator="langevin", temperature=temperature)
    sim = Simulation(lambda p, i, m: p, system, md, device=dev)
    c1, hdt, c2col = sim._baoab_constants()
    return c1, hdt, c2col.contiguous(), sim.masses


def _compare_windows(args, vel, force, masses, consts, steps, seed):
    """The kernel window and the plain window from the same inputs; returns
    (max |dx|, max |dv|, kernel outputs)."""
    pos, idx, mask, h0, mp, box, cutoff, lm, ls = args
    c1, hdt, c2col = consts
    kw = dict(n_steps=steps, c1=c1, hdt=hdt, c2col=c2col,
              seed=torch.tensor([seed], dtype=torch.int32,
                                device=pos.device))
    before = mega_md_steps.launches
    out = mega_md_steps(pos, vel, force, idx, mask, h0, mp, box, cutoff, lm,
                        ls, masses, **kw)
    ref = md_steps_reference(pos, vel, force, idx, mask, h0, mp, box,
                             cutoff, lm, ls, masses, **kw)
    torch.cuda.synchronize()
    assert mega_md_steps.launches == before + 1
    assert all(bool(torch.isfinite(t).all()) for t in out)
    torch.testing.assert_close(out[3], ref[3], rtol=1e-4, atol=0)
    return (float((out[0] - ref[0]).abs().max()),
            float((out[1] - ref[1]).abs().max()), out)


@pytest.mark.parametrize("temperature", [0.0, 100.0])
def test_window_kernel_matches_plain_version(cuda, temperature):
    """A ragged N (66) and a K that is not a multiple of 16 (20), 8 steps,
    noise off (0 K) and on (100 K): pos and vel within 2e-4, ke within
    rtol 1e-4 of the plain window on the same inputs."""
    n = 66
    args = _case(cuda, n, 20)
    vel = 0.1 * torch.randn((n, 3), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(3))
    force = reference_forward(*args).contiguous()
    c1, hdt, c2col, masses = _window_constants(cuda, n, temperature)
    dx, dv, out = _compare_windows(args, vel, force, masses,
                                   (c1, hdt, c2col), 8, seed=77)
    assert dx <= WINDOW_ATOL and dv <= WINDOW_ATOL
    assert float((out[0] - args[0]).abs().max()) > 1e-3


def test_window_at_full_width_with_trained_weights(cuda):
    """One 20-step window at 100 K on LJ-258 with the trained GAMD-small
    weights of results/ckpts/lj_relabel_latest.msgpack (K=96 built, the
    nearest 48 kept), through GNNForceField.megastep_fn: pos and vel within
    2e-4 of the plain window, ke within rtol 1e-4."""
    state, model_cfg, system = load_self_describing(os.path.join(
        REPO, "results", "ckpts", "lj_relabel_latest.msgpack"))
    ff = GNNForceField(state, system, model_cfg, device=cuda)
    _, lattice = lj_fluid_box(system.n_atoms, 0.5)
    pos = torch.as_tensor(np.mod(lattice + np.random.default_rng(0).normal(
        0.0, 0.05, lattice.shape), system.box).astype(np.float32),
        device=cuda)
    idx, mask, ovf = build_nbrs(pos, system, 48)
    assert not bool(ovf)
    force = ff.force_fn(megakernel=True)(pos, idx, mask)
    md = MDConfig(integrator="langevin", temperature=100.0)
    sim = Simulation(lambda p, i, m: p, system, md, device=cuda)
    c1, hdt, c2col = sim._baoab_constants()
    vel = 0.1 * torch.randn((system.n_atoms, 3), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(5))
    seed = torch.tensor([9], dtype=torch.int32, device=cuda)
    kw = dict(n_steps=20, c1=c1, hdt=hdt, c2col=c2col.contiguous(),
              masses=sim.masses)
    before = mega_md_steps.launches
    out = ff.megastep_fn()(pos, vel, force, idx, mask, seed, **kw)
    torch.cuda.synchronize()
    assert mega_md_steps.launches == before + 1
    mp = pack_params(state.params, model_cfg,
                     force_std=state.force_stat.std,
                     force_mean=state.force_stat.safe_mean,
                     unit=system.force_unit_to_internal, device=cuda)
    h0 = torch.as_tensor(state.params["node_emb"], device=cuda).expand(
        system.n_atoms, model_cfg.encoding_size).contiguous()
    ref = md_steps_reference(
        pos, vel, force, idx, mask, h0, mp, system.box, system.cutoff,
        state.length_stat.safe_mean, state.length_stat.std, sim.masses,
        n_steps=20, c1=c1, hdt=hdt, c2col=c2col, seed=seed)
    assert float((out[0] - ref[0]).abs().max()) <= WINDOW_ATOL
    assert float((out[1] - ref[1]).abs().max()) <= WINDOW_ATOL
    torch.testing.assert_close(out[3], ref[3], rtol=1e-4, atol=0)


def test_window_rejects_what_it_does_not_take(cuda):
    """The window's own input checks on the card; nothing launches."""
    pos, idx, mask, h0, mp, *rest = _case(cuda, 64, 16)
    c1, hdt, c2col, masses = _window_constants(cuda, 64, 100.0)
    vel = torch.zeros_like(pos)
    seed = torch.tensor([1], dtype=torch.int32, device=cuda)
    kw = dict(n_steps=2, c1=c1, hdt=hdt, c2col=c2col, seed=seed)
    before = mega_md_steps.launches
    with pytest.raises(ValueError, match="seed"):
        mega_md_steps(pos, vel, vel, idx, mask, h0, mp, *rest, masses,
                      **{**kw, "seed": seed.long()})
    with pytest.raises(ValueError, match="seed"):
        mega_md_steps(pos, vel, vel, idx, mask, h0, mp, *rest, masses,
                      **{**kw, "seed": seed.cpu()})
    with pytest.raises(ValueError, match="c2col"):
        mega_md_steps(pos, vel, vel, idx, mask, h0, mp, *rest, masses,
                      **{**kw, "c2col": c2col[:10].contiguous()})
    with pytest.raises(ValueError, match="masses"):
        mega_md_steps(pos, vel, vel, idx, mask, h0, mp, *rest,
                      masses.double(), **kw)
    with pytest.raises(ValueError, match="vel"):
        mega_md_steps(pos, vel.t().contiguous().t(), vel, idx, mask, h0,
                      mp, *rest, masses, **kw)
    with pytest.raises(ValueError, match="idx"):
        mega_md_steps(pos, vel, vel, idx.long(), mask, h0, mp, *rest,
                      masses, **kw)
    with pytest.raises(ValueError, match="bond"):
        mega_md_steps(pos, vel, vel, idx, mask, h0, mp, *rest, masses,
                      bond=torch.zeros_like(mask, dtype=torch.float64),
                      **kw)
    with pytest.raises(ValueError, match="unknown ablate stage"):
        mega_md_steps(pos, vel, vel, idx, mask, h0, mp, *rest, masses,
                      ablate=("tiles",), **kw)
    with pytest.raises(NotImplementedError, match="one ablated stage"):
        mega_md_steps(pos, vel, vel, idx, mask, h0, mp, *rest, masses,
                      ablate=("noise", "agg"), **kw)
    with pytest.raises(NotImplementedError, match="bond"):
        mega_md_steps(pos, vel, vel, idx, mask, h0, mp, *rest, masses,
                      ablate=("agg",), bond=torch.zeros_like(
                          mask, dtype=torch.float32), **kw)
    # 40 replicas: more tiles than two an SM and node blocks wider than 4
    r40 = [t.expand(40, *t.shape).contiguous() for t in (pos, idx, mask, h0)]
    with pytest.raises(NotImplementedError, match="4 atoms a node block"):
        mega_md_steps(r40[0], torch.zeros_like(r40[0]),
                      torch.zeros_like(r40[0]), *r40[1:], mp, *rest, masses,
                      ablate=("agg",), **kw)
    assert mega_md_steps.launches == before


def _conv_inputs(dev, b, n, k, seed=0, e_w=128, d_w=128):
    """e, idx, mask, hn, src_nodes, dst_code [B, N, ...] and the 8 weights
    on `dev` at e width e_w, message width d_w and hidden 128, drawn as
    tests/test_ops.py draws them."""
    rng = np.random.RandomState(seed)
    w = 128
    t = lambda a: torch.as_tensor(a, device=dev)
    f32 = lambda *s, scale: t(rng.randn(*s).astype(np.float32) * scale)
    inputs = [f32(b, n, k, e_w, scale=0.3),
              t(rng.randint(0, n, (b, n, k)).astype(np.int32)),
              t(rng.rand(b, n, k) > 0.3),
              f32(b, n, d_w, scale=0.5), f32(b, n, w, scale=0.5),
              f32(b, n, w, scale=0.3)]
    weights = [f32(*s, scale=0.08) for s in
               [(e_w, w), (w,), (w, w), (w,), (w, w), (w,), (w, d_w),
                (d_w,)]]
    return inputs, weights


def _conv_run(fn, inputs, weights, g):
    """fn's output and the grads of sum(out * g) for e, hn, src, dst and the
    8 weights."""
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (inputs[0], *inputs[3:], *weights)]
    e, hn, src, dst, *ws = leaves
    out = fn(e, inputs[1], inputs[2], hn, src, dst, *ws)
    return out.detach(), torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("b,n,k", [
    (1, 66, 20),      # ragged edge chunk (K=20 is 16 + 4)
    (2, 66, 20),      # a batch: one graph of B*N nodes, summed weight grads
    (1, 258, 96),     # the training slice's shape
])
def test_conv_gather_kernels_match_plain_version(cuda, b, n, k):
    """Forward within 1e-4 of max |agg|, each of the 12 grads within 1e-3
    of its tensor's max |.|, against autograd through the plain version on
    the same card; one forward and one backward launch."""
    inputs, weights = _conv_inputs(cuda, b, n, k, seed=n + k + b)
    g = torch.randn((b, n, 128), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    launches = (fused_conv_gather_message.launches,
                fused_conv_gather_message.backward_launches)
    out, grads = _conv_run(fused_conv_gather_message, inputs, weights, g)
    ref, ref_grads = _conv_run(batched_reference, inputs, weights, g)
    torch.cuda.synchronize()
    assert (fused_conv_gather_message.launches - launches[0],
            fused_conv_gather_message.backward_launches - launches[1]) \
        == (1, 1)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    for a, r in zip(grads, ref_grads):
        assert a.shape == r.shape and bool(torch.isfinite(a).all())
        assert float((a - r).abs().max()) <= 1e-3 * float(r.abs().max())


def test_conv_gather_kernels_are_run_to_run_identical(cuda):
    """No atomics: two runs give bitwise the same forward and grads."""
    inputs, weights = _conv_inputs(cuda, 2, 66, 20, seed=5)
    g = torch.randn((2, 66, 128), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2))
    first = _conv_run(fused_conv_gather_message, inputs, weights, g)
    second = _conv_run(fused_conv_gather_message, inputs, weights, g)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert all(torch.equal(a, b) for a, b in zip(first[1], second[1]))


#: (E, D) of the DFT model.
WIDE = [(256, 256)]


@pytest.mark.parametrize("e_w,d_w", WIDE)
@pytest.mark.parametrize("b,n,k", [(1, 66, 20), (2, 66, 20), (1, 192, 192)])
def test_conv_gather_kernels_at_the_dft_widths(cuda, b, n, k, e_w, d_w):
    """E = D = 256 (H 128): the forward within 1e-4 of max |agg| and each
    of the 12 grads within 1e-3 of its tensor's max, against autograd
    through the plain version on the same card (the 128 case's bars); one
    forward and one backward launch; a second run gives the same bits."""
    inputs, weights = _conv_inputs(cuda, b, n, k, seed=n + k + b + e_w,
                                   e_w=e_w, d_w=d_w)
    g = torch.randn((b, n, d_w), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    launches = (fused_conv_gather_message.launches,
                fused_conv_gather_message.backward_launches)
    out, grads = _conv_run(fused_conv_gather_message, inputs, weights, g)
    assert (fused_conv_gather_message.launches - launches[0],
            fused_conv_gather_message.backward_launches - launches[1]) \
        == (1, 1)
    again = _conv_run(fused_conv_gather_message, inputs, weights, g)
    ref, ref_grads = _conv_run(batched_reference, inputs, weights, g)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    _grads_close(grads, ref_grads)
    assert torch.equal(out, again[0])
    assert all(torch.equal(a, r) for a, r in zip(grads, again[1]))


def test_conv_gather_wide_with_zero_blocks_gives_the_128_bits(cuda):
    """At E = D = 256 with e's, hn's, the cotangent's and the weights'
    second blocks 0, the forward's first 128 columns, every gradient's
    blocks of width 128 and the first row and column blocks of the weight
    gradients are bit for bit the 128-wide call's on the first blocks, and
    the rest is 0: W1's second row block adds exact zeros to the one
    accumulator, W4's first column block runs the 128 case's epilogue, and
    width 128 keeps its products and sums."""
    (e, idx, mask, hn, src, dst), ws = _conv_inputs(cuda, 2, 66, 20, seed=9)
    g = torch.randn((2, 66, 128), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4))
    pad = lambda t, dims: F.pad(t, [x for d in reversed(range(t.ndim))
                                    for x in ((0, 128) if d in dims
                                              else (0, 0))])
    wide_in = [pad(e, {3}), idx, mask, pad(hn, {2}), src, dst]
    wide_ws = [pad(ws[0], {0}), *ws[1:6], pad(ws[6], {1}), pad(ws[7], {0})]
    out, grads = _conv_run(fused_conv_gather_message, [e, idx, mask, hn, src,
                                                       dst], ws, g)
    wout, wgrads = _conv_run(fused_conv_gather_message, wide_in, wide_ws,
                             pad(g, {2}))
    torch.cuda.synchronize()
    assert torch.equal(wout[..., :128], out)
    assert not bool(wout[..., 128:].any())
    firsts = [(slice(None),) * (t.ndim - 1) + (slice(0, 128),)
              for t in grads]
    firsts[4] = (slice(0, 128), slice(None))            # gW1's rows
    for name, a, r, sl in zip(["ge", "ghn", "gsrc", "gdst", "gw1", "gb1",
                               "gw2", "gb2", "gw3", "gb3", "gw4", "gb4"],
                              wgrads, grads, firsts):
        assert torch.equal(a[sl], r), name
        rest = a.clone()
        rest[sl] = 0
        assert not bool(rest.any()), name


def test_conv_gather_refuses_the_widths_it_does_not_take(cuda):
    """E and D unequal or other than 128 and 256, or H other than 128:
    ValueError naming the widths taken, before any launch."""
    before = (fused_conv_gather_message.launches,
              fused_conv_gather_message.backward_launches)
    for e_w, d_w, h_w in ((192, 128, 128), (128, 384, 128),
                          (256, 256, 64), (128, 256, 128), (256, 128, 128)):
        inputs, ws = _conv_inputs(cuda, 1, 32, 16, e_w=e_w, d_w=d_w)
        if h_w != 128:
            inputs[4], inputs[5] = inputs[4][..., :h_w], inputs[5][..., :h_w]
            ws = [ws[0][:, :h_w], ws[1][:h_w], ws[2][:h_w, :h_w],
                  ws[3][:h_w], ws[4][:h_w, :h_w], ws[5][:h_w],
                  ws[6][:h_w], ws[7]]
            ws = [w.contiguous() for w in ws]
            inputs = [x.contiguous() for x in inputs]
        with pytest.raises(ValueError, match="E = D in .128, 256. and "
                                             "H = 128"):
            fused_conv_gather_message(*inputs, *ws)
    assert (fused_conv_gather_message.launches,
            fused_conv_gather_message.backward_launches) == before


def _bwd_case(dev, b, n, k, seed, p_live=0.5):
    """_conv_inputs at a chosen live share, a seeded cotangent, and the
    kernels' and the plain version's outputs and grads."""
    inputs, weights = _conv_inputs(dev, b, n, k, seed=seed)
    rng = np.random.default_rng(seed)
    inputs[2] = torch.as_tensor(rng.random((b, n, k)) < p_live, device=dev)
    g = torch.randn((b, n, 128), device=dev,
                    generator=torch.Generator(dev).manual_seed(seed))
    got = _conv_run(fused_conv_gather_message, inputs, weights, g)
    want = _conv_run(batched_reference, inputs, weights, g)
    torch.cuda.synchronize()
    return inputs, got, want


def _grads_close(got, want):
    for a, r in zip(got, want):
        assert a.shape == r.shape and bool(torch.isfinite(a).all())
        assert float((a - r).abs().max()) <= 1e-3 * float(r.abs().max())


def test_conv_backward_dead_slots_and_straddling_atoms(cuda):
    """ge exactly 0 on every masked slot; at N=66, K=20 with about half the
    slots live, atoms whose live edges straddle a 64-edge tile, whose gdst
    (and every other grad) matches the plain version."""
    inputs, (_, grads), (_, ref) = _bwd_case(cuda, 1, 66, 20, seed=41)
    mask = inputs[2][0]
    lay = edge_tiles.mask_layout(mask.cpu())
    off, cnt = lay.offset[0], lay.count[0]
    straddle = [i for i in range(66) if cnt[i] > 0 and int(off[i]) // 64
                != int(off[i] + cnt[i] - 1) // 64]
    assert straddle
    assert bool((grads[0][0][~mask] == 0).all())
    gdst, gdst_ref = grads[3][0], ref[3][0]
    assert float((gdst[straddle] - gdst_ref[straddle]).abs().max()) \
        <= 1e-3 * float(gdst_ref.abs().max())
    _grads_close(grads, ref)


def test_conv_backward_of_a_mask_with_no_live_edge(cuda):
    """No live edge: every grad exactly 0 (ge at every slot, the node grads
    of every node, the weight and bias grads)."""
    inputs, (out, grads), _ = _bwd_case(cuda, 1, 33, 16, seed=43,
                                        p_live=0.0)
    assert not bool(out.any())
    assert all(not bool(t.any()) for t in grads)


def test_conv_backward_at_a_batch_of_16(cuda):
    """B=16 graphs of the training slice's shape (N=258, K=96, a quarter of
    the slots live, as at 7.5 A): each of the 12 grads within
    CONV_GRAD_RTOL (1e-3) of its max of the plain version."""
    _, (_, grads), (_, ref) = _bwd_case(cuda, 16, 258, 96, seed=47,
                                        p_live=0.22)
    _grads_close(grads, ref)


def test_conv_backward_launches_and_kernels(cuda):
    """One backward launch a call, and the device kernels of a backward are
    profile_step.CONV_BWD_KERNELS' (the first transcription's edge and
    weight-gradient kernels gone)."""
    inputs, weights = _conv_inputs(cuda, 1, 258, 96, seed=5)
    g = torch.randn((1, 258, 128), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(3))
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (inputs[0], *inputs[3:], *weights)]
    e, hn, src, dst, *ws = leaves
    out = fused_conv_gather_message(e, inputs[1], inputs[2], hn, src, dst,
                                    *ws)
    before = fused_conv_gather_message.backward_launches
    spans = profile_step.traced_spans(
        lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 2)
    assert fused_conv_gather_message.backward_launches - before == 3
    names = {name for _, _, name in spans}
    assert set(profile_step.CONV_BWD_KERNELS) <= names
    assert not names & {"bwd_edge_kernel", "wgrad_kernel",
                        "bwd_node_kernel"}


def test_conv_gather_rejects_what_it_does_not_take(cuda):
    """The entry's input checks on the card; nothing launches."""
    (e, idx, mask, hn, src, dst), ws = _conv_inputs(cuda, 1, 32, 16)
    before = fused_conv_gather_message.launches
    with pytest.raises(ValueError, match="idx"):
        fused_conv_gather_message(e, idx.long(), mask, hn, src, dst, *ws)
    with pytest.raises(ValueError, match="mask"):
        fused_conv_gather_message(e, idx, mask.int(), hn, src, dst, *ws)
    with pytest.raises(ValueError, match=": e must"):
        fused_conv_gather_message(e[..., :64], idx, mask, hn, src, dst, *ws)
    with pytest.raises(ValueError, match="hn"):
        fused_conv_gather_message(e, idx, mask, hn.transpose(1, 2)
                                  .contiguous().transpose(1, 2), src, dst,
                                  *ws)
    with pytest.raises(ValueError, match="w1"):
        fused_conv_gather_message(e, idx, mask, hn, src, dst, ws[0].cpu(),
                                  *ws[1:])
    assert fused_conv_gather_message.launches == before


def _encoder_inputs(dev, b, n, k, seed=0, n_rbf=40):
    """b frames of n atoms in the BOX, their lists (built at 5.0 A, the
    encoder's cutoff 4.2 A refines them) and seeded encoder weights
    [4 + n_rbf, 128], [128], ... on `dev`."""
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(0, BOX, (b, n, 3)).astype(np.float32),
                          device=dev)
    lists = [dense_neighbor_list(p, BOX, 5.0, k) for p in pos]
    idx = torch.stack([t[0] for t in lists])
    mask = torch.stack([t[1] for t in lists])
    w = lambda *s: torch.as_tensor(
        (rng.standard_normal(s) * 0.1).astype(np.float32), device=dev)
    weights = [w(4 + n_rbf, 128), w(128), w(128, 128), w(128), w(128, 128),
               w(128), 1.0 + w(128), w(128)]
    return pos, idx, mask, weights


@pytest.mark.parametrize("b,n,k,cutoff,flip", [
    (1, 64, 16, None, False),   # one slot chunk, the mask passed through
    (1, 66, 20, 4.2, False),    # a ragged chunk, the cutoff refines
    (4, 64, 16, 4.2, True),     # a batch of frames (grid z), flip_dir
    (4, 66, 20, None, False),
])
def test_encoder_kernel_matches_plain_version(cuda, b, n, k, cutoff, flip):
    """e within 1e-4 of max |e| on every slot (fp32 both; the kernel's RBF
    product and LayerNorm sum in another order), the live masks equal,
    and each frame of a batch equal to that frame alone."""
    pos, idx, mask, weights = _encoder_inputs(cuda, b, n, k)
    args = (pos, idx, mask, BOX, cutoff, 4.0, 1.2, *weights)
    before = fused_edge_encoder.launches
    e, live = fused_edge_encoder(*args, flip_dir=flip)
    torch.cuda.synchronize()
    assert fused_edge_encoder.launches == before + 1
    e_ref, live_ref = edge_encoder_reference(*args, flip_dir=flip)
    assert e.shape == (b, n, k, 128) and e.dtype == torch.float32
    assert torch.equal(live, live_ref)
    if cutoff is None:
        assert torch.equal(live, mask)
    scale = float(e_ref.abs().max())
    assert float((e - e_ref).abs().max()) <= 1e-4 * scale
    for f in range(b):
        e_f, live_f = fused_edge_encoder(pos[f], idx[f], mask[f], BOX,
                                         cutoff, 4.0, 1.2, *weights,
                                         flip_dir=flip)
        assert torch.equal(e_f, e[f]) and torch.equal(live_f, live[f])


def test_encoder_rejects_what_it_does_not_take(cuda):
    """The entry's input checks on the card; nothing launches."""
    pos, idx, mask, weights = _encoder_inputs(cuda, 1, 32, 16)
    rest = (BOX, None, 4.0, 1.2)
    before = fused_edge_encoder.launches
    with pytest.raises(ValueError, match="idx"):
        fused_edge_encoder(pos, idx.long(), mask, *rest, *weights)
    with pytest.raises(ValueError, match="build_mask"):
        fused_edge_encoder(pos, idx, mask.int(), *rest, *weights)
    with pytest.raises(ValueError, match="w0"):
        fused_edge_encoder(pos, idx, mask, *rest,
                           torch.zeros((140, 128), device=cuda), *weights[1:])
    with pytest.raises(ValueError, match="w1"):
        fused_edge_encoder(pos, idx, mask, *rest, weights[0], weights[1],
                           weights[2][:, :64].contiguous(), *weights[3:])
    assert fused_edge_encoder.launches == before


@pytest.mark.parametrize("n,k,cutoff,flip", [
    (66, 20, None, False),     # a ragged tail, the mask passed through
    (66, 20, 4.2, True),       # the cutoff refines, flip_dir
    (1000, 48, 4.2, False),    # tiles over several blocks
])
def test_live_encoder_kernel_matches_plain_version(cuda, n, k, cutoff,
                                                   flip):
    """live_edge_encoder over the layout of the live mask, into a buffer
    filled with NaN: one launch a call; the live rows within 1e-4 of max
    |e| of the plain version and equal bit for bit to fused_edge_encoder's
    rows of the same slots (the same tile body, row by row); the dead rows
    still NaN (never written); two calls bit for bit."""
    pos, idx, mask, weights = _encoder_inputs(cuda, 1, n, k)
    args = (pos, idx, mask, BOX, cutoff, 4.0, 1.2, *weights)
    e_all, live = fused_edge_encoder(*args, flip_dir=flip)
    e_all, live = e_all[0], live[0]
    layout = edge_tiles.mask_layout(live)
    params = encoder_params(*weights)
    out = torch.full((n, k, 128), float("nan"), device=cuda)
    before = live_edge_encoder.launches
    e = live_edge_encoder(pos[0], idx[0], layout, params, BOX, 4.0, 1.2,
                          flip_dir=flip, out=out)
    again = live_edge_encoder(pos[0], idx[0], layout, params, BOX, 4.0,
                              1.2, flip_dir=flip)
    torch.cuda.synchronize()
    assert live_edge_encoder.launches == before + 2 and e is out
    ref = live_edge_encoder_reference(pos[0], idx[0], layout, params, BOX,
                                      4.0, 1.2, flip_dir=flip)
    scale = float(ref[live].abs().max())
    assert float((e[live] - ref[live]).abs().max()) <= 1e-4 * scale
    assert torch.equal(e[live], e_all[live])
    assert torch.equal(again[live], e[live])
    assert bool(torch.isnan(e[~live]).all())


def test_encoder_kernels_past_48_rbf_centres(cuda):
    """80 RBF centres, where both encoder kernels take the RBF product's
    k-steps at run time: every slot and the live slots each within 1e-4
    of max |e| of their plain versions, the live rows bit for bit equal
    to the every-slot kernel's."""
    pos, idx, mask, weights = _encoder_inputs(cuda, 1, 66, 20, n_rbf=80)
    args = (pos, idx, mask, BOX, 4.2, 4.0, 1.2, *weights)
    e_all, live = fused_edge_encoder(*args)
    e_ref, live_ref = edge_encoder_reference(*args)
    assert torch.equal(live, live_ref)
    scale = float(e_ref.abs().max())
    assert float((e_all - e_ref).abs().max()) <= 1e-4 * scale
    layout = edge_tiles.mask_layout(live[0])
    params = encoder_params(*weights)
    e = live_edge_encoder(pos[0], idx[0], layout, params, BOX, 4.0, 1.2)
    ref = live_edge_encoder_reference(pos[0], idx[0], layout, params, BOX,
                                      4.0, 1.2)
    torch.cuda.synchronize()
    sel = live[0]
    scale = float(ref[sel].abs().max())
    assert float((e[sel] - ref[sel]).abs().max()) <= 1e-4 * scale
    assert torch.equal(e[sel], e_all[0][sel])


def test_live_encoder_rejects_what_it_does_not_take(cuda):
    """The live entry's input checks on the card; nothing launches."""
    pos, idx, mask, weights = _encoder_inputs(cuda, 1, 66, 20)
    layout = edge_tiles.mask_layout(mask[0])
    params = encoder_params(*weights)
    rest = (BOX, 4.0, 1.2)
    before = live_edge_encoder.launches
    with pytest.raises(ValueError, match="idx"):
        live_edge_encoder(pos[0], idx[0].long(), layout, params, *rest)
    with pytest.raises(ValueError, match="layout.slot"):
        live_edge_encoder(pos[0], idx[0], layout._replace(
            slot=layout.slot[:, :64].contiguous()), params, *rest)
    with pytest.raises(ValueError, match="n_rbf"):
        live_edge_encoder(pos[0], idx[0], layout, params, *rest, n_rbf=129)
    with pytest.raises(ValueError, match="out"):
        live_edge_encoder(pos[0], idx[0], layout, params, *rest,
                          out=torch.empty((66, 20, 64), device=cuda))
    assert live_edge_encoder.launches == before


def test_deployment_force_path_with_trained_weights(cuda):
    """The trained LJ-258 GAMD-small force field of
    results/ckpts/lj_relabel_latest.msgpack on the use_pallas_encoder
    path: one edge_encoder and four conv_msg_gather launches per force
    call, forces within 5e-3 std(F) of the same force field on the CPU
    (plain versions), and predict_batch of 5 frames at batch size 2 (the
    pad path) within 1e-5 std(F) of predict frame by frame."""
    path = os.path.join(REPO, "results", "ckpts",
                        "lj_relabel_latest.msgpack")
    state, model_cfg, system = load_self_describing(
        path, use_pallas=True, use_pallas_encoder=True)
    ff = GNNForceField(state, system, model_cfg, device=cuda)
    ff_cpu = GNNForceField(state, system, model_cfg, device="cpu")
    _, lattice = lj_fluid_box(system.n_atoms, 0.5)
    rng = np.random.default_rng(1)
    frames = (lattice[None] + rng.normal(0.0, 0.1, (5, *lattice.shape))) \
        .astype(np.float32)
    pos = torch.as_tensor(np.mod(frames[0], system.box), device=cuda)
    idx, mask, ovf = dense_neighbor_list(pos, system.box, system.cutoff,
                                         system.nbr_capacity)
    assert not bool(ovf)
    enc, conv = fused_edge_encoder.launches, \
        fused_conv_gather_message.launches
    f = ff.force_fn()(pos, idx, mask)
    torch.cuda.synchronize()
    assert fused_edge_encoder.launches == enc + 1
    assert fused_conv_gather_message.launches == conv + 4
    f_cpu = ff_cpu.force_fn()(pos.cpu(), idx.cpu(), mask.cpu())
    scale = float(f_cpu.std())
    assert float((f.cpu() - f_cpu).abs().max()) < TOLERANCE * scale
    batch = ff.predict_batch(frames, batch_size=2)
    assert batch.shape == (5, system.n_atoms, 3)
    for i in range(5):
        single = ff.predict(frames[i])
        assert float((batch[i] - single).abs().max()) <= 1e-5 * scale \
            / system.force_unit_to_internal


def _banded_case(dev, n, seed=0):
    """bench_large's LJ fluid of n atoms displaced by a seeded 0.1 A
    jitter, its list at 8.0 A (K=96; the cell list above 1,024 atoms) and
    the seeded GAMD-small force field, on `dev`."""
    system, lattice = lj_large(n, 96, dev)
    rng = np.random.default_rng(seed)
    pos = torch.remainder(lattice + torch.as_tensor(
        rng.normal(0.0, 0.1, lattice.shape).astype(np.float32), device=dev),
        system.box)
    search = cell_list_neighbor_list if n > 1024 else dense_neighbor_list
    idx, mask, ovf = search(pos, system.box, system.cutoff + system.skin, 96)
    assert not bool(ovf)
    return pos, idx, mask, seeded_force_field(system, dev)


@pytest.mark.parametrize("n,layer", [
    (258, 1),      # band capped at round_up(N, 16) = 272; N % 16 != 0
    (1000, 0),     # a partial last tile; arcs start below row 0
    (4096, 1),     # the auto band 1,280, the cell list
])
def test_banded_msg_matches_plain_version(cuda, n, layer):
    """banded_msg within 1e-4 of max |agg| of its plain version on the
    real inputs of one layer of the seeded force field, one launch; and
    the plain version equal to the conv-message reference on the sorted
    gather it stands for."""
    pos, idx, mask, ff = _banded_case(cuda, n, seed=n)
    args = banded_layer_inputs(ff, pos, idx, mask, layer)
    e, idx_loc, mask_s, lo, nodes, dst, _, mp, band, tile_n = args
    before = banded.banded_conv_message.launches
    agg = banded.banded_conv_message(*args)
    torch.cuda.synchronize()
    assert banded.banded_conv_message.launches == before + 1
    weights = banded.layer_weights(mp, layer)
    ref = banded.banded_msg_reference(e, idx_loc, mask_s, lo, nodes, dst,
                                      *weights, tile_n=tile_n)
    assert agg.shape == ref.shape == (n, 128)
    assert bool(torch.isfinite(agg).all())
    assert float((agg - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    np_rows = -(-n // 16) * 16
    rows = lo.long().repeat_interleave(tile_n)[:n, None] + idx_loc.long()
    assert int(rows.max()) < np_rows + band == nodes.shape[0]


def test_banded_msg_is_run_to_run_identical(cuda):
    """No atomics: two launches give bitwise the same agg."""
    pos, idx, mask, ff = _banded_case(cuda, 1000, seed=3)
    args = banded_layer_inputs(ff, pos, idx, mask, 0)
    first = banded.banded_conv_message(*args)
    second = banded.banded_conv_message(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_banded_msg_rejects_what_it_does_not_take(cuda):
    """The wrapper's input checks on the card; nothing launches."""
    pos, idx, mask, ff = _banded_case(cuda, 1000, seed=4)
    e, idx_loc, mask_s, lo, nodes, dst, layer, mp, band, tile_n = \
        banded_layer_inputs(ff, pos, idx, mask, 0)
    call = banded.banded_conv_message
    before = call.launches
    with pytest.raises(ValueError, match="idx_loc"):
        call(e, idx_loc.long(), mask_s, lo, nodes, dst, layer, mp, band,
             tile_n)
    with pytest.raises(ValueError, match="lo"):
        call(e, idx_loc, mask_s, lo[:-1].contiguous(), nodes, dst, layer,
             mp, band, tile_n)
    with pytest.raises(ValueError, match="nodes"):
        call(e, idx_loc, mask_s, lo, nodes[:-1].contiguous(), dst, layer,
             mp, band, tile_n)
    with pytest.raises(ValueError, match=": e must"):
        call(e[..., :64].contiguous(), idx_loc, mask_s, lo, nodes, dst,
             layer, mp, band, tile_n)
    lay = edge_tiles.mask_layout(mask_s[1:].contiguous())
    with pytest.raises(ValueError, match="layout.slot"):
        call(e, idx_loc, mask_s, lo, nodes, dst, layer, mp, band, tile_n,
             lay)
    assert call.launches == before


def _kernel_names(fn, calls=3):
    """Short names (tools/profile_step.py) of the device kernels of
    `calls` traced calls of fn (profile_step.traced_spans)."""
    return {name for _, _, name in profile_step.traced_spans(fn, calls)}


def test_conv_message_kernels_launch_tensor_core_tiles(cuda):
    """Rows 3 and 6 run the live-edge wgmma tiles of csrc/conv_tc.cuh
    (row 3 with its layout inside the call, row 6 over a given one), and
    not the CUDA-core edge stage they ran before."""
    inputs, weights = _conv_inputs(cuda, 1, 66, 20, seed=9)
    with torch.no_grad():
        gather = _kernel_names(
            lambda: fused_conv_gather_message(*inputs, *weights))
    assert {"mask_count_kernel", "mask_slots_kernel",
            "split_conv_weights_kernel", "conv_tile_kernel[GatherSrc]",
            "tile_fixup_kernel"} <= gather
    pos, idx, mask, ff = _banded_case(cuda, 1000, seed=6)
    args = banded_layer_inputs(ff, pos, idx, mask, 0)
    lay = edge_tiles.mask_layout(args[2])
    band = _kernel_names(lambda: banded.banded_conv_message(*args,
                                                            layout=lay))
    assert {"split_conv_weights_kernel", "conv_tile_kernel[BandSrc]",
            "tile_fixup_kernel"} <= band
    assert not any(name.startswith(("edge_msg_kernel", "chunk_sum_kernel"))
                   for name in gather | band)


@pytest.mark.parametrize("shape", [(2, 66, 20), (1, 10_000, 96),
                                   (3, 1000, 33)])
def test_mask_layout_kernel_equals_plain_layout(cuda, shape):
    """The layout kernels against live_slot_layout, exactly: offsets,
    counts, the total and the compacted slots; an all-masked row and an
    all-live one."""
    rng = np.random.default_rng(sum(shape))
    mask = torch.as_tensor(rng.random(shape) < 0.2, device=cuda)
    mask[0, 3] = False
    mask[-1, 5] = True
    before = edge_tiles.mask_layout.launches
    got = edge_tiles.mask_layout(mask)
    want = edge_tiles.mask_layout(mask.cpu())
    torch.cuda.synchronize()
    assert edge_tiles.mask_layout.launches == before + 1
    total = int(want.total[0])
    assert torch.equal(got.total.cpu(), want.total)
    assert torch.equal(got.offset.cpu(), want.offset)
    assert torch.equal(got.count.cpu(), want.count)
    assert torch.equal(got.slot[0, :total].cpu(), want.slot[0, :total])


def test_conv_message_kernels_are_run_to_run_identical_at_scale(cuda):
    """No atomics, and which block takes a tile does not enter a sum: two
    calls give the same bits at the paths' largest shapes (row 6 at
    N=10,000, 2,500-odd tiles on a persistent grid; row 3 on a batch of
    16 graphs)."""
    pos, idx, mask, ff = _banded_case(cuda, 10_000, seed=8)
    args = banded_layer_inputs(ff, pos, idx, mask, 1)
    first = banded.banded_conv_message(*args)
    second = banded.banded_conv_message(*args)
    inputs, weights = _conv_inputs(cuda, 16, 258, 96, seed=8)
    with torch.no_grad():
        a = fused_conv_gather_message(*inputs, *weights)
        b = fused_conv_gather_message(*inputs, *weights)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(a, b)


def test_conv_entries_refuse_an_inconsistent_plan(cuda):
    """The C entries check the plan (csrc/conv_tc.cuh::plan_ok): a grid of
    0 or past the tiles, 128 threads, or shared bytes off by 16 returns
    cudaErrorInvalidValue and launches nothing; so do widths (E, D) other
    than (128, 128) and (256, 256) under a good plan."""
    from gamd_tpu_torch.ops.build import load_library
    lib = load_library()
    (e, idx, mask, hn, src, dst), ws = _conv_inputs(cuda, 1, 66, 20, seed=2)
    m, k = 66, 20
    good = edge_tiles.launch_plan(m, k, mxu_probe.sm_count(cuda))
    buf, lay, block_sum, wsplit, part = edge_tiles.call_scratch(m, k, good,
                                                                cuda)
    agg = torch.full((m, 128), 7.0, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for bad, widths in ((good._replace(grid=0), (128, 128)),
                        (good._replace(grid=good.tiles + 1), (128, 128)),
                        (good._replace(threads=128), (128, 128)),
                        (good._replace(smem=good.smem + 16), (128, 128)),
                        (good, (192, 128)), (good, (128, 64)),
                        (good, (128, 256)), (good, (256, 128))):
        err = lib.gamd_conv_msg_gather(
            *[t.data_ptr() for t in (e, idx, mask, hn, src, dst, *ws)],
            m, k, *widths,
            ctypes.byref(edge_tiles.slot_struct(lay, block_sum)),
            wsplit.data_ptr(), part.data_ptr(), *bad[:4], agg.data_ptr(),
            stream)
        assert err != 0, (bad, widths)
    torch.cuda.synchronize()
    assert bool((agg == 7.0).all())


def test_banded_force_path_on_the_card(cuda):
    """GNNForceField.banded_force_fn at N=4,096 (the cell list, auto band
    1,280): four banded_msg launches per force call, forces within 5e-3
    std(F) of reference_forward on the same card and frame; a band too
    narrow gives NaN everywhere."""
    pos, idx, mask, ff = _banded_case(cuda, 4096, seed=5)
    fn = ff.banded_force_fn()
    assert fn.banded_band == 1280
    before = banded.banded_conv_message.launches
    f = fn(pos, idx, mask)
    torch.cuda.synchronize()
    assert banded.banded_conv_message.launches == before + 4
    system, cfg = ff.system, ff.model_cfg
    ref = reference_forward(pos, idx, mask, ff._node_h0(),
                            ff._kernel_params("banded"), system.box,
                            system.cutoff, *ff._length_scale(),
                            rbf_gap=cfg.rbf_gap)
    scale = float(ref.std())
    assert float((f - ref).abs().max()) <= TOLERANCE * scale
    assert bool(torch.isnan(ff.banded_force_fn(band=256)(pos, idx,
                                                         mask)).all())


def test_banded_forces_through_the_encoder_route(cuda):
    """The banded force path at N=4,096 encodes once a force call through
    live_edge_encoder over the layout it makes once (one launch each, four
    banded_msg launches), and its forces are within 5e-3 std(F) of the
    plain banded forward (make_banded_force_fn on the CPU: encode_edges
    over every slot and the plain message)."""
    pos, idx, mask, ff = _banded_case(cuda, 4096, seed=7)
    system, cfg = ff.system, ff.model_cfg
    before = (live_edge_encoder.launches, edge_tiles.mask_layout.launches,
              banded.banded_conv_message.launches)
    f = ff.banded_force_fn()(pos, idx, mask)
    torch.cuda.synchronize()
    assert (live_edge_encoder.launches - before[0],
            edge_tiles.mask_layout.launches - before[1],
            banded.banded_conv_message.launches - before[2]) == (1, 1, 4)
    mp = ff._kernel_params("banded")
    mp_cpu = type(mp)(*[t.cpu() for t in mp])
    plain = banded.make_banded_force_fn(
        mp_cpu, system.box, system.cutoff, system.n_atoms,
        ff._node_h0().cpu(), *ff._length_scale(), flip_dir=cfg.flip_dir,
        use_ln=cfg.use_layer_norm, mlp_act=cfg.mlp_activation)
    f_plain, ovf = plain(pos.cpu(), idx.cpu(), mask.cpu())
    assert not bool(ovf)
    scale = float(f_plain.std())
    assert float((f.cpu() - f_plain).abs().max()) <= TOLERANCE * scale


def test_banded_edges_refuses_what_the_encoder_kernel_does_not_take(cuda):
    """banded_edges on the card takes the bond channel and either MLP
    activation since the encoder's live form does; an activation the
    kernel does not know and a bond that is not [N, K] float32 raise
    ValueError before any work (no layout, no encoder launch)."""
    pos, idx, mask, ff = _banded_case(cuda, 258, seed=3)
    system = ff.system
    mp = ff._kernel_params("banded")
    perm, _, idx_s = banded.sort_by_x(pos, idx)
    args = (pos[perm], idx_s, mask[perm], mp, system.box, system.cutoff,
            *ff._length_scale(), 272)
    before = (live_edge_encoder.launches, edge_tiles.mask_layout.launches)
    with pytest.raises(ValueError, match="activation"):
        banded.banded_edges(*args, mlp_act="relu")
    with pytest.raises(ValueError, match="bond"):
        banded.banded_edges(*args, bond=torch.zeros_like(mask[perm],
                                                         dtype=torch.float64))
    assert (live_edge_encoder.launches,
            edge_tiles.mask_layout.launches) == before


# -- the Nose-Hoover chain ---------------------------------------------------

NHC_RTOL = 1e-5    # kernel vs plain: max |d| / max |x| of each tensor


def _nhc_case(dev, n, r=None, m=10, seed=0):
    """Thermal argon velocities at 100 K ([r,] n, 3, slightly hot), a seeded
    chain ([r,] m) and the chain's constants at 25 / ps, dt 2 fs."""
    rng = np.random.default_rng(seed)
    lead = () if r is None else (r,)
    kt = units.KB * 100.0
    vel = np.sqrt(kt * 1.1 / 39.948) * rng.standard_normal((*lead, n, 3))
    chain = [rng.normal(0, 0.1, (*lead, m)), rng.normal(0, 0.5, (*lead, m)),
             -6.25 + rng.normal(0, 1.0, (*lead, m))]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    ndf = 3 * n
    return dict(vel=f32(vel), xi=f32(chain[0]), vxi=f32(chain[1]),
                g=f32(chain[2]), masses=f32(np.full(n, 39.948)), kt=kt,
                ndf=ndf, q=integ.nhc_masses(kt, 2.5, m, ndf, dev),
                wdts=integ.nhc_schedule(0.02, 5, integ._YS_WEIGHTS[5], dev))


def _nhc_args(case, vel, chain):
    return (vel, *chain, case["masses"], case["kt"], case["ndf"], case["q"],
            case["wdts"])


@pytest.mark.parametrize("n,r", [(258, None), (10_000, None), (258, 3),
                                 (258, 8)])
def test_nhc_half_step_matches_plain_version(cuda, n, r):
    """One launch per half-step; vel, xi, vxi and g within NHC_RTOL of each
    tensor's max of the plain version after one half-step and after 20
    consecutive ones (each side threading its own state); ke2 given as the
    plain version sums it gives the same outputs bit for bit."""
    case = _nhc_case(cuda, n, r)
    chain = (case["xi"], case["vxi"], case["g"])
    before = nhc.nhc_half_step.launches
    out = nhc.nhc_half_step(*_nhc_args(case, case["vel"], chain))
    torch.cuda.synchronize()
    assert nhc.nhc_half_step.launches == before + 1
    ref = nhc.nhc_half_step_reference(*_nhc_args(case, case["vel"], chain))
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= NHC_RTOL * float(b.abs().max())
    ke2 = nhc.twice_kinetic_energy(case["vel"], case["masses"])
    given = nhc.nhc_half_step(*_nhc_args(case, case["vel"], chain), ke2=ke2)
    assert all(torch.equal(a, b) for a, b in zip(given, out))
    k_state = p_state = (case["vel"], *chain)
    for _ in range(20):
        k_state = nhc.nhc_half_step(*_nhc_args(case, k_state[0],
                                               k_state[1:]))
        p_state = nhc.nhc_half_step_reference(*_nhc_args(case, p_state[0],
                                                         p_state[1:]))
    for a, b in zip(k_state, p_state):
        assert float((a - b).abs().max()) <= NHC_RTOL * float(b.abs().max())


def test_nhc_half_step_is_run_to_run_identical(cuda):
    """A fixed-order sum of m v^2 and one thread on the chain: two launches
    give bitwise the same outputs."""
    case = _nhc_case(cuda, 10_000, seed=1)
    args = _nhc_args(case, case["vel"], (case["xi"], case["vxi"],
                                         case["g"]))
    first, second = nhc.nhc_half_step(*args), nhc.nhc_half_step(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_nhc_half_step_rejects_what_it_does_not_take(cuda):
    """The wrapper's input checks on the card (M > 16, types, shapes);
    nothing launches."""
    call = nhc.nhc_half_step
    before = call.launches
    long_case = _nhc_case(cuda, 64, m=17)
    with pytest.raises(ValueError, match="M=17"):
        call(*_nhc_args(long_case, long_case["vel"], (
            long_case["xi"], long_case["vxi"], long_case["g"])))
    case = _nhc_case(cuda, 64)
    chain = (case["xi"], case["vxi"], case["g"])
    with pytest.raises(ValueError, match="vel"):
        call(*_nhc_args(case, case["vel"].double(), chain))
    with pytest.raises(ValueError, match="masses"):
        call(case["vel"], *chain, case["masses"][:-1], case["kt"],
             case["ndf"], case["q"], case["wdts"])
    with pytest.raises(ValueError, match="xi"):
        call(*_nhc_args(case, case["vel"], (case["xi"][None],) + chain[1:]))
    with pytest.raises(ValueError, match="ke2"):
        call(*_nhc_args(case, case["vel"], chain),
             ke2=torch.ones(1, device=cuda))
    assert call.launches == before


@pytest.mark.parametrize("form", ["scalar", "warp"])
def test_nhc_chain_probe_matches_plain_version(cuda, form):
    """The probe's kernel of each form at reps 3 and 50 against the plain
    chain: the chain, the product of the scales and the last ke2 within
    NHC_RTOL of each one's max; at reps 3 within the probe's 1e-4 of its
    reference; two launches equal bit for bit."""
    inputs = probe_nhc_kernel.probe_inputs(cuda)
    keys = ("xi", "vxi", "g", "ke2", "q", "kt", "ndf", "wdts")
    args = [inputs[k] for k in keys]
    for reps in (3, 50):
        before = nhc.nhc_chain_probe.launches[form]
        out = nhc.nhc_chain_probe(*args, reps=reps, form=form)
        torch.cuda.synchronize()
        assert nhc.nhc_chain_probe.launches[form] == before + 1
        ref = nhc.nhc_probe_reference(*args[:3], args[3].reshape(()),
                                      *args[4:], reps)
        for a, b in zip(out, ref):
            assert float((a - b).abs().max()) <= NHC_RTOL * max(
                float(b.abs().max()), 1.0)
    out = nhc.nhc_chain_probe(*args, reps=3, form=form)
    again = nhc.nhc_chain_probe(*args, reps=3, form=form)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert probe_nhc_kernel.parity_error(
        out, probe_nhc_kernel.reference(inputs, 3)) \
        <= probe_nhc_kernel.PARITY_ATOL


@pytest.mark.parametrize("m", [1, 2, 10, 16])
def test_nhc_chain_probe_warp_equals_scalar(cuda, m):
    """The warp form (lane j holds element j, one lane crossing a step)
    runs nhc.cuh's operations in the scalar form's order and rounding: at
    reps 3 and 400, on the probe's constants with a chain of m, its five
    outputs equal the scalar form's bit for bit."""
    inputs = probe_nhc_kernel.probe_inputs(cuda, m)
    for reps in (3, 400):
        scalar = probe_nhc_kernel.run_form(inputs, "scalar", reps)
        warp = probe_nhc_kernel.run_form(inputs, "warp", reps)
        torch.cuda.synchronize()
        for a, b in zip(warp, scalar):
            assert torch.equal(a, b), (m, reps, a, b)


def test_nose_hoover_simulation_on_the_card(cuda):
    """Simulation under nose_hoover with classical LJ-258 forces: two
    nhc_half_step launches a step, and 40 steps within 1e-4 A of the same
    run on the CPU (plain chain)."""
    system = get_preset("lj")
    md = MDConfig(integrator="nose_hoover", rebuild_every=20)
    _, lattice = lj_fluid_box(system.n_atoms, 0.5)
    vel = np.sqrt(units.KB * 100.0 / 39.948) * np.random.default_rng(
        2).standard_normal(lattice.shape)
    from gamd_tpu_torch.physics.lennard_jones import lj_force_fn
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        sim = Simulation(lj_force_fn(system.box), system, md, device=dev)
        before = nhc.nhc_half_step.launches
        res = sim.run(sim.init_state(lattice, vel=vel.astype(np.float32)),
                      40)
        runs[dev.type] = (res, nhc.nhc_half_step.launches - before)
    assert runs["cuda"][1] == 80 and runs["cpu"][1] == 0
    np.testing.assert_allclose(runs["cuda"][0].state.pos.cpu().numpy(),
                               runs["cpu"][0].state.pos.numpy(), atol=1e-4)


def _op_inputs(dev, n, k, seed=0, d=128):
    """Seeded inputs of the op library on `dev`, drawn as
    tests/test_ops.py draws them: per slot e, h_src, src_code [N, K, 128]
    (gate [N, K, d]), idx [N, K] int32, mask, per node h, hn, src_nodes,
    dst_code [N, 128] (table [N, d]) and the 14 layer weights."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    f = lambda *s, scale: t((rng.randn(*s) * scale).astype(np.float32))
    x = dict(e=f(n, k, 128, scale=0.3), h_src=f(n, k, 128, scale=0.3),
             src_code=f(n, k, 128, scale=0.3), gate=f(n, k, d, scale=1.0),
             idx=t(rng.randint(0, n, (n, k)).astype(np.int32)),
             mask=t(rng.rand(n, k) > 0.3), h=f(n, 128, scale=0.5),
             hn=f(n, 128, scale=0.5), src_nodes=f(n, 128, scale=0.5),
             dst_code=f(n, 128, scale=0.3), table=f(n, d, scale=1.0))
    ws = [f(128, scale=0.08) if name.startswith("b")
          else f(128, 128, scale=0.08) for name in message.LAYER_WEIGHTS]
    return x, ws


def _op_call(op, x, ws, fn=None):
    """The entry point of `op` (or its plain version, fn="plain") on x."""
    plain = fn == "plain"
    if op == "gather_agg":
        f = (message.gather_multiply_aggregate if plain
             else message.pallas_gather_multiply_aggregate)
        return f(x["table"], x["gate"], x["idx"], x["mask"])
    if op == "edge_mlp_agg":
        f = message._fused_reference if plain \
            else message.fused_edge_mlp_aggregate
        return f(x["e"], x["h_src"], x["mask"], *ws[4:8])
    if op == "conv_msg":
        f = message._conv_msg_reference if plain \
            else message.fused_conv_message
        return f(x["e"], x["h_src"], x["src_code"], x["dst_code"],
                 x["mask"], *ws[:8])
    f = message._conv_layer_reference if plain else message.fused_conv_layer
    return f(x["e"], x["idx"], x["mask"], x["h"], x["hn"], x["src_nodes"],
             x["dst_code"], ws)


_OP_ENTRY = {"gather_agg": message.pallas_gather_multiply_aggregate,
             "edge_mlp_agg": message.fused_edge_mlp_aggregate,
             "conv_msg": message.fused_conv_message,
             "conv_layer": message.fused_conv_layer}


@pytest.mark.parametrize("op", list(_OP_ENTRY))
@pytest.mark.parametrize("n,k,d", [(66, 20, 128), (258, 96, 200)])
def test_op_kernels_match_plain_version(cuda, op, n, k, d):
    """Each op-library kernel within 1e-4 of its plain version (max |out|;
    conv_layer: std(out)), one launch; a ragged edge chunk (K=20), the
    training slice's shape, and a gather_agg width past one block
    (D=200). Masked slots holding NaN and ids out of range give the same
    bits as clean ones."""
    x, ws = _op_inputs(cuda, n, k, seed=n + k, d=d)
    entry = _OP_ENTRY[op]
    before = entry.launches
    with torch.no_grad():
        out = _op_call(op, x, ws)
        ref = _op_call(op, x, ws, "plain")
    torch.cuda.synchronize()
    assert entry.launches == before + 1
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    scale = ref.std() if op == "conv_layer" else ref.abs().max()
    assert float((out - ref).abs().max()) <= 1e-4 * float(scale)

    dirty = dict(x)
    masked = ~x["mask"]
    for name in ("e", "h_src", "src_code", "gate"):
        dirty[name] = torch.where(masked[..., None], float("nan"), x[name])
    wild = torch.tensor([-1, -n, -n - 1, n, 10 ** 6, -10 ** 6],
                        dtype=torch.int32, device=cuda)
    fill = wild[torch.arange(int(masked.sum()), device=cuda) % 6]
    dirty["idx"] = x["idx"].masked_scatter(masked, fill)
    with torch.no_grad():
        again = _op_call(op, dirty, ws)
    torch.cuda.synchronize()
    assert torch.equal(again, out)


#: Row 10 against its plain version, / max |out|: the kernel adds each
#: warp's run of live slots and then the four runs, the plain version sums
#: over K in torch's order; fp32 re-association over at most K terms.
GATHER_RTOL = 1e-6


@pytest.mark.parametrize("n,k,d", [(258, 96, 128), (258, 96, 96),
                                   (66, 20, 130), (40, 600, 128),
                                   (33, 300, 7)])
def test_gather_agg_matches_plain_version(cuda, n, k, d):
    """csrc/gather_agg.cu (live slots compacted by ballot, 256 slots a
    window, four warps a row, float4 lanes where D % 4 == 0 and one float
    a lane else) within GATHER_RTOL of its plain version at the op
    library's shape, D = 96 and 130, K past one window (600, 300) and a
    D of 7; with ids out of range in live slots (read as JAX reads them)
    and in masked ones, NaN in every masked gate, the last row all masked
    (exactly 0); one launch a call, a repeat bit for bit."""
    x, _ = _op_inputs(cuda, n, k, seed=n + k + d, d=d)
    mask = x["mask"].clone()
    mask[-1] = False
    masked = ~mask
    wild = torch.tensor([-1, -n, -n - 1, n, n + 7, 10 ** 6, -10 ** 6],
                        dtype=torch.int32, device=cuda)
    flat = torch.arange(mask.numel(), device=cuda).reshape(mask.shape)
    pick = masked | (flat % 5 == 0)
    fill = wild[torch.arange(int(pick.sum()), device=cuda) % wild.numel()]
    idx = x["idx"].masked_scatter(pick, fill)
    gate = torch.where(masked[..., None], float("nan"), x["gate"])
    args = (x["table"], gate, idx, mask)
    before = message.pallas_gather_multiply_aggregate.launches
    with torch.no_grad():
        out = message.pallas_gather_multiply_aggregate(*args)
        again = message.pallas_gather_multiply_aggregate(*args)
        ref = message.gather_multiply_aggregate(*args)
    torch.cuda.synchronize()
    assert message.pallas_gather_multiply_aggregate.launches == before + 2
    assert out.shape == ref.shape == (n, d)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, again)
    assert bool((out[-1] == 0).all())
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= GATHER_RTOL * scale


def test_gather_agg_float_lanes_give_the_float4_bits(cuda):
    """A table 4 bytes off 16-byte alignment takes the one-float lanes,
    whose sum order per channel is the float4 lanes': the same bits."""
    x, _ = _op_inputs(cuda, 258, 96, seed=9)
    table = x["table"]
    shifted = torch.empty(table.numel() + 1, device=cuda)[1:].view(
        table.shape)
    shifted.copy_(table)
    assert shifted.data_ptr() % 16 != 0
    with torch.no_grad():
        aligned = message.pallas_gather_multiply_aggregate(
            table, x["gate"], x["idx"], x["mask"])
        off = message.pallas_gather_multiply_aggregate(
            shifted, x["gate"], x["idx"], x["mask"])
    torch.cuda.synchronize()
    assert torch.equal(aligned, off)


def test_conv_message_equals_conv_gather_bit_for_bit(cuda):
    """fused_conv_message on rows gathered at idx (row 8) and
    fused_conv_gather_message (row 3) run the same live-edge tiles
    (csrc/conv_tc.cuh, bf16 x 3) on equal rows over the same layout: the
    same bits."""
    x, ws = _op_inputs(cuda, 258, 96, seed=4)
    rows = x["idx"].long()
    with torch.no_grad():
        pre = message.fused_conv_message(
            x["e"], x["hn"][rows].contiguous(),
            x["src_nodes"][rows].contiguous(), x["dst_code"], x["mask"],
            *ws[:8])
        gathered = fused_conv_gather_message(
            x["e"][None], x["idx"][None], x["mask"][None], x["hn"][None],
            x["src_nodes"][None], x["dst_code"][None], *ws[:8])[0]
    torch.cuda.synchronize()
    assert torch.equal(pre, gathered)


def test_op_conv_kernels_launch_tensor_core_tiles(cuda):
    """Rows 8 and 7 run the live-edge wgmma tiles of csrc/conv_tc.cuh (by
    the policies PreSrc and ClampedSrc), row 7 then its node update at the
    block width update_atoms picks; the CUDA-core edge stage is gone from
    both."""
    x, ws = _op_inputs(cuda, 258, 96, seed=5)
    with torch.no_grad():
        names = {op: _kernel_names(lambda: _op_call(op, x, ws))
                 for op in ("conv_msg", "conv_layer")}
    tiles = {"mask_count_kernel", "mask_slots_kernel",
             "split_conv_weights_kernel", "tile_fixup_kernel"}
    b = message.update_atoms(258, mxu_probe.sm_count(cuda))
    assert tiles | {"conv_tile_kernel[PreSrc]"} <= names["conv_msg"]
    assert tiles | {"conv_tile_kernel[ClampedSrc]",
                    f"conv_update_kernel[B={b}]"} <= names["conv_layer"]
    assert not any(name.startswith(("edge_msg_kernel", "chunk_sum_kernel",
                                    "update_kernel"))
                   for name in names["conv_msg"] | names["conv_layer"])


@pytest.mark.parametrize("n,k", [(66, 20), (258, 96)])
def test_edge_mlp_agg_tiles_match_plain_version(cuda, n, k):
    """Row 9 on the live-edge tiles of csrc/conv_tc.cuh (PreSrc with
    ThetaStages): with an atom that has no live slot (its agg exactly 0)
    and one with all K live, within 1e-4 of its plain version (max |agg|),
    one launch, a second call bit for bit the first, and the kernels by
    name: the layout, the split of two weights, the tiles and the fix-up,
    not the CUDA-core edge stage of the first form."""
    x, ws = _op_inputs(cuda, n, k, seed=11 + n)
    x["mask"][1] = False
    x["mask"][2] = True
    before = message.fused_edge_mlp_aggregate.launches
    with torch.no_grad():
        out = _op_call("edge_mlp_agg", x, ws)
        again = _op_call("edge_mlp_agg", x, ws)
        ref = _op_call("edge_mlp_agg", x, ws, "plain")
    torch.cuda.synchronize()
    assert message.fused_edge_mlp_aggregate.launches == before + 2
    assert bool(torch.isfinite(out).all()) and bool((out[1] == 0).all())
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(out, again)
    with torch.no_grad():
        names = _kernel_names(lambda: _op_call("edge_mlp_agg", x, ws))
    assert {"mask_count_kernel", "mask_slots_kernel",
            "split_conv_weights_kernel",
            "conv_tile_kernel[PreSrc,ThetaStages]",
            "tile_fixup_kernel"} <= names
    assert not any(name.startswith(("edge_msg_kernel", "chunk_sum_kernel"))
                   for name in names)


@pytest.mark.parametrize("n,k", [(258, 96), (600, 20), (2000, 8)])
def test_conv_layer_reads_ids_out_of_range_as_jax(cuda, n, k):
    """fused_conv_layer with ids out of range (negative, N and past it, far
    past either end) in every masked slot and every third live one,
    against its plain version (JAX's rule: from the end, then clamped):
    within 1e-4 of std(out), one launch; N=258, 600 and 2,000 take each
    node-update width (4, 8 and 16 atoms a block on 132 SMs)."""
    x, ws = _op_inputs(cuda, n, k, seed=n)
    mask = x["mask"]
    pick = ~mask | (torch.arange(mask.numel(), device=cuda)
                    .reshape(mask.shape) % 3 == 0)
    wild = torch.tensor([-1, -n, -n - 1, n, n + 3, 10 ** 6, -10 ** 6],
                        dtype=torch.int32, device=cuda)
    fill = wild[torch.arange(int(pick.sum()), device=cuda) % wild.numel()]
    x["idx"] = x["idx"].masked_scatter(pick, fill)
    before = message.fused_conv_layer.launches
    with torch.no_grad():
        out = _op_call("conv_layer", x, ws)
        ref = _op_call("conv_layer", x, ws, "plain")
    torch.cuda.synchronize()
    assert message.fused_conv_layer.launches == before + 1
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.std())


@pytest.mark.parametrize("op", ["edge_mlp_agg", "conv_msg", "conv_layer"])
def test_op_kernel_gradients_match_plain_autograd(cuda, op):
    """The KernelFunction backward on the card (autograd through the plain
    version) against autograd through the plain version itself: every
    float input's gradient of sum(out * g) within 1e-5 of its max."""
    x, ws = _op_inputs(cuda, 66, 20, seed=7)
    g = torch.randn((66, 128), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(3))
    names = {"edge_mlp_agg": ("e", "h_src"),
             "conv_msg": ("e", "h_src", "src_code", "dst_code"),
             "conv_layer": ("e", "h", "hn", "src_nodes", "dst_code")}[op]
    grads = []
    for fn in (None, "plain"):
        xs = {**x, **{name: x[name].clone().requires_grad_()
                      for name in names}}
        wl = [w.clone().requires_grad_() for w in ws]
        out = _op_call(op, xs, wl, fn)
        leaves = [xs[name] for name in names] + [
            w for w in wl if w.grad_fn is None]
        grads.append(torch.autograd.grad(out, leaves, g, allow_unused=True))
    for a, b in zip(*grads):
        if b is None:
            assert a is None
            continue
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_op_kernels_reject_what_they_do_not_take(cuda):
    """The entries' checks on the card: width 64, int64 ids, a CPU weight,
    gather_agg inputs that require grad; nothing launches."""
    x, ws = _op_inputs(cuda, 32, 16)
    counts = [entry.launches for entry in _OP_ENTRY.values()]
    with pytest.raises(ValueError, match="edge_pre"):
        message.fused_edge_mlp_aggregate(x["e"][..., :64].contiguous(),
                                         x["h_src"], x["mask"], *ws[4:8])
    with pytest.raises(ValueError, match="w1"):
        message.fused_conv_message(x["e"], x["h_src"], x["src_code"],
                                   x["dst_code"], x["mask"], ws[0].cpu(),
                                   *ws[1:8])
    with pytest.raises(ValueError, match="idx"):
        message.fused_conv_layer(x["e"], x["idx"].long(), x["mask"], x["h"],
                                 x["hn"], x["src_nodes"], x["dst_code"], ws)
    with pytest.raises(ValueError, match="no gradient"):
        message.pallas_gather_multiply_aggregate(
            x["table"].requires_grad_(), x["gate"], x["idx"], x["mask"])
    assert [entry.launches for entry in _OP_ENTRY.values()] == counts


def _mxu_stages(dev):
    return bench_mxu.stage_inputs(bench_mxu.parse_args([]), dev)


@pytest.mark.parametrize("label", ["peak", "gather_mm", "gather_mm_8M",
                                   "gather_full", "edge_mlp", "repeat"])
def test_mxu_loop_matches_plain_version(cuda, label):
    """Each body at bench_mxu.py's default shapes, iters 2 and 3, a
    seeded salt: one launch, finite, within bench_mxu.KERNEL_RTOL of the
    plain loop."""
    body, inputs, k = _mxu_stages(cuda)[label]
    salt = torch.randn((8, 128), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(1))
    for iters in (2, 3):
        before = mxu_probe.mxu_loop.launches[body]
        out = mxu_probe.mxu_loop(body, inputs, salt, iters, k)
        torch.cuda.synchronize()
        assert mxu_probe.mxu_loop.launches[body] == before + 1
        ref = mxu_probe.mxu_loop_reference(body, inputs, salt, iters, k)
        assert bool(torch.isfinite(out).all()) and out.shape == ref.shape
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        assert err <= bench_mxu.KERNEL_RTOL[body] * scale, (label, err)


def test_mxu_loop_is_run_to_run_identical(cuda):
    stages = _mxu_stages(cuda)
    salt = torch.zeros((8, 128), device=cuda)
    for body, inputs, k in stages.values():
        a = mxu_probe.mxu_loop(body, inputs, salt, 4, k)
        b = mxu_probe.mxu_loop(body, inputs, salt, 4, k)
        assert torch.equal(a, b), body


def test_mxu_loop_rejects_what_it_does_not_take(cuda):
    """An fp32 peak operand, 40 rows (not a multiple of 32), a CPU salt
    with CUDA inputs: refused, nothing launches."""
    stages = _mxu_stages(cuda)
    salt = torch.zeros((8, 128), device=cuda)
    counts = dict(mxu_probe.mxu_loop.launches)
    a, w = stages["peak"][1]
    with pytest.raises(ValueError, match="a must be"):
        mxu_probe.mxu_loop("peak", (a.float(), w), salt, 2)
    e, w1 = stages["edge_mlp"][1]
    with pytest.raises(ValueError, match="multiple of 32"):
        mxu_probe.mxu_loop("edge_mlp", (e[:40].contiguous(), w1), salt, 2)
    with pytest.raises(ValueError, match="body"):
        mxu_probe.mxu_loop("conv", (e, w1), salt, 2)
    assert mxu_probe.mxu_loop.launches == counts


@pytest.mark.parametrize("form", list(gather_probe.FORMS))
def test_onehot_gather_matches_plain_version(cuda, form):
    """Each form at probe_gather.py's inputs, iters 2: one launch, the
    gathered rows (the last product) bit for bit equal to the plain
    version's, the carry within 1e-5 of iters sum |T[idx]| (exact for
    int8 x int8), and equal to iters sum T[idx]."""
    idx, tbl = probe_gather.probe_inputs()
    x = probe_gather.form_inputs(form, idx, tbl, cuda)
    before = gather_probe.onehot_gather.launches[form]
    out, g = probe_gather.call(x, form, 2, product=True)
    torch.cuda.synchronize()
    assert gather_probe.onehot_gather.launches[form] == before + 1
    ref, g_ref = gather_probe.onehot_gather_reference(
        x["idx"], x["tbl"], 2, form, x["starts"], product=True)
    assert torch.equal(g, g_ref)
    assert torch.equal(g, x["tbl"].float()[x["idx"][:, 0].long()])
    total, scale = probe_gather.gathered(x, form)
    tol = 0.0 if form == "int8_int8" else 1e-5 * 2 * scale
    assert float((out - ref).abs().max()) <= tol
    assert abs(float(out[0, 0]) - 2 * total) <= max(tol, 1e-5 * 2 * scale)
    assert bool((out == out[0, 0]).all())
    again = probe_gather.call(x, form, 2)
    assert torch.equal(again, out)


def test_onehot_gather_rejects_what_it_does_not_take(cuda):
    """int64 ids, a float32 table, starts on a full form, 40 rows: refused,
    nothing launches."""
    idx, tbl = probe_gather.probe_inputs()
    x = probe_gather.form_inputs("bf16", idx, tbl, cuda)
    counts = dict(gather_probe.onehot_gather.launches)
    with pytest.raises(ValueError, match="idx"):
        gather_probe.onehot_gather(x["idx"].long(), x["tbl"], 2, "bf16")
    with pytest.raises(ValueError, match="tbl"):
        gather_probe.onehot_gather(x["idx"], x["tbl"].float(), 2, "bf16")
    with pytest.raises(ValueError, match="starts"):
        gather_probe.onehot_gather(x["idx"], x["tbl"], 2, "bf16",
                                   starts=x["idx"][:8, 0].contiguous())
    with pytest.raises(ValueError, match="multiple of 32"):
        gather_probe.onehot_gather(x["idx"][:40].contiguous(), x["tbl"], 2,
                                   "bf16")
    assert gather_probe.onehot_gather.launches == counts


# -- slice 11: the redesigned probe kernels' ragged shapes and plans ---------

@pytest.mark.parametrize("label,rows", [("gather_mm", 96),
                                        ("gather_mm", 6112),
                                        ("gather_full", 96),
                                        ("edge_mlp", 96), ("repeat", 96)])
def test_mxu_loop_ragged_rows(cuda, label, rows):
    """96 rows (three row tiles, a 64-row tile half full) and gather_mm at
    6,112 rows (persistent CTAs of six row tiles, the last CTAs' last tile
    empty): against the plain loop at iters 2."""
    body, inputs, k = _mxu_stages(cuda)[
        "gather_mm_8M" if label == "gather_mm" else label]
    if body == "repeat":
        inputs, k = (inputs[0][:2].contiguous(),), 48
    else:
        inputs = (inputs[0][:rows].contiguous(), *inputs[1:])
    assert mxu_probe.output_rows(body, inputs, k) == rows
    salt = torch.randn((8, 128), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(4))
    ref = mxu_probe.mxu_loop_reference(body, inputs, salt, 2, k)
    out = mxu_probe.mxu_loop(body, inputs, salt, 2, k)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    assert err <= bench_mxu.KERNEL_RTOL[body] * float(ref.abs().max())


@pytest.mark.parametrize("iters", [2, 200])
def test_repeat_kernel_is_its_plain_loop_bit_for_bit(cuda, iters):
    """The repeat body (row 0 carried in registers, 192 CTAs at bench_mxu's
    768 rows and k 48; 96 rows at k 48) at iters 2 and 200 with a seeded
    salt: bit for bit the plain loop, one launch each."""
    _, (dst,), k = _mxu_stages(cuda)["repeat"]
    salt = torch.randn((8, 128), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(iters))
    for inputs in ((dst,), (dst[:2].contiguous(),)):
        before = mxu_probe.mxu_loop.launches["repeat"]
        out = mxu_probe.mxu_loop("repeat", inputs, salt, iters, k)
        torch.cuda.synchronize()
        assert mxu_probe.mxu_loop.launches["repeat"] == before + 1
        ref = mxu_probe.repeat_reference(*inputs, k, salt, iters)
        assert torch.equal(out, ref), float((out - ref).abs().max())


def test_repeat_chain_matches_plain_version(cuda):
    """repeat_chain (one thread, row 0's recurrence) bit for bit its plain
    version at 1, 200 and 20,000 steps, and the kernel's row 0."""
    d0 = torch.tensor(0.7, device=cuda)
    salt = torch.tensor(0.3, device=cuda)
    for reps in (1, 200, 20_000):
        got = mxu_probe.repeat_chain(d0, salt, reps)
        want = mxu_probe.repeat_chain_reference(d0.cpu(), salt.cpu(), reps)
        assert float(got) == float(want), reps
    _, (dst,), k = _mxu_stages(cuda)["repeat"]
    salt8 = torch.zeros((8, 128), device=cuda)
    out = mxu_probe.mxu_loop("repeat", (dst,), salt8, 200, k)
    assert float(out[0, 3]) == float(mxu_probe.repeat_chain(
        dst[0, 3], salt8[0, 0], 200))


def test_mxu_entry_refuses_the_first_repeat_split(cuda):
    """The C entry refuses the first form's repeat plan (24 blocks of 256
    threads on 32-row tiles) and a plan whose rows a thread do not divide
    k, launching nothing."""
    from gamd_tpu_torch.ops.build import load_library
    lib = load_library()
    _, (dst,), k = _mxu_stages(cuda)["repeat"]
    salt = torch.zeros((8, 128), device=cuda)
    out = torch.full((768, 128), 7.0, device=cuda)
    good = mxu_probe.launch_plan("repeat", 768, 0, mxu_probe.sm_count(cuda),
                                 k)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for bad, kk in ((mxu_probe.Plan(24, 1, 32, 128, 256, 512), k),
                    (good, 12), (good._replace(smem=512), k)):
        err = lib.gamd_mxu_loop(4, dst.data_ptr(), None, None, None,
                                salt.data_ptr(), 768, 0, kk, 2,
                                out.data_ptr(), *bad, stream)
        assert err != 0, bad
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())


def test_mxu_entry_refuses_an_inconsistent_plan(cuda):
    """The C entry itself recomputes the plan: one CTA too many, shared
    bytes off by 16, or another split returns cudaErrorInvalidValue and
    launches nothing."""
    from gamd_tpu_torch.ops.build import load_library
    lib = load_library()
    _, (e, w), _ = _mxu_stages(cuda)["edge_mlp"]
    salt = torch.zeros((8, 128), device=cuda)
    out = torch.full((768, 128), 7.0, device=cuda)
    good = mxu_probe.launch_plan("edge_mlp", 768, 0, mxu_probe.sm_count(cuda))
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for bad in (good._replace(ctas=good.ctas + 4),
                good._replace(smem=good.smem + 16),
                good._replace(cluster=4, cols=32, ctas=96, threads=256)):
        err = lib.gamd_mxu_loop(3, e.data_ptr(), w.data_ptr(), None, None,
                                salt.data_ptr(), 768, 0, 1, 2,
                                out.data_ptr(), *bad, stream)
        assert err != 0, bad
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())


@pytest.mark.parametrize("form", list(gather_probe.FORMS))
def test_onehot_gather_ragged(cuda, form):
    """96 edge rows (a 64-row unit half full), band tiles of 32 rows (three
    windows, one unit across two of them), some indices outside their
    window: the gathered rows and the carry against the plain version."""
    rng = np.random.default_rng(5)
    _, tbl = probe_gather.probe_inputs()
    idx = rng.integers(0, 258, (96, 1)).astype(np.int32)
    x = probe_gather.form_inputs(form.replace("band256", "bf16").replace(
        "band208", "bf16"), idx, tbl, cuda)
    starts = None
    if gather_probe.band_of(form) is not None:
        band = gather_probe.band_of(form)
        starts = torch.tensor([0, 64, 384 - band], dtype=torch.int32,
                              device=cuda)
    out, g = gather_probe.onehot_gather(x["idx"], x["tbl"], 3, form, starts,
                                        True)
    torch.cuda.synchronize()
    ref, g_ref = gather_probe.onehot_gather_reference(
        x["idx"], x["tbl"], 3, form, starts, product=True)
    assert torch.equal(g, g_ref)
    scale = float(g_ref.abs().sum())
    tol = 0.0 if form == "int8_int8" else 1e-5 * 3 * max(scale, 1.0)
    assert float((out - ref).abs().max()) <= tol


def test_onehot_entry_refuses_an_inconsistent_plan(cuda):
    """The C entry recomputes the plan: no CTA, more CTAs than SMs, other
    shared bytes or threads returns cudaErrorInvalidValue and launches
    nothing."""
    from gamd_tpu_torch.ops.build import load_library
    lib = load_library()
    idx, tbl = probe_gather.probe_inputs()
    x = probe_gather.form_inputs("bf16", idx, tbl, cuda)
    sms = mxu_probe.sm_count(cuda)
    good = gather_probe.launch_plan("bf16", 13056, 384, sms)
    out = torch.full((8, 128), 7.0, device=cuda)
    partials = torch.empty(sms + 2, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for bad in (good._replace(ctas=0),
                good._replace(ctas=sms + 1),
                good._replace(smem=good.smem + 1024),
                good._replace(threads=128)):
        err = lib.gamd_onehot_gather(
            0, x["idx"].data_ptr(), None, x["tbl"].data_ptr(), 13056, 384,
            384, 13056, 2, partials.data_ptr(), out.data_ptr(), None,
            bad.ctas, bad.threads, bad.smem, stream)
        assert err != 0, bad
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())


# -- slice 9: the lane, sublane and transpose forms; the replica axis --------

@pytest.mark.parametrize("form", list(probe_gather.GATHER_FORMS))
def test_gather_form_matches_plain_version(cuda, form):
    """Each form of gather_forms.cu at probe_gather.py's inputs, iters 2:
    one launch; the last result ([256, 13056] lane, [13056, 256] sublane,
    [384, 256] transpose) bit for bit its plain version's; the carry within
    1e-5 of iters x one iteration's sum of magnitudes; a repeat bit for
    bit."""
    idx, tbl = probe_gather.probe_inputs()
    x = probe_gather.form_inputs(form, idx, tbl, cuda)
    before = probe_gather.launches(form)
    out, g = probe_gather.call(x, form, 2, product=True)
    torch.cuda.synchronize()
    assert probe_gather.launches(form) == before + 1
    x_cpu = probe_gather.form_inputs(form, idx, tbl, "cpu")
    ref, g_ref = probe_gather.call(x_cpu, form, 2, product=True)
    assert torch.equal(g.cpu(), g_ref)
    total, scale = probe_gather.gathered(x_cpu, form)
    assert float((out.cpu() - ref).abs().max()) <= 1e-5 * 2 * scale
    assert abs(float(out[0, 0]) - 2 * total) <= 1e-5 * 2 * scale
    assert bool((out == out[0, 0]).all())
    assert torch.equal(probe_gather.call(x, form, 2), out)


@pytest.mark.parametrize("width", [384, 128])
@pytest.mark.parametrize("rows", [256, 26_112])
def test_lane_gather_on_other_streams(cuda, width, rows):
    """lane_gather on a seeded stream of `rows` columns in [0, 384) (one
    block's worth, and twice probe_gather.py's stream, which needs more
    blocks a slice than the card holds at once), iters 3: the last result
    bit for bit its plain version's, the carry within 1e-5 of iters x one
    iteration's sum of magnitudes, a repeat bit for bit."""
    rng = np.random.default_rng(rows + width)
    tblt = torch.as_tensor(rng.standard_normal((256, 384))
                           .astype(np.float32), device=cuda)
    idx = torch.as_tensor(rng.integers(0, 384, (rows, 1)).astype(np.int32),
                          device=cuda)
    out, g = gather_probe.lane_gather(idx, tblt, 3, width, product=True)
    again = gather_probe.lane_gather(idx, tblt, 3, width)
    torch.cuda.synchronize()
    ref, g_ref = gather_probe.lane_gather_reference(idx.cpu(), tblt.cpu(),
                                                    3, width, product=True)
    assert torch.equal(g.cpu(), g_ref)
    scale = float(tblt[:, idx[:, 0].long()].abs().sum())
    assert float((out.cpu() - ref).abs().max()) <= 1e-5 * 3 * scale
    assert torch.equal(again, out)


@pytest.mark.parametrize("rows,n_pad", [(13056, 384), (32, 32), (100, 384),
                                        (13001, 384)])
def test_sublane_gather_matches_plain_version(cuda, rows, n_pad):
    """The sublane kernel on a seeded stream with an index on the table's
    last row and one past it (clamped), at probe_gather's shapes, a small
    table and two ragged streams: one launch a call; the last result bit
    for bit its plain version's (of the clamped indices), the carry within
    1e-5 of iters x one iteration's sum of magnitudes, a repeat bit for
    bit."""
    rng = np.random.default_rng(rows)
    tbl = torch.as_tensor(rng.standard_normal((n_pad, 256))
                          .astype(np.float32), device=cuda)
    ids = rng.integers(0, n_pad, (rows, 1)).astype(np.int32)
    ids[3, 0], ids[-1, 0] = n_pad - 1, n_pad
    idx = torch.as_tensor(ids, device=cuda)
    before = gather_probe.sublane_gather.launches
    out, g = gather_probe.sublane_gather(idx, tbl, 3, True)
    again, g_again = gather_probe.sublane_gather(idx, tbl, 3, True)
    torch.cuda.synchronize()
    assert gather_probe.sublane_gather.launches == before + 2
    clamped = idx.clamp(0, n_pad - 1).cpu()
    ref, g_ref = gather_probe.sublane_gather_reference(
        clamped, tbl.cpu(), 3, product=True)
    assert torch.equal(g.cpu(), g_ref)
    scale = float(g_ref.abs().sum())
    assert float((out.cpu() - ref).abs().max()) <= 1e-5 * 3 * scale
    assert torch.equal(again, out) and torch.equal(g_again, g)


def test_sublane_entry_refuses_an_inconsistent_plan(cuda):
    """The C entry recomputes the sublane plan: other blocks a slice,
    edges a block, threads or shared bytes returns cudaErrorInvalidValue
    and launches nothing."""
    from gamd_tpu_torch.ops.build import load_library
    lib = load_library()
    idx, tbl = probe_gather.probe_inputs()
    x = probe_gather.form_inputs("sublane", idx, tbl, cuda)
    good = gather_probe.sublane_plan(13056, 384, mxu_probe.sm_count(cuda))
    out = torch.full((8, 128), 7.0, device=cuda)
    partials = torch.empty(4 * (good.per_slice + 1), device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for bad in (good._replace(per_slice=good.per_slice + 1),
                good._replace(span=good.span - 1),
                good._replace(threads=2 * good.threads),
                good._replace(smem=good.smem + 1024)):
        err = lib.gamd_sublane_gather(
            x["idx"].data_ptr(), x["tbl"].data_ptr(), 13056, 384, 2,
            partials.data_ptr(), out.data_ptr(), None, *bad, stream)
        assert err != 0, bad
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())


def test_gather_forms_reject_what_they_do_not_take(cuda):
    """A ragged stream (100 rows) to the lane form, an empty one to the
    sublane form, a bf16 table, int64 ids, a transposed table whose width
    is not a multiple of 32: refused, nothing launches."""
    idx, tbl = probe_gather.probe_inputs()
    lane = probe_gather.form_inputs("lane384", idx, tbl, cuda)
    sub = probe_gather.form_inputs("sublane", idx, tbl, cuda)
    counts = [probe_gather.launches(f) for f in probe_gather.GATHER_FORMS]
    with pytest.raises(ValueError, match="multiple of 256"):
        gather_probe.lane_gather(lane["idx"][:100].contiguous(),
                                 lane["tbl"], 2)
    with pytest.raises(ValueError, match="tblt"):
        gather_probe.lane_gather(lane["idx"], lane["tbl"].bfloat16(), 2)
    with pytest.raises(ValueError, match="idx"):
        gather_probe.sublane_gather(sub["idx"].long(), sub["tbl"], 2)
    with pytest.raises(ValueError, match="rows must be positive"):
        gather_probe.sublane_gather(sub["idx"][:0].contiguous(),
                                    sub["tbl"], 2)
    with pytest.raises(ValueError, match="multiple of 32"):
        gather_probe.transpose_probe(lane["tbl"][:, :200].contiguous(), 2)
    assert [probe_gather.launches(f)
            for f in probe_gather.GATHER_FORMS] == counts


def _replica_case(dev, r=3):
    """The case frame shifted by 0, 1.7, 3.4 ... A, each with its own list
    (N=66, K=20: ragged node blocks and last tiles)."""
    pos, _, _, h0, mp, box, cutoff, lm, ls = _case(dev, 66, 20)
    frames = torch.stack([torch.remainder(pos + 1.7 * i, box)
                          for i in range(r)])
    idx, mask, _ = dense_neighbor_list(frames, box, 5.0, 20)
    return (frames, idx, mask, h0.expand(r, -1, -1).contiguous(), mp, box,
            cutoff, lm, ls)


def test_mega_forward_replica_axis_matches_single_calls(cuda):
    """R=3 replicas in one launch: each replica bit for bit its own
    single-system launch, all within 5e-3 std(F) of reference_forward."""
    args = _replica_case(cuda)
    pos, idx, mask, h0, mp, *rest = args
    before = mega_forward.launches
    out = mega_forward(*args)
    torch.cuda.synchronize()
    assert mega_forward.launches == before + 1 and out.shape == pos.shape
    for r in range(pos.shape[0]):
        one = mega_forward(pos[r], idx[r], mask[r], h0[r].contiguous(), mp,
                           *rest)
        assert torch.equal(out[r], one), r
    ref = reference_forward(*args)
    assert float((out - ref).abs().max()) < TOLERANCE * float(
        ref.abs().std())


def test_mega_forward_eight_replicas_match_single_calls(cuda):
    """R=8 in one launch (the node stages then take more atoms a block
    than at R=1): each replica bit for bit its single-system launch."""
    args = _replica_case(cuda, r=8)
    pos, idx, mask, h0, mp, *rest = args
    out = mega_forward(*args)
    torch.cuda.synchronize()
    for r in range(pos.shape[0]):
        one = mega_forward(pos[r], idx[r], mask[r], h0[r].contiguous(), mp,
                           *rest)
        assert torch.equal(out[r], one), r


@pytest.mark.parametrize("temperature", [0.0, 100.0])
def test_window_replica_axis(cuda, temperature):
    """An R=3 window of 8 steps, noise off and on: pos and vel within 2e-4
    of the plain window at R=3, ke [3, 8] within rtol 1e-4; replica 0 bit
    for bit the single-system window of replica 0's inputs and seed."""
    args = _replica_case(cuda)
    pos = args[0]
    vel = 0.1 * torch.randn(pos.shape, device=cuda,
                            generator=torch.Generator(cuda).manual_seed(3))
    force = reference_forward(*args).contiguous()
    c1, hdt, c2col, masses = _window_constants(cuda, pos.shape[1],
                                               temperature)
    dx, dv, out = _compare_windows(args, vel, force, masses,
                                   (c1, hdt, c2col), 8, seed=77)
    assert dx <= WINDOW_ATOL and dv <= WINDOW_ATOL
    assert out[3].shape == (3, 8)
    single = tuple(a[0].contiguous() if isinstance(a, torch.Tensor) and
                   a.ndim == 3 else a for a in args)
    one = mega_md_steps(
        single[0], vel[0].contiguous(), force[0].contiguous(), *single[1:],
        masses, n_steps=8, c1=c1, hdt=hdt, c2col=c2col,
        seed=torch.tensor([77], dtype=torch.int32, device=cuda))
    for a, b in zip(out, one):
        assert torch.equal(a[0], b)


@pytest.mark.parametrize("integrator", ["langevin", "nose_hoover"])
def test_run_replicas_on_the_card(cuda, integrator):
    """Simulation.run_replicas at R=4 on LJ-64 with a seeded GAMD (widths
    128, 2 layers): the megastep window (Langevin) or per-step NHC through
    force_fn(megakernel=True), one launch a window or force call for all
    replicas, finite, replicas apart."""
    system = get_preset("lj", n_atoms=64, box=lj_fluid_box(64, 0.5)[0],
                        cutoff=6.0, skin=0.5, nbr_capacity=48)
    cfg = ModelConfig(conv_layers=2, use_layer_norm=True)
    ff = GNNForceField(init_params(cfg, system, seed=0), system, cfg,
                       device=cuda)
    md = MDConfig(integrator=integrator, temperature=100.0,
                  friction_per_ps=25.0, rebuild_every=5)
    sim = Simulation(ff.force_fn(megakernel=True), system, md,
                     megastep_fn=(ff.megastep_fn()
                                  if integrator == "langevin" else None),
                     device=cuda)
    states = sim.init_replicas(lj_fluid_box(64, 0.5)[1], 4,
                               rng=torch.Generator(cuda).manual_seed(1))
    before = mega_forward.launches, mega_md_steps.launches
    res = sim.run_replicas(states, 10)
    torch.cuda.synchronize()
    launches = (mega_forward.launches - before[0],
                mega_md_steps.launches - before[1])
    assert launches == ((0, 2) if integrator == "langevin" else (10, 0))
    assert res.thermo.temperature.shape == (4, 10)
    assert bool(torch.isfinite(res.state.pos).all())
    assert float((res.state.pos[0] - res.state.pos[1]).abs().max()) > 1e-3


# -- the water model's bond channel (rows 1-2), the constraints --------------

def _water_case(dev, layers=2):
    """TIP3P-774 with tip3p_final's weights cut to its first `layers` conv
    layers, at the water start without FIRE (water_box snapped onto the
    constraints), the K=96 list at 4.2 + 0.7 A and its bond channel:
    (forward args, bond, force field)."""
    state, model_cfg, system = load_self_describing(os.path.join(
        REPO, "results", "ckpts", "tip3p_final.msgpack"))
    ff = GNNForceField(state, system, model_cfg, device=dev)
    pos = RigidWater(system.n_atoms // 3, system.box).project_initial(
        torch.as_tensor(water_box(system.n_atoms // 3, system.box, seed=0),
                        device=dev))
    pos = torch.remainder(pos, system.box).contiguous()
    idx, mask, ovf = build_nbrs(pos, system)
    assert not bool(ovf)
    mp = ff._kernel_params("megakernel")
    mp = mp._replace(**{name: getattr(mp, name)[:layers].contiguous()
                        for name in mp._fields
                        if getattr(mp, name).shape[0] == model_cfg.conv_layers
                        and getattr(mp, name).ndim == 3})
    args = (pos, idx, mask, ff._node_h0(), mp, system.box, system.cutoff,
            *ff._length_scale())
    return args, neighbor_bond_channel(idx), ff


def test_forward_with_bond_matches_plain_version(cuda):
    """mega_forward with the bond channel on TIP3P-774 (tip3p_final's
    weights, 2 of its 4 layers, K=96): one launch, within 5e-3 std(F) of
    reference_forward with the bond; a bond of zeros gives the bits of no
    bond; the bond changes the forces; edge_hilo and f32_edges give the
    same bits."""
    args, bond, _ = _water_case(cuda)
    before = mega_forward.launches
    out = mega_forward(*args, bond=bond)
    torch.cuda.synchronize()
    assert mega_forward.launches == before + 1
    ref = reference_forward(*args, bond=bond)
    assert float((out - ref).abs().max()) < TOLERANCE * float(
        ref.abs().std())
    none = mega_forward(*args)
    assert torch.equal(mega_forward(*args, bond=torch.zeros_like(bond)),
                       none)
    assert float((out - none).abs().max()) > 1e-3 * float(ref.abs().std())
    for kw in (dict(edge_hilo=True), dict(f32_edges=True)):
        assert torch.equal(mega_forward(*args, bond=bond, **kw), out)


def test_forward_with_bond_replicas_match_single_calls(cuda):
    """R=2 water frames (the start and a shifted copy, each with its own
    list and bond channel) in one launch: each replica bit for bit its own
    single launch."""
    (pos, idx, mask, h0, mp, box, *rest), bond, ff = _water_case(cuda)
    system = ff.system
    frames = torch.stack([pos, torch.remainder(pos + 3.1, box)])
    idx2, mask2, _ = build_nbrs(frames, system)
    bond2 = neighbor_bond_channel(idx2)
    h02 = h0.expand(2, -1, -1).contiguous()
    out = mega_forward(frames, idx2, mask2, h02, mp, box, *rest, bond=bond2)
    for r in range(2):
        one = mega_forward(frames[r], idx2[r], mask2[r], h0, mp, box, *rest,
                           bond=bond2[r])
        assert torch.equal(out[r], one), r


def test_window_with_bond_matches_plain_version(cuda, monkeypatch):
    """A 20-step window with the bond channel and c2col = 0 on TIP3P-774
    (2 layers of tip3p_final, K=96): pos within 2e-4 of the plain window,
    ke within rtol 1e-4, vel within 2e-4 or, if larger, twice the distance
    between the plain window and the plain window with the kernel's bf16
    x 3 edge products (ops.mega.split_bf16_matmul): at hydrogen's mass the
    forward's 1e-5 std(F) moves velocities some 5e-4 A/t0 over a
    window."""
    args, bond, ff = _water_case(cuda)
    system = ff.system
    md = MDConfig(integrator="langevin", temperature=300.0,
                  friction_per_ps=1.0)
    sim = Simulation(lambda p, i, m: p, system, md, device=cuda)
    c1, hdt, _ = sim._baoab_constants()
    vel = integ.maxwell_boltzmann_velocities(
        torch.Generator(cuda).manual_seed(3), sim.masses, 300.0)
    pos, idx, mask, h0, mp, box, cutoff, lm, ls = args
    force = mega_forward(*args, bond=bond)
    kw = dict(n_steps=20, c1=c1, hdt=hdt, c2col=torch.zeros_like(sim.masses),
              seed=torch.tensor([5], dtype=torch.int32, device=cuda),
              bond=bond)
    before = mega_md_steps.launches
    out = mega_md_steps(pos, vel, force, idx, mask, h0, mp, box, cutoff, lm,
                        ls, sim.masses, **kw)
    torch.cuda.synchronize()
    assert mega_md_steps.launches == before + 1
    plain = lambda: md_steps_reference(pos, vel, force, idx, mask, h0, mp,
                                       box, cutoff, lm, ls, sim.masses, **kw)
    ref = plain()
    monkeypatch.setattr(mega_module, "_edge_mm", mega_module.split_bf16_matmul)
    spread = float((plain()[1] - ref[1]).abs().max())
    assert float((out[0] - ref[0]).abs().max()) <= WINDOW_ATOL
    assert float((out[1] - ref[1]).abs().max()) <= max(WINDOW_ATOL,
                                                       2.0 * spread)
    torch.testing.assert_close(out[3], ref[3], rtol=1e-4, atol=0)


def test_eager_water_model_with_conv_kernel_matches_plain(cuda):
    """The water GAMDNet on TIP3P-774 (tip3p_final, all 4 layers) with
    use_pallas (every conv layer through conv_msg_gather, row 3) against
    the plain model on the same frame: forces within 1e-4 std(F) (row 3
    holds its messages within 1e-4 of max |agg|)."""
    state, model_cfg, system = load_self_describing(os.path.join(
        REPO, "results", "ckpts", "tip3p_final.msgpack"))
    (pos, idx, mask, *_), _, ff = _water_case(cuda)
    live = refresh_mask(pos, system.box, system.cutoff, idx, mask)
    plain = ff.force_fn()(pos, idx, live)
    kernel_ff = GNNForceField(state, system, dataclasses.replace(
        model_cfg, use_pallas=True), device=cuda)
    before = fused_conv_gather_message.launches
    got = kernel_ff.force_fn()(pos, idx, live)
    torch.cuda.synchronize()
    assert fused_conv_gather_message.launches == before + 4
    assert float((got - plain).abs().max()) < 1e-4 * float(plain.abs().std())


def test_constraints_are_out_of_reach_of_tf32(cuda):
    """SETTLE, SHAKE, RATTLE and the residual on TIP3P-774 give the same
    bits with TF32 allowed for matmuls and convolutions as without, and
    SETTLE is within 5e-6 A of its float64 evaluation: no product of the
    constraints reaches a TF32 unit."""
    n_mol, box = 258, 20.0
    cst = RigidWater(n_mol, box)
    pos = cst.project_initial(torch.as_tensor(
        water_box(n_mol, box, seed=1), device=cuda))
    gen = torch.Generator(cuda).manual_seed(2)
    new = pos + 0.02 * torch.randn(pos.shape, device=cuda, generator=gen)
    vel = torch.randn(pos.shape, device=cuda, generator=gen)

    def run():
        shake_cst = RigidWater(n_mol, box, method="shake")
        return (cst.positions(pos, new), shake_cst.positions(pos, new),
                cst.velocities(new, vel), cst.residual(new))

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with_tf32 = run()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    without = run()
    for a, b in zip(with_tf32, without):
        assert torch.equal(a, b)
    ref = RigidWater(n_mol, box).positions(pos.double(), new.double())
    assert float((without[0].double() - ref).abs().max()) < 5e-6
    assert float(cst.residual(without[0])) < 1e-5


# -- the benchmark's stage switches, the activation pairs, banded water ----

@pytest.mark.parametrize("name", mega_module.ABLATE_STAGES)
def test_ablated_window_matches_plain_version(cuda, name):
    """mega_md_steps under each of the 14 `ablate` names against its plain
    ablated window, 4 steps on LJ-64 (K=16, two layers) at c2col = 0: pos
    and vel within 2e-4 (ln's plain windows with fp32 and with the
    kernel's bf16 x 3 products, the form whose dynamics grow fastest, are
    1.3e-7 apart here), and one step's forces within 5e-3 std(F); the
    forces unlike the full window's (but for noise, at c2col = 0 the full
    window's bits)."""
    n = 64
    args = _case(cuda, n, 16)
    pos, idx, mask, h0, mp, box, cutoff, lm, ls = args
    vel = 0.1 * torch.randn((n, 3), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(3))
    force = reference_forward(*args).contiguous()
    c1, hdt, c2col, masses = _window_constants(cuda, n, 100.0)
    kw = dict(n_steps=4, c1=c1, hdt=hdt, c2col=torch.zeros_like(c2col),
              seed=torch.tensor([7], dtype=torch.int32, device=cuda))
    wargs = (pos, vel, force, idx, mask, h0, mp, box, cutoff, lm, ls,
             masses)
    before = mega_md_steps.launches
    out = mega_md_steps(*wargs, **kw, ablate=(name,))
    torch.cuda.synchronize()
    assert mega_md_steps.launches == before + 1
    assert all(bool(torch.isfinite(t).all()) for t in out)
    ref = md_steps_reference(*wargs, **kw, ablate=(name,))
    for i in (0, 1):
        assert float((out[i] - ref[i]).abs().max()) <= WINDOW_ATOL, i
    one = dict(kw, n_steps=1)
    f_one = mega_md_steps(*wargs, **one, ablate=(name,))[2]
    f_ref = md_steps_reference(*wargs, **one, ablate=(name,))[2]
    assert float((f_one - f_ref).abs().max()) \
        <= TOLERANCE * float(f_ref.abs().std())
    full = mega_md_steps(*wargs, **kw)
    assert torch.equal(out[2], full[2]) == (name == "noise")


def test_ablated_empty_set_is_the_production_window(cuda):
    """ablate=() and the megastep closure's default give the bits of a
    window without it, with noise on."""
    n = 64
    args = _case(cuda, n, 16)
    pos, idx, mask, h0, mp, box, cutoff, lm, ls = args
    force = reference_forward(*args).contiguous()
    c1, hdt, c2col, masses = _window_constants(cuda, n, 100.0)
    kw = dict(n_steps=4, c1=c1, hdt=hdt, c2col=c2col,
              seed=torch.tensor([7], dtype=torch.int32, device=cuda))
    wargs = (pos, torch.zeros_like(pos), force, idx, mask, h0, mp, box,
             cutoff, lm, ls, masses)
    for got, want in zip(mega_md_steps(*wargs, **kw, ablate=()),
                         mega_md_steps(*wargs, **kw)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("conv_act,mlp_act", [("gelu", "gelu"),
                                              ("silu", "silu"),
                                              ("gelu", "silu")])
def test_activation_pairs_match_plain_version(cuda, conv_act, mlp_act):
    """mega_forward under a non-default activation pair within 5e-3
    std(F) of its plain version (ragged N and K), unlike silu/gelu; and a
    window under the pair within 2e-4 of its plain window at c2col = 0."""
    n = 66
    args = _case(cuda, n, 20)
    kw = dict(conv_act=conv_act, mlp_act=mlp_act)
    out = mega_forward(*args, **kw)
    ref = reference_forward(*args, **kw)
    scale = float(ref.abs().std())
    assert float((out - ref).abs().max()) < TOLERANCE * scale
    assert float((out - mega_forward(*args)).abs().max()) > 1e-3 * scale
    vel = 0.1 * torch.randn((n, 3), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(4))
    c1, hdt, c2col, masses = _window_constants(cuda, n, 0.0)
    pos, idx, mask, h0, mp, box, cutoff, lm, ls = args
    wkw = dict(n_steps=8, c1=c1, hdt=hdt, c2col=c2col,
               seed=torch.tensor([2], dtype=torch.int32, device=cuda), **kw)
    wargs = (pos, vel, ref.contiguous(), idx, mask, h0, mp, box, cutoff, lm,
             ls, masses)
    got = mega_md_steps(*wargs, **wkw)
    want = md_steps_reference(*wargs, **wkw)
    for i in (0, 1):
        assert float((got[i] - want[i]).abs().max()) <= WINDOW_ATOL


def test_live_encoder_with_bond_and_silu_matches_plain_version(cuda):
    """live_edge_encoder's BOND form on TIP3P-774's sorted frame (the
    banded path's encode, tip3p_final's weights) against its plain version
    on the live rows (1e-4 of max |e|), under gelu and silu; a bond of
    zeros the bits of none."""
    from gamd_tpu_torch.neighbors.topology import water_bond_mask
    (pos, idx, mask, _, _, box, cutoff, lm, ls), _, ff = _water_case(cuda)
    mp = ff._kernel_params("banded")
    perm, _, idx_s = banded.sort_by_x(pos, idx)
    pos_s, idx32 = pos[perm], idx_s.to(torch.int32)
    bond = water_bond_mask(perm[:, None], perm[idx_s])
    _, _, live = banded.banded_geometry(pos_s, idx_s, mask[perm], box,
                                        cutoff)
    layout = edge_tiles.mask_layout(live)
    for act in ("gelu", "silu"):
        kw = dict(rbf_gap=ff.model_cfg.rbf_gap, mlp_act=act)
        got = live_edge_encoder(pos_s, idx32, layout, mp, box, lm, ls,
                                n_rbf=ff.model_cfg.n_rbf, bond=bond, **kw)
        ref = live_edge_encoder_reference(pos_s, idx32, layout, mp, box, lm,
                                          ls, bond=bond, **kw)
        scale = float(ref[live].abs().max())
        assert float((got[live] - ref[live]).abs().max()) <= 1e-4 * scale
    zero = live_edge_encoder(pos_s, idx32, layout, mp, box, lm, ls,
                             n_rbf=ff.model_cfg.n_rbf,
                             bond=torch.zeros_like(bond))
    none = live_edge_encoder(pos_s, idx32, layout, mp, box, lm, ls,
                             n_rbf=ff.model_cfg.n_rbf)
    assert torch.equal(zero[live], none[live])


def test_banded_water_force_matches_mega_forward(cuda):
    """GNNForceField.banded_force_fn with the bond channel on TIP3P-774
    (tip3p_final, the K=96 list, band 512) against mega_forward with the
    bond on the same frame: within 5e-3 std(F); one live_edge_encoder and
    four banded_msg launches a call."""
    (pos, idx, mask, *_), bond, ff = _water_case(cuda, layers=4)
    fn = ff.banded_force_fn()
    assert fn.banded_band == 512
    live_edge_encoder.launches = banded.banded_conv_message.launches = 0
    got = fn(pos, idx, mask)
    torch.cuda.synchronize()
    assert (live_edge_encoder.launches,
            banded.banded_conv_message.launches) == (1, 4)
    want = ff.force_fn(megakernel=True)(pos, idx, mask)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) < TOLERANCE * float(
        want.abs().std())


# -- the training loop (slice 21) ---------------------------------------------

def _train_epoch(dev, use_pallas, ckpt_dir=None, max_epoch=1):
    """train() over the training slice's four relabelled LJ-258 frames
    (GAMD-small, LayerNorm, K=96; batch 2, augmentations and dropout on,
    seed 0), on the kernel pair or the plain path; returns (state,
    history)."""
    from gamd_tpu_torch.tools.lj_train_slice import lj_train_slice
    from gamd_tpu_torch.train.loop import train

    sl = lj_train_slice(dev, use_pallas=use_pallas)
    frames = [{"pos": b["pos"][0].cpu().numpy(),
               "forces": b["forces"][0].cpu().numpy()} for b in sl.batches]
    train_cfg = dataclasses.replace(sl.train_cfg, batch_size=2,
                                    max_epoch=max_epoch)
    history = []
    state = train(sl.system, sl.model_cfg, train_cfg, frames,
                  ckpt_dir=ckpt_dir, log_fn=lambda _: None,
                  relabel_fn=sl.relabel_fn, device=dev, history=history)
    return state, history


def test_train_epoch_kernel_path_matches_plain_path(cuda):
    """One epoch of train() (two steps) through the conv_msg_gather pair
    (four forward and four backward launches a step) against the plain
    path from the same seed: the epoch's loss within 1e-4 (relative, phase
    8's bar), at least 99.9% of the parameters within 1e-5 and all within
    2 lr a step."""
    fused_conv_gather_message.launches = 0
    fused_conv_gather_message.backward_launches = 0
    kernel, k_hist = _train_epoch(cuda, True)
    assert (fused_conv_gather_message.launches,
            fused_conv_gather_message.backward_launches) == (8, 8)
    plain, p_hist = _train_epoch(cuda, False)
    assert np.isfinite(k_hist[0]["loss"])
    assert abs(k_hist[0]["loss"] - p_hist[0]["loss"]) <= 1e-4 * abs(
        p_hist[0]["loss"])
    diffs = torch.cat([(a - b).detach().abs().reshape(-1) for a, b in zip(
        kernel.model.parameters(), plain.model.parameters())])
    assert float((diffs <= 1e-5).float().mean()) >= 0.999
    assert float(diffs.max()) <= 2 * 3e-4 * 2


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A state trained for one epoch on the card, written by save_checkpoint
    and read by load_checkpoint into a fresh template on the card: the
    weights, Adam moments and steps, lr and scalers equal; one more epoch
    from each gives the same checkpoint bytes."""
    from gamd_tpu_torch.core.config import TrainConfig
    from gamd_tpu_torch.tools.lj_train_slice import lj_train_slice
    from gamd_tpu_torch.train.checkpoint import load_checkpoint
    from gamd_tpu_torch.train.state import create_train_state

    straight = str(tmp_path / "s")
    _train_epoch(cuda, True, ckpt_dir=straight, max_epoch=2)
    sl = lj_train_slice(cuda)
    template = create_train_state(
        sl.model_cfg, sl.system,
        dataclasses.replace(sl.train_cfg, batch_size=2, max_epoch=2), 2,
        device=cuda)
    state = load_checkpoint(os.path.join(straight, "checkpoint_0.msgpack"),
                            template)
    assert state.step == 2 and state.scheduler.last_epoch == 2
    assert state.force_stat.count.device.type == "cuda"
    for p in state.model.parameters():
        st = state.optimizer.state[p]
        assert p.device.type == st["exp_avg"].device.type == "cuda"
        assert int(st["step"]) == 2
    from gamd_tpu_torch.train.loop import train
    frames = [{"pos": b["pos"][0].cpu().numpy(),
               "forces": b["forces"][0].cpu().numpy()} for b in sl.batches]
    resumed = str(tmp_path / "r")
    train(sl.system, sl.model_cfg,
          dataclasses.replace(sl.train_cfg, batch_size=2, max_epoch=2,
                              start_epoch=1), frames, ckpt_dir=resumed,
          log_fn=lambda _: None, state=state, relabel_fn=sl.relabel_fn,
          device=cuda)
    with open(os.path.join(straight, "checkpoint_1.msgpack"), "rb") as f:
        want = f.read()
    with open(os.path.join(resumed, "checkpoint_1.msgpack"), "rb") as f:
        assert f.read() == want


def test_rpbe_generation_on_the_card(cuda, tmp_path, capsys):
    """generate_rpbe_surrogate on the card at a reduced size (the three
    boxes x 6 frames every 20 steps, 200 FIRE and 200 equilibration
    steps; rigid, damped-shifted-force TIP3P): the npz contract (pos and
    force [18, 192, 3] float32 in bohr and Ha/bohr, a box a frame, O, H,
    H types, the 90/10 split), SETTLE's residual under 1e-5 A, the
    recorded forces within 1e-4 of max |F| of tip3p_forces_rigid at their
    positions in each box, and the mean of the boxes' last-frame T (the
    generator's log) near 300 K: within 100 K, since 320 steps at 2/ps
    are under one friction time from the relaxed start."""
    from gamd_tpu_torch.physics import generate as tgen
    from gamd_tpu_torch.physics import water as w

    out = tgen.generate_rpbe_surrogate(
        str(tmp_path / "r.npz"), frames_per_box=6, record_interval=20,
        equil_steps=200, minimize_steps=200)
    temps = [float(line.split("T=")[1].rstrip("K")) for line in
             capsys.readouterr().out.splitlines() if "T=" in line]
    assert len(temps) == 3 and abs(sum(temps) / 3 - 300.0) <= 100.0
    bohr = units.BOHR_TO_ANGSTROM
    ha_bohr = units.HARTREE_TO_KJ_MOL / bohr          # -> kJ/mol/A
    with np.load(out) as z:
        assert z["pos"].shape == z["force"].shape == (18, 192, 3)
        assert z["pos"].dtype == z["force"].dtype == np.float32
        assert z["box"].shape == (18,) and z["atom_type"].shape == (18, 192)
        assert len(z["test_idx"]) == 1 and len(z["train_idx"]) == 17
        frames = [(torch.as_tensor(z["pos"][i] * bohr, device=cuda),
                   torch.as_tensor(z["force"][i] * ha_bohr, device=cuda),
                   float(z["box"][i]) * bohr) for i in range(18)]
    for pos, force, box in frames:
        params = w.TIP3PParams(cutoff=min(6.0, box / 2 - 0.01))
        assert float(RigidWater(64, box).residual(pos)) < 1e-5
        want = w.tip3p_forces_rigid(pos, box, params)
        assert float((force - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


def test_tip4p_generation_on_the_card(cuda, tmp_path):
    """tools.generate_data --system tip4p (1 seed, 300 FIRE steps, the
    5,000 thermalisation steps, 4 frames every 20 steps; rigid, full
    Ewald) on the card: O, H, H, M rows, M where tip4pew_m_sites puts it
    (1e-5 A) with zero force, the frames' mean T within 300 +- 20 K,
    SETTLE's residual under 1e-5 A, the recorded forces within 1e-4 of
    max |F| of the rigid Ewald forces of their positions."""
    from gamd_tpu_torch.physics import ewald
    from gamd_tpu_torch.physics import water as w
    from gamd_tpu_torch.tools import generate_data

    out = tmp_path / "tip4p_data"
    generate_data.main(["--system", "tip4p", "--seeds", "1", "--frames",
                        "4", "--interval", "20", "--minimize_steps", "300",
                        "--out", str(out)])
    assert sorted(os.listdir(out)) == [f"data_0_{t}.npz" for t in range(4)]
    system = get_preset("tip4p")
    box, n = system.box, system.n_atoms
    cst = RigidWater(n // 3, box)
    ew = ewald.make_ewald_params(box)
    masses = torch.as_tensor(system.atom_masses(), device=cuda)
    real = torch.arange(4 * n // 3, device=cuda) % 4 < 3
    temps = []
    for t in range(4):
        with np.load(out / f"data_0_{t}.npz") as z:
            pos4, vel4, f4 = (torch.as_tensor(z[k], device=cuda)
                              for k in ("pos", "vel", "forces"))
        assert pos4.shape == (4 * n // 3, 3) and not bool(f4[3::4].any())
        pos, vel, forces = pos4[real], vel4[real], f4[real]
        site = w.tip4pew_m_sites(pos[0::3], pos[1::3], pos[2::3], box,
                                 w.TIP4PEwParams())
        assert float((site - pos4[3::4]).abs().max()) <= 1e-5
        assert float(cst.residual(pos)) < 1e-5
        want = ewald.neg_grad(w.tip4pew_energy_rigid_ewald, pos, box, ew) \
            / units.KJ_MOL_NM_TO_INTERNAL
        assert float((forces - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
        v = vel * units.M_PER_S_TO_INTERNAL
        temps.append(float((masses[:, None] * v * v).sum())
                     / ((3 * n - cst.n_constraints) * units.KB))
    assert abs(sum(temps) / 4 - 300.0) <= 20.0


def test_nve_drift_probe_on_the_card(cuda, capsys):
    """tools.nve_drift_probe on the card at 27 molecules (box 10.0 A,
    cutoff 4.2 A), 200 Langevin thermalisation steps then 400 NVE steps
    of 2 fs, SHAKE and SETTLE: a leg each, finite drift, the constraint
    residual under 1e-5 A at the end, and the force probe's line."""
    from gamd_tpu_torch.tools import nve_drift_probe

    legs = nve_drift_probe.main(["--sizes", "27", "--steps", "400",
                                 "--thermalize", "200", "--force_probe"])
    out = capsys.readouterr().out
    assert out.startswith("backend: cuda")
    assert [leg["method"] for leg in legs] == ["shake", "settle"]
    for leg in legs:
        assert np.isfinite(leg["drift_kj_mol_ps"])
        assert leg["residual_a"] < 1e-5, leg
    assert "n_mol=  27 force rms=" in out


def test_analyze_pair_bias_on_lj_distill_best(cuda, tmp_path):
    """tools.analyze_pair_bias on results/ckpts/lj_distill_best.msgpack
    over classical LJ frames generated on the card (1 seed, 20 frames
    every 20 NHC steps after 200 FIRE steps; the test split's 2 frames):
    the JAX script's JSON, finite, ordered pairs in every bin past the
    LJ core (r >= 3.3 A; the bins below may be empty at 100 K, their
    profile 0), and, over the bins with pairs, the labels' projection
    tracking the analytic LJ pair force: the rms of their difference under
    half the pair force's own rms (the estimator's cross-term
    contamination, the JAX module's docstring says, attenuates it)."""
    from gamd_tpu_torch.physics.generate import generate_lj_dataset
    from gamd_tpu_torch.tools import analyze_pair_bias

    data = str(tmp_path / "lj_data")
    generate_lj_dataset(data, seeds=1, frames_per_seed=20,
                        record_interval=20, minimize_steps=200,
                        log_every_frames=0)
    out = analyze_pair_bias.main([
        "--ckpt", os.path.join(REPO, "results", "ckpts",
                               "lj_distill_best.msgpack"),
        "--data_dir", data, "--sample_num", "20", "--seed_num", "1",
        "--json_out", str(tmp_path / "bias.json")])
    assert out["frames"] == 2
    assert all(np.isfinite(np.asarray(v, np.float64)).all()
               for v in out.values())
    r = np.asarray(out["r_bins_a"])
    count = np.asarray(out["pair_count"])
    gt = np.asarray(out["gt_pair_projection_ev_a"])
    assert (count[r >= 3.3] > 0).all()
    assert (gt[count == 0] == 0.0).all()
    f_lj = np.asarray(out["analytic_lj_pair_force_ev_a"])[count > 0]
    miss = gt[count > 0] - f_lj
    assert np.sqrt((miss ** 2).mean()) < 0.5 * np.sqrt((f_lj ** 2).mean())
