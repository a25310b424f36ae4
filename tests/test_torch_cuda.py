"""The CUDA kernels mega_forward, mega_md_steps, the conv-message pair
(conv_msg_gather forward and backward), edge_encoder and banded_msg
against their plain PyTorch versions, on a Hopper card (capability 9.x).
Without one every test here skips.

On the card (which has no JAX) run this file without the JAX package's
conftest:  python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py
"""

import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import numpy as np
import pytest
import torch

from gamd_tpu_torch.core.config import MDConfig, ModelConfig, get_preset
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.neighbors.cell_list import cell_list_neighbor_list
from gamd_tpu_torch.neighbors.dense import build_nbrs, dense_neighbor_list
from gamd_tpu_torch.ops import banded
from gamd_tpu_torch.ops.conv_gather import (batched_reference,
                                            fused_conv_gather_message)
from gamd_tpu_torch.ops.encoder import (edge_encoder_reference,
                                        fused_edge_encoder)
from gamd_tpu_torch.ops.mega import (md_steps_reference, mega_forward,
                                     mega_md_steps, pack_params,
                                     reference_forward)
from gamd_tpu_torch.physics.lennard_jones import lj_fluid_box
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
    (64, 16, True, False),     # one edge chunk, full node blocks
    (66, 20, True, True),      # ragged edge chunk and node block, flip_dir
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


def test_kernel_rejects_what_it_does_not_take(cuda):
    pos, idx, mask, h0, mp, *rest = _case(cuda, 64, 16)
    before = mega_forward.launches
    with pytest.raises(ValueError, match="idx"):
        mega_forward(pos, idx.long(), mask, h0, mp, *rest)
    with pytest.raises(ValueError, match="pos"):
        mega_forward(pos.t().contiguous().t(), idx, mask, h0, mp, *rest)
    with pytest.raises(ValueError, match="h0"):
        mega_forward(pos, idx, mask, h0[:, :64].contiguous(), mp, *rest)
    with pytest.raises(NotImplementedError):
        mega_forward(pos, idx, mask, h0, mp, *rest,
                     bond=torch.zeros_like(mask, dtype=torch.float32))
    assert mega_forward.launches == before


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
    with pytest.raises(NotImplementedError):
        mega_md_steps(pos, vel, vel, idx, mask, h0, mp, *rest, masses,
                      bond=torch.zeros_like(mask, dtype=torch.float32),
                      **kw)
    assert mega_md_steps.launches == before


def _conv_inputs(dev, b, n, k, seed=0):
    """e, idx, mask, hn, src_nodes, dst_code [B, N, ...] and the 8 weights
    at width 128 on `dev`, drawn as tests/test_ops.py draws them."""
    rng = np.random.RandomState(seed)
    w = 128
    t = lambda a: torch.as_tensor(a, device=dev)
    f32 = lambda *s, scale: t(rng.randn(*s).astype(np.float32) * scale)
    inputs = [f32(b, n, k, w, scale=0.3),
              t(rng.randint(0, n, (b, n, k)).astype(np.int32)),
              t(rng.rand(b, n, k) > 0.3),
              f32(b, n, w, scale=0.5), f32(b, n, w, scale=0.5),
              f32(b, n, w, scale=0.3)]
    weights = [f32(*s, scale=0.08) for s in
               [(w, w), (w,), (w, w), (w,), (w, w), (w,), (w, w), (w,)]]
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


def _encoder_inputs(dev, b, n, k, seed=0):
    """b frames of n atoms in the BOX, their lists (built at 5.0 A, the
    encoder's cutoff 4.2 A refines them) and seeded encoder weights [44,
    128], [128], ... on `dev`."""
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(0, BOX, (b, n, 3)).astype(np.float32),
                          device=dev)
    lists = [dense_neighbor_list(p, BOX, 5.0, k) for p in pos]
    idx = torch.stack([t[0] for t in lists])
    mask = torch.stack([t[1] for t in lists])
    w = lambda *s: torch.as_tensor(
        (rng.standard_normal(s) * 0.1).astype(np.float32), device=dev)
    weights = [w(44, 128), w(128), w(128, 128), w(128), w(128, 128),
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
    assert call.launches == before


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
