"""Port parity of the conv backward's tensor-core redesign on the CPU (row 4
of the port's kernel table: csrc/conv_msg_gather_bwd.cu over
csrc/conv_tc.cuh): ops/conv_gather.py::conv_msg_gather_backward_reference,
the backward as the kernels compute it (the live edges in the layout's
order, the forward recomputed and swept back, the weight gradients summed
over the tile ranges in order), held against autograd through the port's
plain forward, against jax.grad of JAX's fp32 reference and against JAX's
Pallas backward in interpret mode; the same with its twelve products in the
kernel's bf16 x 3 arithmetic (ops/mega.py::split_bf16_matmul); the compact
tiles and ranges the kernels walk, and the scratch they are given. The
CUDA kernels themselves are held against the plain version in
tests/test_torch_cuda.py and chip_smoke.py, on the card.
"""

import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.ops.pallas_mp import (_conv_msg_gather_reference as jref,
                                    fused_conv_gather_message as jfused)

from gamd_tpu_torch.ops import conv_gather, edge_tiles, mega
from gamd_tpu_torch.tools import profile_step

W = 128
GRAD_NAMES = ("e", "hn", "src_nodes", "dst_code",
              "w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")
#: max |d| / max |grad| of each gradient, the plain backward against
#: autograd and jax.grad of the fp32 function: the same fp32 arithmetic in
#: another order.
FP32_RTOL = 1e-5
#: ... against JAX's Pallas backward, whose products are single-pass bf16
#: (tests/test_torch_train.py's 4e-2).
PALLAS_TOL = 4e-2
#: ... of the kernel's bf16 x 3 arithmetic against the fp32 plain
#: backward: the card's tolerance of row 4 (chip_smoke.py CONV_GRAD_RTOL).
CONV_GRAD_RTOL = 1e-3


def _inputs(rng, b, n, k, p_live=0.5, e_w=W, d_w=W):
    """A batch of b graphs of n nodes, K=k, e width e_w, message width d_w
    and hidden 128 (numpy, seeded); node 3 of graph 0 has no live edge,
    node 1 of the last all K."""
    e = (rng.standard_normal((b, n, k, e_w)) * 0.3).astype(np.float32)
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    mask = rng.random((b, n, k)) < p_live
    mask[0, 3] = False
    mask[-1, 1] = True
    hn, src = ((rng.standard_normal((b, n, w)) * 0.5).astype(np.float32)
               for w in (d_w, W))
    dst = (rng.standard_normal((b, n, W)) * 0.3).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.08).astype(np.float32)
          for s in [(e_w, W), (W,), (W, W), (W,), (W, W), (W,), (W, d_w),
                    (d_w,)]]
    g = rng.standard_normal((b, n, d_w)).astype(np.float32)
    return (e, idx, mask, hn, src, dst), ws, g


def _flat(args, g):
    """The batch as one graph of B*N nodes (ids offset by b*N), as the
    wrapper hands it to the kernels."""
    e, idx, mask, hn, src, dst = (torch.as_tensor(a) for a in args)
    b, n, k = idx.shape
    idx = idx + n * torch.arange(b, dtype=torch.int32)[:, None, None]
    flat = lambda t: t.reshape(b * n, *t.shape[2:])
    return (flat(e), flat(idx), flat(mask), flat(hn), flat(src),
            flat(dst)), flat(torch.as_tensor(g))


def _plain(args, ws, g):
    """conv_msg_gather_backward_reference on the flattened batch, in the
    order of GRAD_NAMES (ge as [B, N, K, 128], node grads [B, N, 128])."""
    flat, gf = _flat(args, g)
    b, n, k = args[1].shape
    ge, ghn, gsrc, gdst, *wg = conv_gather.conv_msg_gather_backward_reference(
        gf, *flat, *(torch.as_tensor(w) for w in ws))
    node = lambda t: t.reshape(b, n, -1)
    return [ge.reshape(b, n, k, -1), node(ghn), node(gsrc), node(gdst),
            *wg]


def _autograd(args, ws, g):
    """The 12 grads of sum(out * g) by autograd through the plain forward
    (fused_conv_gather_message on the CPU)."""
    e, idx, mask, hn, src, dst = (torch.as_tensor(a) for a in args)
    leaves = [t.clone().requires_grad_(True)
              for t in (e, hn, src, dst, *map(torch.as_tensor, ws))]
    te, thn, tsrc, tdst, *tws = leaves
    out = conv_gather.fused_conv_gather_message(te, idx, mask, thn, tsrc,
                                                tdst, *tws)
    return torch.autograd.grad(out, leaves, torch.as_tensor(g))


def _assert_rel(got, want, rel, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (name, err, scale)


# -- the plain backward against autograd and JAX ------------------------------

@pytest.mark.parametrize("b,n,k,seed", [
    (1, 20, 8, 0),     # fewer live edges than a tile
    (1, 66, 20, 1),    # atoms that straddle tiles, K not a multiple of 16
    (2, 37, 13, 2),    # a batch: weight grads summed over both graphs
    (1, 33, 16, 3),    # a mask with no live edge at all (below)
])
def test_backward_reference_matches_autograd(b, n, k, seed):
    """Each of the 12 grads of the kernel-form backward within 1e-5 of its
    max of autograd through the plain forward; ge exactly 0 on the masked
    slots."""
    args, ws, g = _inputs(np.random.default_rng(seed), b, n, k)
    if seed == 3:
        args[2][:] = False
    got = _plain(args, ws, g)
    want = _autograd(args, ws, g)
    for name, a, r in zip(GRAD_NAMES, got, want):
        _assert_rel(a.numpy(), r.numpy(), FP32_RTOL, name)
    mask = torch.as_tensor(args[2])
    assert bool((got[0][~mask] == 0).all())
    if seed == 3:
        assert all(not bool(t.any()) for t in got)


def _jax_grads(args, ws, g, against):
    """The 12 grads of sum(out * g) by jax.grad of JAX's fp32 reference, or
    of its Pallas entry in interpret mode (tile_n 8), on one graph."""
    e, idx, mask, hn, src, dst = (jnp.asarray(a[0]) for a in args)
    jg = jnp.asarray(g[0])

    def loss(e_, hn_, src_, dst_, ws_):
        if against == "reference":
            out = jref(e_, idx, mask, hn_, src_, dst_, *ws_)
        else:
            out = jfused(e_, idx, mask, hn_, src_, dst_, *ws_, 8, True)
        return jnp.sum(out * jg)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        e, hn, src, dst, [jnp.asarray(w) for w in ws])
    return [np.asarray(t) for t in (*grads[:4], *grads[4])]


@pytest.mark.parametrize("against,rel", [("reference", FP32_RTOL),
                                         ("pallas_interpret", PALLAS_TOL)])
def test_backward_reference_matches_jax(against, rel):
    """Against jax.grad of _conv_msg_gather_reference at 1e-5 of each
    grad's max, and against JAX's Pallas backward kernel in interpret mode
    at its own 4e-2 (tests/test_torch_train.py), on N=20, K=8."""
    args, ws, g = _inputs(np.random.default_rng(12), 1, 20, 8)
    got = [t.numpy()[0] if i < 4 else t.numpy()
           for i, t in enumerate(_plain(args, ws, g))]
    want = _jax_grads(args, ws, g, against)
    for name, a, r in zip(GRAD_NAMES, got, want):
        if against == "reference":
            _assert_rel(a, r, rel, name)
        else:
            np.testing.assert_allclose(a, r, rtol=rel, atol=rel,
                                       err_msg=name)


def _one_pass(a, w):
    return a.bfloat16().float() @ w.bfloat16().float()


@pytest.mark.parametrize("b,n,k", [(1, 66, 20), (2, 37, 13)])
def test_backward_in_kernel_arithmetic(monkeypatch, b, n, k):
    """The twelve products as bf16 x 3 (split_bf16_matmul, the kernels'
    tensor-core arithmetic): each grad within 1e-3 of its max of the fp32
    plain backward (the card's tolerance) and at least 100 times closer to
    it than single-pass bf16 products, so that the lo parts are live (b4's,
    the sum of g_m, takes no product and is the same in all three)."""
    args, ws, g = _inputs(np.random.default_rng(n + k), b, n, k)
    fp32 = _plain(args, ws, g)
    monkeypatch.setattr(conv_gather, "_edge_mm", _one_pass)
    one = _plain(args, ws, g)
    monkeypatch.setattr(conv_gather, "_edge_mm", mega.split_bf16_matmul)
    got = _plain(args, ws, g)
    for name, a, r, o in zip(GRAD_NAMES, got, fp32, one):
        err = float((a - r).abs().max())
        if name == "b4":
            assert err == 0 and torch.equal(o, r)
            continue
        assert err <= CONV_GRAD_RTOL * float(r.abs().max()), name
        assert err * 100 < float((o - r).abs().max()), name


@pytest.mark.parametrize("e_w,d_w", [(256, 256), (128, 256), (256, 128)])
def test_backward_at_the_dft_widths(monkeypatch, e_w, d_w):
    """E or D at 256 (H 128; the DFT model's 256/128/256 first), B=2
    graphs of 37 nodes, K=13: the kernel-form backward within 1e-5 of
    autograd through the plain forward, and with its products in the
    kernels' bf16 x 3 arithmetic within CONV_GRAD_RTOL of it; each grad
    of its input's shape."""
    args, ws, g = _inputs(np.random.default_rng(e_w + d_w), 2, 37, 13,
                          e_w=e_w, d_w=d_w)
    fp32 = _plain(args, ws, g)
    want = _autograd(args, ws, g)
    shapes = [args[0].shape, args[3].shape, args[4].shape, args[5].shape,
              *(w.shape for w in ws)]
    for name, a, r, shape in zip(GRAD_NAMES, fp32, want, shapes):
        assert tuple(a.shape) == tuple(shape), name
        _assert_rel(a.numpy(), r.numpy(), FP32_RTOL, name)
    monkeypatch.setattr(conv_gather, "_edge_mm", mega.split_bf16_matmul)
    for name, a, r in zip(GRAD_NAMES, _plain(args, ws, g), fp32):
        _assert_rel(a.numpy(), r.numpy(), CONV_GRAD_RTOL, name)


def test_weight_grads_place_the_blocks():
    """weight_grads of the backward's six blocks at 256/128/256 (W1's two
    row blocks, W2, W3, W4's two column blocks): gw1 [256, 128] the row
    blocks stacked, gw4 [128, 256] the column blocks side by side, gb1
    block 0's bias sum and gb4 the two column blocks' sums; at width 128
    the four blocks as they are."""
    blocks = conv_gather.split_blocks(256, 256)
    assert blocks == 6 and conv_gather.split_blocks() == 4
    gw = torch.arange(blocks, dtype=torch.float32)[:, None, None].expand(
        blocks, W, W).contiguous()
    gb = 10 + torch.arange(blocks, dtype=torch.float32)[:, None].expand(
        blocks, W).contiguous()
    gw1, gb1, gw2, gb2, gw3, gb3, gw4, gb4 = conv_gather.weight_grads(
        gw, gb, 2)
    assert gw1.shape == (256, W) and gw4.shape == (W, 256)
    assert bool((gw1[:W] == 0).all() and (gw1[W:] == 1).all())
    assert bool((gw2 == 2).all() and (gw3 == 3).all())
    assert bool((gw4[:, :W] == 4).all() and (gw4[:, W:] == 5).all())
    assert bool((gb1 == 10).all() and (gb2 == 12).all()
                and (gb3 == 13).all())
    assert gb4.shape == (256,) and bool((gb4[:W] == 14).all()
                                        and (gb4[W:] == 15).all())
    narrow = conv_gather.weight_grads(gw[:4], gb[:4], 1)
    for got, want in zip(narrow, [t for pair in zip(gw[:4], gb[:4])
                                  for t in pair]):
        assert torch.equal(got, want)


# -- the compact tiles, the ranges and the scratch ----------------------------

@pytest.mark.parametrize("m,k,total", [
    (258, 96, 5500), (16 * 258, 96, 88_000), (66, 20, 660), (66, 20, 1320),
    (20, 8, 63), (20, 8, 64), (20, 8, 65), (20, 8, 0), (1, 1, 1)])
def test_tiles_and_ranges_cover_every_live_edge_once_in_order(m, k, total):
    """The backward plan's persistent blocks take the live tiles once each
    (their rows [0, total) once, in order); the weight-gradient ranges
    take those tiles once each, in order, no range past the last tile."""
    plan = edge_tiles.backward_plan(m, k)
    tiles = sorted((first, rows) for _, first, rows
                   in edge_tiles.plan_tiles(plan, total))
    rows = [r for first, n_rows in tiles for r in range(first, first + n_rows)]
    assert rows == list(range(total))
    spans = conv_gather.wgrad_ranges(total)
    assert len(spans) == conv_gather.WGRAD_RANGES
    covered = [t for first, end in spans for t in range(first, end)]
    assert covered == list(range(len(tiles)))
    assert all(first <= end for first, end in spans)
    # The plain backward's ranges are the kernel's rows.
    assert all(first * mega.TILE_ROWS < total or first == end
               for first, end in spans)


@pytest.mark.parametrize("m,k", [(258, 96), (16 * 258, 96), (66, 20),
                                 (1, 1)])
def test_backward_plan_and_scratch(m, k):
    """One block an SM (the shared memory of two weight buffers, the
    activations and the g_z2 tile fits once), a grid of the least of the
    capacity's tiles and the SMs; the scratch: 8 compact planes of 32 KB a
    tile of the capacity, g_hsrc and g_z2 at every slot, the partials,
    each view 256-byte aligned in one buffer."""
    plan = edge_tiles.backward_plan(m, k)
    tiles = -(-m * k // mega.TILE_ROWS)
    assert plan.tiles == tiles and plan.grid == min(tiles,
                                                    edge_tiles.H100_SMS)
    assert plan.threads == 256 and plan.nbuf == 2
    assert plan.smem == edge_tiles.BACKWARD_SMEM <= edge_tiles.MAX_SMEM
    assert 2 * plan.smem > edge_tiles.MAX_SMEM
    planes, rows, wpart, bpart = conv_gather.backward_scratch(m, k, plan,
                                                              "cpu")
    assert planes.shape == (8, tiles, 2 * 2 * mega.TILE_ROWS * W)
    assert planes.dtype == torch.uint8
    assert rows.shape == (2, m * k, W) and rows.dtype == torch.float32
    assert wpart.shape == (4, conv_gather.WGRAD_RANGES, W, W)
    assert bpart.shape == (4, conv_gather.WGRAD_RANGES, W)
    storage = planes.untyped_storage()
    base = storage.data_ptr()
    assert planes.data_ptr() == base
    for view in (rows, wpart, bpart):
        assert view.untyped_storage().data_ptr() == base
        assert (view.data_ptr() - base) % 256 == 0
    assert storage.nbytes() >= planes.numel() + 4 * (
        rows.numel() + wpart.numel() + bpart.numel())


@pytest.mark.parametrize("e_w,d_w,planes", [(256, 256, 10), (128, 256, 9),
                                            (256, 128, 9)])
def test_backward_scratch_at_the_dft_widths(e_w, d_w, planes):
    """The scratch at E or D = 256: E/128 + D/128 + 6 compact planes (e's
    and g_m's column blocks, ten at 256/128/256), g_hsrc at width D and
    g_z2 at 128 as rows [(D + 128) / 128, M*K, 128], the partials of the
    E/128 + 2 + D/128 weight blocks; the plan and its shared memory those
    of width 128 (the activation tile stays 64 x 128: wide products run a
    128-wide block at a time), one block an SM within MAX_SMEM."""
    m, k = 192, 192
    plan = edge_tiles.backward_plan(m, k)
    assert plan.smem == edge_tiles.BACKWARD_SMEM <= edge_tiles.MAX_SMEM
    p, rows, wpart, bpart = conv_gather.backward_scratch(m, k, plan, "cpu",
                                                         e_w, d_w)
    assert conv_gather.bwd_planes(e_w, d_w) == planes
    assert p.shape == (planes, plan.tiles, conv_gather.PLANE_BYTES)
    assert rows.shape == ((d_w + W) // W, m * k, W)
    blocks = conv_gather.split_blocks(e_w, d_w)
    assert wpart.shape == (blocks, conv_gather.WGRAD_RANGES, W, W)
    assert bpart.shape == (blocks, conv_gather.WGRAD_RANGES, W)
    base = p.untyped_storage().data_ptr()
    for view in (rows, wpart, bpart):
        assert (view.data_ptr() - base) % 256 == 0


@pytest.mark.parametrize("kernel,name", [
    ("void (anonymous namespace)::dead_rows_kernel(unsigned char const*, "
     "long long, float*)", "dead_rows_kernel"),
    ("void (anonymous namespace)::conv_bwd_tile_kernel<(anonymous "
     "namespace)::GatherSrc>(CUtensorMap_st, (anonymous namespace)::"
     "BwdArgs, (anonymous namespace)::GatherSrc)",
     "conv_bwd_tile_kernel[GatherSrc]"),
    ("void (anonymous namespace)::source_sum_kernel(int const*, int "
     "const*, float const*, float const*, float*, float*)",
     "source_sum_kernel"),
    ("void (anonymous namespace)::tile_fixup_kernel((anonymous namespace)"
     "::SlotLayout, float const*, int, float*)", "tile_fixup_kernel"),
    ("void (anonymous namespace)::wgrad_tc_kernel(unsigned char const*, "
     "int, int const*, float*, float*)", "wgrad_tc_kernel"),
    ("void (anonymous namespace)::wgrad_sum_kernel(float const*, float "
     "const*, float*, float*)", "wgrad_sum_kernel"),
])
def test_profile_names_of_the_backward_kernels(kernel, name):
    """tools/profile_step.py's short names of the backward's kernels
    (CONV_BWD_KERNELS), which phase 7 of chip_smoke.py reads."""
    assert profile_step.short_name(kernel) == name
    assert name in profile_step.CONV_BWD_KERNELS
