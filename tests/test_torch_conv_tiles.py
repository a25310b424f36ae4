"""Port parity of the conv message's tensor-core redesign on the CPU (rows 3
and 6 of the port's kernel table: csrc/conv_msg_gather.cu and
csrc/banded_msg.cu over csrc/conv_tc.cuh; rows 7 and 8 on the same tiles
in tests/test_torch_op_tiles.py): the live-edge layout from the mask
(ops/edge_tiles.py::mask_layout, whose CPU path is ops/mega.py::
live_slot_layout), the plain conv message with its four products in the
kernel's bf16 x 3 arithmetic (ops/mega.py::split_bf16_matmul put in the
place of ops/conv_gather.py::_edge_mm) under both source addressings, held
against JAX's fp32 plain reference and the port's fp32 plain version, the
tile kernel's launch plans, and the profiler's names of the tiles'
kernels. The CUDA kernels themselves are held against their plain
versions in tests/test_torch_cuda.py and chip_smoke.py, on the card.
"""

import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.ops.pallas_mp import _conv_msg_gather_reference as jref
from gamd_tpu.physics import lennard_jones as jlj

from gamd_tpu_torch.neighbors.dense import dense_neighbor_list
from gamd_tpu_torch.ops import banded, conv_gather, edge_tiles, mega
from gamd_tpu_torch.tools import profile_step

W = 128
#: max |d agg| / max |agg| of the kernel's arithmetic against the fp32
#: function: the card's tolerance of rows 3 and 6 (chip_smoke.py CONV_RTOL).
CONV_RTOL = 1e-4


def _mask(shape, seed, p=0.25):
    return torch.as_tensor(np.random.default_rng(seed).random(shape) < p)


# -- the live-edge layout from the mask ---------------------------------------

@pytest.mark.parametrize("b,n,k", [(2, 37, 20), (1, 10, 96), (3, 5, 33)])
def test_mask_layout_is_nonzero_order_with_offsets_and_counts(b, n, k):
    """A [B, N, K] mask is one graph of B*N atoms: the layout's slots are
    torch.nonzero's order of the flat mask (atom-major, slot order within
    an atom) up to total and -1 past it, counts the live slots of each
    atom, offsets their exclusive scan; an all-masked row has count 0 and
    the next atom's offset; an all-live row K slots. N % 16 != 0."""
    mask = _mask((b, n, k), seed=b * n + k)
    mask[0, 3] = False
    mask[-1, 1] = True
    lay = edge_tiles.mask_layout(mask)
    flat = mask.reshape(b * n, k)
    ids = torch.nonzero(flat.reshape(-1)).flatten()
    total = int(lay.total[0])
    cap = mega.layout_capacity(b * n, k)
    assert lay.slot.shape == (1, cap) and cap % mega.TILE_ROWS == 0
    assert total == ids.numel() == int(flat.sum())
    assert torch.equal(lay.slot[0, :total].long(), ids)
    assert bool((lay.slot[0, total:] == -1).all())
    count = flat.sum(1)
    assert torch.equal(lay.count[0].long(), count)
    assert torch.equal(lay.offset[0].long(), torch.cumsum(count, 0) - count)
    assert lay.count[0, 3] == 0 and lay.offset[0, 3] == lay.offset[0, 4]
    assert lay.count[0, (b - 1) * n + 1] == k


def test_mask_layout_of_an_all_masked_list():
    lay = edge_tiles.mask_layout(torch.zeros((4, 7), dtype=torch.bool))
    assert int(lay.total[0]) == 0 and not bool(lay.count.any())
    assert bool((lay.offset == 0).all()) and bool((lay.slot == -1).all())
    assert edge_tiles.plan_tiles(edge_tiles.launch_plan(4, 7), 0) == []


def test_mask_layout_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        edge_tiles.mask_layout(torch.zeros((4, 8), dtype=torch.bool,
                                           device="meta"))


# -- the conv message in the kernel's arithmetic ------------------------------

def _inputs(rng, n, k, p_live=0.6):
    e = (rng.standard_normal((n, k, W)) * 0.3).astype(np.float32)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    mask = rng.random((n, k)) < p_live
    hn, src = ((rng.standard_normal((n, W)) * 0.5).astype(np.float32)
               for _ in range(2))
    dst = (rng.standard_normal((n, W)) * 0.3).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.08).astype(np.float32)
          for s in [(W, W), (W,)] * 4]
    return e, idx, mask, hn, src, dst, ws


def _split(monkeypatch):
    monkeypatch.setattr(conv_gather, "_edge_mm", mega.split_bf16_matmul)


def _one_pass(a, w):
    return a.bfloat16().float() @ w.bfloat16().float()


def _hold(got, fp32, jax_fp32, one_pass):
    """got (the kernel's arithmetic) within CONV_RTOL of max |agg| of the
    port's and JAX's fp32 plain versions, and at least 100 times closer to
    them than single-pass bf16 products: the lo parts are live."""
    scale = float(fp32.abs().max())
    err = float((got - fp32).abs().max())
    assert err <= CONV_RTOL * scale, (err, scale)
    assert float((got - torch.as_tensor(np.array(jax_fp32))).abs().max()) \
        <= CONV_RTOL * scale
    assert err * 100 < float((one_pass - fp32).abs().max())


def test_split_conv_message_by_node_id_matches_jax(monkeypatch):
    """Row 3's addressing on a batch of B=2 graphs of N=66 (K=20): the
    plain version with its four products as bf16 x 3, each graph against
    JAX's _conv_msg_gather_reference (pallas_mp.py:485-492) and the port's
    fp32 plain version."""
    rng = np.random.default_rng(3)
    graphs = [_inputs(rng, 66, 20) for _ in range(2)]
    t = lambda i: torch.stack([torch.as_tensor(g[i]) for g in graphs])
    e, idx, mask, hn, src, dst = (t(i) for i in range(6))
    ws = [torch.as_tensor(w) for w in graphs[0][6]]
    want = conv_gather.batched_reference(e, idx, mask, hn, src, dst, *ws)
    with monkeypatch.context() as mp:
        mp.setattr(conv_gather, "_edge_mm", _one_pass)
        one = conv_gather.batched_reference(e, idx, mask, hn, src, dst, *ws)
    _split(monkeypatch)
    before = conv_gather.fused_conv_gather_message.launches
    got = conv_gather.fused_conv_gather_message(e, idx, mask, hn, src, dst,
                                                *ws)
    assert conv_gather.fused_conv_gather_message.launches == before
    jws = [graphs[0][6][i] for i in range(8)]
    jax_out = np.stack([np.asarray(jref(*[jnp.asarray(a) for a in g[:6]],
                                        *jws)) for g in graphs])
    _hold(got, want, jax_out, one)


def test_split_conv_message_from_a_band_matches_jax(monkeypatch):
    """Row 6's addressing at N=1,000 (a partial last band tile; arcs that
    start below row 0), K=32: banded_conv_message's plain version in the
    sorted frame with its products as bf16 x 3, unsorted, against JAX's
    fp32 reference and the port's fp32 gather on the original frame. The
    data holds an atom whose live list straddles a 64-edge tile and an
    edge tile that spans two band tiles."""
    n, k, band, tile_n = 1000, 32, 512, 64
    box, pos = jlj.lj_fluid_box(n, 0.5)
    rng = np.random.default_rng(1)
    pos = ((np.asarray(pos) + rng.standard_normal(pos.shape) * 0.1)
           % box).astype(np.float32)
    idx, mask, _ = dense_neighbor_list(torch.as_tensor(pos), float(box), 6.0,
                                       k)
    e, _, _, hn, src, dst, ws_np = _inputs(rng, n, k)
    e, hn, src, dst = map(torch.as_tensor, (e, hn, src, dst))
    ws = [torch.as_tensor(w) for w in ws_np]
    want = conv_gather.conv_msg_gather_reference(e, idx, mask, hn, src, dst,
                                                 *ws)
    jax_out = np.asarray(jref(*[jnp.asarray(np.asarray(a)) for a in (
        e, idx, mask, hn, src, dst)], *[jnp.asarray(w) for w in ws_np]))

    perm, inv, idx_s = banded.sort_by_x(torch.as_tensor(pos), idx)
    mask_s = mask[perm]
    idx_loc, lo, ovf = banded.band_layout(idx_s, mask_s, n, band, tile_n)
    assert not bool(ovf)
    np_rows = -(-n // 16) * 16
    nodes = torch.zeros((np_rows, 2 * W))
    nodes[:n] = torch.cat([hn[perm], src[perm]], dim=1)
    nodes = torch.cat([nodes, nodes[:band]])
    lay = edge_tiles.mask_layout(mask_s)
    off, cnt = lay.offset[0], lay.count[0]
    tile_of = lambda row: row // mega.TILE_ROWS
    assert any(tile_of(int(o)) != tile_of(int(o + c - 1))
               for o, c in zip(off, cnt) if c > 0)
    assert any(tile_of(int(off[i])) == tile_of(int(off[i + 1]))
               for i in range(tile_n - 1, n - 1, tile_n))
    args = (e[perm], idx_loc, mask_s, lo, nodes, dst[perm])
    names = ("w_e1", "b_e1", "w_e2", "b_e2", "w_t1", "b_t1", "w_t2", "b_t2")
    layer = mega.MegaParams._make([None] * len(mega.MegaParams._fields))
    layer = layer._replace(**{name: wt[None] if name.startswith("w")
                              else wt[None, None]
                              for name, wt in zip(names, ws)})
    with monkeypatch.context() as mp:
        mp.setattr(conv_gather, "_edge_mm", _one_pass)
        one = banded.banded_conv_message(*args, 0, layer, band, tile_n)[inv]
    _split(monkeypatch)
    got = banded.banded_conv_message(*args, 0, layer, band, tile_n,
                                     layout=lay)[inv]
    _hold(got, want, jax_out, one)


# -- the tile kernel's launch plans -------------------------------------------

#: (M, K) of the paths: deployment and training (LJ-258, K=96; a batch of
#: 16), large N (4,096; 10,000), the card tests' small shapes.
SHAPES = [(258, 96), (16 * 258, 96), (4096, 96), (10_000, 96), (66, 20),
          (1, 1)]


@pytest.mark.parametrize("m,k", SHAPES)
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_covers_the_live_tiles_once(m, k, sms):
    """launch_plan's plan is one the entries take; for any live count up to
    the capacity its blocks take every tile once, 64 rows at most, the
    last one short; the shared memory fits a block."""
    plan = edge_tiles.launch_plan(m, k, sms)
    edge_tiles.check_plan(plan, m, k, sms)
    assert 0 < plan.smem <= edge_tiles.MAX_SMEM
    cap = mega.layout_capacity(m, k)
    for total in sorted({0, 1, 63, 64, 65, cap // 5, cap - 1, cap}):
        tiles = edge_tiles.plan_tiles(plan, total)
        rows = sorted((row0, n) for _, row0, n in tiles)
        assert [r for r, _ in rows] == list(range(0, total, 64))
        assert sum(n for _, n in rows) == total
        assert all(0 < n <= 64 for _, n in rows)
        assert all(0 <= b < plan.grid for b, _, _ in tiles)


def test_plans_of_the_paths():
    """Two weight buffers (one block an SM) at the deployment's B=1 shape,
    one (two blocks an SM, a grid of twice the SMs) from a batch of 16
    and at large N."""
    plans = {shape: edge_tiles.launch_plan(*shape) for shape in SHAPES}
    assert plans[(258, 96)].nbuf == 2 and plans[(258, 96)].grid == 132
    for shape in [(16 * 258, 96), (4096, 96), (10_000, 96)]:
        assert plans[shape].nbuf == 1 and plans[shape].grid == 264
    assert plans[(1, 1)].grid == 1


def _bad_plans():
    good = edge_tiles.launch_plan(10_000, 96)
    yield good._replace(threads=128), "threads"
    yield good._replace(nbuf=3, smem=edge_tiles.tile_smem(3)), "buffers"
    yield good._replace(smem=good.smem + 16), "shared memory"
    yield good._replace(grid=0), "no block"
    yield good._replace(grid=2 * 132 + 1), "more blocks than the card holds"
    yield good._replace(tiles=good.tiles - 1), "capacity"
    small = edge_tiles.launch_plan(66, 20)
    yield small._replace(grid=small.tiles + 1), "more blocks than tiles"


@pytest.mark.parametrize("plan,why", list(_bad_plans()))
def test_inconsistent_plan_is_refused(plan, why):
    m, k = (66, 20) if plan.tiles <= 21 else (10_000, 96)
    with pytest.raises(ValueError, match="inconsistent plan"):
        edge_tiles.check_plan(plan, m, k)


# -- the profiler's reading of the kernels ------------------------------------

@pytest.mark.parametrize("e_w,d_w", [(256, 256), (128, 256), (256, 128)])
def test_call_scratch_and_plan_at_the_dft_widths(e_w, d_w):
    """The forward's scratch at E or D = 256: the split table's
    E/128 + 2 + D/128 blocks of 64 KB (six at 256/128/256) and the
    partials [tiles, 2, D]; the launch plan and its shared memory are width
    128's (a tile's products run 128-wide blocks through the same ring and
    activation buffer), within MAX_SMEM."""
    m, k = 4 * 192, 192
    plan = edge_tiles.launch_plan(m, k)
    assert plan.smem == edge_tiles.tile_smem(plan.nbuf) <= edge_tiles.MAX_SMEM
    blocks = conv_gather.split_blocks(e_w, d_w)
    _, lay, _, wsplit, part = edge_tiles.call_scratch(
        m, k, plan, "cpu", n_weights=blocks, width=d_w)
    assert wsplit.numel() == blocks * edge_tiles.SPLIT_BYTES
    assert part.shape == (plan.tiles, 2, d_w)
    assert lay.slot.shape == (1, mega.layout_capacity(m, k))


def test_unsupported_widths_raise_before_any_work():
    """check_widths, the kernels' first check on the card: E and D unequal
    or other than 128 and 256, or H other than 128, raise ValueError naming
    the widths taken; the widths taken come back as (E, H, D)."""
    z = lambda *s: torch.zeros(s)
    assert conv_gather.check_widths(z(256, 128), z(128, 256)) == (256, 128,
                                                                  256)
    for w1, w4 in ((z(192, 128), z(128, 128)), (z(128, 128), z(128, 64)),
                   (z(256, 256), z(256, 256)), (z(128, 128), z(64, 128)),
                   (z(128, 128), z(128, 256)), (z(256, 128), z(128, 128))):
        with pytest.raises(ValueError, match="E = D in .128, 256. and H "
                                             "= 128|w1 .E, H. and w4"):
            conv_gather.check_widths(w1, w4)


@pytest.mark.parametrize("kernel,name", [
    ("void (anonymous namespace)::conv_tile_kernel<1, (anonymous namespace)"
     "::BandSrc>(CUtensorMap_st, (anonymous namespace)::TileArgs, "
     "(anonymous namespace)::BandSrc)", "conv_tile_kernel[BandSrc]"),
    ("void (anonymous namespace)::conv_tile_kernel<2, (anonymous namespace)"
     "::GatherSrc>(CUtensorMap_st, (anonymous namespace)::TileArgs, "
     "(anonymous namespace)::GatherSrc)", "conv_tile_kernel[GatherSrc]"),
    ("void (anonymous namespace)::conv_tile_kernel<2, (anonymous namespace)"
     "::PreSrc>(CUtensorMap_st, (anonymous namespace)::TileArgs, "
     "(anonymous namespace)::PreSrc)", "conv_tile_kernel[PreSrc]"),
    ("void (anonymous namespace)::conv_tile_kernel<1, (anonymous namespace)"
     "::ClampedSrc>(CUtensorMap_st, (anonymous namespace)::TileArgs, "
     "(anonymous namespace)::ClampedSrc)", "conv_tile_kernel[ClampedSrc]"),
    ("void (anonymous namespace)::conv_update_kernel<4>((anonymous "
     "namespace)::UpdateArgs)", "conv_update_kernel[B=4]"),
    ("void (anonymous namespace)::conv_update_kernel<16>((anonymous "
     "namespace)::UpdateArgs)", "conv_update_kernel[B=16]"),
    ("(anonymous namespace)::tile_fixup_kernel((anonymous namespace)::"
     "SlotLayout, float const*, int, float*)", "tile_fixup_kernel"),
    ("(anonymous namespace)::mask_count_kernel(unsigned char const*, int, "
     "int, (anonymous namespace)::SlotLayout)", "mask_count_kernel"),
    ("(anonymous namespace)::mask_slots_kernel(unsigned char const*, int, "
     "int, (anonymous namespace)::SlotLayout)", "mask_slots_kernel"),
    ("(anonymous namespace)::split_conv_weights_kernel((anonymous "
     "namespace)::EdgeWeights, __nv_bfloat16*)",
     "split_conv_weights_kernel"),
])
def test_profile_step_names_the_conv_message_kernels(kernel, name):
    """Each kernel of rows 3, 6, 7 and 8 gets a short name, and the banded
    path's share of the banded message counts every one of its own and
    none of the other rows' (their tile kernels by source policy, row 7's
    node update)."""
    assert profile_step.short_name(kernel) == name
    assert name in profile_step.CONV_KERNELS
    other = ("GatherSrc", "PreSrc", "ClampedSrc", "conv_update_kernel")
    banded_own = not any(tag in name for tag in other)
    assert (name in profile_step.BANDED_KERNELS) == banded_own
