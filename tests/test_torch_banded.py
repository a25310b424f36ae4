"""Port parity of the large-N slice on the CPU: the cell list, the
neighbour-search module, band_layout, the banded conv message's plain
version (the CUDA banded_msg's reference), the banded force path against
the JAX reference forward and the JAX banded kernel in interpret mode,
Simulation(nbr_method="cell"), and run_md --banded. Each test feeds the
same seeded numpy inputs to the JAX function and to its port and states
its tolerance. The kernel itself is held against its plain version in
tests/test_torch_cuda.py and chip_smoke.py, on the card.
"""

import json
import math
import os
from types import SimpleNamespace
from unittest import mock

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.md.simulate import Simulation as JSimulation
from gamd_tpu.models.gnn import GAMDNet as JGAMDNet
from gamd_tpu.models.normalizer import stat_from_values
from gamd_tpu.neighbors import search as jsearch
from gamd_tpu.neighbors.cell_list import cell_list_neighbor_list as jcell
from gamd_tpu.neighbors.dense import dense_neighbor_list as jdense
from gamd_tpu.ops import banded as jbanded
from gamd_tpu.ops.pallas_model import pack_params as jpack
from gamd_tpu.ops.pallas_model import reference_forward as jreference
from gamd_tpu.physics import lennard_jones as jlj
from gamd_tpu.train.checkpoint import save_checkpoint
from gamd_tpu.train.forcefield import GNNForceField as JForceField
from gamd_tpu.train.state import build_model, create_train_state

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.neighbors import search
from gamd_tpu_torch.neighbors.cell_list import cell_list_neighbor_list
from gamd_tpu_torch.neighbors.dense import dense_neighbor_list
from gamd_tpu_torch.ops import banded
from gamd_tpu_torch.ops.conv_gather import conv_msg_gather_reference
from gamd_tpu_torch.ops.mega import pack_params
from gamd_tpu_torch.physics import lennard_jones as tlj
from gamd_tpu_torch.tools import bench_large, run_md
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.state import (ForceFieldState, params_from_jax,
                                        stat_from_jax)

CUTOFF, K = 6.0, 32            # tests/test_banded.py's list
LENGTH = (3.0, 1.0)            # edge-length scaler (mean, std)
REF_RTOL = 1e-4                # max |dF| / std(F) against fp32 reference
THERMO_HEADER = ('#"Step"\t"Time (ps)"\t"Kinetic Energy (kJ/mole)"\t'
                 '"Temperature (K)"')


def _frame(n, seed=0, sigma=0.1):
    """(box, positions [N, 3] float32 numpy): the LJ lattice at reduced
    density 0.5 with a seeded jitter, wrapped."""
    box, pos = jlj.lj_fluid_box(n, 0.5)
    rng = np.random.RandomState(seed)
    pos = (pos + rng.randn(*pos.shape).astype(np.float32) * sigma) % box
    return float(box), pos.astype(np.float32)


def _live_sets(idx, mask):
    idx, mask = np.asarray(idx), np.asarray(mask)
    return [frozenset(idx[i][mask[i]].tolist()) for i in range(len(idx))]


# -- the cell list ----------------------------------------------------------

@pytest.mark.parametrize("n,radius,k_max", [(1024, CUTOFF, K),
                                            (512, 8.0, 96)])
def test_cell_list_matches_jax(n, radius, k_max):
    """The same set of neighbour ids and the same live count in every row
    as JAX's cell list (exact), no overflow on either side, padded slots
    holding the row index, nearest first."""
    box, pos = _frame(n)
    ji, jm, jo = jcell(jnp.asarray(pos), box, radius, k_max)
    ti, tm, to = cell_list_neighbor_list(torch.as_tensor(pos), box, radius,
                                         k_max)
    assert ti.dtype == torch.int32 and tm.dtype == torch.bool
    assert ti.shape == tm.shape == (n, k_max)
    assert to.ndim == 0 and not bool(to) and not bool(jo)
    np.testing.assert_array_equal(tm.sum(1).numpy(),
                                  np.asarray(jm).sum(1))
    assert _live_sets(ti, tm) == _live_sets(ji, jm)
    rows = torch.arange(n)[:, None].expand(n, k_max)
    assert torch.equal(ti[~tm], rows[~tm].to(torch.int32))
    p = torch.as_tensor(pos)
    d = torch.remainder(p[ti.long()] - p[:, None] + box / 2, box) - box / 2
    r2 = torch.where(tm, torch.sum(d * d, dim=-1), torch.inf)
    assert bool((r2[:, 1:] >= r2[:, :-1]).all())       # nearest first


def test_cell_list_equals_dense_list():
    """The cell list equals the port's own dense list at the same radius:
    the same ids in the same slots and the same mask (exact)."""
    box, pos = _frame(1000, seed=3)
    p = torch.as_tensor(pos)
    ci, cm, co = cell_list_neighbor_list(p, box, 7.0, 48)
    di, dm, do = dense_neighbor_list(p, box, 7.0, 48)
    assert not bool(co) and not bool(do)
    assert torch.equal(cm, dm)
    assert torch.equal(ci, di)


@pytest.mark.parametrize("cell_capacity,k_max,expect", [
    (16, K, False),        # fits
    (4, K, True),          # a cell holds more than 4 particles
    (16, 6, True),         # a row has more than 6 neighbours in range
])
def test_cell_list_overflow_flags_match_jax(cell_capacity, k_max, expect):
    box, pos = _frame(512, seed=4)
    _, _, jo = jcell(jnp.asarray(pos), box, CUTOFF, k_max,
                     cell_capacity=cell_capacity)
    _, _, to = cell_list_neighbor_list(torch.as_tensor(pos), box, CUTOFF,
                                       k_max, cell_capacity=cell_capacity)
    assert bool(to) == bool(jo) == expect


def test_cell_list_refuses_fewer_than_three_cells():
    pos = np.zeros((8, 3), np.float32)
    with pytest.raises(ValueError, match="< 3"):
        jcell(jnp.asarray(pos), 10.0, 4.0, 4)
    with pytest.raises(ValueError, match="< 3"):
        cell_list_neighbor_list(torch.as_tensor(pos), 10.0, 4.0, 4)


# -- the search module ------------------------------------------------------

@pytest.mark.parametrize("method", ["dense", "cell"])
def test_neighbor_search_module_matches_jax(method):
    """build_neighbor_list (wrapped reference positions, cutoff + skin),
    edge_mask_fn and needs_rebuild against JAX's, exact."""
    box, pos = _frame(512, seed=5)
    shifted = pos + 1.5 * box            # unwrapped input
    jn = jsearch.build_neighbor_list(jnp.asarray(shifted), box, CUTOFF, 1.0,
                                     K, method=method)
    tn = search.build_neighbor_list(torch.as_tensor(shifted), box, CUTOFF,
                                    1.0, K, method=method)
    np.testing.assert_array_equal(tn.reference_pos.numpy(),
                                  np.asarray(jn.reference_pos))
    assert _live_sets(tn.idx, tn.mask) == _live_sets(jn.idx, jn.mask)
    assert bool(tn.overflow) == bool(jn.overflow)
    moved = pos + np.random.RandomState(6).uniform(
        -0.3, 0.3, pos.shape).astype(np.float32)
    # edge_mask_fn on JAX's own list (slot order may differ at ties).
    tn_same = tn._replace(idx=torch.as_tensor(np.array(jn.idx)),
                          mask=torch.as_tensor(np.array(jn.mask)))
    np.testing.assert_array_equal(
        search.edge_mask_fn(torch.as_tensor(moved), box, CUTOFF,
                            tn_same).numpy(),
        np.asarray(jsearch.edge_mask_fn(jnp.asarray(moved), box, CUTOFF,
                                        jn)))
    for skin in (0.5, 2.0):             # stale, then still fresh
        assert bool(search.needs_rebuild(torch.as_tensor(moved), box, skin,
                                         tn)) \
            == bool(jsearch.needs_rebuild(jnp.asarray(moved), box, skin, jn))
    with pytest.raises(ValueError, match="unknown neighbor method"):
        search.build_neighbor_list(torch.as_tensor(pos), box, CUTOFF, 1.0,
                                   K, method="tree")


@pytest.mark.parametrize("method", ["dense", "cell"])
def test_neighbor_searcher_grows_capacity_as_jax(method):
    """From K=4 both searchers grow 4 -> 7 -> 11 -> ... until the list
    fits: the same final capacity and the same lists (exact)."""
    box, pos = _frame(512, seed=7)
    js = jsearch.NeighborSearcher(box, CUTOFF, skin=0.5, k_max=4,
                                  method=method)
    ts = search.NeighborSearcher(box, CUTOFF, skin=0.5, k_max=4,
                                 method=method)
    jn = js.init_new_neighbor_lst(jnp.asarray(pos))
    tn = ts.init_new_neighbor_lst(torch.as_tensor(pos))
    assert ts.k_max == js.k_max > 4
    assert ts.has_been_init and js.has_been_init
    assert not bool(tn.overflow)
    assert _live_sets(tn.idx, tn.mask) == _live_sets(jn.idx, jn.mask)
    # A small move keeps the list; a large one rebuilds it.
    assert ts.update_neighbor_lst(torch.as_tensor(pos + 0.01), tn) is tn
    rebuilt = ts.update_neighbor_lst(torch.as_tensor(pos + 0.6), tn)
    assert rebuilt is not tn


# -- band_layout ------------------------------------------------------------

def _sorted_list(n, seed, cutoff=CUTOFF, k=K):
    """A JAX dense list of a jittered frame carried into the x-sorted
    frame, as make_banded_force_fn does: (idx_s, mask_s) numpy."""
    box, pos = _frame(n, seed=seed)
    idx, mask, _ = jdense(jnp.asarray(pos), box, cutoff, k)
    perm = jnp.argsort(jnp.asarray(pos)[:, 0])
    inv = jnp.argsort(perm)
    return np.array(inv[idx[perm]]), np.array(mask[perm])


@pytest.mark.parametrize("n,band,tile_n,overflows", [
    (1008, 512, 64, False),    # a partial last tile, arcs across the seam
    (256, 256, 32, False),     # band = every row
    (256, 8, 32, True),        # a band too narrow
])
def test_band_layout_matches_jax_bit_for_bit(n, band, tile_n, overflows):
    """At n % 16 == 0 (np_rows == n) the port's idx_loc, lo and overflow
    equal JAX's bit for bit."""
    idx_s, mask_s = _sorted_list(n, seed=1)
    j_loc, j_lo, j_ovf = jbanded.band_layout(jnp.asarray(idx_s),
                                             jnp.asarray(mask_s), n, band,
                                             tile_n)
    t_loc, t_lo, t_ovf = banded.band_layout(torch.as_tensor(idx_s),
                                            torch.as_tensor(mask_s), n,
                                            band, tile_n)
    assert t_loc.dtype == t_lo.dtype == torch.int32
    np.testing.assert_array_equal(t_loc.numpy(), np.asarray(j_loc))
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(j_lo))
    assert bool(t_ovf) == bool(j_ovf) == overflows
    assert bool((t_lo % 16 == 0).all())
    if n == 1008:
        assert n % tile_n
        # Some tile's band runs past the last row into the head replica
        # (its arc wraps the seam), so the case covers the circular layout.
        assert bool((t_lo.long() + band > n).any())


def _resolved_rows(loc, lo, n, tile_n):
    """Rows of the extended node array each slot reads, mod np_rows: the
    sorted-frame source ids where the layout is right."""
    rows = np.repeat(np.asarray(lo), tile_n)[:n, None] + np.asarray(loc)
    return rows % (-(-n // 16) * 16)


def test_band_layout_where_an_arc_starts_below_row_zero():
    """At n=1,000 (n % 16 != 0) tile 0's arc starts below row 0. JAX's
    band_layout aligns that start and takes it mod np_rows = 1,008, which
    puts lo = 896 past the first source (row 893): that live edge reads
    the wrong row, without the overflow flag (ROADMAP Queue 3). The port
    takes the start mod n first: every live edge reads its own source
    row. Where the arc starts at row 0 or above, the two layouts agree bit
    for bit; overflow agrees everywhere."""
    n, band, tile_n = 1000, 512, 64
    idx_s, mask_s = _sorted_list(n, seed=1)
    j_loc, j_lo, j_ovf = jbanded.band_layout(jnp.asarray(idx_s),
                                             jnp.asarray(mask_s), n, band,
                                             tile_n)
    t_loc, t_lo, t_ovf = banded.band_layout(torch.as_tensor(idx_s),
                                            torch.as_tensor(mask_s), n,
                                            band, tile_n)
    assert bool(t_ovf) == bool(j_ovf) is False
    wrong_t = (_resolved_rows(t_loc, t_lo, n, tile_n) != idx_s) & mask_s
    wrong_j = (_resolved_rows(j_loc, j_lo, n, tile_n) != idx_s) & mask_s
    assert wrong_t.sum() == 0
    assert wrong_j.sum() == 1 and np.argwhere(wrong_j)[0, 0] < tile_n
    assert int(np.asarray(j_lo)[0]) == 896 and int(t_lo[0]) == 880
    same = np.ones(len(t_lo), bool)
    same[0] = False
    np.testing.assert_array_equal(t_lo.numpy()[same], np.asarray(j_lo)[same])
    rows = np.repeat(same, tile_n)[:n]
    np.testing.assert_array_equal(t_loc.numpy()[rows],
                                  np.asarray(j_loc)[rows])


def test_auto_band_matches_jax():
    """The auto band at bench_large's sizes (reduced density 0.5, cutoff
    7.5 A): 1,280 at N=4,096 and 2,304 at N=10,000, as JAX's; capped at
    round_up(N, 16) = 272 at N=258 (arithmetic only)."""
    for n, want in ((4096, 1280), (10_000, 2304), (258, 272)):
        box = jlj.lj_fluid_box(n, 0.5)[0]
        j_fn = jbanded.make_banded_force_fn(None, float(box), 7.5, n, None,
                                            *LENGTH)
        t_fn = banded.make_banded_force_fn(None, float(box), 7.5, n, None,
                                           *LENGTH)
        assert t_fn.banded_band == j_fn.banded_band == want


# -- the banded conv message ------------------------------------------------

def test_banded_conv_message_on_cpu_equals_the_unsorted_gather():
    """banded_conv_message on CPU tensors (the plain version) in the sorted
    frame, unsorted, equals conv_msg_gather_reference on the original
    frame's gather it stands for: 1e-5 of max |agg|. N=1,000 (a partial
    last tile, arcs across the seam), K=32, width 128, random e and
    weights."""
    n, band, tile_n, w = 1000, 512, 64, 128
    box, pos = _frame(n, seed=1)
    idx, mask, _ = dense_neighbor_list(torch.as_tensor(pos), box, CUTOFF, K)
    rng = np.random.default_rng(2)
    t = lambda *s, scale=1.0: torch.as_tensor(
        (rng.standard_normal(s) * scale).astype(np.float32))
    e, hn, src, dst = t(n, K, w), t(n, w), t(n, w), t(n, w)
    weights = [t(w, w, scale=w ** -0.5) if i % 2 == 0 else t(w, scale=0.1)
               for i in range(8)]
    ref = conv_msg_gather_reference(e, idx, mask, hn, src, dst, *weights)

    perm = torch.argsort(torch.as_tensor(pos)[:, 0], stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n)
    idx_s, mask_s = inv[idx[perm].long()], mask[perm]
    idx_loc, lo, ovf = banded.band_layout(idx_s, mask_s, n, band, tile_n)
    assert not bool(ovf)
    np_rows = -(-n // 16) * 16
    nodes = torch.zeros((np_rows, 2 * w))
    nodes[:n] = torch.cat([hn[perm], src[perm]], dim=1)
    nodes = torch.cat([nodes, nodes[:band]])
    # One layer's edge weights in MegaParams' layout ([L, in, out] and
    # [L, 1, out]).
    names = ("w_e1", "b_e1", "w_e2", "b_e2", "w_t1", "b_t1", "w_t2", "b_t2")
    mp = SimpleNamespace(**{name: wt[None] if name.startswith("w")
                            else wt[None, None]
                            for name, wt in zip(names, weights)})
    before = banded.banded_conv_message.launches
    agg_s = banded.banded_conv_message(e[perm], idx_loc, mask_s, lo, nodes,
                                       dst[perm], 0, mp, band, tile_n)
    assert banded.banded_conv_message.launches == before   # plain version
    err = float((agg_s[inv] - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err
    assert float(ref.abs().max()) > 1.0


def test_banded_conv_message_rejects_other_devices():
    x = torch.zeros((4, 2, 128), device="meta")
    mp = SimpleNamespace(**{name: torch.zeros((1, 128, 128)) for name in (
        "w_e1", "w_e2", "w_t1", "w_t2")},
        **{name: torch.zeros((1, 1, 128)) for name in (
            "b_e1", "b_e2", "b_t1", "b_t2")})
    with pytest.raises(ValueError, match="cuda or cpu"):
        banded.banded_conv_message(x, None, None, None,
                                   torch.zeros((32, 256), device="meta"),
                                   None, 0, mp, 16)


# -- the banded force path --------------------------------------------------

def _jax_params(w_layers=2):
    """(flax params as numpy, JAX ModelConfig) of a seeded LJ GAMDNet at
    width 128 with w_layers conv layers."""
    cfg = jcfg.ModelConfig(use_layer_norm=True, conv_layers=w_layers)
    model = JGAMDNet(cfg=cfg, species="lj")
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 3)),
                        jnp.zeros((1, 8, 4), jnp.int32),
                        jnp.zeros((1, 8, 4), bool), 10.0, 0.5, 2.0,
                        train=False)["params"]
    return params_from_jax(params), cfg


def _reference_case(n, seed):
    """Seeded frame, width-128 two-layer weights, the JAX dense list (K=32
    at 6 A) and JAX's fp32 reference_forward on it."""
    box, pos = _frame(n, seed=seed)
    params, cfg = _jax_params()
    jmp = jpack(params, cfg)
    h0 = np.broadcast_to(params["node_emb"][0], (n, 128)).copy()
    idx, mask, _ = jdense(jnp.asarray(pos), box, CUTOFF, K)
    f_ref = np.asarray(jreference(jnp.asarray(pos), idx, mask,
                                  jnp.asarray(h0), jmp, box, CUTOFF,
                                  *LENGTH))
    return dict(n=n, box=box, pos=pos, params=params, jmp=jmp, h0=h0,
                idx=np.array(idx), mask=np.array(mask), f_ref=f_ref)


@pytest.fixture(scope="module")
def banded_case():
    """N=1,008 (band 512 < N, a partial last tile, np_rows = N), K=32 at
    6 A, two conv layers at width 128: the JAX reference forward (fp32)
    and the JAX banded forward in interpret mode, evaluated once."""
    case = _reference_case(1008, seed=2)
    n = case["n"]
    j_fn = jbanded.make_banded_force_fn(
        case["jmp"], case["box"], CUTOFF, n, jnp.asarray(case["h0"]),
        *LENGTH, tile_n=64, interpret=True)
    f_jband, j_ovf = j_fn(jnp.asarray(case["pos"]), jnp.asarray(case["idx"]),
                          jnp.asarray(case["mask"]))
    assert not bool(j_ovf) and j_fn.banded_band < n
    return dict(case, f_jband=np.asarray(f_jband), band=j_fn.banded_band)


def _port_banded(case):
    cfg = tcfg.ModelConfig(use_layer_norm=True, conv_layers=2)
    mp = pack_params(case["params"], cfg)
    fn = banded.make_banded_force_fn(mp, case["box"], CUTOFF, case["n"],
                                     torch.as_tensor(case["h0"]), *LENGTH,
                                     tile_n=64)
    f, ovf = fn(torch.as_tensor(case["pos"]), torch.as_tensor(case["idx"]),
                torch.as_tensor(case["mask"]))
    return fn, f.numpy(), ovf


@pytest.mark.parametrize("n,seed", [(1008, 2), (1000, 1)])
def test_banded_force_fn_matches_jax_reference_forward(n, seed,
                                                       banded_case):
    """make_banded_force_fn on CPU tensors against JAX's reference_forward
    (fp32) on the unsorted frame: max |dF| <= 1e-4 std(F). N=1,000 at seed
    1 is the frame whose tile 0 arc starts below row 0 (see
    test_band_layout_where_an_arc_starts_below_row_zero)."""
    case = banded_case if n == 1008 else _reference_case(n, seed)
    fn, f, ovf = _port_banded(case)
    assert fn.banded_band == 512
    assert ovf.ndim == 0 and not bool(ovf)
    ref = case["f_ref"]
    assert f.shape == ref.shape == (n, 3)
    err = np.abs(f - ref).max()
    assert err <= REF_RTOL * ref.std(), (err, ref.std())


def test_banded_force_fn_matches_jax_banded_kernel(banded_case):
    """Against JAX's banded forward in interpret mode, whose four edge
    products run in bf16: JAX's own bar (tests/test_banded.py:60-63),
    relative MAE < 6e-3 and cosine > 0.99995."""
    _, f, _ = _port_banded(banded_case)
    jf = banded_case["f_jband"]
    rel_mae = np.abs(f - jf).mean() / np.abs(jf).mean()
    cos = (f * jf).sum() / (np.linalg.norm(f) * np.linalg.norm(jf))
    assert rel_mae < 6e-3, rel_mae
    assert cos > 0.99995, cos


def _state_pair(params):
    """(JAX force and length stats, port ForceFieldState with `params`):
    non-trivial scalers, force (0.1, std 2) and length (4.0, std 1.5)."""
    stats = (stat_from_values(0.1, 4.0, 10.0),
             stat_from_values(4.0, 2.25, 10.0))
    port = ForceFieldState(params=params, batch_stats={},
                           force_stat=stat_from_jax(stats[0]),
                           length_stat=stat_from_jax(stats[1]))
    return stats, port


def test_forcefield_banded_force_fn_matches_jax_reference(banded_case):
    """GNNForceField.banded_force_fn (force denormalisation and unit folded
    into the decoder) against JAX's pack_params + reference_forward with
    the same scalers: max |dF| <= 1e-4 std(F); the closure carries
    handles_refresh and banded_band."""
    n, box = banded_case["n"], banded_case["box"]
    cfg_kw = dict(use_layer_norm=True, conv_layers=2)
    (jforce, jlength), state = _state_pair(banded_case["params"])
    system = tcfg.get_preset("lj", n_atoms=n, box=box, cutoff=CUTOFF)
    ff = GNNForceField(state, system, tcfg.ModelConfig(**cfg_kw),
                       device="cpu")
    fn = ff.banded_force_fn()
    assert fn.handles_refresh and fn.banded_band == 512
    f = fn(torch.as_tensor(banded_case["pos"]),
           torch.as_tensor(banded_case["idx"]),
           torch.as_tensor(banded_case["mask"])).numpy()
    jsystem = jcfg.get_preset("lj", n_atoms=n, box=box, cutoff=CUTOFF)
    jmp = jpack(banded_case["params"], jcfg.ModelConfig(**cfg_kw),
                force_std=jforce.std, force_mean=jforce.safe_mean,
                unit=jsystem.force_unit_to_internal)
    ref = np.asarray(jreference(
        jnp.asarray(banded_case["pos"]), jnp.asarray(banded_case["idx"]),
        jnp.asarray(banded_case["mask"]), jnp.asarray(banded_case["h0"]),
        jmp, box, CUTOFF, float(jlength.safe_mean), float(jlength.std)))
    err = np.abs(f - ref).max()
    assert err <= REF_RTOL * ref.std(), (err, ref.std())


def test_band_overflow_poisons_the_forces_with_nan(banded_case):
    """A band too narrow for the arcs: every force is NaN (a torch.where on
    the device flag), where the wide band gives finite forces."""
    n, box = banded_case["n"], banded_case["box"]
    cfg_kw = dict(use_layer_norm=True, conv_layers=2)
    _, state = _state_pair(banded_case["params"])
    system = tcfg.get_preset("lj", n_atoms=n, box=box, cutoff=CUTOFF)
    ff = GNNForceField(state, system, tcfg.ModelConfig(**cfg_kw),
                       device="cpu")
    args = [torch.as_tensor(banded_case[key]) for key in ("pos", "idx",
                                                          "mask")]
    narrow = ff.banded_force_fn(band=64)
    assert narrow.banded_band == 64
    assert bool(torch.isnan(narrow(*args)).all())
    assert bool(torch.isfinite(ff.banded_force_fn()(*args)).all())


def test_banded_path_refusals():
    """What the banded path still refuses: a [hn | src] pack whose node
    and hidden widths differ, a box that is not fixed, an unknown
    neighbour method. (The water bond channel, once refused here, runs
    since: tests/test_torch_water.py::test_banded_water_matches_jax.)"""
    params, _ = _jax_params(w_layers=1)
    mp = pack_params(params, tcfg.ModelConfig(conv_layers=1))
    n, k = 16, 4
    with pytest.raises(ValueError, match="equal node and hidden widths"):
        banded.banded_conv_message(
            torch.zeros((n, k, 128)), torch.zeros((n, k), dtype=torch.int32),
            torch.ones((n, k), dtype=torch.bool),
            torch.zeros((1,), dtype=torch.int32), torch.zeros((n + 16, 64)),
            torch.zeros((n, 128)), 0, mp, 16, tile_n=64)
    _, state = _state_pair(params)
    ff = GNNForceField(state, tcfg.get_preset("lj", box=None),
                       tcfg.ModelConfig(conv_layers=1), device="cpu")
    with pytest.raises(ValueError, match="banded path requires a fixed"):
        ff.banded_force_fn()
    with pytest.raises(ValueError, match="unknown neighbor method"):
        Simulation(lambda p, i, m: p, tcfg.get_preset("lj"),
                   tcfg.MDConfig(), nbr_method="tree", device="cpu")


# -- Simulation(nbr_method="cell") ------------------------------------------

# temperature=0 zeroes the thermostat noise, so both sides are
# deterministic from the same numpy velocities; friction still acts.
MD0 = dict(integrator="langevin", temperature=0.0, dt_fs=2.0,
           friction_per_ps=25.0, rebuild_every=5)


def test_cell_simulation_tracks_jax_classical_lj():
    """Classical LJ through the cell list (N=512, K=48 at 7.5 + 0.5 A): 3
    chunks of 5 steps at temperature 0 from the same positions and
    velocities track JAX's Simulation(nbr_method="cell"): positions and
    velocities within 1e-4, the same overflow flag."""
    n = 512
    box, pos = _frame(n, seed=9, sigma=0.05)
    kw = dict(n_atoms=n, box=box, nbr_capacity=48, skin=0.5)
    vel = (0.02 * np.random.RandomState(10).randn(n, 3)).astype(np.float32)
    jsim = JSimulation(jlj.lj_force_fn(box), jcfg.get_preset("lj", **kw),
                       jcfg.MDConfig(**MD0), nbr_method="cell")
    sim = Simulation(tlj.lj_force_fn(box), tcfg.get_preset("lj", **kw),
                     tcfg.MDConfig(**MD0), nbr_method="cell", device="cpu")
    assert sim.nbr_method == "cell"
    r_j = jsim.run(jsim.init_state(jnp.asarray(pos), vel=jnp.asarray(vel)),
                   15)
    r_t = sim.run(sim.init_state(pos, vel=vel), 15)
    np.testing.assert_allclose(r_t.state.pos.numpy(),
                               np.asarray(r_j.state.pos), atol=1e-4)
    np.testing.assert_allclose(r_t.state.vel.numpy(),
                               np.asarray(r_j.state.vel), atol=1e-4)
    assert r_t.overflow is False and not bool(r_j.overflow)
    assert r_t.positions.shape == (3, n, 3)
    assert float(np.abs(r_t.state.pos.numpy() - pos).max()) > 1e-3


def test_banded_md_tracks_jax_banded_md():
    """The slice end to end at a small size: Simulation(banded_force_fn(),
    nbr_method="cell") against JAX's with the banded kernel in interpret
    mode (bf16 edge products), LJ-128 at widths 32 with 2 conv layers,
    tile 16 (8 tiles, band 128), 2 chunks of 5 steps at temperature 0:
    positions and velocities within 5e-3, as tests/test_torch_slice.py
    holds the dense path."""
    small = dict(encoding_size=32, hidden_dim=32, edge_embedding_dim=32,
                 conv_layers=2)
    n = 128
    box = jlj.lj_fluid_box(n, 0.5)[0]
    kw = dict(n_atoms=n, box=box, cutoff=4.2, nbr_capacity=16, skin=0.8)
    jsystem = jcfg.get_preset("lj", **kw)
    jstate = create_train_state(build_model(jcfg.ModelConfig(**small),
                                            jsystem), jsystem,
                                jcfg.TrainConfig(), 1)
    jstate = jstate.replace(force_stat=stat_from_values(0.1, 4.0, 10.0),
                            length_stat=stat_from_values(4.0, 1.5, 10.0))
    jff = JForceField(jstate, jsystem, jcfg.ModelConfig(**small))
    jsim = JSimulation(jff.banded_force_fn(tile_n=16, interpret=True),
                       jsystem, jcfg.MDConfig(**MD0), nbr_method="cell")
    state = ForceFieldState(params=params_from_jax(jstate.params),
                            batch_stats={},
                            force_stat=stat_from_jax(jstate.force_stat),
                            length_stat=stat_from_jax(jstate.length_stat))
    ff = GNNForceField(state, tcfg.get_preset("lj", **kw),
                       tcfg.ModelConfig(**small), device="cpu")
    sim = Simulation(ff.banded_force_fn(tile_n=16), tcfg.get_preset(
        "lj", **kw), tcfg.MDConfig(**MD0), nbr_method="cell", device="cpu")

    _, lattice = jlj.lj_fluid_box(n, 0.5)
    rng = np.random.RandomState(11)
    pos = ((lattice + 0.1 * rng.randn(n, 3)) % box).astype(np.float32)
    vel = (0.05 * rng.randn(n, 3)).astype(np.float32)
    r_j = jsim.run(jsim.init_state(jnp.asarray(pos), vel=jnp.asarray(vel)),
                   10)
    r_t = sim.run(sim.init_state(pos, vel=vel), 10)
    assert np.isfinite(r_t.state.pos.numpy()).all()
    np.testing.assert_allclose(r_t.state.pos.numpy(),
                               np.asarray(r_j.state.pos), atol=5e-3)
    np.testing.assert_allclose(r_t.state.vel.numpy(),
                               np.asarray(r_j.state.vel), atol=5e-3)
    assert r_t.overflow == bool(r_j.overflow) is False
    assert float(np.abs(r_t.state.pos.numpy() - pos).max()) > 1e-3


# -- run_md --banded --------------------------------------------------------

def test_run_md_banded_cli_on_cpu(tmp_path):
    """run_md --banded --cpu on a small self-describing checkpoint written
    by the JAX package (LJ-256 at the preset's 7.5 A cutoff, widths 32;
    the dense list, band 256): the thermo log in the reference's format,
    finite final positions; --banded with --megastep is a parser
    error."""
    small = dict(encoding_size=32, hidden_dim=32, edge_embedding_dim=32,
                 conv_layers=2)
    n = 256
    box = jlj.lj_fluid_box(n, 0.5)[0]
    jsystem = jcfg.get_preset("lj", n_atoms=n, box=box)
    cfg = jcfg.ModelConfig(**small)
    jstate = create_train_state(build_model(cfg, jsystem), jsystem,
                                jcfg.TrainConfig(), 1)
    jstate = jstate.replace(force_stat=stat_from_values(0.0, 400.0, 10.0),
                            length_stat=stat_from_values(5.5, 1.6, 10.0))
    ckpt = save_checkpoint(str(tmp_path / "small.msgpack"), jstate, cfg,
                           jsystem)
    init = tmp_path / "init.npy"
    np.save(init, _frame(n, seed=5)[1])
    log, traj = tmp_path / "log.txt", tmp_path / "traj.npy"
    run_md.main(["--ckpt", ckpt, "--init_pos", str(init), "--banded",
                 "--steps", "20", "--report_every", "10", "--log", str(log),
                 "--out_traj", str(traj), "--cpu"])
    lines = log.read_text().splitlines()
    assert lines[0] == THERMO_HEADER
    assert [int(line.split("\t")[0]) for line in lines[1:]] == [10, 20]
    temps = [float(line.split("\t")[3]) for line in lines[1:]]
    assert all(math.isfinite(t) and 0 < t < 1000 for t in temps)
    final = np.load(traj)
    assert final.shape == (n, 3) and np.isfinite(final).all()
    with pytest.raises(SystemExit):
        run_md.main(["--banded", "--megastep", "--cpu"])


# -- bench_large ------------------------------------------------------------

def test_bench_large_cli_on_cpu(capsys):
    """tools.bench_large --cpu at small sizes (GAMD-small narrowed to
    widths 32 and one conv layer): one JSON line per configuration with
    the JAX bench's keys, the banded row naming its auto band, no error."""
    small = tcfg.lj_model_config(encoding_size=32, hidden_dim=32,
                                 edge_embedding_dim=32, conv_layers=1)
    with mock.patch.object(bench_large, "lj_model_config",
                           return_value=small):
        rows = bench_large.main(["--sizes", "1000", "--gnn_size", "1000",
                                 "--gnn_banded_sizes", "1000", "--steps",
                                 "8", "--cpu"])
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert printed == rows
    assert [row["config"] for row in rows] == [
        "classical-LJ cell-list N=1000", "GNN-MD cell-list N=1000",
        "GNN-MD banded N=1000 band=640"]
    for row in rows:
        assert set(row) == {"config", "atoms", "steps_per_s",
                            "atom_steps_per_s", "ms_per_step"}, row
        assert row["atoms"] == 1000 and row["steps_per_s"] > 0
