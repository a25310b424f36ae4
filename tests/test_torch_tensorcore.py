"""The tensor-core forward's plain pieces on the CPU (gamd_tpu_torch/ops/
mega.py): split_bf16_matmul, the bf16 x 3 product the CUDA kernel's edge
stages run (csrc/edge_tc.cuh), against a float64 product; the plain forward
with its edge products routed through it, against JAX's mega_forward in its
edge_hilo mode (interpret mode) and JAX's fp32 reference_forward; and
live_edge_layout, the plain version of the kernel's live-edge layout, at
R=2 with its edge cases. The same seeded numpy inputs go to both packages.
Also the profiler tool's reading of the new kernels (tools/
profile_step.py): their short names, each kernel's exclusive device time
and the forward's stages. The CUDA kernels themselves are held against
these plain versions in tests/test_torch_cuda.py and chip_smoke.py, on the
card.
"""

import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.models.gnn import GAMDNet as JGAMDNet
from gamd_tpu.neighbors.dense import dense_neighbor_list as jdense
from gamd_tpu.ops import pallas_model as jmega

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.ops import mega as tmega
from gamd_tpu_torch.tools import profile_step, sass_diff
from gamd_tpu_torch.train.state import params_from_jax

BOX = 12.0
N, K, CUTOFF = 64, 16, 5.0
LENGTH_MEAN, LENGTH_STD = 3.5, 1.2
#: The bound on |split_bf16_matmul(a, w) - a w| of each output, in units of
#: sum_k |a_ik| |w_kj|: each split residual is at most 2^-9 of its part
#: (bf16 rounds to 8 bits), so a dropped lo x lo and the two residuals of
#: the split are about 2^-18 each, and 128 float32 sums add about 2^-17.
SPLIT_BOUND = 2.0 ** -15
#: max |dF| / std(F) of the forward against JAX: the kernel's own bar.
TOLERANCE = 5e-3


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# -- split_bf16_matmul --------------------------------------------------------

@pytest.mark.parametrize("rows,scale", [(64, 1.0), (7, 1e-3), (130, 50.0)])
def test_split_bf16_matmul_within_its_bound(rows, scale):
    """Against the float64 product of the same float32 operands: every
    output within 2^-15 of sum |a||w| (SPLIT_BOUND), and at least 100
    times closer than one bf16 pass, so the lo parts are live. Operands
    span three decades, as activations and weights do."""
    rng = np.random.default_rng(rows)
    a = (rng.normal(size=(rows, 128)) * scale
         * 10.0 ** rng.uniform(-1.5, 1.5, (rows, 128))).astype(np.float32)
    w = (rng.normal(size=(128, 128)) * 0.1).astype(np.float32)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    magnitude = np.abs(a).astype(np.float64) @ np.abs(w).astype(np.float64)
    got = tmega.split_bf16_matmul(_t(a), _t(w)).numpy().astype(np.float64)
    assert np.all(np.abs(got - exact) <= SPLIT_BOUND * magnitude)
    one_pass = (_t(a).bfloat16().float() @ _t(w).bfloat16().float()).numpy()
    assert np.abs(got - exact).max() * 100 < np.abs(one_pass - exact).max()


def test_split_bf16_matmul_is_exact_on_bf16_operands():
    """Operands that bf16 holds exactly have zero lo parts: the product is
    then one float32 product of the same values."""
    rng = np.random.default_rng(1)
    a = _t(rng.normal(size=(16, 128)).astype(np.float32)).bfloat16().float()
    w = _t(rng.normal(size=(128, 128)).astype(np.float32)).bfloat16().float()
    assert torch.equal(tmega.split_bf16_matmul(a, w), a @ w)


# -- the plain forward through the split product ------------------------------

def _model(seed=0):
    """JAX and port packed weights of a seeded GAMD at widths 128, 2
    layers (LayerNorm), 40 RBF centres."""
    widths = dict(encoding_size=128, hidden_dim=128, edge_embedding_dim=128,
                  conv_layers=2)
    cfg = jcfg.ModelConfig(use_layer_norm=True, **widths)
    rng = np.random.RandomState(seed)
    pos = jnp.asarray(rng.uniform(0, BOX, (N, 3)).astype(np.float32))
    idx, mask, _ = jdense(pos, BOX, CUTOFF, K)
    params = JGAMDNet(cfg=cfg, species="lj", use_bond=False).init(
        jax.random.PRNGKey(seed), pos[None], idx[None], mask[None], BOX,
        LENGTH_MEAN, LENGTH_STD, train=False)["params"]
    h0 = np.broadcast_to(np.asarray(params["node_emb"]),
                         (N, cfg.encoding_size)).astype(np.float32)
    tmp = tmega.pack_params(params_from_jax(params), tcfg.ModelConfig(
        use_layer_norm=True, **widths))
    return jmega.pack_params(params, cfg), tmp, h0


def _frame(seed, k=K):
    """A random frame and its dense list (k slots at 5 A)."""
    pos = np.random.RandomState(seed).uniform(0, BOX, (N, 3)).astype(
        np.float32)
    idx, mask, _ = jdense(jnp.asarray(pos), BOX, CUTOFF, k)
    return pos, np.asarray(idx), np.asarray(mask)


def _edge_case_frame(seed=5, k=K):
    """A frame whose layout has the edge cases: atom 3 with no live edge
    (its build mask off), atom 5 with all k slots live (its list is atoms
    6 .. 6 + k - 1, moved to within 2 A of it), atoms whose build-time
    slots lie past the true cutoff, and random dead slots elsewhere."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, BOX, (N, 3)).astype(np.float32)
    pos[6:6 + k] = np.mod(pos[5] + rng.uniform(-1.1, 1.1, (k, 3)),
                          BOX).astype(np.float32)
    idx = np.stack([rng.choice(np.delete(np.arange(N), i), k, replace=False)
                    for i in range(N)]).astype(np.int32)
    idx[5] = np.arange(6, 6 + k)
    mask = rng.uniform(size=(N, k)) < 0.8
    mask[3] = False
    mask[5] = True
    return pos, idx, mask


def _split_forward(pos, idx, mask, tmp, h0, cutoff, monkeypatch):
    monkeypatch.setattr(tmega, "_edge_mm", tmega.split_bf16_matmul)
    return tmega.reference_forward(_t(pos), _t(idx), _t(mask), _t(h0), tmp,
                                   BOX, cutoff, LENGTH_MEAN,
                                   LENGTH_STD).numpy()


@pytest.mark.parametrize("case", ["random", "edge_cases"])
def test_split_forward_matches_jax_edge_hilo(case, monkeypatch):
    """The plain forward with every edge product (the encoder's three,
    each layer's four) through split_bf16_matmul, as the CUDA kernel
    computes them: within 5e-3 std(F) of JAX's mega_forward with
    edge_hilo (interpret mode, bf16 x 3 edge products) and of JAX's fp32
    reference_forward; and within 1e-3 std(F) of the port's own fp32 plain
    forward (the split is fp32-faithful)."""
    jmp, tmp, h0 = _model()
    if case == "random":
        pos, idx, mask = _frame(1)
        cutoff = 4.2
    else:
        pos, idx, mask = _edge_case_frame()
        cutoff = 4.2
    args = (jnp.asarray(pos), jnp.asarray(idx), jnp.asarray(mask),
            jnp.asarray(h0), jmp, BOX, cutoff, LENGTH_MEAN, LENGTH_STD)
    j_ref = np.asarray(jmega.reference_forward(*args))
    j_hilo = np.asarray(jmega.mega_forward(*args, tile_n=8, interpret=True,
                                           edge_hilo=True))
    plain = tmega.reference_forward(_t(pos), _t(idx), _t(mask), _t(h0), tmp,
                                    BOX, cutoff, LENGTH_MEAN,
                                    LENGTH_STD).numpy()
    split = _split_forward(pos, idx, mask, tmp, h0, cutoff, monkeypatch)
    scale = float(np.abs(j_ref).std())
    assert scale > 0 and np.isfinite(split).all()
    assert np.abs(split - j_hilo).max() < TOLERANCE * scale
    assert np.abs(split - j_ref).max() < TOLERANCE * scale
    assert np.abs(split - plain).max() < 1e-3 * scale


def test_edge_products_route_through_the_hook(monkeypatch):
    """_edge_mm takes exactly the 3 + 4L edge products of a forward, and
    its default leaves reference_forward the fp32 function."""
    _, tmp, h0 = _model()
    pos, idx, mask = _frame(2)
    seen = []

    def spy(a, w):
        seen.append(tuple(w.shape))
        return a @ w
    base = tmega.reference_forward(_t(pos), _t(idx), _t(mask), _t(h0), tmp,
                                   BOX, 4.2, LENGTH_MEAN, LENGTH_STD)
    monkeypatch.setattr(tmega, "_edge_mm", spy)
    again = tmega.reference_forward(_t(pos), _t(idx), _t(mask), _t(h0), tmp,
                                    BOX, 4.2, LENGTH_MEAN, LENGTH_STD)
    assert len(seen) == 3 + 4 * 2 and all(s == (128, 128) for s in seen)
    assert torch.equal(base, again)


# -- the live-edge layout -----------------------------------------------------

def _replica_frames(k=K):
    """R=2: a random frame with its dense list, and the edge-case frame."""
    pos0, idx0, mask0 = _frame(3, k)
    pos1, idx1, mask1 = _edge_case_frame(k=k)
    return (_t(np.stack([pos0, pos1])), _t(np.stack([idx0, idx1])),
            _t(np.stack([mask0, mask1])))


def _dense_live(pos, idx, mask, cutoff):
    """The live test in float64, and a flag of slots within 1e-4 A of the
    cutoff, where float32 may round either way."""
    p = pos.double().numpy()
    rel = p[np.arange(p.shape[0])[:, None, None], idx.long().numpy()] \
        - p[:, :, None, :]
    rel -= BOX * np.round(rel / BOX)
    d = np.sqrt((rel * rel).sum(-1))
    return mask.numpy() & (d < cutoff), np.abs(d - cutoff) < 1e-4


@pytest.mark.parametrize("k", [16, 20])
def test_live_edge_layout_is_atom_major_and_tiled_within_replicas(k):
    """R=2 (a random frame; the edge-case frame: an atom with no live
    edge, one with all k live, build-time slots past the cutoff); k=20 is
    not a multiple of 16. Counts are the live slots, offsets their
    exclusive scan, each replica's rows the live slot ids in increasing
    order (atom-major, slot order within an atom) ending at total, and
    the tiles cover each replica's rows once, 64 rows at most, never
    across a replica."""
    pos, idx, mask = _replica_frames(k)
    lay = tmega.live_edge_layout(pos, idx, mask, BOX, 4.2)
    live, near = _dense_live(pos, idx, mask, 4.2)
    live_t = tmega.live_mask(pos, idx, mask, BOX, 4.2).numpy()
    assert np.array_equal(live_t[~near], live[~near])
    cap = tmega.layout_capacity(N, k)
    assert lay.slot.shape == (2, cap) and cap % tmega.TILE_ROWS == 0
    assert np.array_equal(lay.count.numpy(), live_t.sum(-1))
    assert lay.count[1, 3] == 0 and lay.count[1, 5] == k
    for r in range(2):
        total = int(lay.total[r])
        ids = np.flatnonzero(live_t[r].reshape(-1))
        assert total == ids.size
        assert np.array_equal(lay.slot[r, :total].numpy(), ids)
        assert bool((lay.slot[r, total:] == -1).all())
        count = lay.count[r].numpy()
        assert np.array_equal(lay.offset[r].numpy(),
                              np.cumsum(count) - count)
    tiles = tmega.layout_tiles(lay)
    for r in range(2):
        rows = [(row0, n) for rep, row0, n in tiles if rep == r]
        assert [row0 for row0, _ in rows] == list(
            range(0, int(lay.total[r]), tmega.TILE_ROWS))
        assert sum(n for _, n in rows) == int(lay.total[r])
        assert all(0 < n <= tmega.TILE_ROWS for _, n in rows)


def test_segment_sums_over_the_layout_equal_masked_dense_sums():
    """What the node stage sums: each atom's rows in compacted order give
    the masked sum over its K slots (float64 values, so any order is
    exact to rounding), atom with no live edge 0."""
    pos, idx, mask = _replica_frames(20)
    lay = tmega.live_edge_layout(pos, idx, mask, BOX, 4.2)
    live = tmega.live_mask(pos, idx, mask, BOX, 4.2)
    vals = torch.as_tensor(np.random.default_rng(7).normal(
        size=(2, N, 20, 8)))
    dense = torch.where(live[..., None], vals, 0.0).sum(2)
    flat = vals.reshape(2, N * 20, 8)
    for r in range(2):
        for i in range(N):
            o, c = int(lay.offset[r, i]), int(lay.count[r, i])
            seg = flat[r, lay.slot[r, o:o + c].long()].sum(0)
            torch.testing.assert_close(seg, dense[r, i], rtol=1e-12,
                                       atol=1e-12)
    assert float(dense[1, 3].abs().max()) == 0.0


def test_layout_of_one_system_and_without_a_cutoff():
    """One system ([N, 3]) gets a leading R axis of 1; cutoff=None passes
    the build mask through; mega_layout on CPU tensors is the plain
    version."""
    pos, idx, mask = _edge_case_frame()
    one = tmega.live_edge_layout(_t(pos), _t(idx), _t(mask), BOX, 4.2)
    assert one.total.shape == (1,) and one.offset.shape == (1, N)
    free = tmega.live_edge_layout(_t(pos), _t(idx), _t(mask), BOX, None)
    assert np.array_equal(free.count[0].numpy(), mask.sum(1))
    via = tmega.mega_layout(_t(pos), _t(idx), _t(mask), BOX, 4.2)
    assert all(torch.equal(a, b) for a, b in zip(one, via))


def test_rbf_rows_are_the_rows_pack_params_filled():
    """The wrapper's count of RBF rows: the model's n_rbf (40 at the
    default gap); the checked weights it keeps count again once a tensor
    changes in place."""
    _, tmp, _ = _model()
    assert tmega._rbf_rows(tmp) == tcfg.ModelConfig().n_rbf == 40
    assert tmega._weights("t", tmp, tmp.w_rbf.device)[1] == 40
    tmp.w_rbf[40:45] = 1.0
    assert tmega._rbf_rows(tmp) == 45
    assert tmega._weights("t", tmp, tmp.w_rbf.device)[1] == 45


# -- the profiler's reading of the forward's kernels -------------------------

@pytest.mark.parametrize("kernel,name", [
    ("void (anonymous namespace)::node_fused_kernel<16>((anonymous "
     "namespace)::NodeArgs, int)", "node_fused_kernel[B=16]"),
    ("void (anonymous namespace)::node_fused_kernel<4, 0>((anonymous "
     "namespace)::NodeArgs, int)", "node_fused_kernel[B=4]"),
    ("void (anonymous namespace)::node_fused_kernel<4, 12>((anonymous "
     "namespace)::NodeArgs, int)", "node_fused_kernel[B=4]"),
    ("void (anonymous namespace)::node_fused_kernel<16, 0, 0, 1>((anonymous "
     "namespace)::NodeArgs, int)", "node_fused_kernel[B=16]"),
    ("void (anonymous namespace)::node_fused_kernel<4, 12, 1, 0>((anonymous "
     "namespace)::NodeArgs, int)", "node_fused_kernel[B=4]"),
    ("void (anonymous namespace)::edge_tile_kernel<2, 11>(CUtensorMap_st, "
     "(anonymous namespace)::EdgeArgs, int)", "edge_tile_kernel"),
    ("void (anonymous namespace)::encode_tile_kernel<2, false, 3>("
     "CUtensorMap_st, (anonymous namespace)::EncArgs)",
     "encode_tile_kernel"),
    ("void (anonymous namespace)::edge_tile_kernel<1>(CUtensorMap_st, "
     "(anonymous namespace)::EdgeArgs, int)", "edge_tile_kernel"),
    ("void (anonymous namespace)::encode_tile_kernel<2>(CUtensorMap_st, "
     "(anonymous namespace)::EncArgs)", "encode_tile_kernel"),
    ("(anonymous namespace)::live_kernel(float const*, int const*, "
     "unsigned char const*, int, int, float, float, unsigned char*)",
     "live_kernel"),
    ("(anonymous namespace)::layout_kernel(unsigned char const*, int, int, "
     "int, int, int*, int*, int*, int*)", "layout_kernel"),
    ("(anonymous namespace)::split_weights_kernel(MegaWeights, "
     "__nv_bfloat16*)", "split_weights_kernel"),
])
def test_profile_step_names_the_forward_kernels(kernel, name):
    """Each kernel of the forward gets a short name, and every short name
    a stage of FORWARD_STAGES; the benchmark's forms of a stage kernel
    (their second template argument) and its activation forms are named
    as its production form."""
    assert profile_step.short_name(kernel) == name
    assert name in profile_step.FORWARD_STAGES


def test_sass_diff_pairs_kernels_and_masks_parameter_offsets():
    """tools/sass_diff reads a cuobjdump listing by kernel, masks the
    offsets of the kernel's parameters (constant bank 0) and no other
    operand, and pairs kernels by name or by a pair of patterns."""
    dump = (
        "\tFunction : _Za\n"
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;"
        "          /* 0x00000a00ff017b82 */\n"
        "        /*0010*/                   FADD R2, R3, c[0x3][0x10] ;\n"
        "\tFunction : _Zb\n"
        "        /*0000*/                   LDC R1, c[0x0][0x30] ;\n"
        "        /*0010*/                   FADD R2, R3, c[0x3][0x14] ;\n")
    names = {"_Za": "void (anonymous namespace)::k<(int)4, (bool)0>(int)",
             "_Zb": "void <unnamed>::k<4, false, 1>(int)"}
    fns = sass_diff.sass_functions(dump, names)
    assert fns == {
        "k<4, false>(int)": ["LDC R1, c[0x0][X]", "FADD R2, R3, c[0x3][0x10]"],
        "k<4, false, 1>(int)": ["LDC R1, c[0x0][X]",
                                "FADD R2, R3, c[0x3][0x14]"]}
    parent = {"k<4, false>(int)": fns["k<4, false>(int)"]}
    change = {"k<4, false, 1>(int)": fns["k<4, false, 1>(int)"][:1]
              + ["FADD R2, R3, c[0x3][0x10]"]}
    rec, = sass_diff.compare(parent, change,
                             [(r"k<4, false>\(", r"k<4, false, 1>\(")])
    assert (rec["parent_instructions"], rec["change_instructions"],
            rec["differ"]) == (2, 2, 0)
    rec, = sass_diff.compare(fns, {"k<4, false>(int)": ["NOP"]})
    assert rec["differ"] == 2
    rec, = sass_diff.compare(parent, change, [("absent", "k<")])
    assert rec["differ"] is None and rec["parent"] == "absent"


def test_exclusive_times_partition_overlapping_spans():
    """A kernel started early (its span overlapping the one before it, as
    under programmatic dependent launch) gets only what it adds to the
    busy time; the parts sum to the union of the spans; gaps are measured
    from the latest end before a span."""
    spans = [(0.0, 10.0, "layout_kernel"), (4.0, 25.0, "edge_tile_kernel"),
             (6.0, 9.0, "live_kernel"), (30.0, 35.0, "node_fused_kernel[B=4]")]
    kernels, gaps = profile_step.exclusive_times(spans)
    assert kernels["edge_tile_kernel"]["us"] == 15.0
    assert kernels["live_kernel"]["us"] == 0.0
    assert sum(k["us"] for k in kernels.values()) == 10.0 + 15.0 + 5.0
    assert [g for g, _, _ in gaps] == [0.0, 0.0, 5.0]
    assert gaps[-1][1:] == ("edge_tile_kernel", "node_fused_kernel[B=4]")
    stages = profile_step.forward_stages(kernels, 2)
    assert stages == {"live-edge layout": 5.0,
                      "edge stage (tensor cores)": 7.5,
                      "node stages": 2.5}

