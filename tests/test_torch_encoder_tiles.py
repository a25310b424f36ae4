"""Port parity of the edge encoder's tensor-core redesign on the CPU (row 5
of the port's kernel table, csrc/edge_encoder.cu over csrc/encode.cuh):
the live-slot entry ops/encoder.py::live_edge_encoder, whose CPU path is
its plain version live_edge_encoder_reference, against the every-slot
plain version edge_encoder_reference and against JAX's banded encode
(gamd_tpu/ops/banded.py:283-291 through gamd_tpu.ops.pallas_model.
encode_edges); the banded route's true-cutoff mask (ops/banded.py::
banded_geometry) against JAX's, bit for bit, with slots within an ulp of
the cutoff. The CUDA kernel itself is held against its plain versions in
tests/test_torch_cuda.py and chip_smoke.py, on the card.
"""

import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.core import space as jspace
from gamd_tpu.models.gnn import GAMDNet as JGAMDNet
from gamd_tpu.neighbors.dense import dense_neighbor_list as jdense
from gamd_tpu.ops.pallas_model import encode_edges as jencode
from gamd_tpu.ops.pallas_model import pack_params as jpack
from gamd_tpu.physics import lennard_jones as jlj

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.neighbors.dense import dense_neighbor_list
from gamd_tpu_torch.ops import banded, edge_tiles
from gamd_tpu_torch.ops.encoder import (edge_encoder_reference,
                                        encoder_params, live_edge_encoder)
from gamd_tpu_torch.ops.mega import _rbf_rows, pack_params
from gamd_tpu_torch.tools import profile_step
from gamd_tpu_torch.train.state import params_from_jax

BOX = 14.0
N, K = 66, 20                  # neither a multiple of 64: a ragged tail
LENGTH = (4.0, 1.2)            # edge-length scaler (mean, std)


def _inputs(seed=0):
    """N atoms in the BOX, their list (K at 4.5 A; the encoder's cutoff
    4.2 A refines it) and seeded encoder weights (w0 [44, 128], ...)."""
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(0, BOX, (N, 3)).astype(np.float32))
    idx, mask, ovf = dense_neighbor_list(pos, BOX, 4.5, K)
    assert not bool(ovf)
    w = lambda *s: torch.as_tensor(
        (rng.standard_normal(s) * 0.1).astype(np.float32))
    weights = [w(44, 128), w(128), w(128, 128), w(128), w(128, 128),
               w(128), 1.0 + w(128), w(128)]
    return pos, idx, mask, weights


@pytest.mark.parametrize("cutoff,flip", [(None, False), (4.2, False),
                                         (4.2, True), (None, True)])
def test_live_rows_equal_the_every_slot_rows(cutoff, flip):
    """live_edge_encoder on CPU tensors (its plain version; nothing
    launches) over the layout of edge_encoder_reference's live mask: at
    every live slot the row of edge_encoder_reference within 1e-6 of max
    |e|; the rows of dead slots untouched (0 in a new buffer, NaN kept in
    a given one)."""
    pos, idx, mask, weights = _inputs()
    e_ref, live = edge_encoder_reference(pos[None], idx[None], mask[None],
                                         BOX, cutoff, *LENGTH, *weights,
                                         flip_dir=flip)
    e_ref, live = e_ref[0], live[0]
    layout = edge_tiles.mask_layout(live)
    params = encoder_params(*weights)
    before = live_edge_encoder.launches
    e = live_edge_encoder(pos, idx, layout, params, BOX, *LENGTH,
                          flip_dir=flip)
    assert live_edge_encoder.launches == before
    assert e.shape == (N, K, 128) and e.dtype == torch.float32
    assert 0 < int(layout.total[0]) < N * K
    scale = float(e_ref.abs().max())
    assert float((e[live] - e_ref[live]).abs().max()) <= 1e-6 * scale
    assert bool((e[~live] == 0).all())
    poisoned = torch.full((N, K, 128), float("nan"))
    out = live_edge_encoder(pos, idx, layout, params, BOX, *LENGTH,
                            flip_dir=flip, out=poisoned)
    assert out is poisoned
    assert torch.equal(out[live], e[live])
    assert bool(torch.isnan(out[~live]).all())


def _jax_model():
    """(flax params as numpy, JAX ModelConfig) of a seeded LJ GAMDNet at
    width 128 (40 RBF centres) with one conv layer."""
    cfg = jcfg.ModelConfig(use_layer_norm=True, conv_layers=1)
    model = JGAMDNet(cfg=cfg, species="lj")
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 3)),
                        jnp.zeros((1, 8, 4), jnp.int32),
                        jnp.zeros((1, 8, 4), bool), 10.0, 0.5, 2.0,
                        train=False)["params"]
    return params_from_jax(params), cfg


def _jax_banded_geometry(pos_s, idx_s, mask, box, cutoff):
    """gamd_tpu/ops/banded.py:283-289 on numpy inputs: (dist, rel, the
    true-cutoff mask) as jax arrays."""
    pos_s, idx_s = jnp.asarray(pos_s), jnp.asarray(idx_s)
    rel = jspace.min_image(pos_s[idx_s] - pos_s[:, None, :], box)
    dist = jnp.sqrt(jnp.sum(rel * rel, axis=-1))
    if cutoff is not None:
        mask = mask & (dist * dist < cutoff * cutoff)
    return dist, rel, mask


def _jax_banded_encode(pos_s, idx_s, mask, jmp, box, cutoff, flip=False):
    """gamd_tpu/ops/banded.py:283-291 on numpy inputs: (mask, e)."""
    dist, rel, mask = _jax_banded_geometry(pos_s, idx_s, mask, box, cutoff)
    unit = rel / (dist[..., None] + 1e-8)
    if flip:
        unit = -unit
    std = (dist - LENGTH[0]) / LENGTH[1]
    e = jencode(jmp, unit, std, None, "gelu", rbf_gap=0.025)
    return np.asarray(mask), np.asarray(e)


@pytest.mark.parametrize("cutoff,flip", [(None, False), (6.0, False),
                                         (6.0, True)])
def test_live_rows_match_jax_banded_encode(cutoff, flip):
    """The banded route's pieces on the CPU, in the x-sorted frame of an LJ
    frame (N=250, K=32 at 7 A): banded_geometry's mask equal to JAX's bit
    for bit, and live_edge_encoder over its layout with the padded
    MegaParams (the banded path's weights, n_rbf from the padding) within
    1e-5 of max |e| of JAX's encode_edges rows at the live slots."""
    box, pos = jlj.lj_fluid_box(250, 0.5)
    rng = np.random.RandomState(5)
    pos = ((pos + rng.randn(*pos.shape).astype(np.float32) * 0.1)
           % box).astype(np.float32)
    idx, mask, ovf = jdense(jnp.asarray(pos), float(box), 7.0, 32)
    assert not bool(ovf)
    params, cfg = _jax_model()
    jmp = jpack(params, cfg)
    mp = pack_params(params, tcfg.ModelConfig(use_layer_norm=True,
                                              conv_layers=1))
    p = torch.as_tensor(pos)
    perm, _, idx_s = banded.sort_by_x(p, torch.as_tensor(np.array(idx)))
    pos_s = p[perm]
    mask_s = torch.as_tensor(np.array(mask))[perm]
    _, _, live = banded.banded_geometry(pos_s, idx_s, mask_s, float(box),
                                        cutoff)
    jmask, je = _jax_banded_encode(pos_s.numpy(), idx_s.numpy(),
                                   mask_s.numpy(), jmp, float(box), cutoff,
                                   flip)
    assert np.array_equal(live.numpy(), jmask)
    layout = edge_tiles.mask_layout(live)
    assert _rbf_rows(mp) == 40
    e = live_edge_encoder(pos_s, idx_s.to(torch.int32), layout, mp,
                          float(box), *LENGTH, flip_dir=flip,
                          n_rbf=_rbf_rows(mp))
    live_np = live.numpy()
    scale = np.abs(je[live_np]).max()
    assert np.abs(e.numpy()[live_np] - je[live_np]).max() <= 1e-5 * scale
    # The same rows through the unpadded view of the same weights.
    e_view = live_edge_encoder(
        pos_s, idx_s.to(torch.int32), layout, encoder_params(
            torch.as_tensor(params["edge_encoder_w0"]),
            *[torch.as_tensor(params[name]) for name in (
                "edge_encoder_b0", "edge_encoder_w1", "edge_encoder_b1",
                "edge_encoder_w2", "edge_encoder_b2", "edge_ln_scale",
                "edge_ln_bias")]),
        float(box), *LENGTH, flip_dir=flip)
    assert float((e_view[live] - e[live]).abs().max()) <= 1e-6 * scale


def _ulp_frame(cutoff):
    """A frame whose first atom sees the others at distances within a few
    float32 ulps of `cutoff`: along x, along y, and on the xy diagonal,
    each at 9 consecutive float32 steps around the cutoff. Returns (pos
    [N, 3], idx [N, N-1] listing every other atom, mask all True)."""
    c0 = np.float32(5.0)
    tip = np.float32(c0 + np.float32(cutoff))
    steps = [tip]
    for _ in range(4):
        steps.insert(0, np.nextafter(steps[0], np.float32(0)))
        steps.append(np.nextafter(steps[-1], np.float32(100)))
    diag = np.float32(c0 + np.float32(cutoff) / np.float32(np.sqrt(2.0)))
    dsteps = [diag]
    for _ in range(4):
        dsteps.insert(0, np.nextafter(dsteps[0], np.float32(0)))
        dsteps.append(np.nextafter(dsteps[-1], np.float32(100)))
    rows = [(c0, c0, c0)]
    rows += [(x, c0, c0) for x in steps]
    rows += [(c0, y, c0) for y in steps]
    rows += [(d, d, c0) for d in dsteps]
    pos = np.array(rows, np.float32)
    n = len(pos)
    idx = np.array([[j for j in range(n) if j != i] for i in range(n)],
                   np.int32)
    return pos, idx, np.ones(idx.shape, bool)


@pytest.mark.parametrize("cutoff", [4.2, 7.5])
def test_banded_mask_equals_jax_at_the_cutoff(cutoff):
    """banded_geometry's true-cutoff mask (the rule the card's route keeps:
    mask AND dist * dist < cutoff * cutoff, not the kernel's d^2 <
    cutoff^2) equals JAX's banded mask bit for bit on slots within an ulp
    of the cutoff, of which some are live and some dead."""
    box = 20.0
    pos, idx, mask = _ulp_frame(cutoff)
    _, _, live = banded.banded_geometry(
        torch.as_tensor(pos), torch.as_tensor(idx).long(),
        torch.as_tensor(mask), box, cutoff)
    _, _, jmask = _jax_banded_geometry(pos, idx, mask, box, cutoff)
    assert np.array_equal(live.numpy(), np.asarray(jmask))
    near = live.numpy()[0]
    assert near.any() and not near.all()


@pytest.mark.parametrize("kernel,name", [
    ("void (anonymous namespace)::encoder_tile_kernel<2, (anonymous "
     "namespace)::AllSlots>(CUtensorMap_st, (anonymous namespace)::"
     "EncTileArgs, (anonymous namespace)::AllSlots, float*)",
     "encoder_tile_kernel[AllSlots]"),
    ("void (anonymous namespace)::encoder_tile_kernel<1, (anonymous "
     "namespace)::LiveSlots>(CUtensorMap_st, (anonymous namespace)::"
     "EncTileArgs, (anonymous namespace)::LiveSlots, float*)",
     "encoder_tile_kernel[LiveSlots]"),
    ("(anonymous namespace)::split_encoder_weights_kernel(EncoderWeights, "
     "int, __nv_bfloat16*)", "split_encoder_weights_kernel"),
])
def test_profile_step_names_the_encoder_kernels(kernel, name):
    """tools/profile_step.py's short names of the encoder's kernels, which
    its banded path and chip_smoke.py phase 16 sum as the encoder's share
    (ENCODER_KERNELS)."""
    assert profile_step.short_name(kernel) == name
    assert name in profile_step.ENCODER_KERNELS
