"""Port parity of the LJ deployment slice on the CPU: the edge encoder's
plain version (the CUDA edge_encoder's reference) against the JAX Pallas
encoder in interpret mode and against a float64 transcription of its math;
GAMDNet's use_pallas_encoder path; GNNForceField.predict / predict_batch;
Simulation.run_segmented; fire_minimize; the RDF, MSD and diffusion
functions; StateReporter; and the run_md / analyze_rollout CLIs with --cpu.
Each test feeds the same seeded numpy inputs to the JAX function and to
its port and states its tolerance. The kernel itself is held against its
plain version in tests/test_torch_cuda.py and chip_smoke.py, on the card.
"""

import dataclasses
import json
import math
import os
from unittest import mock

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gamd_tpu.ops.pallas_encoder as jpe
import gamd_tpu.ops.pallas_mp as jpm
from gamd_tpu.core import config as jcfg
from gamd_tpu.md.reporters import StateReporter as JStateReporter
from gamd_tpu.md.simulate import Thermo as JThermo
from gamd_tpu.models.gnn import GAMDNet as JGAMDNet
from gamd_tpu.models.normalizer import stat_from_values
from gamd_tpu.neighbors.dense import dense_neighbor_list as jdense
from gamd_tpu.physics import lennard_jones as jlj
from gamd_tpu.physics import rdf as jrdf
from gamd_tpu.physics.minimize import fire_minimize as jfire
from gamd_tpu.train.checkpoint import save_checkpoint
from gamd_tpu.train.forcefield import GNNForceField as JForceField
from gamd_tpu.train.state import build_model, create_train_state

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.md.reporters import StateReporter
from gamd_tpu_torch.md.simulate import Simulation, Thermo
from gamd_tpu_torch.models.gnn import GAMDNet
from gamd_tpu_torch.ops.encoder import (edge_encoder_reference,
                                        fused_edge_encoder)
from gamd_tpu_torch.physics import lennard_jones as tlj
from gamd_tpu_torch.physics import rdf as trdf
from gamd_tpu_torch.physics.minimize import fire_minimize
from gamd_tpu_torch.tools import analyze_rollout, run_md
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.state import (ForceFieldState, init_params,
                                        params_from_jax, stat_from_jax)

WIDTH, N_RBF = 128, 40
SMALL = dict(encoding_size=32, hidden_dim=32, edge_embedding_dim=32,
             conv_layers=2)
N_LJ = 64
BOX_LJ = jlj.lj_fluid_box(N_LJ, 0.5)[0]     # 17.2 A at rho* = 0.5


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for this file's tests (on shared CPUs many threads
    make these small products slower), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the edge encoder -------------------------------------------------------

def _encoder_case(seed=8, n=20, k=8, box=10.0, build_cutoff=4.0):
    """Seeded positions, a JAX dense list and encoder weights (numpy)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    idx, mask, _ = jdense(jnp.asarray(pos), box, build_cutoff, k_max=k)
    w = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)
    weights = [w(4 + N_RBF, WIDTH), w(WIDTH), w(WIDTH, WIDTH), w(WIDTH),
               w(WIDTH, WIDTH), w(WIDTH),
               (1.0 + 0.1 * rng.randn(WIDTH)).astype(np.float32), w(WIDTH)]
    return pos, np.asarray(idx), np.asarray(mask), box, weights


def _port_encoder(pos, idx, mask, box, cutoff, lm, ls, weights, flip=False):
    e, live = edge_encoder_reference(
        torch.tensor(pos)[None], torch.tensor(idx)[None],
        torch.tensor(mask)[None], box, cutoff, lm, ls,
        *[torch.tensor(x) for x in weights], flip_dir=flip)
    return e[0].numpy(), live[0].numpy()


def _gelu_tanh64(x):
    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi)
                                    * (x + 0.044715 * x ** 3)))


def _encoder_float64(pos, idx, bmask, box, cutoff, lm, ls, w0, b0, w1, b1,
                     w2, b2, ln_s, ln_b, rbf_low=0.0, rbf_high=1.0,
                     rbf_gap=0.025, flip=False):
    """_encoder_kernel's math (gamd_tpu/ops/pallas_encoder.py:46-116)
    transcribed in float64 numpy, one frame: round-form min image, unit
    vector 1/(dist + 1e-8), standardised distance, the RBF over
    linspace(rbf_low, rbf_high, n_rbf) with gamma 1/rbf_gap, tanh-gelu MLP,
    LayerNorm eps 1e-6; live = build mask AND d^2 < cutoff^2."""
    f = lambda a: np.asarray(a, np.float64)
    pos = f(pos)
    rel = pos[idx] - pos[:, None, :]
    rel = rel - box * np.round(rel / box)
    d2 = np.sum(rel * rel, axis=-1)
    dist = np.sqrt(d2)
    unit = (-1.0 if flip else 1.0) * rel / (dist[..., None] + 1e-8)
    std = (dist - lm) / ls
    cutoff2 = np.inf if cutoff is None else cutoff ** 2
    live = bmask & (d2 < cutoff2)
    n_rbf = w0.shape[0] - 4
    centers = np.linspace(rbf_low, rbf_high, n_rbf)
    rbf = np.exp(-(1.0 / rbf_gap) * (std[..., None] - centers) ** 2)
    w0 = f(w0)
    z = unit @ w0[:3] + std[..., None] * w0[3] + rbf @ w0[4:] + f(b0)
    z = _gelu_tanh64(z) @ f(w1) + f(b1)
    z = _gelu_tanh64(z) @ f(w2) + f(b2)
    zc = z - z.mean(-1, keepdims=True)
    z = zc / np.sqrt((zc * zc).mean(-1, keepdims=True) + 1e-6)
    return z * f(ln_s) + f(ln_b), live


@pytest.mark.parametrize("cutoff", [None, 3.5])
def test_encoder_reference_matches_jax_pallas_encoder(cutoff):
    """JAX's bf16 bounds (tests/test_ops.py:246-249): mean |de| < 0.05,
    max < 0.5; the live masks equal (cutoff=None passes the build mask
    through, a cutoff refines it)."""
    pos, idx, mask, box, weights = _encoder_case()
    lm, ls = 2.0, 0.8
    e_j, live_j = jpe.fused_edge_encoder(
        jnp.asarray(pos), jnp.asarray(idx), jnp.asarray(mask), box, cutoff,
        lm, ls, *[jnp.asarray(x) for x in weights], tile_n=4,
        interpret=True)
    e_t, live_t = _port_encoder(pos, idx, mask, box, cutoff, lm, ls,
                                weights)
    np.testing.assert_array_equal(live_t, np.asarray(live_j))
    if cutoff is None:
        np.testing.assert_array_equal(live_t, mask)
    else:
        assert live_t.sum() < mask.sum()
    diff = np.abs(e_t - np.asarray(e_j, np.float32))
    assert diff.mean() < 0.05, diff.mean()
    assert diff.max() < 0.5, diff.max()


@pytest.mark.parametrize("cutoff,flip", [(None, False), (3.5, False),
                                         (3.5, True)])
def test_encoder_reference_matches_float64_transcription(cutoff, flip):
    """Every slot, dead ones included, within 1e-5 of max |e| of the
    float64 transcription (fp32 rounding of three 128-wide products and a
    LayerNorm; the bf16 bound above cannot see a wrong gelu form)."""
    pos, idx, mask, box, weights = _encoder_case(seed=11)
    lm, ls = 2.0, 0.8
    e_t, live_t = _port_encoder(pos, idx, mask, box, cutoff, lm, ls,
                                weights, flip=flip)
    e_ref, live_ref = _encoder_float64(pos, idx, mask, box, cutoff, lm, ls,
                                       *weights, flip=flip)
    np.testing.assert_array_equal(live_t, live_ref)
    scale = np.abs(e_ref).max()
    assert np.abs(e_t - e_ref).max() <= 1e-5 * scale


def test_fused_edge_encoder_on_cpu_runs_the_plain_version():
    """A CPU tensor runs edge_encoder_reference (no launch counted), one
    frame without the batch axis as the JAX entry, and a batch of frames
    as each frame alone."""
    pos, idx, mask, box, weights = _encoder_case(seed=3)
    t = [torch.as_tensor(x) for x in weights]
    before = fused_edge_encoder.launches
    e1, live1 = fused_edge_encoder(torch.tensor(pos), torch.tensor(idx),
                                   torch.tensor(mask), box, 3.0, 2.0, 0.8,
                                   *t)
    pos2 = np.stack([pos, np.roll(pos, 1, axis=0)])
    idx2 = np.stack([idx, idx[::-1].copy()])
    mask2 = np.stack([mask, mask[::-1].copy()])
    e2, live2 = fused_edge_encoder(torch.as_tensor(pos2),
                                   torch.as_tensor(idx2),
                                   torch.as_tensor(mask2), box, 3.0, 2.0,
                                   0.8, *t)
    assert fused_edge_encoder.launches == before
    assert e1.shape == (20, 8, WIDTH) and e1.dtype == torch.float32
    assert live1.dtype == torch.bool
    for b in range(2):
        e_b, live_b = fused_edge_encoder(
            torch.as_tensor(pos2[b]), torch.as_tensor(idx2[b]),
            torch.as_tensor(mask2[b]), box, 3.0, 2.0, 0.8, *t)
        torch.testing.assert_close(e2[b], e_b, rtol=0, atol=0)
        assert torch.equal(live2[b], live_b)
    torch.testing.assert_close(e2[0], e1, rtol=0, atol=0)


# -- GAMDNet's use_pallas_encoder path --------------------------------------

def _model_inputs(seed, n=20, k=8, box=10.0):
    """Seeded positions [1, N, 3] and a JAX dense list [1, N, K] (numpy)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, box, (1, n, 3)).astype(np.float32)
    idx, mask, _ = jdense(jnp.asarray(pos[0]), box, 3.5, k_max=k)
    return pos, np.asarray(idx)[None], np.asarray(mask)[None], box


def _port_model(cfg, seed):
    """A port GAMDNet in eval with init_params(seed) weights, and its
    seeded inputs as tensors."""
    state = init_params(cfg, tcfg.get_preset("lj"), seed=seed)
    model = GAMDNet(cfg).load_params(state.params).eval()
    pos, idx, mask, box = _model_inputs(seed)
    return model, torch.tensor(pos), torch.tensor(idx), \
        torch.tensor(mask), box


def _edges_into_conv(model, *args, **kwargs):
    """(e, mask) as the model's conv stack receives them."""
    seen = {}
    hook = model.graph_conv.register_forward_pre_hook(
        lambda mod, inputs: seen.update(e=inputs[1], mask=inputs[3]))
    try:
        model(*args, **kwargs)
    finally:
        hook.remove()
    return seen["e"], seen["mask"]


def test_use_pallas_encoder_flag_selects_the_encoder_kernel_function():
    """The port's GAMDNet ignored use_pallas_encoder and always encoded
    with erf-gelu (encode_edges). With use_pallas and use_pallas_encoder in
    eval, the conv layers must get the encoder kernel's e (tanh-gelu,
    edge_encoder_reference) to 1e-6 of max |e|, which differs from the
    erf-gelu encoder by more than 1e-5 of max |e|, and the mask passed
    through."""
    cfg = tcfg.ModelConfig(encoding_size=WIDTH, hidden_dim=WIDTH,
                           edge_embedding_dim=WIDTH, conv_layers=1,
                           use_pallas=True, use_pallas_encoder=True)
    model, pos, idx, mask, box = _port_model(cfg, seed=0)
    lm, ls = 4.0, 1.5
    with torch.no_grad():
        e, live = _edges_into_conv(model, pos, idx, mask, box, lm, ls)
        e_kernel, live_kernel = edge_encoder_reference(
            pos, idx, mask, box, None, lm, ls, model.edge_encoder_w0,
            model.edge_encoder_b0, model.edge_encoder_w1,
            model.edge_encoder_b1, model.edge_encoder_w2,
            model.edge_encoder_b2, model.edge_ln_scale, model.edge_ln_bias)
        e_erf = model.encode_edges(pos, idx, box, lm, ls)
    scale = float(e_kernel.abs().max())
    assert float((e - e_kernel).abs().max()) <= 1e-6 * scale
    assert float((e_erf - e_kernel).abs().max()) > 1e-5 * scale
    assert torch.equal(live, mask) and torch.equal(live_kernel, mask)


@pytest.mark.parametrize("flags", [
    dict(use_pallas=True, use_pallas_encoder=True, train=True),
    dict(use_pallas=False, use_pallas_encoder=True, train=False),
])
def test_plain_encoder_where_jax_takes_it(flags):
    """JAX's condition (gnn.py:296-299): train mode, or use_pallas off,
    keeps the erf-gelu encoder (dropout 0 here, so train mode's e is the
    encoder's output exactly)."""
    train = flags.pop("train")
    cfg = tcfg.ModelConfig(encoding_size=WIDTH, hidden_dim=WIDTH,
                           edge_embedding_dim=WIDTH, conv_layers=1,
                           dropout=0.0, **flags)
    model, pos, idx, mask, box = _port_model(cfg, seed=2)
    with torch.no_grad():
        e, _ = _edges_into_conv(model, pos, idx, mask, box, 4.0, 1.5,
                                train=train,
                                generator=torch.Generator().manual_seed(0))
        e_erf = model.encode_edges(pos, idx, box, 4.0, 1.5)
    torch.testing.assert_close(e, e_erf, rtol=0, atol=0)


def test_pallas_encoder_model_matches_jax_interpret():
    """Port GAMDNet with use_pallas and use_pallas_encoder (plain versions
    on the CPU) against the JAX model with both Pallas kernels in interpret
    mode, patched as tests/test_ops.py:157-168 does, at that test's bf16
    tolerance rtol = atol = 0.08."""
    cfg = tcfg.ModelConfig(encoding_size=WIDTH, hidden_dim=WIDTH,
                           edge_embedding_dim=WIDTH, conv_layers=2,
                           use_pallas=True, use_pallas_encoder=True)
    pos, idx, mask, box = _model_inputs(seed=5)
    fields = dataclasses.asdict(cfg)
    jmodel = JGAMDNet(cfg=jcfg.ModelConfig(**fields), species="lj")
    # The same parameters, initialised through the XLA path (which needs no
    # interpret switch).
    plain = jcfg.ModelConfig(**{**fields, "use_pallas": False,
                                "use_pallas_encoder": False})
    variables = JGAMDNet(cfg=plain, species="lj").init(
        jax.random.PRNGKey(5), pos, idx, mask, box, 0.0, 1.0)
    model = GAMDNet(cfg).load_params(
        params_from_jax(variables["params"])).eval()
    orig = jpm._conv_msg_gather_forward
    orig_enc = jpe.fused_edge_encoder
    with mock.patch.object(jpm, "_conv_msg_gather_forward",
                           lambda *a: orig(*a[:-1], True)), \
         mock.patch.object(jpe, "fused_edge_encoder",
                           lambda *a, **kw: orig_enc(
                               *a, **{**kw, "interpret": True})):
        out_j = np.asarray(jmodel.apply(variables, pos, idx, mask, box,
                                        0.0, 1.0))
    with torch.no_grad():
        out_t = model(torch.tensor(pos), torch.tensor(idx),
                      torch.tensor(mask), box, 0.0, 1.0).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=0.08, atol=0.08)


# -- GNNForceField.predict / predict_batch ----------------------------------

LJ64 = dict(n_atoms=N_LJ, box=BOX_LJ)


def _force_fields(model_overrides=None):
    """(JAX GNNForceField, port GNNForceField on the CPU) on the same small
    weights with non-trivial scalers, LJ-64."""
    overrides = model_overrides or {}
    jsystem = jcfg.get_preset("lj", **LJ64)
    jmodel_cfg = jcfg.ModelConfig(**SMALL, **overrides)
    state = create_train_state(build_model(jmodel_cfg, jsystem),
                               jsystem, jcfg.TrainConfig(), 1)
    state = state.replace(force_stat=stat_from_values(0.3, 25.0, 10.0),
                          length_stat=stat_from_values(5.5, 1.6, 10.0))
    jff = JForceField(state, jsystem, jmodel_cfg)
    port_state = ForceFieldState(
        params=params_from_jax(state.params), batch_stats={},
        force_stat=stat_from_jax(state.force_stat),
        length_stat=stat_from_jax(state.length_stat))
    ff = GNNForceField(port_state, tcfg.get_preset("lj", **LJ64),
                       tcfg.ModelConfig(**SMALL, **overrides), device="cpu")
    return jff, ff


def _lj_frames(m, seed=0, sigma=0.3):
    """m frames: the LJ-64 lattice with seeded Gaussian displacements
    (some atoms leave the box, so the wrap is exercised)."""
    _, lattice = jlj.lj_fluid_box(N_LJ, 0.5)
    rng = np.random.default_rng(seed)
    return (lattice[None] + rng.normal(0, sigma, (m, N_LJ, 3))).astype(
        np.float32)


def test_predict_matches_jax_in_dataset_units():
    """predict of one frame against JAX's, within 1e-4 std(F) (fp32 both,
    JAX at matmul precision highest); both in dataset units: the port's
    predict is its force_fn (kJ/mol/A) over force_unit_to_internal, with no
    0.1 factor."""
    jff, ff = _force_fields()
    frame = _lj_frames(1)[0]
    with jax.default_matmul_precision("highest"):
        f_j = np.asarray(jax.jit(jff.predict)(jnp.asarray(frame)))
    f_t = ff.predict(frame)
    assert f_t.shape == (N_LJ, 3) and f_t.dtype == torch.float32
    scale = f_j.std()
    assert np.abs(f_t.numpy() - f_j).max() <= 1e-4 * scale

    from gamd_tpu_torch.core import space
    from gamd_tpu_torch.neighbors.dense import dense_neighbor_list
    posw = space.wrap(torch.as_tensor(frame), ff.system.box)
    idx, mask, _ = dense_neighbor_list(posw, ff.system.box,
                                       ff.system.cutoff,
                                       ff.system.nbr_capacity)
    internal = ff.force_fn()(posw, idx, mask)
    unit = ff.system.force_unit_to_internal
    assert unit == 0.1
    torch.testing.assert_close(f_t * unit, internal, rtol=1e-5,
                               atol=1e-5 * float(internal.std()))


@pytest.mark.parametrize("m,batch_size", [(5, 2), (4, 4)])
def test_predict_batch_matches_jax(m, batch_size):
    """predict_batch against JAX's, within 1e-4 std(F); m = 5 at batch size
    2 pads the last batch with the last frame and trims; and each frame
    against the port's own predict of it, within 1e-5 std(F)."""
    jff, ff = _force_fields()
    frames = _lj_frames(m, seed=m)
    with jax.default_matmul_precision("highest"):
        f_j = np.asarray(jff.predict_batch(jnp.asarray(frames),
                                           batch_size=batch_size))
    f_t = ff.predict_batch(frames, batch_size=batch_size)
    assert f_t.shape == (m, N_LJ, 3)
    scale = f_j.std()
    assert np.abs(f_t.numpy() - f_j).max() <= 1e-4 * scale
    for i in range(m):
        single = ff.predict(frames[i]).numpy()
        assert np.abs(f_t[i].numpy() - single).max() <= 1e-5 * scale


# -- run_segmented, fire_minimize --------------------------------------------

def test_run_segmented_equals_one_run():
    """Segments that are whole neighbour chunks draw the same noise and
    rebuild at the same steps as one run: identical state, thermo and
    sampled positions; the overflow flags OR-ed."""
    _, ff = _force_fields()
    system = ff.system
    md = tcfg.MDConfig(integrator="langevin", temperature=100.0,
                       friction_per_ps=25.0, rebuild_every=5)
    sim = Simulation(ff.force_fn(), system, md, device="cpu")
    frame = _lj_frames(1, seed=9, sigma=0.1)[0]

    def start():
        return sim.init_state(frame, rng=torch.Generator().manual_seed(4))

    whole = sim.run(start(), 30)
    parts = sim.run_segmented(start(), 30, segment=10)
    assert torch.equal(parts.state.pos, whole.state.pos)
    assert torch.equal(parts.state.vel, whole.state.vel)
    assert torch.equal(parts.thermo.temperature, whole.thermo.temperature)
    assert torch.equal(parts.thermo.kinetic_energy,
                       whole.thermo.kinetic_energy)
    assert torch.equal(parts.positions, whole.positions)
    assert parts.positions.shape == (6, N_LJ, 3)
    assert parts.overflow is False and whole.overflow is False
    ragged = sim.run_segmented(start(), 12, segment=7)
    assert ragged.thermo.temperature.shape == (12,)
    assert ragged.positions.shape == (3, N_LJ, 3)     # chunks 5+2, 5


def test_fire_minimize_matches_jax():
    """50 FIRE steps on the LJ-64 lattice with 0.2 A displacements, JAX and
    port from the same positions: positions within 1e-4 A (fp32 forces
    summed in another order, 50 steps) and the energy falls."""
    frame = _lj_frames(1, seed=3, sigma=0.2)[0]
    x_j, f_j = jfire(lambda p: jlj.lj_forces_dense(p, BOX_LJ),
                     jnp.asarray(frame), n_steps=50)
    x_t, f_t = fire_minimize(lambda p: tlj.lj_forces_dense(p, BOX_LJ),
                             torch.as_tensor(frame), n_steps=50)
    assert np.abs(x_t.numpy() - np.asarray(x_j)).max() <= 1e-4
    assert np.abs(f_t.numpy() - np.asarray(f_j)).max() \
        <= 1e-3 * np.abs(np.asarray(f_j)).max()
    e0 = float(tlj.lj_energy_dense(torch.as_tensor(frame), BOX_LJ))
    assert float(tlj.lj_energy_dense(x_t, BOX_LJ)) < e0


# -- rdf, MSD, diffusion; the thermo reporter --------------------------------

def _walk(t, n, box, seed, step=0.3):
    """t wrapped frames of a seeded random walk of n atoms."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0, box, (1, n, 3))
    walk = start + np.cumsum(rng.normal(0, step, (t, n, 3)), axis=0)
    return np.mod(walk, box).astype(np.float32)


@pytest.mark.parametrize("species", [False, True])
def test_radial_distribution_matches_jax(species):
    """g(r) of seeded frames against JAX's; the pair counts may differ only
    where a distance lies within rounding of a bin edge, by one pair
    (2 pairs, i-j and j-i) per frame, so g within 2 / (ideal pairs of the
    shell * frames) of JAX's; rdf_l2 of the two below 1e-3."""
    box = BOX_LJ
    frames = _walk(6, N_LJ, box, seed=1)
    sel = (np.arange(N_LJ) % 3 == 0) if species else None
    r_j, g_j = jrdf.radial_distribution(frames, box, n_bins=50,
                                        species_a=sel, species_b=sel)
    r_t, g_t = trdf.radial_distribution(torch.as_tensor(frames), box,
                                        n_bins=50, species_a=sel,
                                        species_b=sel)
    np.testing.assert_allclose(r_t, r_j, rtol=1e-6)
    n_sel = N_LJ if sel is None else int(sel.sum())
    edges = np.linspace(0.0, box / 2, 51)
    ideal = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3) \
        * n_sel * n_sel / box ** 3
    assert np.all(np.abs(g_t - g_j) <= 2.0 / (ideal * 6) + 1e-9)
    assert trdf.rdf_l2(g_t, g_j) < 1e-3
    assert trdf.rdf_l2(g_t, np.ones_like(g_t)) == pytest.approx(
        jrdf.rdf_l2(g_j, np.ones_like(g_j)), abs=1e-3)


def test_msd_and_diffusion_match_jax():
    """unwrap_trajectory, mean_squared_displacement and
    diffusion_coefficient on a seeded random walk against JAX's, within
    float32 rounding of the accumulated displacements (1e-4 relative)."""
    box, dt_ps = BOX_LJ, 0.04
    frames = _walk(30, N_LJ, box, seed=2)
    u_j = np.asarray(jrdf.unwrap_trajectory(frames, box))
    u_t = trdf.unwrap_trajectory(torch.as_tensor(frames), box).numpy()
    np.testing.assert_allclose(u_t, u_j, rtol=1e-5, atol=1e-4)
    sel = np.arange(N_LJ) % 2 == 0
    for species in (None, sel):
        t_j, msd_j = jrdf.mean_squared_displacement(frames, box, dt_ps,
                                                    species=species)
        t_t, msd_t = trdf.mean_squared_displacement(frames, box, dt_ps,
                                                    species=species)
        np.testing.assert_allclose(t_t, t_j)
        np.testing.assert_allclose(msd_t, msd_j, rtol=1e-4)
        d_j = jrdf.diffusion_coefficient(t_j, msd_j)
        d_t = trdf.diffusion_coefficient(t_t, msd_t)
        assert d_t == pytest.approx(d_j, rel=1e-4)


@pytest.mark.parametrize("potential_energy", [False, True])
def test_state_reporter_writes_jax_bytes(tmp_path, potential_energy):
    """The same thermo (and PE) arrays give the same file, byte for byte."""
    rng = np.random.default_rng(0)
    ke = rng.uniform(300, 330, 250).astype(np.float32)
    temp = rng.uniform(90, 110, 250).astype(np.float32)
    pe = rng.uniform(-900, -800, 250).astype(np.float32)
    kw = dict(report_interval=50, dt_fs=2.0,
              potential_energy=potential_energy)
    n_j = JStateReporter(str(tmp_path / "j.txt"), **kw).write(
        JThermo(jnp.asarray(ke), jnp.asarray(temp)), start_step=100,
        potential=jnp.asarray(pe))
    n_t = StateReporter(str(tmp_path / "t.txt"), **kw).write(
        Thermo(torch.as_tensor(ke), torch.as_tensor(temp)), start_step=100,
        potential=torch.as_tensor(pe))
    assert n_t == n_j == 5
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


# -- the CLIs -----------------------------------------------------------------

THERMO_HEADER = ('#"Step"\t"Time (ps)"\t"Kinetic Energy (kJ/mole)"\t'
                 '"Temperature (K)"')
REPORT_KEYS = {
    "rdf_l2", "rdf_peak_gnn", "rdf_peak_gt", "rdf_peak_pos_gnn",
    "rdf_peak_pos_gt", "temperature_mean", "temperature_target",
    "n_rollout_frames", "n_gt_frames", "steps",
    "rollout_steps_per_s_incl_compile",
    # --classical_baseline
    "rdf_l2_vs_classical_rollout", "rdf_peak_classical_rollout",
    "classical_temperature_mean",
    # >= 20 rollout frames
    "diffusion_m2_s", "classical_diffusion_m2_s",
    # --pe
    "pe_gnn_mean_kj_mol", "pe_gnn_std_kj_mol", "pe_gnn_drift_kj_mol_ps",
    "pe_classical_mean_kj_mol", "pe_classical_std_kj_mol",
    # --json_out's curves
    "r", "g_gnn", "g_gt",
}


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    """A self-describing checkpoint written by the JAX package: SMALL
    widths on LJ-64 (rho* = 0.5), non-trivial scalers; and a start frame."""
    path = tmp_path_factory.mktemp("ckpt")
    jsystem = jcfg.get_preset("lj", **LJ64)
    jmodel_cfg = jcfg.ModelConfig(**SMALL)
    state = create_train_state(build_model(jmodel_cfg, jsystem), jsystem,
                               jcfg.TrainConfig(), 1)
    state = state.replace(force_stat=stat_from_values(0.0, 400.0, 10.0),
                          length_stat=stat_from_values(5.5, 1.6, 10.0))
    ckpt = save_checkpoint(str(path / "small.msgpack"), state, jmodel_cfg,
                           jsystem)
    init = str(path / "init.npy")
    np.save(init, _lj_frames(1, seed=5, sigma=0.1)[0])
    return ckpt, init


@pytest.mark.parametrize("path_flag", [None, "--use_pallas", "--megakernel",
                                       "--megastep"])
def test_run_md_cli_on_cpu(tmp_path, small_ckpt, path_flag):
    """run_md --cpu on each force path: the thermo log in the reference's
    format, one row per report interval, and the final positions."""
    ckpt, init = small_ckpt
    log, traj = tmp_path / "log.txt", tmp_path / "traj.npy"
    argv = ["--ckpt", ckpt, "--init_pos", init, "--steps", "40",
            "--report_every", "10", "--log", str(log), "--out_traj",
            str(traj), "--cpu"] + ([path_flag] if path_flag else [])
    run_md.main(argv)
    lines = log.read_text().splitlines()
    assert lines[0] == THERMO_HEADER
    assert [int(line.split("\t")[0]) for line in lines[1:]] == \
        [10, 20, 30, 40]
    temps = [float(line.split("\t")[3]) for line in lines[1:]]
    assert all(math.isfinite(t) and 0 < t < 1000 for t in temps)
    final = np.load(traj)
    assert final.shape == (N_LJ, 3) and np.isfinite(final).all()


def test_run_md_cli_seeded_weights_and_fire_start(tmp_path):
    """Without --ckpt (seeded weights, the LJ preset) and without
    --init_pos (the FIRE-minimised lattice), through the argument
    defaults, at tiny widths and a few steps."""
    log = tmp_path / "log.txt"
    with mock.patch("gamd_tpu_torch.physics.minimize.fire_minimize",
                    wraps=fire_minimize) as fire:
        run_md.main(["--steps", "4", "--report_every", "2", "--log",
                     str(log), "--encoding_size", "16", "--hidden_dim",
                     "16", "--edge_embedding_dim", "16", "--conv_layer",
                     "1", "--cpu"])
    assert fire.call_count == 1
    assert fire.call_args.kwargs["n_steps"] == 1000
    assert len(log.read_text().splitlines()) == 3


@pytest.mark.parametrize("argv,names", [
    (["--system", "tip3p"], "Queue 1 item 5"),
    (["--integrator", "nose_hoover"], "Queue 1 item 3"),
])
def test_run_md_cli_refuses_what_later_slices_bring(argv, names):
    with pytest.raises(NotImplementedError, match=names):
        run_md.main(argv + ["--cpu"])


def test_analyze_rollout_cli_on_cpu(tmp_path, small_ckpt):
    """analyze_rollout --cpu on a ground-truth directory of classical
    frames: the JAX CLI's report keys, finite values, the PE TSV, and the
    default integrator (nose_hoover) refused."""
    ckpt, init = small_ckpt
    data = tmp_path / "gt"
    data.mkdir()
    system = tcfg.get_preset("lj", **LJ64)
    sim = Simulation(tlj.lj_force_fn(system.box), system,
                     tcfg.MDConfig(rebuild_every=10), device="cpu")
    res = sim.run(sim.init_state(np.load(init),
                                 rng=torch.Generator().manual_seed(0)), 120)
    for t, frame in enumerate(res.positions.numpy()):
        np.savez(data / f"data_0_{195 + t}.npz", pos=frame)
    out = tmp_path / "report.json"
    report = analyze_rollout.main([
        "--ckpt", ckpt, "--data_dir", str(data), "--integrator", "langevin",
        "--friction", "25", "--steps", "400", "--equil_fraction", "0",
        "--classical_baseline", "--pe", "--json_out", str(out), "--cpu"])
    saved = json.loads(out.read_text())
    assert set(saved) == REPORT_KEYS
    assert saved["n_gt_frames"] == 7          # t >= 200 of 195..206
    assert saved["n_rollout_frames"] == 20    # one sample per 20 steps
    assert all(math.isfinite(v) for k, v in report.items())
    assert len(saved["g_gnn"]) == len(saved["r"]) == 100
    pe = (tmp_path / "report.json_pe.tsv").read_text().splitlines()
    assert pe[0].split("\t") == [
        '#"Frame"', '"Time (ps)"', '"Classical PE on GNN traj (kJ/mole)"',
        '"Classical PE on classical traj (kJ/mole)"']
    assert len(pe) == 21
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        analyze_rollout.main(["--ckpt", ckpt, "--data_dir", str(data),
                              "--cpu"])
