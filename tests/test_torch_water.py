"""The port's water slice on the CPU, against the JAX package on the same
numpy inputs: the topology (neighbors/topology.py), TIP3P water
(physics/water.py), the water GAMDNet (one-hot node encoder, bond channel)
plain and with use_pallas, GNNForceField's water paths (force_fn, the
megakernel force path and megastep window with the bond channel, predict,
predict_batch), mega_forward's edge_hilo / f32_edges switches, the
refusals of what later slices bring, and run_md --system tip3p --cpu.

The system is small: 27 molecules (81 atoms) in a 9.4 A box, cutoff 4.2 A
(under half the box); lists of K=64 (4.2 + 0.5 A holds up to 54 atoms
here),
seeded weights 2 layers 32 wide and the committed tip3p_final weights (4
layers, 128 wide). The CUDA kernels with the bond channel are held against
their plain versions in tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses
import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.models.normalizer import stat_from_values
from gamd_tpu.neighbors.dense import dense_neighbor_list as jdense
from gamd_tpu.neighbors.dense import refresh_mask as jrefresh
from gamd_tpu.neighbors import topology as jtopo
from gamd_tpu.ops import pallas_model as jmega
from gamd_tpu.physics import water as jw
from gamd_tpu.train import checkpoint as jckpt
from gamd_tpu.train.forcefield import GNNForceField as JForceField
from gamd_tpu.train.state import build_model, create_train_state

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.md.constraints import RigidWater
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.models.gnn import GAMDNet
from gamd_tpu_torch.neighbors import topology as ttopo
from gamd_tpu_torch.ops import banded
from gamd_tpu_torch.ops import mega as tmega
from gamd_tpu_torch.physics import water as tw
from gamd_tpu_torch.tools import run_md
from gamd_tpu_torch.train import checkpoint as tckpt
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.state import (ForceFieldState, init_params,
                                        params_from_jax, stat_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = os.path.join(REPO, "results", "ckpts")
N_MOL, BOX, CUTOFF, K = 27, 9.4, 4.2, 64
N = 3 * N_MOL
SYSTEM = dict(n_atoms=N, box=BOX, cutoff=CUTOFF, nbr_capacity=K, skin=0.5)
SMALL = dict(encoding_size=32, hidden_dim=32, edge_embedding_dim=32,
             conv_layers=2)
MODEL_RTOL = 1e-5      # max |dF| / max |F|, port against JAX (fp32)
KERNEL_TOL = 5e-3      # max |dF| / std(F), the megakernel's fp32 bar
WINDOW_ATOL = 2e-4     # the megastep window's pos and vel (c2col = 0)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _frames(n, seed, sigma=0.1):
    """n frames [n, N, 3]: the water box with seeded jitter, snapped back
    onto the rigid monomer by JAX's project_initial, wrapped."""
    from gamd_tpu.md.constraints import RigidWater as JRigidWater
    base = jw.water_box(N_MOL, BOX, seed=seed)
    rng = np.random.RandomState(seed)
    cst = JRigidWater(N_MOL, BOX)
    out = []
    for _ in range(n):
        p = base + rng.normal(0.0, sigma, base.shape).astype(np.float32)
        p = np.asarray(cst.project_initial(jnp.asarray(p)))
        out.append(np.mod(p, BOX).astype(np.float32))
    return np.stack(out)


@pytest.fixture(scope="module")
def frame():
    """(pos [N, 3], idx [N, K], mask [N, K]) at the true cutoff."""
    pos = _frames(1, seed=3)[0]
    idx, mask = _jlist(pos)
    return pos, idx, mask


def _jlist(pos, radius=CUTOFF):
    idx, mask, ovf = jdense(jnp.asarray(pos), BOX, radius, K)
    assert not bool(ovf)
    return np.asarray(idx), np.asarray(mask)


def _jax_seeded_state(seed=0):
    system = jcfg.get_preset("tip3p", **SYSTEM)
    cfg = jcfg.ModelConfig(**SMALL)
    state = create_train_state(build_model(cfg, system), system,
                               jcfg.TrainConfig(seed=seed), 1)
    state = state.replace(force_stat=stat_from_values(0.0, 900.0, 10.0),
                          length_stat=stat_from_values(3.2, 0.8, 10.0))
    return state, cfg, system


@pytest.fixture(scope="module")
def seeded():
    """(JAX state, JAX cfg, JAX system, port ForceFieldState, port cfg,
    port system): seeded water weights 2 x 32 with the bond channel."""
    jstate, jcfg_, jsys = _jax_seeded_state()
    state = ForceFieldState(params=params_from_jax(jstate.params),
                            batch_stats={},
                            force_stat=stat_from_jax(jstate.force_stat),
                            length_stat=stat_from_jax(jstate.length_stat))
    return (jstate, jcfg_, jsys, state, tcfg.ModelConfig(**SMALL),
            tcfg.get_preset("tip3p", **SYSTEM))


@pytest.fixture(scope="module")
def trained():
    """The same, with tip3p_final's weights and scalers on the small box."""
    path = os.path.join(CKPTS, "tip3p_final.msgpack")
    jstate, jcfg_, _ = jckpt.load_self_describing(path)
    state, cfg, system = tckpt.load_self_describing(path)
    assert cfg.conv_layers == 4 and cfg.hidden_dim == 128
    assert system.has_bonds and system.species == "water"
    return (jstate, jcfg_, jcfg.get_preset("tip3p", **SYSTEM), state, cfg,
            dataclasses.replace(system, **SYSTEM))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# -- topology -----------------------------------------------------------------

def test_topology_matches_jax_exactly():
    """water_bond_mask, edge_type_water and neighbor_bond_channel on ids
    that include negative ones and ids at and past N, for one list and for
    replicas [2, N, K]: bit for bit."""
    rng = np.random.RandomState(0)
    i = rng.randint(-7, N + 7, size=(500,)).astype(np.int32)
    j = rng.randint(-7, N + 7, size=(500,)).astype(np.int32)
    j[:60] = i[:60] + rng.randint(-3, 4, size=60)   # same-molecule pairs
    np.testing.assert_array_equal(
        ttopo.water_bond_mask(_t(i), _t(j)).numpy(),
        np.asarray(jtopo.water_bond_mask(jnp.asarray(i), jnp.asarray(j))))
    np.testing.assert_array_equal(
        ttopo.edge_type_water(_t(i), _t(j)).numpy(),
        np.asarray(jtopo.edge_type_water(jnp.asarray(i), jnp.asarray(j))))
    idx = rng.randint(-4, N + 4, size=(2, N, K)).astype(np.int32)
    got = ttopo.neighbor_bond_channel(_t(idx))
    want = np.asarray(jtopo.neighbor_bond_channel(jnp.asarray(idx)))
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


# -- TIP3P physics ------------------------------------------------------------

@pytest.mark.parametrize("n_mol,box,seed", [(27, 9.4, 0), (258, 20.0, 3)])
def test_water_box_matches_jax_bit_for_bit(n_mol, box, seed):
    got = tw.water_box(n_mol, box, seed=seed)
    want = jw.water_box(n_mol, box, seed=seed)
    assert got.dtype == np.float32 and got.shape == (3 * n_mol, 3)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("rigid", [True, False])
def test_tip3p_energy_and_forces_match_jax(rigid):
    """The rigid (nonbonded) and flexible energies and their forces on a
    jittered box at cutoff 4.5 A: rtol 1e-5 (forces against 1e-5 of their
    largest magnitude); the force closure gives the same forces."""
    pos = _frames(1, seed=1, sigma=0.15)[0]
    p_j, p_t = jw.TIP3PParams(cutoff=4.5), tw.TIP3PParams(cutoff=4.5)
    if rigid:
        e_j = jw.tip3p_energy_rigid(jnp.asarray(pos), BOX, p_j)
        f_j = jw.tip3p_forces_rigid(jnp.asarray(pos), BOX, p_j)
        e_t = tw.tip3p_energy_rigid(_t(pos), BOX, p_t)
        f_t = tw.tip3p_forces_rigid(_t(pos), BOX, p_t)
    else:
        e_j = jw.tip3p_energy(jnp.asarray(pos), BOX, p_j)
        f_j = jw.tip3p_forces(jnp.asarray(pos), BOX, p_j)
        e_t = tw.tip3p_energy(_t(pos), BOX, p_t)
        f_t = tw.tip3p_forces(_t(pos), BOX, p_t)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-5)
    f_j = np.asarray(f_j)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=1e-5,
                               atol=1e-5 * np.abs(f_j).max())
    closure = tw.tip3p_force_fn(BOX, p_t, rigid=rigid)
    np.testing.assert_array_equal(closure(_t(pos), None, None).numpy(),
                                  f_t.numpy())
    np.testing.assert_allclose(
        tw.atom_charges(N_MOL, p_t).numpy(),
        np.asarray(jw.atom_charges(N_MOL, p_j)), rtol=0)


def test_tip3p_force_fn_refuses_ewald():
    """Refused until the water slice brought physics/ewald.py: the Ewald
    force closure (rigid and flexible) against JAX's on a jittered box
    (make_ewald_params(box): cutoff 10 A), 1e-4 of the largest |F| (the
    Ewald bar of tests/test_torch_ewald.py), with handles_refresh; an
    unknown electrostatics raises ValueError."""
    pos = _frames(1, seed=1, sigma=0.15)[0]
    for rigid in (True, False):
        want = np.asarray(jw.tip3p_force_fn(BOX, rigid=rigid,
                                            electrostatics="ewald")(
            jnp.asarray(pos), None, None))
        fn = tw.tip3p_force_fn(BOX, rigid=rigid, electrostatics="ewald")
        assert fn.handles_refresh
        assert _rel(fn(_t(pos), None, None), want) < 1e-4
    with pytest.raises(ValueError, match="electrostatics"):
        tw.tip3p_force_fn(BOX, electrostatics="pme")


# -- the water GAMDNet --------------------------------------------------------

def _jax_apply(jstate, cfg, pos, idx, mask):
    model = build_model(cfg, jcfg.get_preset("tip3p", **SYSTEM))
    feat = jnp.asarray(jcfg.get_preset("tip3p", **SYSTEM)
                       .species_onehot())[None]
    bond = jtopo.neighbor_bond_channel(jnp.asarray(idx))[None]
    ls = jstate.length_stat
    return np.asarray(model.apply(
        {"params": jstate.params}, jnp.asarray(pos)[None],
        jnp.asarray(idx)[None], jnp.asarray(mask)[None], BOX,
        ls.safe_mean, jnp.maximum(ls.std, 1e-12), node_feat=feat,
        bond=bond, train=False))[0]


@pytest.mark.parametrize("weights", ["seeded", "trained"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_water_gamdnet_matches_jax(request, frame, weights, use_pallas):
    """The port's water GAMDNet (node encoder, bond column) against JAX's
    GAMDNet.apply on the same frame and list: within 1e-5 of max |F|; with
    use_pallas every conv layer goes through fused_conv_gather_message's
    plain version (the JAX reference is its plain model)."""
    jstate, jcfg_, _, state, cfg, system = request.getfixturevalue(weights)
    pos, idx, mask = frame
    want = _jax_apply(jstate, jcfg_, pos, idx, mask)
    cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    model = GAMDNet(cfg, "water", use_bond=True).load_params(state.params)
    assert "node_emb" not in dict(model.named_parameters())
    assert model.edge_encoder_w0.shape[0] == 4 + cfg.n_rbf + 1
    feat = _t(system.species_onehot())[None]
    bond = ttopo.neighbor_bond_channel(_t(idx))[None]
    with torch.no_grad():
        got = model(_t(pos)[None], _t(idx)[None], _t(mask)[None], BOX,
                    state.length_stat.safe_mean,
                    max(state.length_stat.std, 1e-12), node_feat=feat,
                    bond=bond)[0]
    assert _rel(got, want) < MODEL_RTOL
    params, _ = model.export_params()
    assert params["node_encoder"]["kernel"].tobytes() == np.asarray(
        state.params["node_encoder"]["kernel"], np.float32).tobytes()
    with pytest.raises(ValueError, match="bond channel"):
        model(_t(pos)[None], _t(idx)[None], _t(mask)[None], BOX, 3.0, 1.0,
              node_feat=feat)


def test_init_params_for_water_has_jax_layout():
    """Seeded water weights carry the node encoder and the bond row, in
    the shapes of JAX's water model, and no LJ embedding."""
    jstate, _, _ = _jax_seeded_state()
    state = init_params(tcfg.ModelConfig(**SMALL),
                        tcfg.get_preset("tip3p", **SYSTEM), seed=1)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: np.shape(a), t)
    assert shapes(state.params) == shapes(params_from_jax(jstate.params))
    lj = init_params(tcfg.ModelConfig(**SMALL), tcfg.get_preset("lj"),
                     seed=1)
    assert "node_emb" in lj.params and "node_encoder" not in lj.params


# -- GNNForceField's water paths ----------------------------------------------

def _port_ff(fixture):
    _, _, _, state, cfg, system = fixture
    return GNNForceField(state, system, cfg, device="cpu")


def _jax_ff(fixture):
    jstate, jcfg_, jsys, *_ = fixture
    return JForceField(jstate, jsys, jcfg_)


@pytest.mark.parametrize("weights", ["seeded", "trained"])
def test_force_fn_and_megakernel_match_jax(request, frame, weights):
    """force_fn (the eager model) against JAX's force_fn: 1e-5 of max |F|.
    force_fn(megakernel=True), the plain version of the CUDA forward with
    the bond channel, against JAX's reference_forward with the bond (1e-5
    of max |F|) and JAX's Pallas mega_forward(edge_hilo=True) in interpret
    mode (5e-3 std(F)), on the build-time list at 4.2 + 0.5 A."""
    fixture = request.getfixturevalue(weights)
    pos, _, _ = frame
    idx, mask = _jlist(pos, CUTOFF + 0.5)
    ff, jff = _port_ff(fixture), _jax_ff(fixture)
    live = np.asarray(jrefresh(jnp.asarray(pos), BOX, CUTOFF,
                               jnp.asarray(idx), jnp.asarray(mask)))
    eager = ff.force_fn()(_t(pos), _t(idx), _t(live))
    assert _rel(eager, jff.force_fn()(jnp.asarray(pos), jnp.asarray(idx),
                                      jnp.asarray(live))) < MODEL_RTOL

    fn = ff.force_fn(megakernel=True)
    assert fn.handles_refresh
    got = fn(_t(pos), _t(idx), _t(mask))
    jstate, jcfg_, jsys = fixture[:3]
    mp = jmega.pack_params(jstate.params, jcfg_,
                           force_std=jnp.maximum(jstate.force_stat.std,
                                                 1e-12),
                           force_mean=jstate.force_stat.safe_mean,
                           unit=jsys.force_unit_to_internal)
    h0 = np.asarray(jff._node_h0())
    np.testing.assert_array_equal(ff._node_h0().numpy(), h0)
    bond = jtopo.neighbor_bond_channel(jnp.asarray(idx))
    ls = jstate.length_stat
    args = (jnp.asarray(pos), jnp.asarray(idx), jnp.asarray(mask),
            jnp.asarray(h0), mp, BOX, CUTOFF, ls.safe_mean,
            jnp.maximum(ls.std, 1e-12))
    ref = np.asarray(jmega.reference_forward(*args, bond=bond,
                                             rbf_gap=jcfg_.rbf_gap))
    assert _rel(got, ref) < MODEL_RTOL
    hilo = np.asarray(jmega.mega_forward(*args, bond=bond, tile_n=8,
                                         interpret=True, edge_hilo=True))
    assert float(np.abs(got.numpy() - hilo).max()) \
        < KERNEL_TOL * float(np.abs(hilo).std())


def test_mega_forward_takes_the_precision_switches(seeded, frame):
    """mega_forward takes JAX's edge_hilo and f32_edges (the kernel's
    bf16 x 3 products stand for both); on the CPU each gives the plain
    fp32 forward, within 5e-3 std(F) of JAX's fp32-edge Pallas forward.
    A bond of zeros gives the bits of no bond."""
    jstate, jcfg_, jsys, state, cfg, system = seeded
    pos, _, _ = frame
    idx, mask = _jlist(pos, CUTOFF + 0.5)
    ff = GNNForceField(state, system, cfg, device="cpu")
    mp = ff._kernel_params("megakernel")
    args = (_t(pos), _t(idx), _t(mask), ff._node_h0(), mp, BOX, CUTOFF,
            *ff._length_scale())
    bond = ttopo.neighbor_bond_channel(_t(idx))
    plain = tmega.mega_forward(*args, bond=bond)
    for kw in (dict(edge_hilo=True), dict(f32_edges=True)):
        assert torch.equal(tmega.mega_forward(*args, bond=bond, **kw), plain)
    jmp = jmega.pack_params(jstate.params, jcfg_,
                            force_std=jstate.force_stat.std,
                            force_mean=jstate.force_stat.safe_mean,
                            unit=jsys.force_unit_to_internal)
    f32 = np.asarray(jmega.mega_forward(
        jnp.asarray(pos), jnp.asarray(idx), jnp.asarray(mask),
        jnp.asarray(args[3].numpy()), jmp, BOX, CUTOFF, *args[7:],
        bond=jnp.asarray(bond.numpy()), tile_n=8, interpret=True,
        f32_edges=True))
    assert float(np.abs(plain.numpy() - f32).max()) \
        < KERNEL_TOL * float(np.abs(f32).std())
    assert torch.equal(tmega.mega_forward(*args, bond=torch.zeros_like(bond)),
                       tmega.mega_forward(*args))


def test_megastep_window_with_bond_matches_jax(seeded, frame):
    """GNNForceField.megastep_fn (the plain window with the bond channel)
    with c2col = 0, 4 steps, against JAX's Pallas mega_md_steps with the
    same bond and edge_hilo in interpret mode: pos and vel within 2e-4."""
    jstate, jcfg_, jsys, state, cfg, system = seeded
    pos, _, _ = frame
    idx, mask = _jlist(pos, CUTOFF + 0.5)
    ff = GNNForceField(state, system, cfg, device="cpu")
    vel = (0.5 * np.random.RandomState(7).randn(N, 3)).astype(np.float32)
    f0 = ff.force_fn(megakernel=True)(_t(pos), _t(idx), _t(mask))
    md = tcfg.MDConfig(integrator="langevin", temperature=300.0,
                       friction_per_ps=1.0)
    sim = Simulation(lambda p, i, m: p, system, md, device="cpu")
    c1, hdt, _ = sim._baoab_constants()
    kw = dict(n_steps=4, c1=c1, hdt=hdt, masses=sim.masses)
    got = ff.megastep_fn()(_t(pos), _t(vel), f0, _t(idx), _t(mask),
                           torch.tensor([3], dtype=torch.int32),
                           c2col=torch.zeros(N), **kw)
    jmp = jmega.pack_params(jstate.params, jcfg_,
                            force_std=jstate.force_stat.std,
                            force_mean=jstate.force_stat.safe_mean,
                            unit=jsys.force_unit_to_internal)
    want = jmega.mega_md_steps(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(f0.numpy()),
        jnp.asarray(idx), jnp.asarray(mask),
        jnp.asarray(ff._node_h0().numpy()), jmp, BOX, CUTOFF,
        *ff._length_scale(), jnp.asarray(sim.masses.numpy()), n_steps=4,
        c1=c1, hdt=hdt, c2col=jnp.zeros((N,)), seed=3,
        bond=jtopo.neighbor_bond_channel(jnp.asarray(idx)), tile_n=8,
        interpret=True, edge_hilo=True)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=WINDOW_ATOL)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-3)
    assert float(np.abs(got[0].numpy() - pos).max()) > 1e-3


def test_predict_and_predict_batch_match_jax(trained):
    """predict of one frame and predict_batch of 3 frames (batch 2, the
    last batch padded) against JAX's: 1e-5 of max |F|, in dataset units."""
    frames = _frames(3, seed=4)
    ff, jff = _port_ff(trained), _jax_ff(trained)
    assert _rel(ff.predict(_t(frames[0])),
                jff.predict(jnp.asarray(frames[0]))) < MODEL_RTOL
    got = ff.predict_batch(_t(frames), batch_size=2)
    want = jff.predict_batch(jnp.asarray(frames), batch_size=2)
    assert got.shape == (3, N, 3)
    assert _rel(got, want) < MODEL_RTOL


# -- the banded path with the bond channel ---------------------------------

#: TIP3P-774 in the preset's 20 A box: the auto band (512) is narrower
#: than the 784 padded rows, as on the deployment (a box of a few cutoffs
#: overflows any band and poisons the forces).
BANDED_MOL, BANDED_BOX = 258, 20.0


@pytest.fixture(scope="module")
def banded_frame():
    """(system kwargs, pos, idx, mask) of the port's water_box at 258
    molecules with a seeded jitter, the JAX dense list at 4.2 + 0.5 A,
    K=64."""
    n = 3 * BANDED_MOL
    kw = dict(n_atoms=n, box=BANDED_BOX, cutoff=CUTOFF, nbr_capacity=K,
              skin=0.5)
    rng = np.random.RandomState(7)
    pos = tw.water_box(BANDED_MOL, BANDED_BOX, seed=7)
    pos = np.mod(pos + rng.normal(0.0, 0.05, pos.shape), BANDED_BOX)
    pos = pos.astype(np.float32)
    idx, mask, ovf = jdense(jnp.asarray(pos), BANDED_BOX, CUTOFF + 0.5, K)
    assert not bool(ovf)
    return kw, pos, np.asarray(idx), np.asarray(mask)


def test_banded_water_matches_jax(seeded, banded_frame):
    """GNNForceField.banded_force_fn with the bond channel (computed in the
    sorted frame from the original ids) on TIP3P-774 of the port's
    water_box, seeded weights 2 x 32, K=64, band 512, against JAX: its fp32
    reference_forward with the bond on the unsorted frame within the LJ
    banded test's 1e-4 std(F), and its banded force fn in interpret mode,
    whose edge products run in single-pass bf16. On water that kernel is
    6.98e-3 (relative MAE) from JAX's own fp32 forward, above the LJ bar
    of 6e-3, so the port is held no farther from it than that (5% over,
    cosine > 0.9999). Without the bond the forces differ."""
    jstate, jcfg_, _, state, cfg, _ = seeded
    kw, pos, idx, mask = banded_frame
    jsys = jcfg.get_preset("tip3p", **kw)
    jff = JForceField(jstate, jsys, jcfg_)
    ff = GNNForceField(state, tcfg.get_preset("tip3p", **kw), cfg,
                       device="cpu")
    fn = ff.banded_force_fn()
    assert fn.handles_refresh and fn.banded_band == 512
    got = fn(_t(pos), _t(idx), _t(mask)).numpy()
    assert np.isfinite(got).all()
    jmp = jmega.pack_params(jstate.params, jcfg_,
                            force_std=jnp.maximum(jstate.force_stat.std,
                                                  1e-12),
                            force_mean=jstate.force_stat.safe_mean,
                            unit=jsys.force_unit_to_internal)
    ls = jstate.length_stat
    ref = np.asarray(jmega.reference_forward(
        jnp.asarray(pos), jnp.asarray(idx), jnp.asarray(mask),
        jnp.asarray(jff._node_h0()), jmp, kw["box"], CUTOFF, ls.safe_mean,
        jnp.maximum(ls.std, 1e-12),
        bond=jtopo.neighbor_bond_channel(jnp.asarray(idx)),
        rbf_gap=jcfg_.rbf_gap))
    assert np.abs(got - ref).max() < 1e-4 * ref.std()
    jband = np.asarray(jff.banded_force_fn(interpret=True)(
        jnp.asarray(pos), jnp.asarray(idx), jnp.asarray(mask)))
    rel_mae = lambda a, b: np.abs(a - b).mean() / np.abs(b).mean()
    assert rel_mae(got, jband) < 1.05 * rel_mae(ref, jband)
    cos = (got * jband).sum() / (np.linalg.norm(got)
                                 * np.linalg.norm(jband))
    assert cos > 0.9999, cos
    no_bond = banded.make_banded_force_fn(
        ff._kernel_params("banded"), kw["box"], CUTOFF, kw["n_atoms"],
        ff._node_h0(), *ff._length_scale())(
            _t(pos), _t(idx), _t(mask))[0].numpy()
    assert np.isfinite(no_bond).all()
    assert np.abs(got - no_bond).max() > 1e-3 * ref.std()


def test_banded_force_fn_takes_tip3p_final(trained, banded_frame):
    """tip3p_final's weights (4 x 128) on the banded path on the CPU, at
    TIP3P-774: the same forces as the megakernel path's plain forward on
    the same list (1e-4 std(F)), both with the bond channel."""
    kw, pos, idx, mask = banded_frame
    state, cfg, system = trained[3:]
    ff = GNNForceField(state, dataclasses.replace(system, **kw), cfg,
                       device="cpu")
    got = ff.banded_force_fn()(_t(pos), _t(idx), _t(mask)).numpy()
    want = ff.force_fn(megakernel=True)(_t(pos), _t(idx), _t(mask)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-4 * want.std()


# -- refusals -----------------------------------------------------------------

def test_refusals_raise_before_any_work(seeded, tmp_path):
    """run_md --system dft with --banded or with --megastep on rigid water
    is the JAX CLI's parser error (--system dft itself runs since the DFT
    slice), megastep with a constraint raises, naming what it needs, and
    an ablate name JAX's kernel does not know raises ValueError before any
    work. The long-range envelopes, refused until
    the water slice, now load (the megastep window and the banded path
    refuse them with ValueError, run_md --megastep too), and constrained
    replicas run (the banded path with a bond channel, once refused here,
    runs since: test_banded_water_matches_jax)."""
    _, _, _, state, cfg, system = seeded
    for name in ("tip3p_lr_latest", "tip3p_rj_best"):
        lr_state, lr_cfg, lr_sys = tckpt.load_self_describing(
            os.path.join(CKPTS, f"{name}.msgpack"))
        assert lr_cfg.longrange == "ewald_recip"
        lr_ff = GNNForceField(lr_state, lr_sys, lr_cfg, device="cpu")
        for fn in (lr_ff.megastep_fn, lr_ff.banded_force_fn):
            with pytest.raises(ValueError, match="long-?range"):
                fn()
    with pytest.raises(ValueError, match="long-?range"):
        run_md.main(["--system", "tip3p", "--ckpt",
                     os.path.join(CKPTS, "tip3p_lr_latest.msgpack"),
                     "--megastep", "--no-rigid", "--cpu", "--steps", "2"])
    for flag in ("--banded", "--megastep"):
        with pytest.raises(SystemExit):
            run_md.main(["--system", "dft", flag, "--cpu"])
    ff = GNNForceField(state, system, cfg, device="cpu")
    cst = RigidWater(N_MOL, BOX)
    md = tcfg.MDConfig(integrator="langevin")
    with pytest.raises(ValueError, match="unconstrained"):
        Simulation(ff.force_fn(megakernel=True), system, md,
                   megastep_fn=ff.megastep_fn(), constraint=cst,
                   device="cpu")
    with pytest.raises(SystemExit):
        run_md.main(["--system", "tip3p", "--megastep", "--cpu"])
    sim = Simulation(ff.force_fn(), system, md, constraint=cst,
                     device="cpu")
    states = sim.init_replicas(_frames(1, seed=0)[0], 2)
    assert states.pos.shape == (2, N, 3)
    with pytest.raises(ValueError, match="unknown ablate stage"):
        tmega.mega_md_steps(*[None] * 12, n_steps=1, c1=1.0, hdt=0.1,
                            c2col=None, seed=None, ablate=("bond",))


# -- run_md --system tip3p ----------------------------------------------------

@pytest.fixture(scope="module")
def water_ckpt(tmp_path_factory):
    """A self-describing water checkpoint written by the JAX package (the
    seeded 2 x 32 model on the small box)."""
    jstate, jcfg_, jsys = _jax_seeded_state()
    path = tmp_path_factory.mktemp("water") / "small.msgpack"
    return jckpt.save_checkpoint(str(path), jstate, jcfg_, jsys)


@pytest.mark.parametrize("flags", [["--megakernel"], ["--use_pallas"],
                                   ["--megastep", "--no-rigid"]])
def test_run_md_water_cli_on_cpu(tmp_path, monkeypatch, water_ckpt, flags):
    """run_md --system tip3p --cpu on the small checkpoint: the start
    (water_box, 1,500 FIRE steps at trust radius 0.05 A, project_initial),
    rigid by default (SETTLE/RATTLE: the residual under 1e-5 A at the
    end), the thermo log and finite positions and forces; --megastep runs
    with --no-rigid."""
    runs = []
    rollout = run_md.rollout
    monkeypatch.setattr(run_md, "rollout",
                        lambda *a: runs.append(rollout(*a)) or runs[-1])
    log, traj = tmp_path / "log.txt", tmp_path / "traj.npy"
    run_md.main(["--system", "tip3p", "--ckpt", water_ckpt, "--steps", "20",
                 "--report_every", "10", "--log", str(log), "--out_traj",
                 str(traj), "--cpu"] + flags)
    assert len(log.read_text().splitlines()) == 3
    assert np.isfinite(np.load(traj)).all()
    (run,) = runs
    rigid = "--no-rigid" not in flags
    assert (run["constraint"] is not None) == rigid
    assert run["sim"].ndf == 3 * N - (3 * N_MOL if rigid else 0)
    res = run["result"]
    assert not res.overflow
    assert bool(torch.isfinite(res.state.pos).all())
    assert bool(torch.isfinite(res.state.force).all())
    if rigid:
        assert float(run["constraint"].residual(res.state.pos)) < 1e-5


def test_run_md_water_banded_cli_on_cpu(tmp_path, monkeypatch,
                                       banded_frame):
    """run_md --system tip3p --banded --cpu on a JAX-written checkpoint of
    the seeded 2 x 32 model on the preset's TIP3P-774 box (a small box
    overflows any band), from the water_box frame (--init_pos, so that
    the FIRE start is not rerun): the banded force path with the bond
    channel (band 512), rigid, a few steps with every force finite and
    the residual under 1e-5 A."""
    jstate, jcfg_, _ = _jax_seeded_state()
    ckpt = jckpt.save_checkpoint(str(tmp_path / "w774.msgpack"), jstate,
                                 jcfg_, jcfg.get_preset("tip3p"))
    init = tmp_path / "start.npy"
    np.save(init, banded_frame[1])
    runs = []
    rollout = run_md.rollout
    monkeypatch.setattr(run_md, "rollout",
                        lambda *a: runs.append(rollout(*a)) or runs[-1])
    log = tmp_path / "log.txt"
    run_md.main(["--system", "tip3p", "--ckpt", ckpt, "--banded", "--cpu",
                 "--init_pos", str(init), "--steps", "4", "--report_every",
                 "2", "--log", str(log)])
    assert len(log.read_text().splitlines()) == 3
    (run,) = runs
    assert run["sim"].force_fn.banded_band == 512
    assert run["system"].n_atoms == 774 and run["constraint"] is not None
    res = run["result"]
    assert not res.overflow
    assert bool(torch.isfinite(res.state.force).all())
    assert float(run["constraint"].residual(res.state.pos)) < 1e-5


def test_run_md_tip4p_seeded_weights_on_cpu(tmp_path):
    """run_md --system tip4p --cpu with seeded weights (the fallback
    architecture, 16 wide, 1 layer) from a given start (the water box of
    251 molecules snapped onto the constraints, so no FIRE): the TIP4P-Ew
    preset's 753 atoms, rigid by default, the thermo log and a finite
    frame on the constraints."""
    n_mol, box = 251, tcfg.get_preset("tip4p").box
    init, log, traj = (tmp_path / "init.npy", tmp_path / "log.txt",
                       tmp_path / "traj.npy")
    np.save(init, RigidWater(n_mol, box).project_initial(
        torch.as_tensor(tw.water_box(n_mol, box, seed=1))).numpy())
    run_md.main(["--system", "tip4p", "--init_pos", str(init), "--steps",
                 "4", "--report_every", "2", "--log", str(log),
                 "--out_traj", str(traj), "--encoding_size", "16",
                 "--hidden_dim", "16", "--edge_embedding_dim", "16",
                 "--conv_layer", "1", "--megakernel", "--cpu"])
    assert len(log.read_text().splitlines()) == 3
    final = torch.as_tensor(np.load(traj))
    assert final.shape == (3 * n_mol, 3) and bool(torch.isfinite(final).all())
    assert float(RigidWater(n_mol, box).residual(final)) < 1e-5
