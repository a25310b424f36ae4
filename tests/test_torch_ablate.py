"""The port's benchmark switches and activation pairs on the CPU: the plain
window under each of `ablate`'s stage names (ops/mega.py::ABLATE_STAGES)
against JAX's interpret-mode mega_md_steps(ablate=...) where JAX's form does
not depend on its TPU tiling, the three forms the port defines for itself
against independent transcriptions of their definitions, the plain forward
under each silu/gelu pair against JAX's reference_forward, and
tools/bench_ablate.py's lines. The CUDA forms are held to these plain
versions in tests/test_torch_cuda.py and chip_smoke.py, on the card."""

import json
import math
import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import config as jcfg
from gamd_tpu.neighbors.dense import dense_neighbor_list
from gamd_tpu.ops import pallas_model as jmega
from gamd_tpu.train.state import build_model, create_train_state

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.ops import mega as tmega
from gamd_tpu_torch.tools import bench_ablate
from gamd_tpu_torch.train.state import params_from_jax

BOX = 12.0
N, K, CUTOFF, SKIN = 64, 16, 4.2, 0.8
LENGTH_MEAN, LENGTH_STD = 4.0, 1.5
SMALL = dict(encoding_size=32, hidden_dim=32, edge_embedding_dim=32,
             conv_layers=2)
MASS = 39.948
#: The window's bars (tests/test_torch_megastep.py's
#: test_window_without_noise_matches_jax_kernel): x and v, and forces
#: against std(F) of JAX's.
WINDOW_ATOL, FORCE_RTOL = 2e-4, 1e-3
#: The plain forward against JAX's reference_forward, / std(F) (fp32).
ACT_RTOL = 5e-3
JAX_HELD = tuple(s for s in tmega.ABLATE_STAGES
                 if s not in tmega.PORT_DEFINED)


def _t(a):
    return torch.as_tensor(np.array(a))


def _case(widths):
    """Small packed weights (JAX and port) of seeded parameters, a frame
    with its list, h0, velocities and start forces, all from one seed."""
    system = jcfg.get_preset("lj", n_atoms=N, box=BOX, cutoff=CUTOFF,
                             nbr_capacity=K, skin=SKIN)
    cfg = jcfg.ModelConfig(**widths)
    params = create_train_state(build_model(cfg, system), system,
                                jcfg.TrainConfig(), 1).params
    rng = np.random.RandomState(5)
    pos = rng.uniform(0, BOX, (N, 3)).astype(np.float32)
    vel = (0.1 * rng.randn(N, 3)).astype(np.float32)
    idx, mask, _ = dense_neighbor_list(jnp.asarray(pos), BOX, CUTOFF + SKIN,
                                       K)
    h0 = np.broadcast_to(np.asarray(params["node_emb"]),
                         (N, cfg.encoding_size)).astype(np.float32)
    tmp = tmega.pack_params(params_from_jax(params),
                            tcfg.ModelConfig(**widths))
    f0 = tmega.reference_forward(_t(pos), _t(idx), _t(mask), _t(h0), tmp,
                                 BOX, CUTOFF, LENGTH_MEAN, LENGTH_STD)
    return dict(params=params, jmp=jmega.pack_params(params, cfg), tmp=tmp,
                pos=pos, vel=vel, idx=np.asarray(idx),
                mask=np.asarray(mask), h0=h0, f0=f0.numpy())


@pytest.fixture(scope="module")
def case():
    return _case(SMALL)


@pytest.fixture(scope="module")
def wide_nodes():
    """The case with 128 node features: JAX's `decoder` form writes h's
    rows into its 128-lane force buffer, so it runs at D = 128 only."""
    return _case({**SMALL, "encoding_size": 128})


def _port_window(c, ablate, c2col, steps=2):
    masses = torch.full((N,), MASS)
    return tmega.mega_md_steps(
        _t(c["pos"]), _t(c["vel"]), _t(c["f0"]), _t(c["idx"]),
        _t(c["mask"]), _t(c["h0"]), c["tmp"], BOX, CUTOFF, LENGTH_MEAN,
        LENGTH_STD, masses, n_steps=steps, c1=0.95, hdt=0.01,
        c2col=torch.as_tensor(c2col),
        seed=torch.tensor([3], dtype=torch.int32), ablate=ablate)


@pytest.mark.parametrize("name", JAX_HELD)
def test_ablated_window_matches_jax(request, name):
    """Two steps of the plain window under one JAX-held stage switch
    against JAX's interpret-mode kernel (f32 edge products and the hi/lo
    edge stream, so that e is stored to fp32 as the port's; tile_n 8) with
    the same switch: x and v within 2e-4, forces within 1e-3 std(F).
    c2col is 0, but for `noise`, whose zero draws make both sides
    deterministic at a real amplitude."""
    c = request.getfixturevalue("wide_nodes" if name == "decoder"
                                else "case")
    c2col = np.full((N,), 0.3 if name == "noise" else 0.0, np.float32)
    j = jmega.mega_md_steps(
        jnp.asarray(c["pos"]), jnp.asarray(c["vel"]), jnp.asarray(c["f0"]),
        jnp.asarray(c["idx"]), jnp.asarray(c["mask"]), jnp.asarray(c["h0"]),
        c["jmp"], BOX, CUTOFF, LENGTH_MEAN, LENGTH_STD,
        jnp.full((N,), MASS, jnp.float32), n_steps=2, c1=0.95, hdt=0.01,
        c2col=jnp.asarray(c2col), seed=3, tile_n=8, interpret=True,
        f32_edges=True, edge_hilo=True, ablate=(name,))
    t = _port_window(c, (name,), c2col)
    for got, ref in zip(t[:2], j[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=WINDOW_ATOL)
    f_ref = np.asarray(j[2])
    err = float(np.abs(t[2].numpy() - f_ref).max())
    assert err < FORCE_RTOL * float(f_ref.std()), (name, err)
    full = _port_window(c, (), c2col)
    assert not torch.equal(t[2], full[2])


def _conv_definition(mp, layer, h, hn, e, idx, mask, form):
    """One conv layer in float64 numpy, atom by atom and slot by slot, with
    the port's definition of `form`: repeat (every edge adds atom 0's dst)
    or agg (each atom takes its first live slot's message, in slot
    order)."""
    g = lambda t: t.double().numpy()
    silu = lambda x: x / (1.0 + np.exp(-x))
    w = {k: g(getattr(mp, k)[layer]) for k in (
        "w_src", "b_src", "w_dst", "b_dst", "w_e1", "b_e1", "w_e2", "b_e2",
        "w_t1", "b_t1", "w_t2", "b_t2", "w_pd", "b_pd", "w_pe", "b_pe",
        "w_p", "b_p")}
    h, hn, e = g(h), g(hn), g(e)
    src = hn @ w["w_src"] + w["b_src"][0]
    dst = hn @ w["w_dst"] + w["b_dst"][0]
    out = np.zeros_like(h)
    for i in range(h.shape[0]):
        agg = np.zeros(h.shape[1])
        for k in range(idx.shape[1]):
            if not mask[i, k]:
                continue
            j = int(idx[i, k])
            z = silu(e[i, k] @ w["w_e1"] + w["b_e1"][0]) @ w["w_e2"] \
                + w["b_e2"][0] + src[j] + dst[0 if form == "repeat" else i]
            z = silu(silu(z) @ w["w_t1"] + w["b_t1"][0]) @ w["w_t2"] \
                + w["b_t2"][0]
            agg += hn[j] * z
            if form == "agg":
                break
        pre = hn[i] @ w["w_pd"] + w["b_pd"][0] + agg @ w["w_pe"] \
            + w["b_pe"][0]
        out[i] = h[i] + silu(pre) @ w["w_p"] + w["b_p"][0]
    return out


@pytest.mark.parametrize("form", ["repeat", "agg"])
def test_port_defined_conv_forms(case, form):
    """repeat and agg: the plain conv layer under the switch against a
    float64 transcription of the port's definition (1e-5 of max |h|), and
    unlike the unswitched layer."""
    c, mp = case, case["tmp"]
    idx, mask = _t(c["idx"]), _t(c["mask"])
    rng = np.random.RandomState(2)
    h = torch.as_tensor(rng.randn(N, 32).astype(np.float32))
    e = torch.as_tensor(rng.randn(N, K, 32).astype(np.float32))
    hn = tmega.node_norm(mp, 0, h)
    got = tmega.conv_apply(mp, 0, h, hn, hn, e, idx, mask,
                           ablate=frozenset([form]))
    want = _conv_definition(mp, 0, h, hn, e, idx.numpy(), mask.numpy(),
                            form)
    assert np.abs(got.double().numpy() - want).max() \
        < 1e-5 * np.abs(want).max()
    full = tmega.conv_apply(mp, 0, h, hn, hn, e, idx, mask)
    assert float((got - full).abs().max()) > 1e-3


def test_port_defined_gather_pos(case):
    """gather_pos: the plain forward equals the unswitched layers over
    edges encoded from atom 0's position for every neighbour, with the
    live mask of the true list; and it differs from the full forward."""
    c, mp = case, case["tmp"]
    pos, idx, mask, h0 = (_t(c[k]) for k in ("pos", "idx", "mask", "h0"))
    got = tmega.reference_forward(pos, idx, mask, h0, mp, BOX, CUTOFF,
                                  LENGTH_MEAN, LENGTH_STD,
                                  ablate=("gather_pos",))
    p = pos.double().numpy()
    rel_true = p[idx.numpy()] - p[:, None, :]
    rel_true -= BOX * np.floor(rel_true / BOX + 0.5)
    live = mask.numpy() & ((rel_true ** 2).sum(-1) < CUTOFF ** 2)
    rel = np.broadcast_to(p[0] - p[:, None, :], (N, K, 3)).copy()
    rel -= BOX * np.floor(rel / BOX + 0.5)
    dist = np.sqrt((rel ** 2).sum(-1))
    unit = torch.as_tensor(rel / (dist[..., None] + 1e-8), dtype=torch.float32)
    std = torch.as_tensor((dist - LENGTH_MEAN) / LENGTH_STD,
                          dtype=torch.float32)
    e = tmega.encode_edges(mp, unit, std, None)
    h = h0
    for layer in range(SMALL["conv_layers"]):
        hn = tmega.node_norm(mp, layer, h)
        h = tmega.conv_apply(mp, layer, h, hn, hn, e, idx,
                             torch.as_tensor(live))
    want = tmega.decode_nodes(mp, h)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) < 1e-4 * scale
    full = tmega.reference_forward(pos, idx, mask, h0, mp, BOX, CUTOFF,
                                   LENGTH_MEAN, LENGTH_STD)
    assert float((got - full).abs().max()) > 1e-3 * scale


def test_every_stage_changes_the_window(case):
    """Each of the 14 switches changes the plain window (at a real noise
    amplitude, so that `noise` shows too); an unknown name and a name
    given as characters raise ValueError; a name given as a string is the
    stage."""
    c2col = np.full((N,), 0.3, np.float32)
    full = _port_window(case, (), c2col, steps=1)
    for name in tmega.ABLATE_STAGES:
        got = _port_window(case, name, c2col, steps=1)
        assert not torch.equal(got[1], full[1]), name
    with pytest.raises(ValueError, match="unknown ablate stage"):
        _port_window(case, ("noise", "tiles"), c2col, steps=1)
    with pytest.raises(ValueError, match="unknown ablate stage"):
        tmega.ablate_set(list("agg"))


@pytest.mark.parametrize("conv_act", ["silu", "gelu"])
@pytest.mark.parametrize("mlp_act", ["gelu", "silu"])
def test_activation_pairs_match_jax_reference(case, conv_act, mlp_act):
    """The plain forward under each activation pair against JAX's
    reference_forward with that pair (fp32): within 5e-3 std(F); a pair
    unlike silu/gelu gives other forces."""
    c = case
    got = tmega.reference_forward(
        _t(c["pos"]), _t(c["idx"]), _t(c["mask"]), _t(c["h0"]), c["tmp"],
        BOX, CUTOFF, LENGTH_MEAN, LENGTH_STD, conv_act=conv_act,
        mlp_act=mlp_act).numpy()
    ref = np.asarray(jmega.reference_forward(
        jnp.asarray(c["pos"]), jnp.asarray(c["idx"]), jnp.asarray(c["mask"]),
        jnp.asarray(c["h0"]), c["jmp"], BOX, CUTOFF, LENGTH_MEAN,
        LENGTH_STD, conv_act=conv_act, mlp_act=mlp_act))
    assert np.abs(got - ref).max() < ACT_RTOL * ref.std()
    if (conv_act, mlp_act) != ("silu", "gelu"):
        assert np.abs(got - c["f0"]).max() > 1e-3 * ref.std()


def test_bench_ablate_cpu_lines(capsys):
    """tools/bench_ablate.py --cpu at one step: a line for the full run and
    one for a stage with every field (the stage's delta against the full
    run paired with it), the summary, and the device line beside them;
    the floors from the shared counts (tools/bounds.py): the products'
    at their peaks, the gathers' bytes, none for the other stages."""
    bench_ablate.main(["--cpu", "--steps", "1", "--reps", "1",
                       "--only", "full,theta"])
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    assert lines[0].startswith("device cpu")
    stages = [r for r in rows if "stage" in r]
    assert [r["stage"] for r in stages] == ["full", "theta"]
    for r in stages:
        for key in ("us_per_step", "device_us_per_step", "desc",
                    "floor_us", "bound_by"):
            assert key in r, (r, key)
        assert r["device_us_per_step"] is None      # no card on the CPU
    theta = stages[1]   # against a full run made just before it
    assert {"full_us_per_step", "delta_us", "floor_share"} <= set(theta)
    assert theta["delta_us"] == theta["full_us_per_step"] \
        - theta["us_per_step"]
    assert theta["bound_by"] == "operations" and theta["floor_us"] > 0
    summary = rows[-1]
    assert summary["summary"] == "megastep decomposition"
    for key in ("full_us", "sum_of_deltas_us", "deltas_share_of_full",
                "sum_floor_us"):
        assert key in summary
    assert math.isfinite(summary["full_us"])
    floors = bench_ablate.stage_floors(5482, 258, 40,
                                       tcfg.lj_model_config())
    assert set(floors) == {name for name, _, _ in bench_ablate.STAGES}
    assert floors["gather_conv"][1] == "bytes"
    assert floors["noise"] == floors["agg"] == (0.0, None)
