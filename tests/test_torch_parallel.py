"""Data-parallel training on the CPU (Queue 1 item 7a: parallel/mesh.py,
update_stat over ranks, BatchNorm under a group, make_train_step and
train() with a mesh, train_gamd --num_device): two gloo ranks, spawned
once for the module (tests/torch_dp_worker.py computes each rank's side),
against the port in one process on the whole batch and against JAX's
update_stat(axis_name="dp") under vmap and JAX's train step on a
make_mesh(2) / dp_sharding batch (the conftest's virtual CPU devices).
Widths 16, two conv layers, 24 LJ atoms, batches of four frames (two a
rank), torch on one thread."""

import contextlib
import os
import re
import sys

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from gamd_tpu.core import config as jcfg
from gamd_tpu.models.normalizer import RunningStat as JStat
from gamd_tpu.models.normalizer import init_stat as jinit_stat
from gamd_tpu.models.normalizer import update_stat as jupdate_stat
from gamd_tpu.parallel.mesh import dp_sharding as jdp_sharding
from gamd_tpu.parallel.mesh import make_mesh as jmake_mesh
from gamd_tpu.train.loop import make_train_step as jmake_train_step
from gamd_tpu.train.state import build_model as jbuild
from gamd_tpu.train.state import TrainState as JTrainState
from gamd_tpu.train.state import make_optimizer as jmake_optimizer

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.parallel import mesh as tmesh
from gamd_tpu_torch.tools import train_gamd
from gamd_tpu_torch.train import checkpoint as tckpt
from gamd_tpu_torch.train import loop as tloop
from gamd_tpu_torch.train.state import init_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dp_worker as worker  # noqa: E402

LR = tcfg.TrainConfig().lr
PARAM_ATOL, PARAM_SHARE = 1e-5, 0.999   # test_torch_train.py's bars


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread, for the module's fixtures too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_kw(norm):
    return dict(use_layer_norm=norm == "layer", drop_edge=False,
                dropout=0.0, **worker.JAX_TINY)


def _start_weights(norm):
    """The port's seeded weights (init_params, flax's tree) at the
    worker's JAX widths: the start of both packages' mesh steps."""
    system_t, _ = worker.lj_set()
    weights = init_params(tcfg.ModelConfig(**_jax_kw(norm)), system_t,
                          seed=4)
    if norm == "batch":
        # Off the symmetric point (test_torch_train.py::
        # _off_symmetric_point): at scale 1 and bias 0 layer 0's BatchNorm
        # zeroes the identical LJ rows and the edge pipeline's gradients
        # are rounding noise.
        rng = np.random.RandomState(2)
        for name, norm_p in weights.params["graph_conv"].items():
            if name.startswith("norm_"):
                d = norm_p["bias"].shape
                norm_p["scale"] = (1.0 + 0.1 * rng.randn(*d)).astype(
                    np.float32)
                norm_p["bias"] = (0.5 * rng.randn(*d)).astype(np.float32)
    return weights


def _jax_state(norm, weights):
    """(system, model, train_cfg, state) of JAX's tiny LJ model at the
    worker's widths, no dropout and no augmentation (JAX's draws are its
    own). The state holds `weights` (_start_weights), with JAX's Adam
    state and empty scalers: JAX's own initialisation runs the model op
    by op and takes longer than the step's compile."""
    system_t, _ = worker.lj_set()
    system = jcfg.SystemConfig(**{f: getattr(system_t, f) for f in (
        "name", "n_atoms", "box", "cutoff", "nbr_capacity", "skin",
        "species", "masses", "temperature")})
    cfg = jcfg.ModelConfig(**_jax_kw(norm))
    train_cfg = jcfg.TrainConfig(batch_size=worker.BATCH, rotate_aug=False,
                                 jitter_sigma=0.0)
    params = jax.tree.map(jnp.asarray, weights.params)
    state = JTrainState(
        params=params,
        batch_stats=jax.tree.map(jnp.asarray, weights.batch_stats),
        opt_state=jmake_optimizer(train_cfg, 1).init(params),
        force_stat=jinit_stat(), length_stat=jinit_stat(),
        rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))
    return system, jbuild(cfg, system), train_cfg, state


def _jax_mesh_step(norm, weights):
    """JAX's train step from `weights` on the first batch sharded over
    make_mesh(2) with dp_sharding (BatchNorm in float64, as the port's
    BatchNorm steps: see test_torch_train.py::_precision); its metrics
    and the parameters after it."""
    context = jax.enable_x64(True) if norm == "batch" else \
        contextlib.nullcontext()
    dtype = jnp.float64 if norm == "batch" else jnp.float32
    _, frames = worker.lj_set()
    with context:
        system, model, train_cfg, state = _jax_state(norm, weights)
        tx = jmake_optimizer(train_cfg, 1)
        step = jmake_train_step(model, system, train_cfg, tx)
        shard = jdp_sharding(jmake_mesh(2))
        batch = {k: jax.device_put(jnp.asarray(np.stack(
            [f[k] for f in frames[:worker.BATCH]]), dtype), shard)
            for k in ("pos", "forces")}
        new, metrics = step(state, batch)
        return ({k: float(v) for k, v in metrics.items()},
                jax.tree.map(np.asarray, new.params))


CASES = {
    "stat": {"what": "stat"},
    "batchnorm": {"what": "batchnorm"},
    "aug_layer": {"what": "steps", "kind": "aug", "norm": "layer",
                  "steps": 3},
    "aug_batch": {"what": "steps", "kind": "aug", "norm": "batch",
                  "steps": 3},
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(cases, {rank: {case: result}}, JAX's mesh steps, tmp): every case
    of two gloo ranks, spawned once; JAX's two mesh steps run here while
    the ranks work. The JAX cases start from the JAX steps' weights; the
    train case writes checkpoints under its directory."""
    tmp = tmp_path_factory.mktemp("dp")
    cases = dict(CASES)
    weights = {norm: _start_weights(norm) for norm in ("layer", "batch")}
    for norm, w in weights.items():
        cases[f"jax_{norm}"] = {"what": "steps", "kind": "jax",
                                "norm": norm, "steps": 1,
                                "params": w.params,
                                "batch_stats": w.batch_stats}
    cases["train"] = {"what": "train", "kind": "aug", "norm": "layer",
                      "ckpt_dir": str(tmp / "ck2")}
    spawned = mp.spawn(worker.run_rank, nprocs=2, join=False,
                       args=(2, f"file://{tmp / 'pg'}", str(tmp), cases))
    jax_runs = {norm: _jax_mesh_step(norm, w) for norm, w in weights.items()}
    while not spawned.join():
        pass
    results = {r: torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
               for r in range(2)}
    return cases, results, jax_runs, tmp


def _flat(tree):
    if isinstance(tree, dict):
        return np.concatenate([_flat(tree[k]) for k in sorted(tree)]) \
            if tree else np.zeros(0)
    return np.asarray(tree, np.float64).ravel()


def test_update_stat_over_ranks(ranks):
    """update_stat(group=...) on two ranks (plain; masked, the ranks'
    counts differing; and from an empty stat): both ranks hold the same
    moments, JAX's update_stat(axis_name="dp") under jax.vmap over the
    two shares within 1e-6 (of each moment's scale: the mean on the std's)
    and the one-process update on the whole batch within 1e-5."""
    _, results, _, _ = ranks
    start, values, mask = worker.stat_inputs()
    one = worker.one_process({"what": "stat"})
    jstat = JStat(*(jnp.float32(x) for x in start))
    jempty = JStat(jnp.float32(0), jnp.float32(0), jnp.float32(0))
    shares = lambda a: jnp.asarray(a.reshape(2, 2, *a.shape[1:]))
    vm = lambda fn: jax.vmap(fn, axis_name="dp")(shares(values),
                                                 shares(mask))
    want = {
        "plain": vm(lambda v, m: jupdate_stat(jstat, v, axis_name="dp")),
        "masked": vm(lambda v, m: jupdate_stat(jstat, v, m,
                                               axis_name="dp")),
        "empty": vm(lambda v, m: jupdate_stat(jempty, v, m,
                                              axis_name="dp"))}
    assert results[0]["stat"] == results[1]["stat"]
    for name, got in results[0]["stat"].items():
        count, mean, m2 = got
        scale = [abs(count), np.sqrt(m2 / count), abs(m2)]
        jax_row = [float(x[0]) for x in want[name]]
        assert all(float(x[0]) == float(x[1]) for x in want[name])
        for a, b, c, s in zip(got, jax_row, one[name], scale):
            assert abs(a - b) <= 1e-6 * s, (name, got, jax_row)
            assert abs(a - c) <= 1e-5 * s, (name, got, one[name])
    assert results[0]["stat"]["masked"][0] == float(mask.sum()) + start[0]


def test_batchnorm_over_ranks_matches_one_process(ranks):
    """BatchNorm in train mode under a two-rank group (float64): each
    rank's output rows, the running stats after two calls, and the
    gradients of the global sum(out * cot) with respect to x, scale and
    bias equal the one-process BatchNorm on the whole batch within 1e-10
    of each tensor's max."""
    _, results, _, _ = ranks
    one = worker.one_process({"what": "batchnorm"})
    for rank in range(2):
        got = results[rank]["batchnorm"]
        rows = slice(2 * rank, 2 * rank + 2)
        for key in ("out", "x_grad"):
            want = one[key][rows]
            assert torch.allclose(got[key], want, rtol=0,
                                  atol=1e-10 * float(want.abs().max())), key
        for key in ("scale_grad", "bias_grad", "mean", "var"):
            want = one[key]
            assert torch.allclose(got[key], want, rtol=0,
                                  atol=1e-10 * float(want.abs().max())), key
        assert got["loss"] == pytest.approx(one["loss"], rel=1e-12)
    assert torch.equal(results[0]["batchnorm"]["scale_grad"],
                       results[1]["batchnorm"]["scale_grad"])


@pytest.mark.parametrize("norm", ["layer", "batch"])
def test_two_rank_steps_match_one_process(ranks, norm):
    """Three train steps on two ranks (LayerNorm fp32; BatchNorm float64)
    with rotation, jitter, edge dropout, drop_edge and the LJ relabel on,
    the draws made at the global batch's shape: each step's loss,
    data_loss, net_force and force_std within 1e-5 (relative) of the
    one-process steps on the whole batch, the parameters after within
    1e-5 of them, BatchNorm's running stats within 1e-5 of their max, the
    scalers within 1e-5 of their scale, and the two ranks' parameters
    equal bit for bit."""
    _, results, _, _ = ranks
    name = f"aug_{norm}"
    case = CASES[name]
    one = worker.one_process(case)
    got = results[0][name]
    for s, (a, b) in enumerate(zip(got["metrics"], one["metrics"])):
        for key in ("loss", "data_loss", "net_force", "force_std"):
            assert a[key] == pytest.approx(b[key], rel=1e-5), (s, key)
        assert a["nbr_overflow"] == b["nbr_overflow"] == 0.0
    diff = np.abs(_flat(got["params"]) - _flat(one["params"]))
    assert diff.max() <= PARAM_ATOL, diff.max()
    assert np.array_equal(_flat(got["params"]),
                          _flat(results[1][name]["params"]))
    if norm == "batch":
        a, b = _flat(got["batch_stats"]), _flat(one["batch_stats"])
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    count, mean, m2 = one["stats"][:3]
    for a, b, s in zip(got["stats"], one["stats"],
                       [count, np.sqrt(m2 / count), m2] * 2):
        assert abs(a - b) <= 1e-5 * abs(s), (got["stats"], one["stats"])


@pytest.mark.parametrize("norm", ["layer", "batch"])
def test_two_rank_step_matches_jax_mesh_step(ranks, norm):
    """The port's step on two ranks (from JAX's initial weights; no
    augmentation or dropout, whose draws differ between the packages)
    against JAX's step on the same batch sharded over make_mesh(2): loss,
    data_loss and net_force within JAX's rel 1e-4
    (tests/test_train.py:377-382), the parameters after it at least 99.9%
    within 1e-5 and all within 2 lr (test_torch_train.py's bars, Adam's
    first step moving an element whose gradient sign differs by rounding
    by about lr); LayerNorm in fp32, BatchNorm in float64 and off the
    symmetric point (layer 0's scale, whose exact gradient is 0, apart)."""
    _, results, jax_runs, _ = ranks
    metrics, after = jax_runs[norm]
    got = results[0][f"jax_{norm}"]
    for key in ("loss", "data_loss", "net_force"):
        assert got["metrics"][0][key] == pytest.approx(metrics[key],
                                                       rel=1e-4), key
    got_p, want_p = got["params"], jax.tree.map(np.asarray, after)
    if norm == "batch":
        # Layer 0's BatchNorm normalises the one LJ embedding that every
        # atom carries: x - mean is rounding noise, so its scale's exact
        # gradient is 0 and Adam's first step turns each side's noise into
        # +-lr. Compared apart: within 2 lr.
        pop = lambda tree: {**tree, "graph_conv": {
            **tree["graph_conv"], "norm_0": {
                "bias": tree["graph_conv"]["norm_0"]["bias"]}}}
        scale = lambda tree: tree["graph_conv"]["norm_0"]["scale"]
        assert np.abs(scale(got_p) - scale(want_p)).max() <= 2 * LR
        got_p, want_p = pop(got_p), pop(want_p)
    diffs = np.abs(_flat(got_p) - _flat(want_p))
    assert np.mean(diffs <= PARAM_ATOL) >= PARAM_SHARE
    assert diffs.max() <= 2 * LR


def test_train_with_mesh_matches_one_process(ranks, tmp_path):
    """Two epochs of train(mesh=...) on two ranks (LayerNorm, augmentation
    and relabelling on, 8 training and 4 validation frames, a checkpoint
    every epoch): every epoch's logged metrics, validation included,
    within 1e-5 of the one-process train() (relative, val_outlier
    absolute), the final parameters within 1e-5; rank 0 alone logs and
    writes the checkpoint files, the same files as the one-process run."""
    cases, results, _, tmp = ranks
    one_dir = tmp_path / "ck1"
    one = worker.one_process({**cases["train"], "ckpt_dir": str(one_dir)})
    got = results[0]["train"]
    assert len(got["history"]) == len(one["history"]) == 2
    for a, b in zip(got["history"], one["history"]):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key] == pytest.approx(
                b[key], rel=1e-5, abs=1e-6 if key == "val_outlier" else 0)
    diff = np.abs(_flat(got["params"]) - _flat(one["params"]))
    assert diff.max() <= PARAM_ATOL
    assert len(got["logs"]) == len(one["logs"]) > 0
    assert results[1]["train"]["logs"] == []
    assert sorted(os.listdir(cases["train"]["ckpt_dir"])) == sorted(
        os.listdir(one_dir))


def test_mesh_helpers_refuse_unequal_shares():
    """A batch the ranks do not split equally raises ValueError before any
    work in train(); make_mesh outside a process group raises."""
    system, frames = worker.lj_set()
    mesh = tmesh.Mesh(group=None, rank=0, world_size=3,
                      device=torch.device("cpu"))
    with pytest.raises(ValueError, match="3 equal shares"):
        tloop.train(system, tcfg.ModelConfig(**worker.TINY),
                    tcfg.TrainConfig(batch_size=4),
                    worker.ListDataset(frames), mesh=mesh, device="cpu")
    with pytest.raises(RuntimeError, match="init_rank"):
        tmesh.make_mesh()


def _write_lj_set(root, n_frames):
    """data_0_{t}.npz frames of the LJ-258 lattice displaced by 0.1 A,
    labelled by the port's LJ forces (kJ/mol/nm), under root/lj_data."""
    from gamd_tpu_torch.core import units
    from gamd_tpu_torch.physics import lennard_jones as tlj
    system = tcfg.get_preset("lj")
    out = os.path.join(root, "lj_data")
    os.makedirs(out)
    rng = np.random.RandomState(0)
    _, base = tlj.lj_fluid_box(system.n_atoms, 0.5)
    for t in range(n_frames):
        pos = np.mod(base + 0.1 * rng.randn(*base.shape),
                     system.box).astype(np.float32)
        f = tlj.lj_forces_dense(torch.as_tensor(pos), system.box).numpy()
        np.savez(os.path.join(out, f"data_0_{t}.npz"), pos=pos,
                 vel=np.zeros_like(pos),
                 forces=(f / units.KJ_MOL_NM_TO_INTERNAL).astype(
                     np.float32))


def test_train_gamd_num_device_two_on_cpu(tmp_path, capfd):
    """train_gamd --cpu --num_device 2 (two gloo CPU ranks; LJ-258 set of
    12 frames, batch 2, widths 16, one conv layer, rotation and jitter on,
    one epoch) writes the one-process run's files, its checkpoint's
    parameters within 1e-5 of the one-process CLI's, and rank 0 alone
    prints the epochs; --num_device 3 with batch 2 trains in one process
    and says so, and --num_device 2 without --cpu on a machine with fewer
    cards raises before any work, naming the count."""
    _write_lj_set(str(tmp_path), 12)
    flags = ["--system", "lj", "--data_dir", str(tmp_path), "--sample_num",
             "12", "--seed_num", "1", "--max_epoch", "1", "--batch_size",
             "2", "--encoding_size", "16", "--hidden_dim", "16",
             "--edge_embedding_dim", "16", "--conv_layer", "1",
             "--use_layer_norm", "--checkpoint_every", "1", "--cpu"]
    logs = []
    assert train_gamd.main(flags + ["--num_device", "2", "--cp_dir",
                                    str(tmp_path / "dp")],
                           log_fn=logs.append) is None
    assert "Data-parallel over 2 ranks (gloo)" in logs
    out = capfd.readouterr().out
    epochs = re.findall(r"^epoch (\d+): data_loss", out, flags=re.M)
    assert epochs == ["0"], out
    one = train_gamd.main(flags + ["--cp_dir", str(tmp_path / "one")],
                          log_fn=lambda line: None)
    assert one.step == 5
    assert sorted(os.listdir(tmp_path / "dp")) == sorted(
        os.listdir(tmp_path / "one"))
    name = "checkpoint_0.msgpack"
    a, _, _ = tckpt.load_self_describing(str(tmp_path / "dp" / name))
    b, _, _ = tckpt.load_self_describing(str(tmp_path / "one" / name))
    assert np.abs(_flat(a.params) - _flat(b.params)).max() <= PARAM_ATOL

    args = train_gamd.build_parser().parse_args(
        flags[:-1] + ["--cpu", "--num_device", "3"])
    said = []
    assert train_gamd.n_ranks(args, said.append) == 1
    assert said == ["--num_device 3 does not divide --batch_size 2: "
                    "training in one process"]
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="--num_device 2 asks for 2 "
                                               "cards"):
            train_gamd.main(["--num_device", "2", "--data_dir",
                             str(tmp_path / "none")])
