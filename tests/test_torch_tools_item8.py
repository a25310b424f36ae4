"""The five tools of Queue 1 item 8 on the CPU, at small sizes, with the
plain versions: tools/profile_md.py, trace_force.py, distill_rollout.py
(its labels against the LJ oracle on the written positions),
analyze_pair_bias.py on distill_rollout's frames (and against
scripts/analyze_pair_bias.py on the same checkpoint and frames), and
nve_drift_probe.py. Their kernel paths run on the card (chip_smoke.py
phases 59-62 and tests/test_torch_cuda.py)."""

import glob
import importlib.util
import json
import os
import re
import shutil
import sys

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import numpy as np
import pytest
import torch

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.core import units
from gamd_tpu_torch.models.normalizer import RunningStat
from gamd_tpu_torch.physics import lennard_jones as tlj
from gamd_tpu_torch.tools import (analyze_pair_bias, distill_rollout,
                                  nve_drift_probe, profile_md, trace_force)
from gamd_tpu_torch.train.checkpoint import save_checkpoint
from gamd_tpu_torch.train.state import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"^(.{42}) +([\d.]+) us/step   \(([\d,]+) steps/s\)$")
PAIR_BIAS_KEYS = {"frames", "r_bins_a", "pair_force_bias_ev_a",
                  "pair_count", "gt_pair_projection_ev_a",
                  "analytic_lj_pair_force_ev_a",
                  "effective_pair_potential_bias_ev", "du_at_min_ev",
                  "bias_rms_ev_a", "estimator_calibration_rms_ev_a"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread, for the module's fixtures too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_profile_md_prints_its_six_bodies(capsys):
    """profile_md --cpu at 2 steps a body: the header, then one line a
    body in the JAX script's format, all six bodies, finite times."""
    out = profile_md.main(["--cpu", "--steps", "2", "--reps", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "LJ-258, K=64, dtype=float32, cpu"
    labels = [LINE.match(line).group(1).strip() for line in lines[1:]]
    assert labels == ["trivial (x*c)", "BAOAB only (const force)",
                      "mask refresh", "edge features", "full GNN force",
                      "full MD step (incl rebuilds)"]
    assert len(out) == 6 and all(np.isfinite(v) and v > 0
                                 for v in out.values())


def test_trace_force_prints_its_table(tmp_path, capsys):
    """trace_force --cpu float32 at 2 calls: the Chrome trace written, the
    total and the top ops a step in the JAX script's format (host time on
    the CPU); bfloat16 with pallas meets the model's refusal."""
    got = trace_force.main(["float32", "--cpu", "--calls", "2", "--logdir",
                            str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "use_pallas: False"
    assert re.match(r"total host time: [\d.]+ ms over 2 steps -> [\d.]+ "
                    r"us/step$", out[2])
    rows = [re.match(r"^ *[\d.]+ us/step  x *\d+  \S", line)
            for line in out[3:]]
    assert rows and all(rows) and len(rows) <= trace_force.TOP
    assert got["where"] == "host" and got["us_per_step"] > 0
    assert os.path.getsize(tmp_path / "trace.json") > 0
    with pytest.raises(NotImplementedError, match="use_pallas"):
        trace_force.main(["bfloat16", "pallas", "--cpu", "--calls", "1",
                          "--logdir", str(tmp_path)])


@pytest.fixture(scope="module")
def distilled(tmp_path_factory):
    """distill_rollout --cpu on a seeded LJ-258 checkpoint (widths 16, one
    conv layer): 1 seed at seed_start 0, 10 frames every 4 NHC steps after
    4 thermalisation steps, 20 FIRE steps."""
    root = tmp_path_factory.mktemp("distill")
    system = tcfg.get_preset("lj")
    cfg = tcfg.ModelConfig(encoding_size=16, hidden_dim=16,
                           edge_embedding_dim=16, conv_layers=1,
                           use_layer_norm=True)
    state = create_train_state(cfg, system, tcfg.TrainConfig(), 1,
                               device="cpu")
    ckpt = str(root / "tiny.msgpack")
    save_checkpoint(ckpt, state, model_cfg=cfg, system=system)
    out = str(root / "lj_data")
    seeds = distill_rollout.main([
        "--cpu", "--ckpt", ckpt, "--out", out, "--seeds", "1",
        "--seed_start", "0", "--frames", "10", "--interval", "4",
        "--thermalize", "4", "--minimize_steps", "20",
        "--dispatch_frames", "5"])
    return seeds, ckpt, out


def test_distill_rollout_labels_are_the_oracle(distilled):
    """The frames data_0_{t}.npz (pos, vel, forces float32 [258, 3]),
    finite, distinct along the trajectory, each frame's forces the LJ
    oracle's (lj_forces_dense at lj_fluid_box's edge, kJ/mol/nm) of its
    written positions within 1e-6 of their max."""
    seeds, _, out = distilled
    assert seeds == [0]
    files = sorted(glob.glob(os.path.join(out, "data_0_*.npz")))
    assert len(files) == 10
    params = tlj.LJParams()
    box, _ = tlj.lj_fluid_box(258, 0.5, params)
    frames = [np.load(f) for f in files]
    for f in frames:
        assert set(f.files) == {"pos", "vel", "forces"}
        assert all(f[k].shape == (258, 3) and f[k].dtype == np.float32
                   and np.isfinite(f[k]).all() for k in f.files)
        want = tlj.lj_forces_dense(torch.as_tensor(f["pos"]), box,
                                   params).numpy() \
            / units.KJ_MOL_NM_TO_INTERNAL
        assert np.abs(f["forces"] - want).max() <= 1e-6 * np.abs(want).max()
    assert np.abs(frames[0]["pos"] - frames[-1]["pos"]).max() > 1e-3


def test_analyze_pair_bias_on_distilled_frames(distilled, tmp_path):
    """analyze_pair_bias --cpu on the distilled set's test split (one
    frame): the JAX script's JSON keys, bins and counts, finite values;
    the JSON file equals the returned dict."""
    _, ckpt, out = distilled
    path = str(tmp_path / "bias.json")
    got = analyze_pair_bias.main([
        "--cpu", "--ckpt", ckpt, "--data_dir", out, "--sample_num", "10",
        "--seed_num", "1", "--n_bins", "8", "--json_out", path])
    with open(path) as f:
        assert json.load(f) == got
    assert set(got) == PAIR_BIAS_KEYS
    assert got["frames"] == 1
    assert len(got["r_bins_a"]) == len(got["pair_count"]) == 8
    assert sum(got["pair_count"]) > 0
    assert all(np.isfinite(got[k]).all() for k in PAIR_BIAS_KEYS
               if k != "frames")


def _scaled_checkpoint(path, forces):
    """distilled's tiny LJ-258 model, its force scaler set to the moments
    of `forces` (count, mean, M2 over every component), written to path."""
    system = tcfg.get_preset("lj")
    cfg = tcfg.ModelConfig(encoding_size=16, hidden_dim=16,
                           edge_embedding_dim=16, conv_layers=1,
                           use_layer_norm=True)
    state = create_train_state(cfg, system, tcfg.TrainConfig(), 1,
                               device="cpu")
    f = np.concatenate([np.ravel(x) for x in forces]).astype(np.float64)
    stat = RunningStat(*(torch.tensor(x) for x in (
        float(f.size), f.mean(), float(((f - f.mean()) ** 2).sum()))))
    save_checkpoint(path, state._replace(force_stat=stat), model_cfg=cfg,
                    system=system)
    return path


def _jax_analyze_pair_bias(argv, monkeypatch):
    """scripts/analyze_pair_bias.py's main() on argv (loaded by file path),
    its JSON output; JAX's matmul precision, which the script pins,
    restored. The checkpoint's template state (create_train_state, whose
    values the checkpoint's replace) is built in one jitted program: op by
    op, flax's init takes about 8 s on the CPU."""
    import jax
    from gamd_tpu.train import state as jstate
    template = jstate.create_train_state
    monkeypatch.setattr(jstate, "create_train_state", lambda *a, **k:
                        jax.jit(lambda: template(*a, **k))())
    spec = importlib.util.spec_from_file_location(
        "jax_analyze_pair_bias",
        os.path.join(REPO, "scripts", "analyze_pair_bias.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    path = argv[argv.index("--json_out") + 1]
    monkeypatch.setattr(sys, "argv", ["analyze_pair_bias.py", *argv])
    precision = jax.config.jax_default_matmul_precision
    try:
        script.main()
    finally:
        jax.config.update("jax_default_matmul_precision", precision)
    with open(path) as f:
        return json.load(f)


def test_analyze_pair_bias_matches_the_jax_script(distilled, tmp_path,
                                                  monkeypatch, capsys):
    """The port's analyze_pair_bias --cpu and scripts/analyze_pair_bias.py
    --cpu on the same checkpoint and frames: the canonical 10 x 1,000
    layout's first three test frames (distill_rollout's frames 0-2 written
    under their names; only those files are read), 8 bins. Equal keys,
    frames and pair counts; every array and number within 1e-6 of its
    largest magnitude (the model's prediction and its denormalisation,
    the eV/A units, the analytic LJ force, the projection and du). The
    checkpoint's force scaler holds the labels' moments, so the
    predictions are of the labels' size and weigh in the error."""
    from gamd_tpu.train.data import reference_split
    _, _, out = distilled
    canon = tmp_path / "canon"
    canon.mkdir()
    _, test_idx = reference_split(10 * 1000)
    for t, flat in enumerate(test_idx[:3]):
        shutil.copy(os.path.join(out, f"data_0_{t}.npz"),
                    canon / f"data_{flat // 1000}_{flat % 1000}.npz")
    ckpt = _scaled_checkpoint(str(tmp_path / "scaled.msgpack"), [
        np.load(os.path.join(out, f"data_0_{t}.npz"))["forces"]
        for t in range(3)])
    argv = ["--cpu", "--ckpt", ckpt, "--data_dir", str(canon),
            "--max_frames", "3", "--n_bins", "8", "--json_out"]
    got = analyze_pair_bias.main(argv + [str(tmp_path / "port.json")])
    want = _jax_analyze_pair_bias(argv + [str(tmp_path / "jax.json")],
                                  monkeypatch)
    capsys.readouterr()
    assert got.keys() == want.keys() == PAIR_BIAS_KEYS
    assert got["frames"] == want["frames"] == 3
    assert got["pair_count"] == want["pair_count"]
    assert sum(got["pair_count"]) > 0
    for key in sorted(PAIR_BIAS_KEYS - {"frames", "pair_count"}):
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.shape == b.shape, key
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), (key, a, b)


def test_nve_drift_probe_runs_its_legs(capsys):
    """nve_drift_probe --cpu at 8 molecules: a leg each for shake and
    settle (drift, residual under 1e-5 A, wall time) and the force
    probe's line."""
    legs = nve_drift_probe.main(["--cpu", "--sizes", "8", "--steps", "10",
                                 "--thermalize", "5", "--minimize_steps",
                                 "10", "--force_probe"])
    out = capsys.readouterr().out
    assert [leg["method"] for leg in legs] == ["shake", "settle"]
    assert all(leg["residual_a"] < 1e-5 and np.isfinite(leg["de_kj_mol"])
               for leg in legs)
    assert len(re.findall(r"^n_mol=   8 method=(shake|settle) +dE=", out,
                          flags=re.M)) == 2
    assert re.search(r"^n_mol=   8 force rms=[\d.]+ mean_abs=[\d.]+ "
                     r"kJ/mol/A$", out, flags=re.M)
