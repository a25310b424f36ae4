"""The rank side of tests/test_torch_parallel.py: what each of two gloo
ranks computes on the CPU, in a module that imports no JAX (spawned ranks
import it by name; pytest collects it not, its name has no test_ prefix).

run_rank(rank, world, init_method, out_dir, cases) joins the group,
computes every case of `cases` on this rank's share and saves {case:
result} to out_dir/rank{rank}.pt; one_process(case) computes the same
case's result in one process, on the whole batch.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from gamd_tpu_torch.core import config as tcfg
from gamd_tpu_torch.models import gnn
from gamd_tpu_torch.models.normalizer import (RunningStat, init_stat,
                                              update_stat)
from gamd_tpu_torch.parallel.mesh import (all_reduce_sum, average_gradients,
                                          dp_sharding, init_rank, make_mesh)
from gamd_tpu_torch.physics import lennard_jones as tlj
from gamd_tpu_torch.train import loop as tloop
from gamd_tpu_torch.train.state import create_train_state, params_from_jax

TINY = dict(encoding_size=16, hidden_dim=16, edge_embedding_dim=16,
            conv_layers=2)
#: The JAX comparisons' widths: one conv layer (JAX's train step compiles
#: in about half the time of two's on the CPU).
JAX_TINY = dict(TINY, conv_layers=1)
BATCH = 4          # global batch; two ranks of two frames
N_ATOMS = 24


class ListDataset:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def lj_set(n_frames=12, seed=0):
    """(system, frames): 24 LJ atoms at reduced density 0.5, the lattice
    displaced by 0.3 A, labels the LJ forces in kJ/mol/nm
    (tests/test_torch_train_loop.py::lj_frames)."""
    params = tlj.LJParams()
    box, pos0 = tlj.lj_fluid_box(N_ATOMS, 0.5, params)
    params = tlj.LJParams(cutoff=min(params.cutoff, box / 2 - 0.01))
    rng = np.random.RandomState(seed)
    frames = []
    for _ in range(n_frames):
        p = (pos0 + rng.randn(*pos0.shape).astype(np.float32) * 0.3) % box
        f = tlj.lj_forces_dense(torch.as_tensor(p, dtype=torch.float32),
                                box, params).numpy()
        frames.append({"pos": p.astype(np.float32),
                       "forces": (f / 0.1).astype(np.float32)})
    system = tcfg.SystemConfig(
        name="tiny-lj", n_atoms=N_ATOMS, box=float(box),
        cutoff=float(params.cutoff), nbr_capacity=N_ATOMS, skin=1.0,
        species="lj", masses=(39.948,), temperature=100.0)
    return system, frames


def relabel_fn(system):
    """The LJ oracle at the system's box and cutoff, in kJ/mol/nm."""
    params = tlj.LJParams(cutoff=system.cutoff)
    return lambda p: tlj.lj_forces_dense(p, system.box, params) * 10.0


# -- the cases ----------------------------------------------------------------

def stat_inputs():
    """(start stat, values [4, 5, 6] float32, mask [4, 5, 6] bool), seeded:
    a share of rank 1's rows masked more than rank 0's, so the ranks'
    counts differ."""
    rng = np.random.default_rng(3)
    values = rng.normal(2.0, 1.5, (BATCH, 5, 6)).astype(np.float32)
    mask = rng.uniform(size=(BATCH, 5, 6)) < np.array(
        [0.9, 0.8, 0.3, 0.5])[:, None, None]
    start = (7.0, 1.25, 3.5)
    return start, values, mask


def stat_case(rows=slice(None), group=None):
    start, values, mask = stat_inputs()
    stat = RunningStat(*(torch.tensor(x) for x in start))
    v, m = torch.as_tensor(values[rows]), torch.as_tensor(mask[rows])
    out = {}
    for name, s in (("plain", update_stat(stat, v, group=group)),
                    ("masked", update_stat(stat, v, mask=m, group=group)),
                    ("empty", update_stat(init_stat("cpu"), v, mask=m,
                                          group=group))):
        out[name] = [float(x) for x in s]
    return out


def batchnorm_inputs():
    rng = np.random.default_rng(5)
    x = rng.normal(0.5, 2.0, (BATCH, 6, 8))
    cot = rng.normal(size=(BATCH, 6, 8))
    scale = rng.normal(1.0, 0.3, 8)
    bias = rng.normal(0.0, 0.3, 8)
    return x, cot, scale, bias


def batchnorm_case(rows=slice(None), group=None):
    """Two train-mode calls of BatchNorm in float64 (the running stats
    move twice) and the gradients of sum(out * cot) (all-reduced over the
    ranks: every rank holds the global loss) with respect to x, scale and
    bias; under a group, x's gradient is divided by the ranks (each rank's
    backward gives the ranks' count times it, see parallel.mesh) and the
    parameters' are averaged."""
    x, cot, scale, bias = (torch.as_tensor(a) for a in batchnorm_inputs())
    bn = gnn.BatchNorm(8).double()
    with torch.no_grad():
        bn.scale.copy_(scale)
        bn.bias.copy_(bias)
    bn(x[rows] * 0.5 + 1.0, train=True, group=group)
    xr = x[rows].clone().requires_grad_(True)
    out = bn(xr, train=True, group=group)
    loss = torch.sum(out * cot[rows])
    world = 1
    if group is not None:
        loss = all_reduce_sum(loss, group)
        world = dist.get_world_size(group)
    loss.backward()
    if group is not None:
        average_gradients(bn.parameters(), group)
    return {"out": out.detach(), "x_grad": xr.grad / world,
            "scale_grad": bn.scale.grad, "bias_grad": bn.bias.grad,
            "mean": bn.mean.clone(), "var": bn.var.clone(),
            "loss": float(loss.detach())}


def step_setup(case):
    """(system, model_cfg, train_cfg, state, relabel, dtype) of a step
    case. "aug" cases (LayerNorm fp32, BatchNorm float64): rotation at
    probability 0.5, jitter, edge dropout, drop_edge and relabelling on,
    from the port's seeded weights. "jax" cases: no augmentation, no
    dropout, the stored labels, from the JAX weights given."""
    kind, norm = case["kind"], case["norm"]
    system, _ = lj_set()
    dtype = torch.float64 if norm == "batch" else torch.float32
    aug = kind == "aug"
    model_cfg = tcfg.ModelConfig(use_layer_norm=norm == "layer",
                                 drop_edge=aug, dropout=0.1 if aug else 0.0,
                                 **(TINY if aug else JAX_TINY))
    train_cfg = tcfg.TrainConfig(
        batch_size=BATCH, rotate_aug=aug, rotate_prob=0.5,
        jitter_sigma=0.01 if aug else 0.0)
    state = create_train_state(model_cfg, system, train_cfg, 1, seed=0,
                               device="cpu")
    if "params" in case:
        state.model.load_params(params_from_jax(case["params"]),
                                params_from_jax(case["batch_stats"]))
    state.model.to(dtype)
    return (system, model_cfg, train_cfg, state,
            relabel_fn(system) if aug else None, dtype)


def steps_case(case, mesh=None):
    """case["steps"] train steps on the set's first batches; returns the
    metrics of each step, the parameters and buffers after, the scalers."""
    system, _, train_cfg, state, relabel, dtype = step_setup(case)
    _, frames = lj_set()
    step = tloop.make_train_step(state.model, system, train_cfg,
                                 relabel_fn=relabel, mesh=mesh)
    shard = dp_sharding(mesh) if mesh is not None else (lambda x: x)
    metrics = []
    for s in range(case["steps"]):
        items = frames[s * BATCH:(s + 1) * BATCH]
        batch = {k: shard(torch.as_tensor(np.stack([it[k] for it in items]),
                                          dtype=dtype))
                 for k in ("pos", "forces")}
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items() if k != "pos"})
    params, batch_stats = state.model.export_params()
    return {"metrics": metrics, "params": params,
            "batch_stats": batch_stats,
            "stats": [float(x) for x in (*state.force_stat,
                                         *state.length_stat)]}


def train_case(case, mesh=None):
    """Two epochs of train() on 8 training and 4 validation frames,
    checkpoints under case["ckpt_dir"] (rank 0's only); the history and
    the weights after."""
    system, model_cfg, train_cfg, _, relabel, _ = step_setup(case)
    import dataclasses
    train_cfg = dataclasses.replace(train_cfg, max_epoch=2,
                                    checkpoint_every=1)
    _, frames = lj_set()
    history, logs = [], []
    state = tloop.train(system, model_cfg, train_cfg,
                        ListDataset(frames[:8]), ListDataset(frames[8:]),
                        ckpt_dir=case["ckpt_dir"], mesh=mesh,
                        log_fn=logs.append, relabel_fn=relabel,
                        device="cpu", history=history)
    params, _ = state.model.export_params()
    return {"history": [{k: v for k, v in h.items() if k != "seconds"}
                        for h in history],
            "params": params, "logs": logs}


CASES = {"stat": lambda case, mesh: stat_case(
             slice(mesh.rank * 2, mesh.rank * 2 + 2), mesh.group),
         "batchnorm": lambda case, mesh: batchnorm_case(
             slice(mesh.rank * 2, mesh.rank * 2 + 2), mesh.group),
         "steps": steps_case, "train": train_case}


def one_process(case):
    """The case computed in this process on the whole batch."""
    if case["what"] == "stat":
        return stat_case()
    if case["what"] == "batchnorm":
        return batchnorm_case()
    return CASES[case["what"]](case, None)


def run_rank(rank, world, init_method, out_dir, cases):
    torch.set_num_threads(1)
    init_rank(rank, world, "gloo", init_method)
    try:
        mesh = make_mesh(device="cpu")
        results = {name: CASES[case["what"]](case, mesh)
                   for name, case in cases.items()}
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
