"""The training step (port of gamd_tpu/train/loop.py::make_train_step).

One step, in the JAX step's order: rotation augmentation (positions and
forces), wrap, the dense neighbour search per frame (skipped when the batch
carries idx and mask), jitter after the search, optional relabelling at the
augmented positions, the streaming edge-length and force scalers, the
normalised labels, the GNN forward in train mode, the loss, backward and an
Adam step. Metrics stay tensors on the device: nothing is read on the host
inside a step. The epoch loop, the data pipeline and checkpoint saving come
with a later slice.
"""

import torch

from gamd_tpu_torch.core import space
from gamd_tpu_torch.core.config import SystemConfig, TrainConfig
from gamd_tpu_torch.models.gnn import GAMDNet, gather_nodes
from gamd_tpu_torch.models.normalizer import normalize, update_stat
from gamd_tpu_torch.neighbors.dense import dense_neighbor_list
from gamd_tpu_torch.train import augment
from gamd_tpu_torch.train.state import TrainState


def search_batch(pos, box, cutoff, k_max):
    """Dense neighbour lists of every frame of pos [B, N, 3]: idx [B, N, K]
    int32, mask [B, N, K] bool, and whether any frame overflowed (0-d bool
    tensor)."""
    lists = [dense_neighbor_list(p, box, cutoff, k_max) for p in pos]
    idx, mask, ovf = (torch.stack(t) for t in zip(*lists))
    return idx, mask, torch.any(ovf)


def edge_distances(pos, idx, box):
    """[B, N, K] minimum-image distances from atom i to idx[i, k]."""
    rel = space.min_image(gather_nodes(pos, idx) - pos[:, :, None, :], box)
    return torch.sqrt(torch.sum(rel * rel, dim=-1))


def _loss(pred, gt_norm, train_cfg: TrainConfig):
    """(loss, data_loss, net_force) of loop.py:184-221."""
    if train_cfg.loss == "mae":
        data_loss = torch.mean(torch.abs(pred - gt_norm))
    elif train_cfg.loss == "relmae":
        wmag = 1.0 / (torch.linalg.vector_norm(gt_norm, dim=-1, keepdim=True)
                      + 0.05)
        data_loss = torch.mean(torch.abs(pred - gt_norm) * wmag)
    elif train_cfg.loss == "mse":
        data_loss = torch.mean((pred - gt_norm) ** 2)
    else:
        raise ValueError(f"unknown loss {train_cfg.loss!r}: mae, mse or "
                         "relmae")
    net_force = torch.abs(torch.mean(pred))      # mean over every element
    loss = data_loss + train_cfg.lambda_net_force * net_force
    if train_cfg.lambda_cosine > 0.0:
        dot = torch.sum(pred * gt_norm, dim=-1)
        norms = (torch.linalg.vector_norm(pred, dim=-1)
                 * torch.linalg.vector_norm(gt_norm, dim=-1))
        cos = dot / (norms + 1e-3)
        loss = loss + train_cfg.lambda_cosine * torch.mean(1.0 - cos)
    return loss, data_loss, net_force


def make_train_step(model: GAMDNet, system: SystemConfig,
                    train_cfg: TrainConfig, relabel_fn=None):
    """train_step(state, batch) -> (state, metrics) for the TrainState
    whose module is `model`.

    batch: {"pos": [B, N, 3], "forces": [B, N, 3]} on the state's device,
    optionally with precomputed "idx"/"mask" [B, N, K]. relabel_fn: pos
    [B, N, 3] -> forces [B, N, 3] (dataset units), recomputing the labels
    at the augmented positions (e.g. physics.lennard_jones.lj_forces_dense
    with the box bound).

    The module and optimizer are updated in place; the returned state
    carries the new scalers and step. metrics: loss, data_loss, net_force,
    force_std, nbr_overflow (tensors) and pos, the positions the model saw.
    """
    if system.box is None:
        raise NotImplementedError("per-sample boxes come with the port's "
                                  "water / DFT slice")
    if train_cfg.rigid_jitter:
        augment.rigid_jitter_positions()      # raises: the water slice
    box = system.box

    def train_step(state: TrainState, batch):
        gen = state.generator
        pos, gt = batch["pos"], batch["forces"]
        if train_cfg.rotate_aug:
            r = augment.random_flip_rotation(gen, pos.shape[0],
                                             train_cfg.rotate_prob,
                                             pos.device)
            pos, gt = augment.rotate_sample(pos, gt, box, r)
        pos = space.wrap(pos, box)
        if "idx" in batch:
            idx, mask = batch["idx"], batch["mask"]
            overflow = torch.zeros((), dtype=torch.bool, device=pos.device)
        else:
            idx, mask, overflow = search_batch(pos, box, system.cutoff,
                                               system.nbr_capacity)
        pos = augment.jitter_positions(gen, pos, train_cfg.jitter_sigma)
        if relabel_fn is not None:
            gt = relabel_fn(pos)

        length_stat = update_stat(state.length_stat,
                                  edge_distances(pos, idx, box), mask=mask)
        force_stat = update_stat(state.force_stat, gt)
        gt_norm = normalize(gt, force_stat)

        state.optimizer.zero_grad(set_to_none=True)
        pred = model(pos, idx, mask, box, length_stat.safe_mean,
                     torch.clamp(length_stat.std, min=1e-12), train=True,
                     generator=gen)
        loss, data_loss, net_force = _loss(pred, gt_norm, train_cfg)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()

        metrics = {"loss": loss.detach(), "data_loss": data_loss.detach(),
                   "net_force": net_force.detach(),
                   "force_std": force_stat.std, "nbr_overflow": overflow,
                   "pos": pos}
        return state._replace(force_stat=force_stat, length_stat=length_stat,
                              step=state.step + 1), metrics

    return train_step
