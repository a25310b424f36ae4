"""Data parallelism across ranks (port of gamd_tpu/parallel/mesh.py:
make_mesh, dp_sharding, replicated; the reduction over the batch of
gamd_tpu/models/normalizer.py::update_stat's axis_name and of the sharded
train step, gamd_tpu/train/loop.py:352-386).

JAX shards a batch over a mesh's "dp" axis inside one program, and XLA
inserts the reductions. Here each rank is a process with its own model on
its own device (one card a rank with the nccl backend; CPU ranks, or
several ranks on one card, with gloo), and the reductions are explicit:

  * every rank holds the same parameters and optimizer state
    (replicated: broadcast from rank 0);
  * each rank takes a contiguous share of every global batch
    (dp_sharding: rows rank * b .. (rank + 1) * b - 1, b = B / world, as
    P("dp") splits the leading axis; unequal shares are refused);
  * a random draw is made at the global batch's shape from a generator
    seeded alike on every rank, and each rank keeps its rows
    (global_rows), so the ranks draw what one process draws;
  * every reduction over the batch is a sum all-reduced over the group
    (all_reduce_sum, differentiable: its backward all-reduces the
    gradient, as torch's SyncBatchNorm does), and after backward one flat
    all-reduce averages the gradients (average_gradients).

Only all_reduce and broadcast are used: the two collectives that gloo
also runs on CUDA tensors. The caller picks the backend when it starts
the process group (init_rank); nothing here swaps one for another.
"""

from typing import NamedTuple

import torch
import torch.distributed as dist

from gamd_tpu_torch.core.device import resolve_device

__all__ = ["Mesh", "init_rank", "make_mesh", "dp_sharding", "replicated",
           "all_reduce_sum", "global_rows", "average_gradients"]


class Mesh(NamedTuple):
    """A 1-D data-parallel mesh as one rank sees it."""

    group: object            # the process group of the ranks
    rank: int                # this rank within it
    world_size: int          # ranks in it
    device: torch.device     # this rank's device


def init_rank(rank: int, world_size: int, backend: str, init_method: str):
    """Join the process group: `backend` is "nccl" (one card a rank) or
    "gloo" (CPU ranks, or several ranks on one card); init_method a
    "file://" path or "tcp://localhost:<port>" that every rank is given."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def make_mesh(device=None) -> Mesh:
    """The mesh over every rank of the process group (init_rank first):
    the group is the data-parallel axis, so JAX's n_devices and axis_name
    have no counterpart. device: this rank's device, its current card
    unless the caller passes another (CPU ranks pass "cpu"); a card asked
    for where torch finds none raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh runs inside a rank: call init_rank "
                           "(torch.distributed.init_process_group) first")
    device = resolve_device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(),
                world_size=dist.get_world_size(), device=device)


def _share(n: int, group):
    """(first row, rows) of this rank's share of a leading axis of n."""
    world = dist.get_world_size(group)
    if n % world:
        raise ValueError(f"a batch of {n} does not split into {world} "
                         "equal shares")
    rows = n // world
    return dist.get_rank(group) * rows, rows


def dp_sharding(mesh: Mesh):
    """x -> this rank's contiguous share of x's leading (batch) axis."""
    def shard(x):
        start, rows = _share(x.shape[0], mesh.group)
        return x[start:start + rows]
    return shard


def global_rows(draw, shape, group=None):
    """draw(shape) in one process. Under a group, draw at the global
    batch's shape (shape[0] * ranks rows) and keep this rank's rows; a
    draw that returns a tuple has each member cut so."""
    if group is None:
        return draw(tuple(shape))
    world = dist.get_world_size(group)
    out = draw((shape[0] * world, *shape[1:]))
    start = dist.get_rank(group) * shape[0]
    cut = lambda t: t[start:start + shape[0]]
    return tuple(cut(t) for t in out) if isinstance(out, tuple) else cut(out)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t, group):
    """The sum of t over the group's ranks, on every rank, differentiable:
    the backward all-reduces the gradient. With every rank computing the
    same loss, each rank's gradients then sum to the group's size times the
    loss's gradient, which average_gradients divides out."""
    return _AllReduceSum.apply(t, group)


def average_gradients(params, group):
    """The mean over the group of every parameter's gradient, in place, in
    one all-reduce of the gradients laid end to end (parameters without a
    gradient, the same on every rank, are left out)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _tensors(obj, out):
    """Every tensor of a module (parameters, buffers), an optimizer (its
    state), or a nest of tuples, lists and dicts of them, in a fixed
    order."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, torch.nn.Module):
        out.extend(p for _, p in sorted(obj.named_parameters()))
        out.extend(b for _, b in sorted(obj.named_buffers()))
    elif isinstance(obj, torch.optim.Optimizer):
        for group in obj.param_groups:
            for p in group["params"]:
                state = obj.state.get(p, {})
                _tensors([state[k] for k in sorted(state)], out)
    elif isinstance(obj, dict):
        _tensors([obj[k] for k in sorted(obj)], out)
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            _tensors(item, out)
    return out


def replicated(mesh: Mesh):
    """obj -> obj with every tensor in it (a module's parameters and
    buffers, an optimizer's state, a TrainState's scalers: see _tensors)
    broadcast in place from the group's rank 0. Under nccl a tensor on the
    CPU (Adam's step count) travels through the rank's card."""
    src = dist.get_global_rank(mesh.group, 0)
    nccl = dist.get_backend(mesh.group) == "nccl"

    @torch.no_grad()
    def replicate(obj):
        for t in _tensors(obj, []):
            t = t.detach()
            if nccl and not t.is_cuda:
                tmp = t.to(mesh.device)
                dist.broadcast(tmp, src=src, group=mesh.group)
                t.copy_(tmp)
            else:
                dist.broadcast(t, src=src, group=mesh.group)
        return obj
    return replicate
