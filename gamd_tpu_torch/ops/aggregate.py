"""Neighbour aggregation, the plain version (port of
gamd_tpu/ops/aggregate.py): in the padded [N, K] layout the message
scatter of a conv layer is a masked reduction over K,

    out[i, :] = sum_k mask[i, k] * h[idx[i, k], :] * e[i, k, :]

gamd_tpu_torch.ops.message.pallas_gather_multiply_aggregate runs the same
function as a CUDA kernel.
"""

import torch


def gather_index(idx, n):
    """idx [...] as int64 row ids of an n-row table, read as JAX's indexing
    reads them: a negative id counts from the end, then ids clamp into
    [0, n). Any id is then safe to gather, as a masked slot's need not be."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def gather_multiply_aggregate(h, e, idx, mask):
    """out[i] = sum_k mask[i,k] * h[idx[i,k]] * e[i,k].

    Args:
        h:    [N, D] node features.
        e:    [N, K, D] per-edge gate values.
        idx:  [N, K] neighbour indices (any value valid where mask False).
        mask: [N, K] bool.

    Returns:
        [N, D]; a masked slot adds exactly 0, whatever its gate holds.
    """
    h_src = h[gather_index(idx, h.shape[0])]
    return torch.sum(torch.where(mask[..., None], h_src * e, 0.0), dim=1)
