"""GAMDNet's eval forward on one frame with every conv layer's message
passing through one form of the op library (ops/message.py), the stages
of gamd_tpu/ops/pallas_mp.py's module docstring:

* gather_aggregate: the edge pipeline in PyTorch up to the gate theta(z),
  then pallas_gather_multiply_aggregate (hn gathered in the kernel);
* edge_mlp_aggregate: z = edge_affine(e) + src_code + dst_code in PyTorch,
  then fused_edge_mlp_aggregate (theta, the gate and the sum);
* conv_message: the gathers in PyTorch, then fused_conv_message;
* conv_layer: fused_conv_layer, the node update and residual included.

Each form computes the function of the model's own layer
(models/gnn.py::EdgeGatedConv): the forces agree with GAMDNet's. The
kernels take the LJ model's silu conv activation only, as in JAX.
"""

import torch
import torch.nn.functional as F

from gamd_tpu_torch.ops.aggregate import gather_index
from gamd_tpu_torch.ops.message import (fused_conv_layer, fused_conv_message,
                                        fused_edge_mlp_aggregate,
                                        pallas_gather_multiply_aggregate)

FORMS = ("gather_aggregate", "edge_mlp_aggregate", "conv_message",
         "conv_layer")


def layer_weights(conv):
    """An EdgeGatedConv's 14 weights in fused_conv_layer's order: edge_affine
    (w1, b1, w2, b2), theta_edge (w3, b3, w4, b4), phi_dst, phi_edge, phi."""
    return (conv.edge_affine_w1, conv.edge_affine_b1, conv.edge_affine_w2,
            conv.edge_affine_b2, conv.theta_edge_w1, conv.theta_edge_b1,
            conv.theta_edge_w2, conv.theta_edge_b2, conv.phi_dst_w,
            conv.phi_dst_b, conv.phi_edge_w, conv.phi_edge_b, conv.phi_w,
            conv.phi_b)


def conv_layer(conv, h_raw, hn, e, idx, mask, form):
    """EdgeGatedConv.forward in eval on one graph (h_raw, hn [N, D], e
    [N, K, E], idx [N, K] int32, mask [N, K] bool) through `form`."""
    ws = layer_weights(conv)
    w1, b1, w2, b2, w3, b3, w4, b4, wpd, bpd, wpe, bpe, wp, bp = ws
    src_nodes, dst_code = conv.src_affine(hn), conv.dst_affine(hn)
    if form == "conv_layer":
        return fused_conv_layer(e, idx, mask, h_raw, hn, src_nodes,
                                dst_code, ws)
    rows = gather_index(idx, hn.shape[0])
    h_src, src_code = hn[rows], src_nodes[rows]
    if form == "conv_message":
        agg = fused_conv_message(e, h_src, src_code, dst_code, mask,
                                 *ws[:8])
    else:
        z = F.silu(e @ w1 + b1) @ w2 + b2 + src_code + dst_code[:, None]
        if form == "edge_mlp_aggregate":
            agg = fused_edge_mlp_aggregate(z, h_src, mask, w3, b3, w4, b4)
        elif form == "gather_aggregate":
            gate = F.silu(F.silu(z) @ w3 + b3) @ w4 + b4
            agg = pallas_gather_multiply_aggregate(hn, gate, idx, mask)
        else:
            raise ValueError(f"form {form!r}: one of {FORMS}")
    return h_raw + F.silu(hn @ wpd + bpd + agg @ wpe + bpe) @ wp + bp


@torch.no_grad()
def forward(model, pos, idx, mask, box, length_mean, length_std, form):
    """GAMDNet's eval forward (model: models/gnn.py::GAMDNet, LJ, silu conv
    activation) on one frame, pos [N, 3] wrapped, idx/mask [N, K], every
    conv layer through `form`: the normalised forces [N, 3]."""
    if model.cfg.conv_activation != "silu":
        raise NotImplementedError("the op library's kernels take the silu "
                                  "conv activation only")
    e = model.encode_edges(pos[None], idx[None], box, length_mean,
                           length_std)[0]
    block = model.graph_conv
    h = model.node_emb.expand(pos.shape[0],
                              model.cfg.encoding_size).contiguous()
    for layer in range(block.n_layers):
        hn = getattr(block, f"norm_{layer}")(h)
        h = conv_layer(getattr(block, f"conv_{layer}"), h, hn, e, idx, mask,
                       form)
    return model.graph_decoder(h)
