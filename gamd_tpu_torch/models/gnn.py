"""GAMD GNN force field over padded [N, K] neighbour lists, eval and train
forward (port of gamd_tpu/models/gnn.py::GAMDNet for the LJ species).

Every tensor is a dense [B, N, K, F] block; padded neighbour slots point at
the centre atom and are zeroed by the mask when messages are summed. Per
edge, with edges pointing neighbour (src) -> centre (dst):

    e_emb = theta_edge(edge_affine(e) + src_affine(h_nbr) + dst_affine(h_ctr))
    agg_i = sum_k mask_ik * h_nbr_ik * e_emb_ik
    h'_i  = h_i + phi(phi_dst(h_i) + phi_edge(agg_i))

Parameter names and layouts follow the flax tree (`load_params` and
`export_params` map one onto the other), gelu is the exact erf form and
LayerNorm eps is 1e-6, as in flax. With cfg.use_pallas the edge pipeline of
every conv layer runs through ops.conv_gather.fused_conv_gather_message
(the CUDA kernel pair on the card); the node update stays plain torch, as
in JAX. In train mode (forward(..., train=True, generator=g)) BatchNorm
uses and updates batch statistics as flax does, and edge dropout and
drop_edge draw from `generator`. The water variant (one-hot node encoder,
bond channel) comes with the water slice.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gamd_tpu_torch.core import space
from gamd_tpu_torch.core.config import ModelConfig
from gamd_tpu_torch.models.mlp import MLP, Dense, get_activation
from gamd_tpu_torch.ops.conv_gather import fused_conv_gather_message

LN_EPS = 1e-6     # flax nn.LayerNorm default
BN_EPS = 1e-5     # torch BatchNorm1d default, as the JAX model
BN_MOMENTUM = 0.9  # flax momentum (torch BatchNorm1d's 0.1)
DROP_EDGE_KEEP = 0.8  # per-layer Bernoulli keep of drop_edge (gnn.py:159-165)


def rbf_expand(d, low=0.0, high=1.0, gap=0.025):
    """Gaussian radial basis exp(-(1/gap) * (d - mu)^2) with centres
    linspace(low, high, ceil((high-low)/gap))."""
    num_centers = int(np.ceil((high - low) / gap))
    centers = torch.linspace(low, high, num_centers, dtype=d.dtype,
                             device=d.device)
    return torch.exp(-(1.0 / gap) * (d[..., None] - centers) ** 2)


def gather_nodes(h, idx):
    """Batched neighbour gather: h [B, N, D], idx [B, N, K] -> [B, N, K, D]."""
    b = torch.arange(h.shape[0], device=h.device)[:, None, None]
    return h[b, idx.long()]


def edge_geometry(pos, idx, box, flip_dir=False):
    """(unit_dir [B,N,K,3], dist [B,N,K]) from centre i to neighbour
    idx[i, k] under the minimum image; unit is negated when flip_dir."""
    rel = space.min_image(gather_nodes(pos, idx) - pos[:, :, None, :], box)
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1))
    unit = rel / (dist[..., None] + 1e-8)
    return (-unit if flip_dir else unit), dist


class LayerNorm(nn.Module):
    """flax-named LayerNorm (`scale`, `bias`), eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, train: bool = False):
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, LN_EPS)


class BatchNorm(nn.Module):
    """BatchNorm over the feature axis as flax computes it, with flax names:
    params `scale`, `bias`; running stats `mean`, `var` (batch_stats).

    Eval uses the running stats. Train normalises with the batch's mean and
    biased variance over every axis but the last (E[x^2] - E[x]^2, clipped
    at 0: flax's use_fast_variance) and updates the running stats to
    0.9 * old + 0.1 * batch, variance biased (F.batch_norm would store the
    unbiased one)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x, train: bool = False):
        if train:
            axes = tuple(range(x.ndim - 1))
            mean = torch.mean(x, dim=axes)
            var = torch.clamp(torch.mean(x * x, dim=axes) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean
                                + (1.0 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * self.scale) \
            + self.bias


def _bernoulli(shape, keep_prob, device, generator):
    """Keep mask: uniform [0, 1) < keep_prob, as jax.random.bernoulli."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


class EdgeGatedConv(nn.Module):
    """One message-passing layer; parameter names as the flax module."""

    def __init__(self, node_dim: int, hidden_dim: int, edge_dim: int,
                 activation: str = "silu", drop_edge: bool = False,
                 use_pallas: bool = False):
        super().__init__()
        self.act = get_activation(activation)
        self.drop_edge = drop_edge
        self.use_pallas = use_pallas
        p = lambda *shape: nn.Parameter(torch.zeros(*shape))
        nd, hd = node_dim, hidden_dim
        self.edge_affine_w1, self.edge_affine_b1 = p(edge_dim, hd), p(hd)
        self.edge_affine_w2, self.edge_affine_b2 = p(hd, hd), p(hd)
        self.theta_edge_w1, self.theta_edge_b1 = p(hd, hd), p(hd)
        self.theta_edge_w2, self.theta_edge_b2 = p(hd, nd), p(nd)
        self.phi_dst_w, self.phi_dst_b = p(nd, hd), p(hd)
        self.phi_edge_w, self.phi_edge_b = p(nd, hd), p(hd)
        self.phi_w, self.phi_b = p(hd, nd), p(nd)
        self.src_affine = Dense(nd, hd)
        self.dst_affine = Dense(nd, hd)

    def forward(self, h_raw, hn, e, idx, mask, train: bool = False,
                generator=None):
        """h_raw [B,N,D] residual input, hn [B,N,D] normalised, e [B,N,K,E],
        idx/mask [B,N,K] -> h' [B,N,D]. In train mode with drop_edge, a
        Bernoulli keep of 0.8 drawn from `generator` is ANDed into the
        aggregation mask."""
        act = self.act
        src_nodes = self.src_affine(hn)
        dst_code = self.dst_affine(hn)
        if self.drop_edge and train:
            mask = mask & _bernoulli(mask.shape, DROP_EDGE_KEEP, mask.device,
                                     generator)
        if self.use_pallas:
            agg = fused_conv_gather_message(
                e, idx, mask, hn, src_nodes, dst_code,
                self.edge_affine_w1, self.edge_affine_b1,
                self.edge_affine_w2, self.edge_affine_b2,
                self.theta_edge_w1, self.theta_edge_b1,
                self.theta_edge_w2, self.theta_edge_b2)
        else:
            edge_code = act(e @ self.edge_affine_w1 + self.edge_affine_b1) \
                @ self.edge_affine_w2 + self.edge_affine_b2
            pre = edge_code + gather_nodes(src_nodes, idx) \
                + dst_code[:, :, None]
            e_emb = act(act(pre) @ self.theta_edge_w1 + self.theta_edge_b1) \
                @ self.theta_edge_w2 + self.theta_edge_b2
            msg = gather_nodes(hn, idx) * e_emb
            agg = torch.sum(torch.where(mask[..., None], msg, 0.0), dim=2)
        delta = act(hn @ self.phi_dst_w + self.phi_dst_b
                    + agg @ self.phi_edge_w + self.phi_edge_b) \
            @ self.phi_w + self.phi_b
        return h_raw + delta


class ConvBlock(nn.Module):
    """Pre-norm residual stack: h = conv(norm(h)) + h, per layer; children
    named norm_{l} and conv_{l} as in flax."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.n_layers = cfg.conv_layers
        d = cfg.encoding_size
        for layer in range(cfg.conv_layers):
            norm = LayerNorm(d) if cfg.use_layer_norm else BatchNorm(d)
            self.add_module(f"norm_{layer}", norm)
            self.add_module(f"conv_{layer}", EdgeGatedConv(
                d, cfg.hidden_dim, cfg.edge_embedding_dim,
                cfg.conv_activation, drop_edge=cfg.drop_edge,
                use_pallas=cfg.use_pallas))

    def forward(self, h, e, idx, mask, train: bool = False, generator=None):
        for layer in range(self.n_layers):
            hn = getattr(self, f"norm_{layer}")(h, train)
            h = getattr(self, f"conv_{layer}")(h, hn, e, idx, mask, train,
                                               generator)
        return h


class GAMDNet(nn.Module):
    """GAMD force model (LJ: one learned embedding broadcast to every atom).

    forward returns the *normalised* per-atom force [B, N, 3]; the caller
    denormalises with the force statistics.
    """

    def __init__(self, cfg: ModelConfig, species: str = "lj",
                 use_bond: bool = False):
        super().__init__()
        if species != "lj" or use_bond:
            raise NotImplementedError(
                "the water GAMDNet (one-hot node encoder, bond channel) "
                "comes with the port's water slice")
        if cfg.update_edge or not cfg.expand_edge:
            raise NotImplementedError(
                "update_edge / expand_edge=False are not ported")
        self.cfg = cfg
        h, e = cfg.hidden_dim, cfg.edge_embedding_dim
        in_feats = 3 + 1 + cfg.n_rbf
        p = lambda *shape: nn.Parameter(torch.zeros(*shape))
        self.edge_encoder_w0, self.edge_encoder_b0 = p(in_feats, h), p(h)
        self.edge_encoder_w1, self.edge_encoder_b1 = p(h, h), p(h)
        self.edge_encoder_w2, self.edge_encoder_b2 = p(h, e), p(e)
        self.edge_ln_scale = nn.Parameter(torch.ones(e))
        self.edge_ln_bias = p(e)
        self.node_emb = p(1, cfg.encoding_size)
        self.graph_conv = ConvBlock(cfg)
        self.graph_decoder = MLP(cfg.encoding_size, cfg.out_feats,
                                 hidden_dim=h, hidden_layer=2,
                                 activation=cfg.mlp_activation)

    @torch.no_grad()
    def load_params(self, params, batch_stats=None):
        """Copy a nested dict in the flax tree layout (numpy or torch leaves)
        into this module; batch_stats fill the BatchNorm running stats."""
        tensors = dict(self.named_parameters())
        tensors.update(self.named_buffers())
        for name, t in tensors.items():
            keys = name.split(".")
            tree = params
            if keys[-1] in ("mean", "var"):
                tree = batch_stats
            for key in keys:
                tree = tree[key]
            t.copy_(torch.as_tensor(np.asarray(tree, np.float32)))
        return self

    def export_params(self):
        """(params, batch_stats): this module's weights as nested dicts of
        float32 numpy arrays in the flax tree layout, the inverse of
        load_params; batch_stats is {} for LayerNorm models."""
        params, batch_stats = {}, {}
        named = list(self.named_parameters()) + list(self.named_buffers())
        for name, t in named:
            keys = name.split(".")
            tree = batch_stats if keys[-1] in ("mean", "var") else params
            for key in keys[:-1]:
                tree = tree.setdefault(key, {})
            tree[keys[-1]] = t.detach().cpu().numpy().astype(np.float32)
        return params, batch_stats

    def encode_edges(self, pos, idx, box, length_mean, length_std,
                     train: bool = False, generator=None):
        """The encoded edges e [B,N,K,E] that every conv layer reads: the
        encoder MLP over unit vector, standardised length and its RBF
        expansion, the edge LayerNorm, and in train mode edge dropout
        cfg.dropout (inverse-scaled, as flax) drawn from `generator`."""
        cfg = self.cfg
        act = get_activation(cfg.mlp_activation)
        unit, dist = edge_geometry(pos, idx, box, flip_dir=cfg.flip_dir)
        std_dist = (dist - length_mean) / length_std
        feats = torch.cat([unit, std_dist[..., None],
                           rbf_expand(std_dist, cfg.rbf_low, cfg.rbf_high,
                                      cfg.rbf_gap)], dim=-1)
        z = act(feats @ self.edge_encoder_w0 + self.edge_encoder_b0)
        z = act(z @ self.edge_encoder_w1 + self.edge_encoder_b1)
        e = z @ self.edge_encoder_w2 + self.edge_encoder_b2
        e = F.layer_norm(e, e.shape[-1:], eps=LN_EPS) * self.edge_ln_scale \
            + self.edge_ln_bias
        if train and cfg.dropout > 0.0:
            keep_prob = 1.0 - cfg.dropout
            keep = _bernoulli(e.shape, keep_prob, e.device, generator)
            e = torch.where(keep, e / keep_prob, 0.0)
        return e

    def forward(self, pos, idx, mask, box, length_mean, length_std,
                train: bool = False, generator=None):
        """pos [B,N,3] wrapped, idx/mask [B,N,K], box float, length_mean/std
        floats or 0-d tensors -> normalised forces [B,N,3].

        train=True: BatchNorm on batch statistics (running stats updated),
        edge dropout and drop_edge, both drawn from `generator`."""
        e = self.encode_edges(pos, idx, box, length_mean, length_std, train,
                              generator)
        b, n, _ = pos.shape
        h = self.node_emb.expand(b, n, self.cfg.encoding_size)
        h = self.graph_conv(h, e, idx, mask, train, generator)
        return self.graph_decoder(h)
