"""GAMD GNN force field over padded [N, K] neighbour lists, eval and train
forward (port of gamd_tpu/models/gnn.py::GAMDNet: the LJ species, the
water species with its one-hot node encoder and its bond channel, and the
DFT model's switches update_edge and expand_edge=False; and of its
cubic_kernel and RBFExpansion, which the models do not use).

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
in JAX. With cfg.use_pallas and cfg.use_pallas_encoder, in eval with a
scalar box, the encoded edges come from ops.encoder.fused_edge_encoder (the
CUDA edge_encoder on the card) as in JAX (gamd_tpu/models/gnn.py:296-308):
that encoder's gelu is the tanh form, and its live mask is the given mask
passed through. In train mode (forward(..., train=True, generator=g)) BatchNorm
uses and updates batch statistics as flax does, and edge dropout and
drop_edge draw from `generator`. The water variant (species="water")
encodes the one-hot species feature node_feat [B, N, F] through a dense
layer `node_encoder` instead of the LJ embedding `node_emb`, and with
use_bond the bond channel bond [B, N, K] is the encoder's last input
column (gamd_tpu/models/gnn.py:316-344); JAX leaves the fused encoder off
under use_bond, and so does the port. With cfg.update_edge every conv
layer also returns its edge embedding normalised by its own LayerNorm
`edge_layer_norm` (gamd_tpu/models/gnn.py:191-192), which the next layer
reads as its e (an edge width of D after the first layer); such a layer
runs the plain edge pipeline under use_pallas too, as in JAX
(gnn.py:168). With cfg.expand_edge False the encoder reads the unit
vector and the standardised length without their RBF expansion (4
inputs, 5 with the bond), and the fused encoder stays off, as in JAX.
Both are the DFT model's (dftlarge_final).

cfg.compute_dtype="bfloat16" is JAX's mixed-precision policy
(gamd_tpu/models/gnn.py:273-363) on the plain path: the parameters stay
float32 and are cast where JAX casts them. The encoder MLP, the src/dst
affines, the edge pipeline, the node update and the decoder compute in
bf16 (each product a bf16 matmul, each sum and activation rounded to
bf16); the norms take their statistics in float32 and return float32, as
flax's LayerNorm and BatchNorm do under a bf16 input with float32 scale
and bias (the parameter-free edge LayerNorm returns bf16, which the
float32 edge scale and bias then promote); the gated sum over neighbours
is float32 (float32 hn times bf16 e_emb), the residual stream h is bf16,
and the output float32. The kernel paths compute in float32 and refuse
it: use_pallas (with or without use_pallas_encoder) here, the
megakernel, megastep and banded force paths in train.forcefield.
"""

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gamd_tpu_torch.core import space
from gamd_tpu_torch.core.config import ModelConfig
from gamd_tpu_torch.models.mlp import MLP, Dense, get_activation
from gamd_tpu_torch.ops.conv_gather import fused_conv_gather_message
from gamd_tpu_torch.ops.encoder import fused_edge_encoder
from gamd_tpu_torch.parallel.mesh import all_reduce_sum, global_rows

LN_EPS = 1e-6     # flax nn.LayerNorm default
BN_EPS = 1e-5     # torch BatchNorm1d default, as the JAX model
BN_MOMENTUM = 0.9  # flax momentum (torch BatchNorm1d's 0.1)
DROP_EDGE_KEEP = 0.8  # per-layer Bernoulli keep of drop_edge (gnn.py:159-165)
#: ModelConfig.compute_dtype -> the torch dtype the plain path computes in
#: (None: float32 throughout).
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig):
    """The torch compute dtype of cfg.compute_dtype (None for float32);
    raises for a dtype the port does not take."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port takes "
            f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[cfg.compute_dtype]


def _caster(dtype):
    """x -> x in `dtype` (identity for None)."""
    return (lambda x: x) if dtype is None else (lambda x: x.to(dtype))


def _wide(x):
    """x in float32 if it is bf16, else as it is (float32 or float64)."""
    return x.float() if x.dtype == torch.bfloat16 else x


def cubic_kernel(r, re, eps=1e-3):
    """Smoothing kernel relu((1 - (r/re)^2)^3), with r <= eps mapped to re
    first; unused by the models, part of the reference's surface
    (gamd_tpu/models/gnn.py:46)."""
    r = torch.where(r <= eps, re, r)
    return F.relu((1.0 - (r / re) ** 2) ** 3)


def rbf_expand(d, low=0.0, high=1.0, gap=0.025):
    """Gaussian radial basis exp(-(1/gap) * (d - mu)^2) with centres
    linspace(low, high, ceil((high-low)/gap))."""
    num_centers = int(np.ceil((high - low) / gap))
    centers = torch.linspace(low, high, num_centers, dtype=d.dtype,
                             device=d.device)
    return torch.exp(-(1.0 / gap) * (d[..., None] - centers) ** 2)


class RBFExpansion(nn.Module):
    """rbf_expand as a module, its centres fixed (not parameters); the JAX
    module's fields and defaults (gamd_tpu/models/gnn.py:64)."""

    def __init__(self, low: float = 0.0, high: float = 30.0,
                 gap: float = 0.1):
        super().__init__()
        self.low, self.high, self.gap = low, high, gap

    def forward(self, d):
        return rbf_expand(d, self.low, self.high, self.gap)


def gather_nodes(h, idx):
    """Batched neighbour gather: h [B, N, D], idx [B, N, K] -> [B, N, K, D]."""
    b = torch.arange(h.shape[0], device=h.device)[:, None, None]
    return h[b, idx.long()]


def encoder_inputs(cfg: ModelConfig, use_bond: bool = False):
    """The edge encoder's input width: unit vector and length (4), the RBF
    expansion with cfg.expand_edge, and the bond channel."""
    return 4 + (cfg.n_rbf if cfg.expand_edge else 0) + int(use_bond)


def edge_geometry(pos, idx, box, flip_dir=False):
    """(unit_dir [B,N,K,3], dist [B,N,K]) from centre i to neighbour
    idx[i, k] under the minimum image (box a scalar, or a frame's own, [B]
    or [B, 3]); unit is negated when flip_dir."""
    rel = gather_nodes(pos, idx) - pos[:, :, None, :]
    rel = space.min_image(rel, space.frame_box(box, rel))
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1))
    unit = rel / (dist[..., None] + 1e-8)
    return (-unit if flip_dir else unit), dist


class LayerNorm(nn.Module):
    """flax-named LayerNorm (`scale`, `bias`), eps 1e-6; a bf16 input is
    normalised in float32 and the output is float32, as flax's."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, train: bool = False, group=None):
        return F.layer_norm(_wide(x), x.shape[-1:], self.scale, self.bias,
                            LN_EPS)


class BatchNorm(nn.Module):
    """BatchNorm over the feature axis as flax computes it, with flax names:
    params `scale`, `bias`; running stats `mean`, `var` (batch_stats).

    Eval uses the running stats. Train normalises with the batch's mean and
    biased variance over every axis but the last (E[x^2] - E[x]^2, clipped
    at 0: flax's use_fast_variance) and updates the running stats to
    0.9 * old + 0.1 * batch, variance biased (F.batch_norm would store the
    unbiased one). Under a process group (data-parallel ranks) the batch
    is the global one: the sums of x and x^2 are all-reduced over the
    group (differentiably) and divided by the global count, as JAX's
    sharded step normalises, so every rank's running stats move alike. A
    bf16 input is normalised in float32 and the output is float32, as
    flax's."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x, train: bool = False, group=None):
        x = _wide(x)
        if train:
            axes = tuple(range(x.ndim - 1))
            if group is None:
                mean = torch.mean(x, dim=axes)
                mean_sq = torch.mean(x * x, dim=axes)
            else:
                count = x.numel() // x.shape[-1] * dist.get_world_size(
                    group)
                sums = all_reduce_sum(torch.stack(
                    [torch.sum(x, dim=axes), torch.sum(x * x, dim=axes)]),
                    group) / count
                mean, mean_sq = sums[0], sums[1]
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean
                                + (1.0 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * self.scale) \
            + self.bias


def _bernoulli(shape, keep_prob, device, generator, group=None):
    """Keep mask: uniform [0, 1) < keep_prob, as jax.random.bernoulli;
    under a process group drawn at the global batch's shape, this rank's
    rows kept (parallel.mesh.global_rows)."""
    return global_rows(lambda s: torch.rand(s, generator=generator,
                                            device=device) < keep_prob,
                       shape, group)


class EdgeGatedConv(nn.Module):
    """One message-passing layer; parameter names as the flax module. With
    update_edge the layer owns `edge_layer_norm` (LayerNorm over D), and
    forward(..., return_edges=True) returns the normalised edge embedding
    beside h', as the flax module's (h', e') pair."""

    def __init__(self, node_dim: int, hidden_dim: int, edge_dim: int,
                 activation: str = "silu", drop_edge: bool = False,
                 use_pallas: bool = False, dtype=None,
                 update_edge: bool = False):
        super().__init__()
        self.act = get_activation(activation, dtype)
        self.drop_edge = drop_edge
        self.use_pallas = use_pallas
        self.dtype = dtype
        self.update_edge = update_edge
        p = lambda *shape: nn.Parameter(torch.zeros(*shape))
        nd, hd = node_dim, hidden_dim
        self.edge_affine_w1, self.edge_affine_b1 = p(edge_dim, hd), p(hd)
        self.edge_affine_w2, self.edge_affine_b2 = p(hd, hd), p(hd)
        self.theta_edge_w1, self.theta_edge_b1 = p(hd, hd), p(hd)
        self.theta_edge_w2, self.theta_edge_b2 = p(hd, nd), p(nd)
        self.phi_dst_w, self.phi_dst_b = p(nd, hd), p(hd)
        self.phi_edge_w, self.phi_edge_b = p(nd, hd), p(hd)
        self.phi_w, self.phi_b = p(hd, nd), p(nd)
        self.src_affine = Dense(nd, hd, dtype)
        self.dst_affine = Dense(nd, hd, dtype)
        if update_edge:
            self.edge_layer_norm = LayerNorm(nd)

    def forward(self, h_raw, hn, e, idx, mask, train: bool = False,
                generator=None, return_edges: bool = False, group=None):
        """h_raw [B,N,D] residual input, hn [B,N,D] normalised, e [B,N,K,E],
        idx/mask [B,N,K] -> h' [B,N,D]; with return_edges (h', e'), e'
        [B,N,K,D] the normalised edge embedding under update_edge, else
        None. In train mode with drop_edge, a Bernoulli keep of 0.8 drawn
        from `generator` (at the global batch's shape under a process
        group) is ANDed into the aggregation mask."""
        act = self.act
        src_nodes = self.src_affine(hn)
        dst_code = self.dst_affine(hn)
        if self.drop_edge and train:
            mask = mask & _bernoulli(mask.shape, DROP_EDGE_KEEP, mask.device,
                                     generator, group)
        cd = _caster(self.dtype)
        new_e = None
        if self.use_pallas and not self.update_edge:
            agg = fused_conv_gather_message(
                e, idx, mask, hn, src_nodes, dst_code,
                self.edge_affine_w1, self.edge_affine_b1,
                self.edge_affine_w2, self.edge_affine_b2,
                self.theta_edge_w1, self.theta_edge_b1,
                self.theta_edge_w2, self.theta_edge_b2)
        else:
            edge_code = act(cd(e) @ cd(self.edge_affine_w1)
                            + cd(self.edge_affine_b1)) \
                @ cd(self.edge_affine_w2) + cd(self.edge_affine_b2)
            pre = edge_code + gather_nodes(src_nodes, idx) \
                + dst_code[:, :, None]
            e_emb = act(act(pre) @ cd(self.theta_edge_w1)
                        + cd(self.theta_edge_b1)) \
                @ cd(self.theta_edge_w2) + cd(self.theta_edge_b2)
            if self.update_edge:
                new_e = self.edge_layer_norm(e_emb)
            msg = gather_nodes(hn, idx) * e_emb
            agg = torch.sum(torch.where(mask[..., None], msg, 0.0), dim=2)
        delta = act(cd(hn) @ cd(self.phi_dst_w) + cd(self.phi_dst_b)
                    + cd(agg) @ cd(self.phi_edge_w) + cd(self.phi_edge_b)) \
            @ cd(self.phi_w) + cd(self.phi_b)
        # Unrounded under bf16: ConvBlock rounds it for the residual stream.
        out = h_raw + delta if self.dtype is None \
            else h_raw.float() + delta.float()
        return (out, new_e) if return_edges else out


def conv_edge_dims(cfg: ModelConfig):
    """The edge width each conv layer reads: edge_embedding_dim, and with
    update_edge encoding_size past the first layer (each layer's e' is its
    normalised [.., D] edge embedding)."""
    return [cfg.encoding_size if cfg.update_edge and layer > 0
            else cfg.edge_embedding_dim for layer in range(cfg.conv_layers)]


class ConvBlock(nn.Module):
    """Pre-norm residual stack: h = conv(norm(h)) + h, per layer; children
    named norm_{l} and conv_{l} as in flax. With update_edge each layer's
    e' is the next layer's e."""

    def __init__(self, cfg: ModelConfig, dtype=None):
        super().__init__()
        self.n_layers = cfg.conv_layers
        d = cfg.encoding_size
        for layer, edge_dim in enumerate(conv_edge_dims(cfg)):
            norm = LayerNorm(d) if cfg.use_layer_norm else BatchNorm(d)
            self.add_module(f"norm_{layer}", norm)
            self.add_module(f"conv_{layer}", EdgeGatedConv(
                d, cfg.hidden_dim, edge_dim, cfg.conv_activation,
                drop_edge=cfg.drop_edge, use_pallas=cfg.use_pallas,
                dtype=dtype, update_edge=cfg.update_edge))

    def forward(self, h, e, idx, mask, train: bool = False, generator=None,
                group=None):
        """Under a bf16 compute dtype each layer's sum h + delta reaches the
        next norm in float32 and the residual stream in bf16, as in the
        jitted JAX model, where XLA keeps the sum in float32 inside the
        fusion that feeds the norm. `group`: the data-parallel ranks, for
        BatchNorm's batch moments and drop_edge's draws."""
        norm_in = h
        for layer in range(self.n_layers):
            hn = getattr(self, f"norm_{layer}")(norm_in, train, group)
            norm_in, new_e = getattr(self, f"conv_{layer}")(
                h, hn, e, idx, mask, train, generator, return_edges=True,
                group=group)
            h = norm_in.to(h.dtype)
            if new_e is not None:
                e = new_e
        return h


class GAMDNet(nn.Module):
    """GAMD force model (LJ: one learned embedding broadcast to every atom).

    forward returns the *normalised* per-atom force [B, N, 3]; the caller
    denormalises with the force statistics.
    """

    def __init__(self, cfg: ModelConfig, species: str = "lj",
                 use_bond: bool = False):
        super().__init__()
        if species not in ("lj", "water"):
            raise ValueError(f"unknown species {species!r}")
        self.dtype = compute_dtype(cfg)
        if self.dtype is not None and cfg.use_pallas:
            which = ("use_pallas and use_pallas_encoder (the conv kernel "
                     "pair and edge_encoder)" if cfg.use_pallas_encoder
                     else "use_pallas (the conv kernel pair)")
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r} runs on the plain "
                f"path only: {which} compute in float32")
        self.cfg = cfg
        self.species = species
        self.use_bond = use_bond
        h, e = cfg.hidden_dim, cfg.edge_embedding_dim
        in_feats = encoder_inputs(cfg, use_bond)
        p = lambda *shape: nn.Parameter(torch.zeros(*shape))
        self.edge_encoder_w0, self.edge_encoder_b0 = p(in_feats, h), p(h)
        self.edge_encoder_w1, self.edge_encoder_b1 = p(h, h), p(h)
        self.edge_encoder_w2, self.edge_encoder_b2 = p(h, e), p(e)
        self.edge_ln_scale = nn.Parameter(torch.ones(e))
        self.edge_ln_bias = p(e)
        if species == "lj":
            self.node_emb = p(1, cfg.encoding_size)
        else:
            self.node_encoder = Dense(cfg.in_node_feats, cfg.encoding_size,
                                      self.dtype)
        self.graph_conv = ConvBlock(cfg, self.dtype)
        self.graph_decoder = MLP(cfg.encoding_size, cfg.out_feats,
                                 hidden_dim=h, hidden_layer=2,
                                 activation=cfg.mlp_activation,
                                 dtype=self.dtype)

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
                     train: bool = False, generator=None, bond=None,
                     group=None):
        """The encoded edges e [B,N,K,E] that the first conv layer reads:
        the encoder MLP over unit vector, standardised length, its RBF
        expansion (with cfg.expand_edge) and (use_bond) the bond channel
        [B,N,K], the edge LayerNorm, and in train mode edge dropout
        cfg.dropout (inverse-scaled, as flax) drawn from `generator`, at
        the global batch's shape under a process group `group`. box is a
        scalar, or per frame [B] or [B, 3]."""
        cfg = self.cfg
        act = get_activation(cfg.mlp_activation, self.dtype)
        unit, dist = edge_geometry(pos, idx, box, flip_dir=cfg.flip_dir)
        std_dist = (dist - length_mean) / length_std
        feats = [unit, std_dist[..., None]]
        if cfg.expand_edge:
            feats.append(rbf_expand(std_dist, cfg.rbf_low, cfg.rbf_high,
                                    cfg.rbf_gap))
        if self.use_bond:
            if bond is None:
                raise ValueError("use_bond=True requires a bond channel")
            feats.append(bond[..., None].to(std_dist.dtype))
        feats = torch.cat(feats, dim=-1)
        cd = _caster(self.dtype)
        z = act(cd(feats) @ cd(self.edge_encoder_w0)
                + cd(self.edge_encoder_b0))
        z = act(z @ cd(self.edge_encoder_w1) + cd(self.edge_encoder_b1))
        e = z @ cd(self.edge_encoder_w2) + cd(self.edge_encoder_b2)
        e = F.layer_norm(_wide(e), e.shape[-1:], eps=LN_EPS).to(e.dtype) \
            * self.edge_ln_scale + self.edge_ln_bias
        if train and cfg.dropout > 0.0:
            keep_prob = 1.0 - cfg.dropout
            keep = _bernoulli(e.shape, keep_prob, e.device, generator,
                              group)
            e = torch.where(keep, e / keep_prob, 0.0)
        return e

    def forward(self, pos, idx, mask, box, length_mean, length_std,
                train: bool = False, generator=None, node_feat=None,
                bond=None, group=None):
        """pos [B,N,3] wrapped, idx/mask [B,N,K], box float, length_mean/std
        floats or 0-d tensors -> normalised forces [B,N,3]. The water
        species takes node_feat [B,N,F] (the one-hot species) and, with
        use_bond, bond [B,N,K].

        train=True: BatchNorm on batch statistics (running stats updated),
        edge dropout and drop_edge, both drawn from `generator`. `group`,
        a process group of data-parallel ranks each holding its share of
        the batch: BatchNorm's moments are the global batch's and the
        draws are made at its shape (parallel.mesh)."""
        cfg = self.cfg
        if cfg.use_pallas and cfg.use_pallas_encoder and not train \
                and not self.use_bond and cfg.expand_edge \
                and space.one_box(box):
            e, mask = fused_edge_encoder(
                pos, idx, mask, box, None, length_mean, length_std,
                self.edge_encoder_w0, self.edge_encoder_b0,
                self.edge_encoder_w1, self.edge_encoder_b1,
                self.edge_encoder_w2, self.edge_encoder_b2,
                self.edge_ln_scale, self.edge_ln_bias, rbf_low=cfg.rbf_low,
                rbf_high=cfg.rbf_high, rbf_gap=cfg.rbf_gap,
                flip_dir=cfg.flip_dir)
        else:
            e = self.encode_edges(pos, idx, box, length_mean, length_std,
                                  train, generator, bond, group)
        b, n, _ = pos.shape
        if self.species == "lj":
            h = _caster(self.dtype)(
                self.node_emb.expand(b, n, self.cfg.encoding_size))
        else:
            if node_feat is None:
                raise ValueError("water variants require node_feat one-hot")
            h = _caster(self.dtype)(self.node_encoder(node_feat))
        h = self.graph_conv(h, e, idx, mask, train, generator, group)
        return _wide(self.graph_decoder(h))
