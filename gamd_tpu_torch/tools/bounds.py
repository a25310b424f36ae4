"""The card's published peaks and the whole-model forward's operation
counts, shared by chip_smoke.py (each kernel's bound) and
tools/bench_ablate.py (each ablated stage's floor), so that both price the
same work the same way.

The forward's edge-level products (the RBF, the encoder's two, four a conv
layer) run over the live edges on the tensor cores as three bf16 passes
(bf16 x 3, csrc/edge_tc.cuh); everything else runs in fp32 on the CUDA
cores. stage_ops splits forward_ops by the benchmark's stages
(ops/mega.py::ABLATE_STAGES); the rest, the rank-1 geometric terms and the
gated products, belongs to no stage.
"""

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def _widths(model_cfg):
    return (model_cfg.encoding_size, model_cfg.hidden_dim,
            model_cfg.edge_embedding_dim, model_cfg.conv_layers)


def stage_ops(edges, n, n_rbf, model_cfg):
    """{stage: (tensor-core FLOP, fp32 FLOP)} of one forward over `edges`
    live edges and n atoms (2 operations a multiply-add), for the stages
    that own products: the RBF product over n_rbf rows, the encoder's two
    MLP products, each layer's edge MLP (W_e1, W_e2) and theta MLP (W_t1,
    W_t2) on the tensor cores; the source affine, the other node products
    (dst, the update's three) and the decoder in fp32."""
    d, h, e, layers = _widths(model_cfg)
    tc = lambda per_edge: (2.0 * 3 * edges * per_edge, 0.0)
    fp32 = lambda per_node: (0.0, 2.0 * n * per_node)
    return {
        "rbf": tc(n_rbf * h),
        "encmlp": tc(h * h + h * e),
        "emlp": tc(layers * (e * h + h * h)),
        "theta": tc(layers * (h * h + h * d)),
        "srcaff": fp32(layers * d * h),
        "nodeops": fp32(layers * (d * h + 2 * d * h + h * d)),
        "decoder": fp32(d * h + h * 3),
    }


def forward_ops(edges, n, n_rbf, model_cfg, bond=False):
    """(tensor-core FLOP, fp32 FLOP) of one forward as mega_forward computes
    it over `edges` live edges and n atoms: stage_ops' products, and on the
    CUDA cores the rank-1 geometric terms (one more with the bond channel)
    and the gated product."""
    d, h, _, layers = _widths(model_cfg)
    stages = stage_ops(edges, n, n_rbf, model_cfg).values()
    return (sum(s[0] for s in stages),
            sum(s[1] for s in stages)
            + 2.0 * edges * ((4 + bond) * h + layers * d))


def ops_ms(tc_flops, fp32_flops):
    """Least ms of tensor-core and fp32 operations: each against its peak,
    the two times added."""
    return (tc_flops / BF16_FLOPS + fp32_flops / FP32_FLOPS) * 1e3


def bytes_ms(nbytes):
    """Least ms of moving `nbytes` through HBM."""
    return nbytes / HBM_BYTES_PER_S * 1e3
