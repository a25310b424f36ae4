"""The CUDA kernel mega_forward against its plain PyTorch version, on a
Hopper card (capability 9.x). Without one every test here skips.

On the card (which has no JAX) run this file without the JAX package's
conftest:  python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py
"""

import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import numpy as np
import pytest
import torch

from gamd_tpu_torch.core.config import ModelConfig, get_preset
from gamd_tpu_torch.neighbors.dense import dense_neighbor_list
from gamd_tpu_torch.ops.mega import mega_forward, pack_params, \
    reference_forward
from gamd_tpu_torch.train.state import init_params

BOX = 12.0
TOLERANCE = 5e-3      # max |dF| / std(F), the reference's fp32 tolerance


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device of capability 9.x (H100)")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("the kernel is built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, n, k, use_ln=True, layers=2, seed=0):
    cfg = ModelConfig(conv_layers=layers, use_layer_norm=use_ln)
    system = get_preset("lj", n_atoms=n, box=BOX, cutoff=4.2,
                        nbr_capacity=k, skin=0.8)
    state = init_params(cfg, system, seed=seed)
    bs = state.batch_stats
    if not use_ln:
        rng = np.random.default_rng(seed)
        for stats in bs["graph_conv"].values():
            stats["mean"] += rng.uniform(-0.2, 0.2, stats["mean"].shape)
            stats["var"] += rng.uniform(0.1, 0.5, stats["var"].shape)
    mp = pack_params(state.params, cfg, batch_stats=bs, force_std=2.0,
                     force_mean=0.1, unit=0.1, device=dev)
    pos = torch.as_tensor(np.random.default_rng(seed + 1).uniform(
        0, BOX, (n, 3)).astype(np.float32), device=dev)
    idx, mask, _ = dense_neighbor_list(pos, BOX, 5.0, k)
    h0 = torch.as_tensor(state.params["node_emb"], device=dev).expand(
        n, cfg.encoding_size).contiguous()
    return (pos, idx, mask, h0, mp, BOX, 4.2, 4.0, 1.2)


@pytest.mark.parametrize("n,k,use_ln,flip", [
    (64, 16, True, False),     # one edge chunk, full node blocks
    (66, 20, True, True),      # ragged edge chunk and node block, flip_dir
    (64, 16, False, False),    # BatchNorm folded into the node affine
])
def test_kernel_matches_plain_version(cuda, n, k, use_ln, flip):
    args = _case(cuda, n, k, use_ln=use_ln)
    before = mega_forward.launches
    out = mega_forward(*args, use_ln=use_ln, flip_dir=flip)
    ref = reference_forward(*args, use_ln=use_ln, flip_dir=flip)
    torch.cuda.synchronize()
    assert mega_forward.launches == before + 1
    assert out.shape == (n, 3) and bool(torch.isfinite(out).all())
    err = float((out - ref).abs().max())
    assert err < TOLERANCE * float(ref.abs().std())


def test_kernel_rejects_what_it_does_not_take(cuda):
    pos, idx, mask, h0, mp, *rest = _case(cuda, 64, 16)
    before = mega_forward.launches
    with pytest.raises(ValueError, match="idx"):
        mega_forward(pos, idx.long(), mask, h0, mp, *rest)
    with pytest.raises(ValueError, match="pos"):
        mega_forward(pos.t().contiguous().t(), idx, mask, h0, mp, *rest)
    with pytest.raises(ValueError, match="h0"):
        mega_forward(pos, idx, mask, h0[:, :64].contiguous(), mp, *rest)
    with pytest.raises(NotImplementedError):
        mega_forward(pos, idx, mask, h0, mp, *rest,
                     bond=torch.zeros_like(mask, dtype=torch.float32))
    assert mega_forward.launches == before
