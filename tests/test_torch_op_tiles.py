"""Port parity of the op library's conv message and conv layer in their
kernels' arithmetic on the CPU (rows 8 and 7 of the port's kernel table:
csrc/conv_msg.cu and csrc/conv_layer.cu over csrc/conv_tc.cuh's live-edge
tiles): the plain versions with their four edge products as bf16 x 3
(ops/mega.py::split_bf16_matmul put in the place of ops/message.py::
_edge_mm), held against JAX's fp32 references and the port's fp32 plain
versions, row 7 with ids out of range in live and masked slots; and the
node update's block choice (ops/message.py::update_atoms). The CUDA
kernels themselves are held against their plain versions in
tests/test_torch_cuda.py and chip_smoke.py, on the card.
"""

import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.ops import pallas_mp as jmp

from gamd_tpu_torch.ops import mega, message

W = 128
#: max |d| / scale of the kernels' arithmetic against the fp32 function,
#: scale max |agg| (row 8) or std(out) (row 7): the card's tolerance of
#: rows 7 and 8 (chip_smoke.py CONV_RTOL).
CONV_RTOL = 1e-4
#: Ids out of range as JAX's indexing reads them: from the end, then
#: clamped into [0, N).
WILD = (-1, -7, 10 ** 6, -10 ** 6)


def _inputs(n, k, seed):
    """Seeded inputs [N, K, .] of both entries: e, idx, mask (an atom with
    no live slot, one with all K live), h, hn, src_nodes, dst_code and the
    14 layer weights."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)
    mask = rng.random((n, k)) < 0.6
    mask[1], mask[2] = False, True
    x = dict(e=f(n, k, W, scale=0.3),
             idx=rng.integers(0, n, (n, k)).astype(np.int32), mask=mask,
             h=f(n, W, scale=0.5), hn=f(n, W, scale=0.5),
             src_nodes=f(n, W, scale=0.5), dst_code=f(n, W, scale=0.3))
    ws = [f(W, scale=0.08) if name.startswith("b") else f(W, W, scale=0.08)
          for name in message.LAYER_WEIGHTS]
    return x, ws


def _wild(x, n):
    """x with ids out of range (negative, N and past it, far past either
    end) in every masked slot and every third live one."""
    idx, mask = x["idx"].copy(), x["mask"]
    pick = ~mask | (np.arange(idx.size).reshape(idx.shape) % 3 == 0)
    wild = np.array([*WILD, -n, -n - 1, n, n + 3], np.int32)
    idx[pick] = np.resize(wild, int(pick.sum()))
    assert (idx[mask] < 0).any() and (idx[mask] >= n).any()
    assert (idx[~mask] < 0).any() and (idx[~mask] >= n).any()
    return {**x, "idx": idx}


def _one_pass(a, w):
    return a.bfloat16().float() @ w.bfloat16().float()


def _three_ways(monkeypatch, fn):
    """fn() with the plain versions' edge products in fp32, single-pass
    bf16 and the kernels' bf16 x 3: (fp32, one pass, bf16 x 3)."""
    fp32 = fn()
    with monkeypatch.context() as mp:
        mp.setattr(message, "_edge_mm", _one_pass)
        one = fn()
    with monkeypatch.context() as mp:
        mp.setattr(message, "_edge_mm", mega.split_bf16_matmul)
        split = fn()
    return fp32, one, split


def _hold(got, fp32, jax_fp32, one_pass, scale):
    """got (the kernels' arithmetic) within CONV_RTOL x scale of the port's
    and JAX's fp32 plain versions, and at least 100 times closer to them
    than single-pass bf16 products: the lo parts are live."""
    err = float((got - fp32).abs().max())
    assert err <= CONV_RTOL * scale, (err, scale)
    jax_err = float((got - torch.as_tensor(np.array(jax_fp32))).abs().max())
    assert jax_err <= CONV_RTOL * scale, (jax_err, scale)
    assert err * 100 < float((one_pass - fp32).abs().max())


@pytest.mark.parametrize("n,k,seed", [(66, 20, 0), (40, 33, 1)])
def test_conv_message_in_kernel_arithmetic_matches_jax(monkeypatch, n, k,
                                                       seed):
    """Row 8: fused_conv_message's plain version on rows gathered
    beforehand (h_src = hn[idx], src_code = src[idx]) with its four edge
    products as bf16 x 3, against JAX's _conv_msg_reference
    (pallas_mp.py:308) and the port's fp32 plain version, within CONV_RTOL
    of max |agg|."""
    x, ws = _inputs(n, k, seed)
    h_src, src_code = x["hn"][x["idx"]], x["src_nodes"][x["idx"]]
    args = (x["e"], h_src, src_code, x["dst_code"], x["mask"], *ws[:8])
    targs = [torch.as_tensor(a) for a in args]
    before = message.fused_conv_message.launches
    fp32, one, split = _three_ways(
        monkeypatch, lambda: message.fused_conv_message(*targs))
    assert message.fused_conv_message.launches == before
    want = jmp._conv_msg_reference(*[jnp.asarray(a) for a in args])
    _hold(split, fp32, want, one, float(fp32.abs().max()))


@pytest.mark.parametrize("n,k,seed", [(66, 20, 2), (40, 33, 3)])
def test_conv_layer_in_kernel_arithmetic_matches_jax(monkeypatch, n, k,
                                                     seed):
    """Row 7: fused_conv_layer's plain version with its four edge products
    as bf16 x 3 (the node update's three stay fp32, as in the kernel), ids
    out of range in live and masked slots, against JAX's
    _conv_layer_reference (pallas_mp.py:841) and the port's fp32 plain
    version, within CONV_RTOL of std(out)."""
    x, ws = _inputs(n, k, seed)
    x = _wild(x, n)
    names = ("e", "idx", "mask", "h", "hn", "src_nodes", "dst_code")
    t = [torch.as_tensor(x[name]) for name in names]
    tws = tuple(torch.as_tensor(w) for w in ws)
    before = message.fused_conv_layer.launches
    fp32, one, split = _three_ways(
        monkeypatch, lambda: message.fused_conv_layer(*t, tws))
    assert message.fused_conv_layer.launches == before
    want = jmp._conv_layer_reference(*[jnp.asarray(x[name])
                                       for name in names],
                                     tuple(jnp.asarray(w) for w in ws))
    assert bool(torch.isfinite(split).all())
    _hold(split, fp32, want, one, float(fp32.std()))


def test_edge_product_hook_is_plain_fp32():
    """The hook's default is a @ w: the CPU path is the fp32 function."""
    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.standard_normal((3, 4, W)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((W, W)).astype(np.float32))
    assert torch.equal(message._edge_mm(a, w), a @ w)


# -- the node update's block choice -------------------------------------------

def test_update_block_at_the_op_library_shape():
    """N=258 on an H100's 132 SMs: 4 atoms a block, 65 blocks."""
    b = message.update_atoms(258, 132)
    assert b == 4 and -(-258 // b) == 65


@pytest.mark.parametrize("sms", [132, 114])
def test_update_grid_is_one_wave_up_to_what_16_atoms_cover(sms):
    """For every N up to 16 x SMs the grid of ceil(N / B) blocks fits in
    one wave, and B is the smallest of 4, 8, 16 that fits; past it B stays
    16."""
    most = message.UPDATE_MAX_ATOMS * sms
    for n in range(1, most + 1):
        b = message.update_atoms(n, sms)
        assert b in (4, 8, 16) and -(-n // b) <= sms, n
        assert b == 4 or -(-n // (b // 2)) > sms, n
    for n in (most + 1, 10 * most):
        assert message.update_atoms(n, sms) == 16
