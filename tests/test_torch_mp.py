"""Port parity of the message-passing op library (gamd_tpu_torch/ops/
message.py and ops/aggregate.py) on the CPU: each entry point against the
JAX package's fp32 reference and its Pallas kernel (interpret mode, as
tests/test_ops.py runs it) on the same inputs (made with numpy from a
seed), the gradients against jax.grad through JAX's custom_vjp, masked
slots holding NaN or ids out of range, a bf16 `e`, the refusals, and
GAMDNet's forward with every conv layer through each form of the library
(tools/op_library.py) against JAX's GAMDNet. The CUDA kernels themselves
are held against their plain versions in tests/test_torch_cuda.py and
chip_smoke.py, on the card."""

import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gamd_tpu.ops as jops
from gamd_tpu.core.config import ModelConfig as JModelConfig
from gamd_tpu.models.gnn import GAMDNet as JGAMDNet
from gamd_tpu.neighbors.dense import dense_neighbor_list as jdense
from gamd_tpu.ops import pallas_mp as jmp
from gamd_tpu.ops.aggregate import gather_multiply_aggregate as jgather_agg

import gamd_tpu_torch.ops as tops
from gamd_tpu_torch.core.config import ModelConfig
from gamd_tpu_torch.models.gnn import GAMDNet
from gamd_tpu_torch.ops import message
from gamd_tpu_torch.ops.aggregate import (gather_index,
                                          gather_multiply_aggregate)
from gamd_tpu_torch.tools import op_library
from gamd_tpu_torch.train.state import params_from_jax

WIDTH = 128
OPS = ("gather_agg", "edge_mlp_agg", "conv_msg", "conv_layer")
#: Per op: (port entry, its plain version, JAX fp32 reference, JAX Pallas
#: entry, the Pallas entry's tile_n at n=20, tests/test_ops.py's tolerance
#: for it). JAX's gather-agg and edge-MLP entries need n % tile_n == 0.
ENTRIES = {
    "gather_agg": (message.pallas_gather_multiply_aggregate,
                   gather_multiply_aggregate, jgather_agg,
                   jmp.pallas_gather_multiply_aggregate, 4, 1e-4),
    "edge_mlp_agg": (message.fused_edge_mlp_aggregate,
                     message._fused_reference, jmp._fused_reference,
                     jmp.fused_edge_mlp_aggregate, 4, 2e-3),
    "conv_msg": (message.fused_conv_message, message._conv_msg_reference,
                 jmp._conv_msg_reference, jmp.fused_conv_message, 8, 0.05),
    "conv_layer": (message.fused_conv_layer, message._conv_layer_plain,
                   jmp._conv_layer_reference, jmp.fused_conv_layer, 8,
                   0.05),
}
#: The inputs each op's masked slots may hold anything in (NaN here).
PER_SLOT = {"gather_agg": ("e",), "edge_mlp_agg": ("edge_pre", "h_src"),
            "conv_msg": ("e", "h_src", "src_code"), "conv_layer": ("e",)}


def _case(op, n, k, seed):
    """The named inputs of `op` in its argument order, numpy, drawn as
    tests/test_ops.py draws them (widths 128; fused_conv_layer's 14
    weights last)."""
    rng = np.random.RandomState(seed)
    w = WIDTH
    f = lambda *s, scale: (rng.randn(*s) * scale).astype(np.float32)
    idx = rng.randint(0, n, (n, k)).astype(np.int32)
    mask = rng.rand(n, k) > 0.3

    def weights(names, scale):
        return {name: f(w, scale=scale) if name.startswith("b")
                else f(w, w, scale=scale) for name in names}

    if op == "gather_agg":
        return dict(h=f(n, w, scale=1.0), e=f(n, k, w, scale=1.0), idx=idx,
                    mask=mask)
    if op == "edge_mlp_agg":
        return dict(edge_pre=f(n, k, w, scale=1.0),
                    h_src=f(n, k, w, scale=1.0), mask=mask,
                    **weights(("w1", "b1", "w2", "b2"), 0.1))
    if op == "conv_msg":
        return dict(e=f(n, k, w, scale=0.3), h_src=f(n, k, w, scale=0.3),
                    src_code=f(n, k, w, scale=0.3),
                    dst_code=f(n, w, scale=0.3), mask=mask,
                    **weights(message.CONV_WEIGHTS, 0.08))
    return dict(e=f(n, k, w, scale=0.3), idx=idx, mask=mask,
                h=f(n, w, scale=0.5), hn=f(n, w, scale=0.5),
                src_nodes=f(n, w, scale=0.5), dst_code=f(n, w, scale=0.3),
                **weights(message.LAYER_WEIGHTS, 0.08))


def _call(fn, op, args, *extra):
    """fn on the named args in order; fused_conv_layer's weights as one
    tuple, then `extra` (JAX's tile_n and interpret)."""
    vals = list(args.values())
    if op == "conv_layer":
        return fn(*vals[:7], tuple(vals[7:]), *extra)
    return fn(*vals, *extra)


def _torch(args):
    return {name: torch.as_tensor(a) for name, a in args.items()}


def _jax(args):
    return {name: jnp.asarray(a) for name, a in args.items()}


def _port_plain(op, args):
    """The port entry on CPU tensors (its plain version), as numpy."""
    return _call(ENTRIES[op][0], op, _torch(args)).numpy()


def _assert_rel(actual, expected, rel, name=""):
    """max |a - b| <= rel * max |b|."""
    a, b = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= rel * scale, f"{name}: max |d| {err} > {rel} * {scale}"


@pytest.mark.parametrize("against", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("op", OPS)
def test_entry_matches_jax(op, against):
    """n=20 (no multiple of the TPU tiles), k=8, widths 128: within 1e-5 of
    max |out| of JAX's fp32 reference; against the Pallas entry in
    interpret mode at tests/test_ops.py's tolerance for it (bf16 products
    in rows 7-8)."""
    args = _case(op, 20, 8, seed=OPS.index(op))
    out = _port_plain(op, args)
    assert out.shape == (20, WIDTH) and np.isfinite(out).all()
    _, _, jref, jpallas, tile_n, tol = ENTRIES[op]
    if against == "reference":
        _assert_rel(out, _call(jref, op, _jax(args)), 1e-5, op)
    else:
        want = _call(jpallas, op, _jax(args), tile_n, True)
        np.testing.assert_allclose(out, np.asarray(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("against", ["reference", "pallas_interpret"])
def test_conv_layer_takes_a_bf16_e(against):
    """A bf16 e into fused_conv_layer is cast to float32 first, as JAX's
    reference does (pallas_mp.py:844): the same rounded values on both
    sides give JAX's output within 1e-5 of max (its Pallas entry, which
    feeds the bf16 e to the kernel, at 0.05); the gradient of e comes back
    in bf16."""
    args = _case("conv_layer", 20, 8, seed=9)
    e32 = torch.as_tensor(args["e"])
    targs = {**_torch(args), "e": e32.to(torch.bfloat16).requires_grad_()}
    out = _call(message.fused_conv_layer, "conv_layer", targs)
    jargs = {**_jax(args), "e": jnp.asarray(args["e"]).astype(jnp.bfloat16)}
    np.testing.assert_array_equal(
        targs["e"].detach().float().numpy(),
        np.asarray(jargs["e"].astype(jnp.float32)))
    if against == "reference":
        _assert_rel(out.detach().numpy(),
                    _call(jmp._conv_layer_reference, "conv_layer", jargs),
                    1e-5)
    else:
        want = _call(jmp.fused_conv_layer, "conv_layer", jargs, 8, True)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   rtol=0.05, atol=0.05)
    out.sum().backward()
    assert targs["e"].grad.dtype == torch.bfloat16


@pytest.mark.parametrize("op", OPS[1:])
def test_gradients_match_jax_custom_vjp(op):
    """n=8, k=4: the port's gradients of sum(out * G), G a seeded
    cotangent, for every differentiable argument, against jax.grad through
    the JAX entry (its custom_vjp: the Pallas forward in interpret mode,
    the backward through the reference), within 1e-4 of each gradient's
    max."""
    args = _case(op, 8, 4, seed=20 + OPS.index(op))
    g = np.random.RandomState(5).randn(8, WIDTH).astype(np.float32)
    diff = [name for name in args if name not in ("idx", "mask")]
    tleaves = {name: torch.as_tensor(args[name]).requires_grad_()
               for name in diff}
    out = _call(ENTRIES[op][0], op, {**_torch(args), **tleaves})
    torch.sum(out * torch.as_tensor(g)).backward()

    jbase = _jax(args)
    jpallas, tile_n = ENTRIES[op][3], ENTRIES[op][4]

    def loss(leaves):
        return jnp.sum(_call(jpallas, op, {**jbase, **leaves}, tile_n, True)
                       * g)

    want = jax.grad(loss)({name: jbase[name] for name in diff})
    for name in diff:
        _assert_rel(tleaves[name].grad.numpy(), want[name], 1e-4, name)


@pytest.mark.parametrize("op", OPS[1:])
def test_kernel_function_backward_is_autograd_through_plain(op):
    """KernelFunction's plumbing on the CPU, its launch replaced by the
    plain version: the forward and every gradient equal autograd through
    the plain version bit for bit; idx and mask get none."""
    args = _case(op, 8, 4, seed=30 + OPS.index(op))
    plain = ENTRIES[op][1]
    diff = [name for name in args if name not in ("idx", "mask")]
    runs = []
    for through_function in (True, False):
        leaves = {name: torch.as_tensor(args[name]).requires_grad_()
                  for name in diff}
        vals = list({**_torch(args), **leaves}.values())
        out = (message.KernelFunction.apply(plain, plain, *vals)
               if through_function else plain(*vals))
        torch.sum(out * torch.cos(out)).backward()
        runs.append((out.detach(), [leaves[name].grad for name in diff]))
    (out_f, grads_f), (out_p, grads_p) = runs
    assert torch.equal(out_f, out_p)
    for name, a, b in zip(diff, grads_f, grads_p):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("op", OPS)
def test_masked_slots_add_exactly_zero(op):
    """Masked slots holding NaN (in e, edge_pre, h_src, src_code or the
    gate) and, where ids are gathered, ids out of range (negative, past N,
    far past): the output equals the port's on clean inputs bit for bit,
    and JAX's reference on the same inputs (its jnp.where, its index
    rule) within 1e-5 of max."""
    args = _case(op, 20, 8, seed=40 + OPS.index(op))
    mask = args["mask"]
    dirty = {name: a.copy() for name, a in args.items()}
    for name in PER_SLOT[op]:
        dirty[name][~mask] = np.nan
    if "idx" in dirty:
        wild = np.array([-1, -20, -21, 20, 10 ** 6, -10 ** 6], np.int32)
        dirty["idx"][~mask] = np.resize(wild, int((~mask).sum()))
    out = _port_plain(op, dirty)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, _port_plain(op, args))
    want = np.asarray(_call(ENTRIES[op][2], op, _jax(dirty)))
    assert np.isfinite(want).all()
    _assert_rel(out, want, 1e-5, op)


def test_gather_index_reads_ids_as_jax_indexing():
    """Every id from -45 to 44 against a 20-row table gathers the row that
    JAX's h[idx] gathers."""
    h = np.arange(20, dtype=np.float32)[:, None] * np.ones((1, 3),
                                                          np.float32)
    ids = np.arange(-45, 45, dtype=np.int32).reshape(9, 10)
    got = torch.as_tensor(h)[gather_index(torch.as_tensor(ids), 20)]
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.asarray(h)[ids]))


def test_gather_agg_has_no_gradient_as_in_jax():
    """pallas_gather_multiply_aggregate refuses inputs that require grad
    while grad mode is on, as jax.grad through the JAX entry fails (no
    VJP); without grad mode, or through gather_multiply_aggregate, it
    computes."""
    args = _case("gather_agg", 8, 4, seed=50)
    h, e, idx, mask = _torch(args).values()
    with pytest.raises(ValueError, match="no gradient"):
        message.pallas_gather_multiply_aggregate(h.requires_grad_(), e, idx,
                                                 mask)
    with pytest.raises(ValueError, match="no gradient"):
        message.pallas_gather_multiply_aggregate(
            h.detach(), e.requires_grad_(), idx, mask)
    with torch.no_grad():
        out = message.pallas_gather_multiply_aggregate(h, e, idx, mask)
    gather_multiply_aggregate(h, e, idx, mask).sum().backward()
    assert h.grad is not None and out.shape == (8, WIDTH)
    jargs = _jax(args)
    with pytest.raises(ValueError):
        jax.grad(lambda x: jnp.sum(jmp.pallas_gather_multiply_aggregate(
            x, jargs["e"], jargs["idx"], jargs["mask"], 8, True)))(
                jargs["h"])


@pytest.mark.parametrize("op", OPS)
def test_kernel_checks_refuse_what_the_kernels_do_not_take(op):
    """check_inputs, which every entry runs on a CUDA tensor before its
    launch, here on CPU tensors: the MLP kernels refuse a width other than
    128 (gather_agg takes any D), int64 ids and a non-contiguous input."""
    args = _torch(_case(op, 8, 4, seed=60))
    fn = f"entry {op}"
    cpu = torch.device("cpu")
    message.check_inputs(fn, cpu, **args)
    first = next(iter(args))
    narrow = {**args, first: args[first][..., :64].contiguous()}
    if op == "gather_agg":
        narrow["e"] = args["e"][..., :64].contiguous()
        message.check_inputs(fn, cpu, width=64, **narrow)
    else:
        with pytest.raises(ValueError, match=f": {first} must"):
            message.check_inputs(fn, cpu, **narrow)
    with pytest.raises(ValueError, match=": mask must"):
        message.check_inputs(fn, cpu, **{**args,
                                         "mask": args["mask"].int()})
    if "idx" in args:
        with pytest.raises(ValueError, match=": idx must"):
            message.check_inputs(fn, cpu, **{**args,
                                             "idx": args["idx"].long()})
    strided = args[first].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match=f": {first} must"):
        message.check_inputs(fn, cpu, **{**args, first: strided})


def test_conv_layer_refuses_a_weights_tuple_of_another_length():
    args = _torch(_case("conv_layer", 8, 4, seed=61))
    vals = list(args.values())
    with pytest.raises(ValueError, match="14-tuple"):
        message.fused_conv_layer(*vals[:7], tuple(vals[7:-1]))


def test_ops_package_exports_as_jax():
    assert tops.__all__ == jops.__all__
    assert tops.gather_multiply_aggregate is gather_multiply_aggregate
    assert tops.pallas_gather_multiply_aggregate \
        is message.pallas_gather_multiply_aggregate


def test_op_library_forms_match_jax_gamdnet():
    """GAMDNet (n=20 in a 10 A box, K=8, widths 128, 2 LayerNorm layers)
    with every conv layer through each form of the op library: the forces
    of JAX's GAMDNet on the same weights within 1e-5 of max |F|."""
    kw = dict(encoding_size=WIDTH, hidden_dim=WIDTH,
              edge_embedding_dim=WIDTH, conv_layers=2)
    n, box = 20, 10.0
    pos = np.random.RandomState(70).uniform(0, box, (n, 3)).astype(
        np.float32)
    idx, mask, _ = jdense(jnp.asarray(pos), box, 4.0, 8)
    jmodel = JGAMDNet(cfg=JModelConfig(**kw))
    variables = jmodel.init(jax.random.PRNGKey(3), pos[None], idx[None],
                            mask[None], box, 2.0, 0.8)
    want = np.asarray(jmodel.apply(variables, pos[None], idx[None],
                                   mask[None], box, 2.0, 0.8))[0]
    model = GAMDNet(ModelConfig(**kw)).load_params(
        params_from_jax(variables["params"]))
    tidx, tmask = torch.as_tensor(np.array(idx)), torch.as_tensor(
        np.array(mask))
    for form in op_library.FORMS:
        got = op_library.forward(model, torch.as_tensor(pos), tidx, tmask,
                                 box, 2.0, 0.8, form)
        _assert_rel(got.numpy(), want, 1e-5, form)
    with pytest.raises(ValueError, match="form"):
        op_library.forward(model, torch.as_tensor(pos), tidx, tmask, box,
                           2.0, 0.8, "unfused")
