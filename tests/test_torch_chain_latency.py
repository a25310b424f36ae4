"""The chain's latency probe on the CPU (ops/nhc.py::chain_latency, whose
CPU path is its plain version chain_latency_reference): each chained step
against a float32 numpy transcription of nhc.cuh's operations, bit for
bit; the refusals; and tools/probe_nhc_kernel.py on the CPU, which has no
chain bound to give (the latency is timed on the card only). The kernel
itself is held against this plain version and timed on the card by
tools/probe_nhc_kernel.py::chain_bound (chip_smoke.py phase 19).
"""

import numpy as np
import pytest
import torch

from gamd_tpu_torch.ops import nhc
from gamd_tpu_torch.tools import probe_nhc_kernel


def _numpy_step(op, x):
    """One step of `op` in float32 numpy, each operation rounded on its
    own, as nhc.cuh's nhc_mul, nhc_add, nhc_sub and nhc_div."""
    c0, c1, c2, c3 = [np.float32(c) for c in nhc.LATENCY_CONSTS]
    f = np.float32
    if op == "backward":
        a = f(np.exp(f(c0 * x)))
        return f(a * f(f(a * x) + f(c1 * c2)))
    v = f(c3 * f(f(c3 * f(1.0)) + f(c1 * x)))
    return f(f(f(v * v) - f(1.0)) / c2)


@pytest.mark.parametrize("op", list(nhc.LATENCY_OPS))
def test_chain_latency_plain_version_chains_its_step(op):
    """chain_latency on a CPU tensor: 5 chained steps of `op` from x,
    equal to the numpy transcription; within 8 ulps where the step takes
    an exponential, which numpy and PyTorch may round differently in the
    last bit, bit for bit where it does not."""
    x0 = 0.5
    got = nhc.chain_latency(op, 5, torch.tensor(x0))
    want = np.float32(x0)
    for _ in range(5):
        want = _numpy_step(op, want)
    assert got.dtype == torch.float32 and got.ndim == 0
    ulp = abs(float(np.spacing(np.float32(want))))
    assert abs(float(got) - float(want)) <= 8 * ulp
    if op == "forward":
        assert float(got) == float(want)


def test_chain_latency_refusals():
    with pytest.raises(ValueError, match="op must be one of"):
        nhc.chain_latency("expf", 4, torch.tensor(0.5))
    with pytest.raises(ValueError, match="reps"):
        nhc.chain_latency("forward", 0, torch.tensor(0.5))
    with pytest.raises(ValueError, match="cuda or cpu"):
        nhc.chain_latency("forward", 4, torch.tensor(0.5, device="meta"))


def test_probe_on_the_cpu_gives_no_chain_bound():
    """probe_nhc_kernel --cpu: both forms' parity, no times and no chain
    bound (a latency is a device number)."""
    results = probe_nhc_kernel.main(["--cpu", "--reps", "3"])
    assert set(results) == set(nhc.FORMS)
    assert all(r["us_per_half_step"] is None for r in results.values())
