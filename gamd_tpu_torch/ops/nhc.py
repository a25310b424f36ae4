"""The Nose-Hoover chain (NHC) half-step and the probe of the chain alone:
the plain versions of the chain math of gamd_tpu/md/integrators.py::
_nhc_propagate and the wrappers of their Hopper kernels in
csrc/nhc_chain.cu.

* nhc_chain_reference is one half-step of the chain alone (thermostat
  positions xi, velocities vxi and forces g over the n_c * n_ys weighted
  substeps), in _nhc_propagate's update order, batch-polymorphic: chains
  [..., M], ke2 [...].
* nhc_half_step_reference adds what surrounds the chain: ke2 = sum m v^2
  over the atoms (unless it is given; twice_kinetic_energy) before, and
  v * scale after. It is what md.integrators._nhc_propagate computes.
* nhc_half_step is the entry: a CPU tensor runs nhc_half_step_reference; a
  CUDA tensor makes one launch of the kernel (one block per chain) or
  raises. It counts its launches in `nhc_half_step.launches`.
* nhc_chain_probe computes what scripts/probe_nhc_kernel.py's two Pallas
  kernels compute: `reps` chain half-steps with ke2 threaded through the
  square of each half-step's scale, returning the chain, the product of
  the scales and the last ke2. Its plain version is nhc_probe_reference;
  on a CUDA tensor it launches the kernel in its "scalar" form (one thread
  holds the chain) or its "warp" form (lane j holds element j), counted
  in `nhc_chain_probe.launches[form]`. nhc_probe_warp_reference computes
  the same bits in the warp kernel's schedule: a mirror that the tests
  hold against both.
* chain_latency chains one of the chain's dependent steps `reps` times on
  one thread (its plain version chain_latency_reference), so that the
  step's latency can be timed on the card: the price of the chain's
  dependent sequence, the bound that the roofline does not see.

The schedule `wdts` [n_c * n_ys] and the chain masses `q` [M] are float32
tensors that the caller builds (md.integrators.nhc_schedule and nhc_masses
in _nhc_propagate's order; tools/probe_nhc_kernel.py in the probe's).
"""

import ctypes
import math

import torch

from gamd_tpu_torch.ops.mega import _check

#: Longest chain the kernels hold in registers (compile-time NHC_MAX_M).
MAX_CHAIN = 16
#: Forms of nhc_chain_probe's kernel, by their code in the C entry.
FORMS = {"scalar": 0, "warp": 1}
#: Largest grid x of a launch: chains per call.
MAX_CHAINS = 2**31 - 1


def nhc_chain_reference(xi, vxi, g, ke2, q, kt, ndf_kt, wdts):
    """One NHC half-step of the chain alone: (xi, vxi, g, scale) from chains
    [..., M] and ke2 [...] (2 KE of the particles at the start).

    g[0] is reset from ke2 first; the rest of g carries over from the last
    call. The order of every update is _nhc_propagate's
    (gamd_tpu/md/integrators.py:206-229): each chain element is a column
    of [...] tensors, and each weight's multiples 0.25, -0.125 and 0.5 are
    exact, so they round as JAX's float32 products do.
    """
    m = xi.shape[-1]
    xi, vxi, g = list(xi.unbind(-1)), list(vxi.unbind(-1)), list(g.unbind(-1))
    q = q.unbind(0)
    g[0] = (ke2 - ndf_kt) / q[0]
    scale = torch.ones_like(ke2)
    for wdt in wdts.tolist():
        quarter, eighth, half = 0.25 * wdt, -0.125 * wdt, 0.5 * wdt
        vxi[m - 1] = vxi[m - 1] + quarter * g[m - 1]
        for j in range(m - 2, -1, -1):
            aa = torch.exp(eighth * vxi[j + 1])
            vxi[j] = aa * (aa * vxi[j] + quarter * g[j])
        scale = scale * torch.exp(-half * vxi[0])
        xi = [x + half * v for x, v in zip(xi, vxi)]
        g[0] = (scale * scale * ke2 - ndf_kt) / q[0]
        for j in range(m - 1):
            aa = torch.exp(eighth * vxi[j + 1])
            vxi[j] = aa * (aa * vxi[j] + quarter * g[j])
            g[j + 1] = (q[j] * vxi[j] * vxi[j] - kt) / q[j + 1]
        vxi[m - 1] = vxi[m - 1] + quarter * g[m - 1]
    return (torch.stack(xi, -1), torch.stack(vxi, -1), torch.stack(g, -1),
            scale)


def twice_kinetic_energy(vel, masses):
    """ke2 = sum m v^2 over the last two axes of vel [..., N, 3]: the fp32
    products m v v summed in float64 and rounded once to float32, so that
    the kernel's summation order and PyTorch's give the same ke2 (but for
    the rarest rounding ties); the chain's g[0] = (ke2 - ndf kT) / q[0]
    cancels to a few digits, and at large N each digit of ke2 counts."""
    return torch.sum((masses[:, None] * vel * vel).double(),
                     dim=(-2, -1)).to(vel.dtype)


def nhc_half_step_reference(vel, xi, vxi, g, masses, kt, ndf, q, wdts,
                            ke2=None):
    """Plain version of nhc_half_step: (vel * scale, xi, vxi, g)."""
    if ke2 is None:
        ke2 = twice_kinetic_energy(vel, masses)
    xi, vxi, g, scale = nhc_chain_reference(xi, vxi, g, ke2, q, kt,
                                            ndf * kt, wdts)
    return vel * scale[..., None, None], xi, vxi, g


def nhc_probe_reference(xi, vxi, g, ke2, q, kt, ndf, wdts, reps):
    """Plain version of nhc_chain_probe: (xi, vxi, g, product of the
    scales, last ke2) after `reps` chain half-steps, ke2 <- scale^2 ke2
    after each (probe_nhc_kernel.py:80-86)."""
    total = torch.ones_like(ke2)
    for _ in range(reps):
        xi, vxi, g, scale = nhc_chain_reference(xi, vxi, g, ke2, q, kt,
                                                ndf * kt, wdts)
        ke2 = scale * scale * ke2
        total = total * scale
    return xi, vxi, g, total, ke2


def nhc_probe_warp_reference(xi, vxi, g, ke2, q, kt, ndf, wdts, reps):
    """Plain version of nhc_chain_probe's warp form, in its kernel's
    schedule: the chain as [M] vectors, element j in the kernel's lane j.
    Each update of one element is computed on the whole vector and kept
    where the element's mask is set; the neighbour's value comes from the
    vector shifted by one (the kernel's shuffle). The forward sweep's
    M - 1 exponentials are one vector exp taken before the sweep, and the
    scale, ke2 and the product of the scales are element 0's. Every value
    it keeps is nhc_probe_reference's, bit for bit: the same float32
    operations on the same operands, in the same order."""
    m = xi.shape[-1]
    lane = torch.arange(m, device=xi.device)
    ndf_kt = ndf * kt
    q0, q_prev = q[0], torch.cat([q[:1], q[:-1]])

    def down(t):            # element j takes element j + 1 (the last its own)
        return torch.cat([t[1:], t[-1:]])

    def up(t):              # element j takes element j - 1 (the first its own)
        return torch.cat([t[:1], t[:-1]])

    x, v, gg = xi, vxi, g
    total = torch.ones_like(ke2)
    for _ in range(reps):
        gg = torch.where(lane == 0, (ke2 - ndf_kt) / q0, gg)
        scale = torch.ones_like(ke2)
        for wdt in wdts.tolist():
            quarter, eighth, half = 0.25 * wdt, -0.125 * wdt, 0.5 * wdt
            v = torch.where(lane == m - 1, v + quarter * gg, v)
            for j in range(m - 2, -1, -1):
                aa = torch.exp(eighth * down(v))
                v = torch.where(lane == j, aa * (aa * v + quarter * gg), v)
            scale = scale * torch.exp(-half * v[0])
            x = x + half * v
            aa = down(torch.exp(eighth * v))
            gg = torch.where(lane == 0, (scale * scale * ke2 - ndf_kt) / q0,
                             gg)
            for j in range(m - 1):
                v = torch.where(lane == j, aa * (aa * v + quarter * gg), v)
                prev = up(v)
                gg = torch.where(lane == j + 1,
                                 (q_prev * prev * prev - kt) / q, gg)
            v = torch.where(lane == m - 1, v + quarter * gg, v)
        ke2 = scale * scale * ke2
        total = total * scale
    return x, v, gg, total, ke2


def declare(lib):
    """Set argtypes/restype of the library's three NHC entries."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gamd_nhc_half_step.argtypes = [
        p, p, p, p, p, p, p, p,                       # vel m ke2 xi vxi g q w
        i, i, i, i, f, f,                             # r n m n_sub kt ndf_kt
        p, p, p, p, p]                                # outs, stream
    lib.gamd_nhc_half_step.restype = ctypes.c_int
    lib.gamd_nhc_chain_probe.argtypes = [
        p, p, p, p, p, p,                             # xi vxi g ke2 q wdts
        i, i, i, i, f, f,                             # m n_sub reps form kt
        p, p, p, p, p]                                # outs, stream
    lib.gamd_nhc_chain_probe.restype = ctypes.c_int
    lib.gamd_nhc_chain_latency.argtypes = [
        i, i, f, f, f, f, f,                          # op reps x c0..c3
        p, p]                                         # out stream
    lib.gamd_nhc_chain_latency.restype = ctypes.c_int


def _check_chain(fn, xi, vxi, g, q, wdts, lead):
    """The chain's checks on a CUDA device: xi, vxi, g [*lead, M] with
    1 <= M <= MAX_CHAIN, q [M], wdts [S] with S >= 1, all float32 and
    contiguous on xi's device. Returns (M, S)."""
    dev = xi.device
    m = xi.shape[-1] if xi.ndim else 0
    if not 1 <= m <= MAX_CHAIN:
        raise ValueError(f"{fn}: the chain length M={m} must lie in [1, "
                         f"{MAX_CHAIN}]")
    for name, t in (("xi", xi), ("vxi", vxi), ("g", g)):
        _check(fn, name, t, dev, torch.float32, (*lead, m))
    _check(fn, "q", q, dev, torch.float32, (m,))
    s = wdts.shape[0] if isinstance(wdts, torch.Tensor) and wdts.ndim else 0
    if s < 1:
        raise ValueError(f"{fn}: wdts must hold at least one substep")
    _check(fn, "wdts", wdts, dev, torch.float32, (s,))
    return m, s


def _raise_on(fn, err):
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")


def nhc_half_step(vel, xi, vxi, g, masses, kt, ndf, q, wdts, ke2=None):
    """One NHC half-step: (vel * scale, xi, vxi, g), new tensors.

    Args:
        vel: [..., N, 3] float32 velocities; each leading index is one
            system with its own chain.
        xi, vxi, g: [..., M] float32 chain positions, velocities (1/t0) and
            forces (1/t0^2).
        masses: [N] float32 particle masses.
        kt: kB T (kJ/mol); ndf: degrees of freedom.
        q: [M] float32 chain masses; wdts: [n_c * n_ys] float32 weighted
            substeps.
        ke2: optional [...] float32 2 KE; summed from vel when None.

    A CPU `vel` runs nhc_half_step_reference. A CUDA `vel` makes one
    launch of csrc/nhc_chain.cu's nhc_half_step_kernel (one block per
    chain, M <= 16) or raises.
    """
    if vel.device.type == "cpu":
        return nhc_half_step_reference(vel, xi, vxi, g, masses, kt, ndf, q,
                                       wdts, ke2)
    fn = "nhc_half_step"
    if vel.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {vel.device}")
    if vel.ndim < 2 or vel.shape[-1] != 3 or vel.shape[-2] < 1:
        raise ValueError(f"{fn}: vel must be [..., N, 3] with N >= 1; got "
                         f"{tuple(vel.shape)}")
    dev = vel.device
    lead, n = tuple(vel.shape[:-2]), vel.shape[-2]
    r = math.prod(lead)
    if not 1 <= r <= MAX_CHAINS:
        raise ValueError(f"{fn}: {r} chains; at most {MAX_CHAINS}")
    _check(fn, "vel", vel, dev, torch.float32, (*lead, n, 3))
    _check(fn, "masses", masses, dev, torch.float32, (n,))
    m, s = _check_chain(fn, xi, vxi, g, q, wdts, lead)
    if ke2 is not None:
        _check(fn, "ke2", ke2, dev, torch.float32, lead)
    outs = [torch.empty_like(t) for t in (vel, xi, vxi, g)]
    from gamd_tpu_torch.ops.build import load_library
    err = load_library().gamd_nhc_half_step(
        vel.data_ptr(), masses.data_ptr(),
        None if ke2 is None else ke2.data_ptr(), xi.data_ptr(),
        vxi.data_ptr(), g.data_ptr(), q.data_ptr(), wdts.data_ptr(), r, n,
        m, s, float(kt), float(ndf * kt), *[t.data_ptr() for t in outs],
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(fn, err)
    nhc_half_step.launches += 1
    return tuple(outs)


nhc_half_step.launches = 0


def nhc_chain_probe(xi, vxi, g, ke2, q, kt, ndf, wdts, reps, form):
    """`reps` chain half-steps with ke2 threaded through scale^2: (xi, vxi,
    g [M], product of the scales, last ke2), the last two 0-d.

    Args:
        xi, vxi, g: [M] float32 chain state; ke2: 0-d or [1] float32.
        q, wdts, kt, ndf: as nhc_half_step.
        reps: half-steps in the call (>= 1); form: "scalar" or "warp".

    A CPU `xi` runs nhc_probe_reference (both forms compute it). A CUDA
    `xi` makes one launch of csrc/nhc_chain.cu's probe kernel of that form
    or raises.
    """
    fn = "nhc_chain_probe"
    if form not in FORMS:
        raise ValueError(f"{fn}: form must be one of {sorted(FORMS)}, not "
                         f"{form!r}")
    if int(reps) < 1:
        raise ValueError(f"{fn}: reps must be at least 1, not {reps}")
    if xi.device.type == "cpu":
        return nhc_probe_reference(xi, vxi, g, ke2.reshape(()), q, kt, ndf,
                                   wdts, int(reps))
    if xi.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {xi.device}")
    dev = xi.device
    m, s = _check_chain(fn, xi, vxi, g, q, wdts, ())
    _check(fn, "ke2", ke2, dev, torch.float32, tuple(ke2.shape))
    if ke2.numel() != 1:
        raise ValueError(f"{fn}: ke2 must hold one value; got shape "
                         f"{tuple(ke2.shape)}")
    outs = [torch.empty_like(t) for t in (xi, vxi, g)]
    tail = torch.empty(2, device=dev, dtype=torch.float32)
    from gamd_tpu_torch.ops.build import load_library
    err = load_library().gamd_nhc_chain_probe(
        xi.data_ptr(), vxi.data_ptr(), g.data_ptr(), ke2.data_ptr(),
        q.data_ptr(), wdts.data_ptr(), m, s, int(reps), FORMS[form],
        float(kt), float(ndf * kt), *[t.data_ptr() for t in outs],
        tail.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(fn, err)
    nhc_chain_probe.launches[form] += 1
    return (*outs, tail[0], tail[1])


nhc_chain_probe.launches = dict.fromkeys(FORMS, 0)


#: The chain's dependent steps that chain_latency chains: a step of the
#: backward sweep (expf and the kick) and of the forward sweep (the kick
#: and the IEEE division).
LATENCY_OPS = {"backward": 0, "forward": 1}
#: chain_latency's constants: c0 (-wdt/8), c1 (wdt/4), c2 (the force, or
#: the division's denominator), c3 (the damping factor).
LATENCY_CONSTS = (-1.25e-4, 2.5e-4, 1.5, 0.999)


def _latency_step(op, x, c0, c1, c2, c3):
    """One step of chain_latency's `op` on a 0-d float32 x (nhc.cuh's
    operations, each rounded on its own)."""
    if op == "backward":
        a = torch.exp(c0 * x)
        return a * (a * x + c1 * c2)
    v = c3 * (c3 * 1.0 + c1 * x)
    return (v * v - 1.0) / c2


def chain_latency_reference(op, reps, x):
    """Plain version of chain_latency: the last x of `reps` chained
    steps (0-d float32 on x's device)."""
    consts = [torch.tensor(c, dtype=torch.float32, device=x.device)
              for c in LATENCY_CONSTS]
    for _ in range(reps):
        x = _latency_step(op, x, *consts)
    return x


def chain_latency(op, reps, x):
    """`reps` steps of the chain's dependent step `op` (LATENCY_OPS) on one
    thread, each waiting on the last, from the 0-d float32 x with the
    constants LATENCY_CONSTS: the last x (0-d). Timed on the card, reps
    steps give the step's latency (tools/probe_nhc_kernel.py::
    chain_bound).

    A CPU x runs chain_latency_reference. A CUDA x makes one launch of
    csrc/nhc_chain.cu's chain_latency_kernel or raises."""
    fn = "chain_latency"
    if op not in LATENCY_OPS:
        raise ValueError(f"{fn}: op must be one of {sorted(LATENCY_OPS)}, "
                         f"not {op!r}")
    if int(reps) < 1:
        raise ValueError(f"{fn}: reps must be at least 1, not {reps}")
    if x.device.type == "cpu":
        return chain_latency_reference(op, int(reps), x)
    if x.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {x.device}")
    out = torch.empty(1, device=x.device, dtype=torch.float32)
    from gamd_tpu_torch.ops.build import load_library
    err = load_library().gamd_nhc_chain_latency(
        LATENCY_OPS[op], int(reps), float(x), *LATENCY_CONSTS,
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(fn, err)
    return out[0]
