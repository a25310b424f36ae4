"""FIRE energy minimiser, fast inertial relaxation engine (port of
gamd_tpu/physics/minimize.py; Bitzek et al., PRL 97, 170201 (2006)).

run_md's LJ start: the FCC lattice relaxed by 1000 FIRE steps on the LJ
forces before the thermostat takes over. The iteration count is fixed and
the step's scalars (dt, alpha, the count of downhill steps) stay 0-d
tensors on the positions' device, so the loop never waits for the device.
"""

from typing import Callable

import torch


def fire_minimize(force_fn: Callable, pos, n_steps: int = 500,
                  dt_start: float = 0.01, dt_max: float = 0.1,
                  n_min: int = 5, f_inc: float = 1.1, f_dec: float = 0.5,
                  alpha_start: float = 0.1, f_alpha: float = 0.99,
                  max_step: float = 0.1):
    """Minimise a potential by damped dynamics.

    Args:
        force_fn: pos -> force (= -grad E).
        pos: [N, 3] initial positions (a tensor).
        n_steps: fixed iteration count.
        max_step: trust radius, the per-iteration displacement cap per atom
            (angstrom): overlapping starts give 1/r^12 forces that would
            otherwise throw atoms across the box in one step.

    Returns:
        (pos, final_force) after n_steps FIRE iterations.
    """
    scalar = lambda v: torch.tensor(v, dtype=pos.dtype, device=pos.device)
    x = pos
    v = torch.zeros_like(pos)
    dt, alpha = scalar(dt_start), scalar(alpha_start)
    n_pos = torch.zeros((), dtype=torch.int32, device=pos.device)
    for _ in range(n_steps):
        # fp32 LJ forces overflow to inf for near-coincident overlaps;
        # clamp so the capped step still points downhill.
        f = torch.nan_to_num(force_fn(x), nan=0.0, posinf=1e10,
                             neginf=-1e10)
        power = torch.sum(f * v)
        f_norm = torch.sqrt(torch.sum(f * f) + 1e-12)
        v_norm = torch.sqrt(torch.sum(v * v) + 1e-12)
        v_mixed = (1.0 - alpha) * v + alpha * f * (v_norm / f_norm)

        uphill = power < 0.0
        v_new = torch.where(uphill, 0.0, v_mixed)
        grow = ~uphill & (n_pos > n_min)
        n_pos = torch.where(uphill, 0, n_pos + 1)
        dt = torch.where(grow, torch.clamp(dt * f_inc, max=dt_max),
                         torch.where(uphill, dt * f_dec, dt))
        alpha = torch.where(grow, alpha * f_alpha,
                            torch.where(uphill, alpha_start, alpha))

        v = v_new + dt * f
        dx = dt * v
        step_norm = torch.sqrt(torch.sum(dx * dx, dim=-1, keepdim=True))
        dx = dx * torch.clamp(max_step / torch.clamp(step_norm, min=1e-12),
                              max=1.0)
        x = x + dx
    return x, force_fn(x)
