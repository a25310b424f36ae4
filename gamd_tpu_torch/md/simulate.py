"""GNN-driven MD loop on torch (port of gamd_tpu/md/simulate.py: Thermo,
RunResult and Simulation for the Langevin integrator, with run and
run_segmented).

A run is a loop over chunks: each chunk rebuilds the padded neighbour list
at cutoff + skin (the dense search, or the cell list for large N), draws
the chunk's thermostat noise in one call, and advances `rebuild_every`
BAOAB steps reusing the list (Verlet-skin reuse; the true-cutoff mask is
redone every force call, in the force kernel when the force function
`handles_refresh`). With a `megastep_fn` a chunk is one
call of it instead (GNNForceField.megastep_fn: the whole window in one
CUDA library call), seeded from the state's generator on the device.
Capacity overflow is OR-ed on the device and read on the host once per
run.
"""

import math
from typing import Callable, NamedTuple, Optional

import torch

from gamd_tpu_torch.core import space, units
from gamd_tpu_torch.core.config import MDConfig, SystemConfig
from gamd_tpu_torch.core.device import resolve_device
from gamd_tpu_torch.md import integrators as integ
from gamd_tpu_torch.neighbors import dense
from gamd_tpu_torch.neighbors.cell_list import cell_list_neighbor_list


class Thermo(NamedTuple):
    """Per-step thermodynamic log."""

    kinetic_energy: torch.Tensor   # [steps] kJ/mol
    temperature: torch.Tensor      # [steps] K


class RunResult(NamedTuple):
    state: integ.LangevinState     # final integrator state
    thermo: Thermo
    overflow: bool                 # neighbour capacity exceeded at a rebuild
    positions: torch.Tensor = None  # [n_chunks, N, 3] wrapped, one per chunk


class Simulation:
    """Langevin MD of a periodic particle system with a given force model.

    Args:
        force_fn: (pos_wrapped [N,3], idx [N,K] int32, mask [N,K] bool) ->
            force [N,3] in kJ/mol/A, e.g. GNNForceField.force_fn(...).
        system: SystemConfig (box, cutoff, skin, capacity, masses).
        md: MDConfig (integrator, dt, thermostat, rebuild cadence, seed).
        nbr_method: "dense" (all-pairs search) or "cell" (the cell list,
            for large N; the box must be at least 3 build radii wide).
        k_model: keep the nearest k_model slots of each built list; if a
            dropped slot is live at build time the run reports overflow.
        megastep_fn: a fused window, (pos, vel, force, idx, mask, seed, *,
            n_steps, c1, hdt, c2col, masses) -> (pos, vel, force, ke), e.g.
            GNNForceField.megastep_fn(); Langevin only. force_fn then gives
            the initial force only.
        device: where the state lives; "cuda" unless the caller asks for
            the CPU.
    """

    def __init__(self, force_fn: Callable, system: SystemConfig,
                 md: MDConfig, nbr_method: str = "dense",
                 k_model: Optional[int] = None, megastep_fn=None,
                 device="cuda"):
        if system.box is None:
            raise ValueError("Simulation requires a fixed box")
        if nbr_method not in ("dense", "cell"):
            raise ValueError(f"unknown neighbor method {nbr_method!r}")
        if megastep_fn is not None and md.integrator != "langevin":
            raise ValueError("megastep_fn supports the langevin integrator "
                             f"only, not {md.integrator!r}")
        if md.integrator != "langevin":
            raise NotImplementedError(
                f"integrator {md.integrator!r}: the port runs 'langevin' so "
                "far; the others come with a later slice")
        self.device = resolve_device(device)
        self.force_fn = force_fn
        self.system = system
        self.md = md
        self.nbr_method = nbr_method
        self.k_model = k_model
        self.masses = torch.as_tensor(system.atom_masses(),
                                      device=self.device)
        self.dt = md.dt_fs * units.FS
        self.ndf = 3 * system.n_atoms
        self.friction = md.friction_per_ps / units.PS
        self.megastep_fn = megastep_fn
        if megastep_fn is not None:
            self._window_constants = self._baoab_constants()

    def _baoab_constants(self):
        """(c1, half dt, per-atom noise amplitude [N]) of a BAOAB step."""
        c1 = math.exp(-self.friction * self.dt)
        b = math.sqrt(1.0 - math.exp(-2.0 * self.friction * self.dt))
        sigma = torch.sqrt(units.KB * self.md.temperature / self.masses)
        return c1, 0.5 * self.dt, b * sigma

    # -- neighbour plumbing -------------------------------------------------

    def _build_nbrs(self, pos):
        sysc = self.system
        if self.nbr_method == "dense":
            return dense.build_nbrs(pos, sysc, self.k_model)
        idx, mask, ovf = cell_list_neighbor_list(
            pos, float(sysc.box), float(sysc.cutoff + sysc.skin),
            sysc.nbr_capacity)
        return dense.keep_nearest(idx, mask, ovf, self.k_model)

    def _force_with(self, idx, mask):
        box = self.system.box
        if getattr(self.force_fn, "handles_refresh", False):
            # The force kernel redoes the true-cutoff mask itself: pass the
            # raw build-time mask.
            def force(pos):
                return self.force_fn(space.wrap(pos, box), idx, mask)
            return force

        def force(pos):
            posw = space.wrap(pos, box)
            live = dense.refresh_mask(posw, box, self.system.cutoff, idx,
                                      mask)
            return self.force_fn(posw, idx, live)
        return force

    def _integrator(self, force):
        return integ.baoab_langevin(force, self.dt, self.masses,
                                    self.md.temperature,
                                    friction=self.friction)

    def init_state(self, pos, vel=None, rng: torch.Generator = None):
        """Initial state; velocities default to Maxwell-Boltzmann drawn from
        `rng` (default: a generator on the device seeded with md.seed),
        which then carries the thermostat noise stream."""
        if rng is None:
            rng = torch.Generator(device=self.device)
            rng.manual_seed(self.md.seed)
        pos = torch.as_tensor(pos, dtype=torch.float32, device=self.device)
        if vel is None:
            vel = integ.maxwell_boltzmann_velocities(
                rng, self.masses, self.md.temperature)
        vel = torch.as_tensor(vel, dtype=torch.float32, device=self.device)
        idx, mask, _ = self._build_nbrs(space.wrap(pos, self.system.box))
        init_fn, _ = self._integrator(self._force_with(idx, mask))
        return init_fn(pos, vel, rng)

    def _chunk(self, state, n_steps: int):
        """One neighbour-rebuild chunk of n_steps; returns (state, overflow
        flag, [n_steps] KE) with everything left on the device."""
        if self.megastep_fn is not None:
            return self._mega_chunk(state, n_steps)
        idx, mask, ovf = self._build_nbrs(space.wrap(state.pos,
                                                     self.system.box))
        _, step_fn = self._integrator(self._force_with(idx, mask))
        noise = torch.randn((n_steps, self.system.n_atoms, 3),
                            generator=state.rng, device=self.device)
        ke = []
        for step in range(n_steps):
            state = step_fn(state, noise[step])
            ke.append(integ.kinetic_energy(state.vel, self.masses))
        return state, ovf, torch.stack(ke)

    def _mega_chunk(self, state, n_steps: int):
        """The chunk as one megastep_fn call: the window starts from the
        wrapped positions, and its seed is drawn from state.rng on the
        device (no host sync)."""
        posw = space.wrap(state.pos, self.system.box)
        idx, mask, ovf = self._build_nbrs(posw)
        seed = torch.randint(0, 2**31 - 1, (1,), generator=state.rng,
                             device=self.device, dtype=torch.int32)
        c1, hdt, c2col = self._window_constants
        pos, vel, force, ke = self.megastep_fn(
            posw, state.vel, state.force, idx, mask, seed, n_steps=n_steps,
            c1=c1, hdt=hdt, c2col=c2col, masses=self.masses)
        return integ.LangevinState(pos=pos, vel=vel, force=force,
                                   rng=state.rng), ovf, ke

    def run(self, state, n_steps: int) -> RunResult:
        """Advance n_steps: full chunks of md.rebuild_every steps, then a
        shorter last chunk if n_steps is not a multiple of it."""
        rebuild = max(1, min(self.md.rebuild_every, n_steps))
        lengths = [rebuild] * (n_steps // rebuild)
        if n_steps % rebuild:
            lengths.append(n_steps % rebuild)
        any_ovf = torch.zeros((), dtype=torch.bool, device=self.device)
        kes, samples = [], []
        for length in lengths:
            state, ovf, ke = self._chunk(state, length)
            any_ovf |= ovf
            kes.append(ke)
            samples.append(space.wrap(state.pos, self.system.box))
        ke = torch.cat(kes)
        thermo = Thermo(kinetic_energy=ke,
                        temperature=2.0 * ke / (self.ndf * units.KB))
        return RunResult(state=state, thermo=thermo,
                         overflow=bool(any_ovf.item()),
                         positions=torch.stack(samples))

    def run_segmented(self, state, n_steps: int,
                      segment: int = 10000) -> RunResult:
        """Advance n_steps as runs of at most `segment` steps, one after
        the other; thermo and positions are concatenated and the overflow
        flags OR-ed (gamd_tpu/md/simulate.py:265-290)."""
        results = []
        done = 0
        while done < n_steps:
            chunk = min(segment, n_steps - done)
            result = self.run(state, chunk)
            state = result.state
            results.append(result)
            done += chunk
        thermo = Thermo(
            kinetic_energy=torch.cat([r.thermo.kinetic_energy
                                      for r in results]),
            temperature=torch.cat([r.thermo.temperature for r in results]))
        return RunResult(state=state, thermo=thermo,
                         overflow=any(r.overflow for r in results),
                         positions=torch.cat([r.positions for r in results]))
