"""GNN-driven MD loop on torch (port of gamd_tpu/md/simulate.py: Thermo,
RunResult and Simulation for the nve, langevin, nose_hoover and andersen
integrators, with run, run_segmented and run_recorded, and holonomic
constraints (md.constraints.RigidWater) in all of them; independent
replicas with init_replicas, stack_states and run_replicas, constrained or
not, and run_recorded over replicas; the one-call simulate()).

A run is a loop over chunks: each chunk rebuilds the padded neighbour list
at cutoff + skin (the dense search, or the cell list for large N), draws
the chunk's thermostat noise in one call (Langevin: one normal block;
Andersen: one uniform and one normal block; NVE and NHC draw none), and
advances `rebuild_every` steps reusing the list (Verlet-skin reuse; the
true-cutoff mask is redone every force call, in the force kernel when the
force function `handles_refresh`). With a `megastep_fn` a chunk is one
call of it instead (GNNForceField.megastep_fn: the whole window in one
CUDA library call), seeded from the state's generator on the device.
Capacity overflow is OR-ed on the device and read on the host once per
run.

Replicas are R independent copies of the system stepped in lockstep: every
state tensor carries a leading replica axis ([R, N, 3]; NHC chains
[R, M]), each replica has its own neighbour list, and a chunk's noise is
one block (n_steps, R, N, 3) for all of them. A force function that
`handles_refresh` (the megakernel, the dense classical water closures)
gets the whole [R, N, 3] stack in one call; any other is called once per
replica. A constraint projects the molecules of all replicas at once.
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

INTEGRATORS = ("nve", "langevin", "nose_hoover", "andersen")
STOCHASTIC = ("langevin", "andersen")     # states that carry a generator


class Thermo(NamedTuple):
    """Per-step thermodynamic log."""

    kinetic_energy: torch.Tensor   # [steps] kJ/mol
    temperature: torch.Tensor      # [steps] K


class RunResult(NamedTuple):
    """run_replicas gives every field a leading replica axis: thermo
    [R, steps], positions [R, n_chunks, N, 3]."""

    state: NamedTuple              # final integrator state
    thermo: Thermo
    overflow: bool                 # neighbour capacity exceeded at a rebuild
    positions: torch.Tensor = None  # [n_chunks, N, 3] wrapped, one per chunk


class Simulation:
    """NVE/NVT MD of a periodic particle system with a given force model.

    Args:
        force_fn: (pos_wrapped [N,3], idx [N,K] int32, mask [N,K] bool) ->
            force [N,3] in kJ/mol/A, e.g. GNNForceField.force_fn(...).
        system: SystemConfig (box, cutoff, skin, capacity, masses).
        md: MDConfig (integrator: nve, langevin, nose_hoover or andersen;
            dt; thermostat: friction_per_ps is Langevin's friction, the NHC
            frequency and Andersen's collision rate, and chain_length,
            chain_mts and chain_ys shape the chain; rebuild cadence; seed).
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
        constraint: holonomic constraints of one system, e.g.
            md.constraints.RigidWater (SETTLE and RATTLE in every
            integrator, of one system or of replicas; the temperature
            counts 3N - n_constraints degrees of freedom a replica). A
            megastep_fn takes none, as in the JAX package.
    """

    def __init__(self, force_fn: Callable, system: SystemConfig,
                 md: MDConfig, nbr_method: str = "dense",
                 k_model: Optional[int] = None, megastep_fn=None,
                 device="cuda", constraint=None):
        if system.box is None:
            raise ValueError("Simulation requires a fixed box")
        if nbr_method not in ("dense", "cell"):
            raise ValueError(f"unknown neighbor method {nbr_method!r}")
        if megastep_fn is not None and (md.integrator != "langevin"
                                        or constraint is not None):
            raise ValueError("megastep_fn supports the unconstrained "
                             f"langevin integrator only (integrator "
                             f"{md.integrator!r}, constraint {constraint!r})")
        if md.integrator not in INTEGRATORS:
            raise ValueError(f"unknown integrator {md.integrator!r}")
        self.device = resolve_device(device)
        self.force_fn = force_fn
        self.system = system
        self.md = md
        self.nbr_method = nbr_method
        self.k_model = k_model
        self.constraint = constraint
        self.masses = torch.as_tensor(system.atom_masses(),
                                      device=self.device)
        self.dt = md.dt_fs * units.FS
        self.ndf = 3 * system.n_atoms - (
            constraint.n_constraints if constraint is not None else 0)
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
        """The chunk's list of positions [N, 3]; of replicas [R, N, 3], each
        replica's own [R, N, K] and one overflow flag for all (JAX maps its
        search over the replica axis)."""
        sysc = self.system
        if self.nbr_method == "dense":
            return dense.build_nbrs(pos, sysc, self.k_model)
        if pos.ndim == 3:
            lists = [self._build_nbrs(p) for p in pos]
            idx, mask, ovf = (torch.stack(t) for t in zip(*lists))
            return idx, mask, torch.any(ovf)
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

    def _batched_force(self, idx, mask):
        """(pos [R, N, 3]) -> [R, N, 3] given per-replica lists [R, N, K]
        (gamd_tpu/md/simulate.py:343-358): a force function that
        handles_refresh gets the whole stack and the raw build-time masks;
        any other is called once per replica with its own refreshed mask,
        which is what JAX's vmap computes."""
        if getattr(self.force_fn, "handles_refresh", False):
            return self._force_with(idx, mask)
        singles = [self._force_with(i, m) for i, m in zip(idx, mask)]

        def force(pos):
            return torch.stack([f(p) for f, p in zip(singles, pos)])
        return force

    def _integrator(self, force):
        md, cst = self.md, self.constraint
        if md.integrator == "nve":
            return integ.velocity_verlet(force, self.dt, self.masses,
                                         constraint=cst)
        if md.integrator == "langevin":
            return integ.baoab_langevin(force, self.dt, self.masses,
                                        md.temperature,
                                        friction=self.friction,
                                        constraint=cst)
        if md.integrator == "nose_hoover":
            return integ.nose_hoover_chain(
                force, self.dt, self.masses, md.temperature,
                frequency=self.friction, chain_length=md.chain_length,
                n_c=md.chain_mts, n_ys=md.chain_ys, ndf=self.ndf,
                constraint=cst)
        return integ.andersen(force, self.dt, self.masses, md.temperature,
                              collision_rate=self.friction, constraint=cst)

    def init_state(self, pos, vel=None, rng: torch.Generator = None):
        """Initial state; velocities default to Maxwell-Boltzmann drawn from
        `rng` (default: a generator on the device seeded with md.seed).
        Under Langevin and Andersen the generator then carries the
        thermostat noise stream; NVE and NHC states hold none."""
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
        if self.md.integrator in STOCHASTIC:
            return init_fn(pos, vel, rng)
        return init_fn(pos, vel)

    def init_replicas(self, pos, n_replicas: int,
                      rng: torch.Generator = None):
        """Replica state from one configuration (gamd_tpu/md/simulate.py:
        360-394): identical positions, independent Maxwell-Boltzmann
        velocities, every state tensor with a leading replica axis.

        Under NHC each replica is init_state's with its own generator,
        seeded by a draw from `rng` (JAX splits its key into one per
        replica), its own list and force and a chain [R, M]. Otherwise the
        velocities [R, N, 3] are one draw from `rng` (default: a generator
        on the device seeded with md.seed), which then carries the noise
        stream of all replicas under Langevin and Andersen; the start list
        is built once and shared, the forces taken in one batched call.
        With a constraint the velocities are projected, as init_state
        projects them.
        """
        if rng is None:
            rng = torch.Generator(device=self.device)
            rng.manual_seed(self.md.seed)
        pos = torch.as_tensor(pos, dtype=torch.float32, device=self.device)
        r = int(n_replicas)
        if self.md.integrator == "nose_hoover":
            seeds = torch.randint(0, 2**62, (r,), generator=rng,
                                  device=self.device).tolist()
            states = [self.init_state(
                pos, rng=torch.Generator(device=self.device).manual_seed(s))
                for s in seeds]
            return type(states[0])(*[torch.stack(f) for f in zip(*states)])
        vel = integ.maxwell_boltzmann_velocities(
            rng, self.masses, self.md.temperature, n_replicas=r)
        pos_r = pos.expand(r, -1, -1).contiguous()
        if self.constraint is not None:
            vel = self.constraint.velocities(pos_r, vel)
        idx, mask, _ = self._build_nbrs(space.wrap(pos, self.system.box))
        force = self._batched_force(
            idx.expand(r, -1, -1).contiguous(),
            mask.expand(r, -1, -1).contiguous())(pos_r)
        if self.md.integrator == "nve":
            return integ.NVEState(pos=pos_r, vel=vel, force=force)
        state_type = (integ.AndersenState if self.md.integrator == "andersen"
                      else integ.LangevinState)
        return state_type(pos=pos_r, vel=vel, force=force, rng=rng)

    def _chunk_noise(self, state, n_steps: int):
        """The chunk's thermostat noise, one block per kind, drawn from
        state.rng: [n_steps] per-step arguments of step_fn, or None. A
        replica state draws (n_steps, R, N, 3) blocks."""
        shape = (n_steps, *state.pos.shape[:-2], self.system.n_atoms, 3)
        if self.md.integrator == "langevin":
            return torch.randn(shape, generator=state.rng,
                               device=self.device)
        if self.md.integrator == "andersen":
            u = torch.rand(shape, generator=state.rng, device=self.device)
            xi = torch.randn(shape, generator=state.rng, device=self.device)
            return list(zip(u, xi))
        return None

    def _chunk(self, state, n_steps: int):
        """One neighbour-rebuild chunk of n_steps; returns (state, overflow
        flag, [n_steps] KE, or [n_steps, R] for replicas) with everything
        left on the device."""
        if self.megastep_fn is not None:
            return self._mega_chunk(state, n_steps)
        idx, mask, ovf = self._build_nbrs(space.wrap(state.pos,
                                                     self.system.box))
        force = (self._batched_force if state.pos.ndim == 3
                 else self._force_with)(idx, mask)
        _, step_fn = self._integrator(force)
        noise = self._chunk_noise(state, n_steps)
        ke = []
        for step in range(n_steps):
            state = step_fn(state) if noise is None else \
                step_fn(state, noise[step])
            ke.append(integ.kinetic_energy(state.vel, self.masses))
        return state, ovf, torch.stack(ke)

    def _mega_chunk(self, state, n_steps: int):
        """The chunk as one megastep_fn call: the window starts from the
        wrapped positions, and its seed is drawn from state.rng on the
        device (no host sync), one seed for all replicas."""
        posw = space.wrap(state.pos, self.system.box)
        idx, mask, ovf = self._build_nbrs(posw)
        seed = torch.randint(0, 2**31 - 1, (1,), generator=state.rng,
                             device=self.device, dtype=torch.int32)
        c1, hdt, c2col = self._window_constants
        pos, vel, force, ke = self.megastep_fn(
            posw, state.vel, state.force, idx, mask, seed, n_steps=n_steps,
            c1=c1, hdt=hdt, c2col=c2col, masses=self.masses)
        return integ.LangevinState(pos=pos, vel=vel, force=force,
                                   rng=state.rng), ovf, ke.movedim(-1, 0)

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

    def run_replicas(self, states, n_steps: int) -> RunResult:
        """Advance a replica state (init_replicas) n_steps in lockstep, as
        run does one system (gamd_tpu/md/simulate.py:486-506); the
        megakernel force and megastep window take all replicas in one
        call. Every RunResult field gains a leading replica axis: thermo
        [R, steps], positions [R, n_chunks, N, 3]."""
        if states.pos.ndim != 3:
            raise ValueError("run_replicas takes a replica state [R, N, 3] "
                             "(init_replicas); use run for one system")
        res = self.run(states, n_steps)
        thermo = Thermo(kinetic_energy=res.thermo.kinetic_energy.t(),
                        temperature=res.thermo.temperature.t())
        return RunResult(state=res.state, thermo=thermo,
                         overflow=res.overflow,
                         positions=res.positions.transpose(0, 1))

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

    def run_recorded(self, state, n_frames: int, record_interval: int,
                     record_force):
        """Frames every `record_interval` steps, for dataset generation
        (gamd_tpu/md/simulate.py:292-339): frame t is recorded before the
        state advances (frame 0 is the initial state), then the state
        advances record_interval steps in chunks of the largest divisor of
        record_interval that is at most md.rebuild_every.

        `record_force(pos_wrapped) -> [N, 3]` computes the recorded force
        (e.g. the classical dense potential). Returns (final state,
        overflow, pos [F, N, 3] wrapped, vel [F, N, 3], force [F, N, 3],
        temperature [F] at the last step before each next frame).

        A replica state (stack_states of R starts) advances all replicas in
        lockstep, as JAX's vmap of its recorded run
        (gamd_tpu/physics/generate.py:49-111): record_force then takes the
        stack [R, N, 3], and every output gains a leading replica axis
        (pos [R, F, N, 3], temperature [R, F]).
        """
        rebuild = max(1, min(self.md.rebuild_every, record_interval))
        while record_interval % rebuild:
            rebuild -= 1
        n_chunks = record_interval // rebuild
        box = self.system.box
        any_ovf = torch.zeros((), dtype=torch.bool, device=self.device)
        pos, vel, force, ke = [], [], [], []
        for _ in range(n_frames):
            posw = space.wrap(state.pos, box)
            pos.append(posw)
            vel.append(state.vel)
            force.append(record_force(posw))
            for _ in range(n_chunks):
                state, ovf, chunk_ke = self._chunk(state, rebuild)
                any_ovf |= ovf
            ke.append(chunk_ke[-1])
        temp = 2.0 * torch.stack(ke) / (self.ndf * units.KB)
        lead = lambda t: t.movedim(0, 1) if state.pos.ndim == 3 else t
        return (state, bool(any_ovf.item()),
                *(lead(torch.stack(t)) for t in (pos, vel, force)),
                lead(temp))


def stack_states(states):
    """One replica state of single-system states of different starts
    (JAX's _stack_states): every tensor field stacked on a new leading
    axis. A Langevin or Andersen replica state carries one generator for
    the noise of all replicas: the first state's (JAX stacks one key per
    replica; the port draws a replica state's noise in one block)."""
    return type(states[0])(*[f[0] if isinstance(f[0], torch.Generator)
                             else torch.stack(f) for f in zip(*states)])


def simulate(force_fn, system: SystemConfig, md: MDConfig, pos, vel=None,
             rng: torch.Generator = None, nbr_method: str = "dense",
             device="cuda") -> RunResult:
    """One call: a Simulation's init_state and md.n_steps of run
    (gamd_tpu/md/simulate.py:509-514)."""
    sim = Simulation(force_fn, system, md, nbr_method=nbr_method,
                     device=device)
    return sim.run(sim.init_state(pos, vel=vel, rng=rng), md.n_steps)
