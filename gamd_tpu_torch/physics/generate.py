"""Classical ground-truth dataset generation (port of
gamd_tpu/physics/generate.py: random_rotation_matrix, _record_seed,
generate_lj_dataset, _record_seeds_batched, generate_water_dataset and
generate_tip4p_dataset; the stacking of seeds, JAX's _stack_states, is
md.simulate.stack_states).

Per seed: the FCC lattice rotated and jittered from
np.random.RandomState(seed) and wrapped into the box, FIRE on the dense
LJ forces, then Nose-Hoover chain MD (chain 10, n_c = n_ys = 5, 100 K,
2 fs, rebuild every 10 steps) through Simulation.run_recorded, which
records (pos, vel, force) every `record_interval` steps. Each frame is
written as data_{seed}_{t}.npz with keys pos [A], vel [m/s] and forces
[kJ/mol/nm], all float32, the layout TrajectoryDataset reads. Under NHC
on the card every chain half-step is one launch of the CUDA kernel
nhc_half_step (ops/nhc.py).

Velocities are Maxwell-Boltzmann from a torch.Generator seeded with
1000 + seed on the run's device; JAX draws them from PRNGKey(1000 + seed),
which torch cannot reproduce, so the trajectories differ from JAX's from
the first step (the start lattice and FIRE do not).

Water (TIP3P and TIP4P-Ew) is rigid by default, SETTLE and RATTLE at
2 fs (md.constraints.RigidWater), under the reference protocol's full
Ewald electrostatics: per seed, physics.water.water_box, FIRE on the
flexible Ewald potential (trust radius 0.05 A), the snap onto the
constraints (project_initial) and Maxwell-Boltzmann velocities from a
torch.Generator seeded 2000 + seed (TIP4P: 3000 + seed); then all seeds
advance in lockstep as constrained replicas of one BAOAB Langevin
Simulation (300 K, 2/ps, rebuild every 10 steps): 5,000 thermalisation
steps, then the recorded frames, the forces the rigid Ewald ones
(nonbonded only, as OpenMM's rigid water). A replica state draws its
noise in one block from one generator (the first seed's), where JAX keeps
a key per seed, so the trajectories differ from JAX's. TIP4P frames are
written in the 4-site layout (O, H, H, M; physics.water.
expand_with_m_sites), which TrajectoryDataset reads without the M rows.

The RPBE surrogate (generate_rpbe_surrogate) is the DFT system's data:
64 rigid TIP3P molecules at three densities (liquid density, -3% and +3%
in box edge), each box FIRE-relaxed on the flexible potential, snapped
onto the constraints, given velocities from a torch.Generator seeded
4000 + its index (JAX: PRNGKey(4000 + index)), run 2,000 steps of
Langevin (300 K, 2/ps, 2 fs; the damped-shifted-force TIP3P at a cutoff of
min(6 A, box/2)) and recorded; one npz in bohr and Ha/bohr with a box a
frame and a 90/10 split, the layout train.data.RealLargeDataset reads.
"""

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from gamd_tpu_torch.core import space, units
from gamd_tpu_torch.core.config import MDConfig, get_preset
from gamd_tpu_torch.md.constraints import RigidWater, tip3p_rigid_params
from gamd_tpu_torch.md.simulate import Simulation, stack_states
from gamd_tpu_torch.physics import ewald
from gamd_tpu_torch.physics import lennard_jones as lj
from gamd_tpu_torch.physics import water as w
from gamd_tpu_torch.physics.minimize import fire_minimize

#: Steps every seed runs before the first recorded frame (the grid starts
#: begin far colder than a liquid).
THERMALIZE_STEPS = 5000


def random_rotation_matrix(rng: np.random.RandomState):
    """Rotation from three Euler angles drawn uniformly in [-pi, pi):
    Rz @ Ry @ Rx, float32."""
    angles = rng.uniform(-1.0, 1.0, size=(3,)) * np.pi
    cx, sx = np.cos(angles[0]), np.sin(angles[0])
    cy, sy = np.cos(angles[1]), np.sin(angles[1])
    cz, sz = np.cos(angles[2]), np.sin(angles[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
    return rz @ ry @ rx


class LJProtocol(NamedTuple):
    """The LJ generator's pieces: the NHC Simulation, the recorded force
    (dense LJ forces, also FIRE's), the lattice and its box."""
    sim: Simulation
    record_force: Callable
    lattice: np.ndarray     # [N, 3] float32, the FCC lattice
    box: float              # lj_fluid_box's edge (A)


def lj_protocol(n_particles=258, params: lj.LJParams = lj.LJParams(),
                temperature=None, device="cuda") -> LJProtocol:
    """The protocol's Simulation and forces on `device`.

    The Simulation takes the LJ preset (258 atoms, box 27.27 A, cutoff
    7.5 A + skin, K=96) at `temperature` (default the preset's 100 K);
    its force and the recorded force use lj_fluid_box's edge, as the JAX
    generator does. n_particles other than the preset's 258 raises
    ValueError (the preset fixes the masses and the list)."""
    system = (get_preset("lj") if temperature is None
              else get_preset("lj", temperature=float(temperature)))
    if n_particles != system.n_atoms:
        raise ValueError(f"the LJ protocol runs the preset's "
                         f"{system.n_atoms} atoms, not {n_particles}")
    box, lattice = lj.lj_fluid_box(n_particles, 0.5, params)
    md = MDConfig(integrator="nose_hoover", temperature=system.temperature,
                  dt_fs=system.dt_fs, friction_per_ps=system.friction_per_ps,
                  chain_length=10, chain_mts=5, chain_ys=5,
                  rebuild_every=10)
    sim = Simulation(lj.lj_force_fn(box, params), system, md, device=device)
    return LJProtocol(sim, lambda p: lj.lj_forces_dense(p, box, params),
                      lattice, box)


def lj_start(seed, lattice, box):
    """Seed's start: the lattice rotated about its centre by
    random_rotation_matrix, jittered by 0.005 A normal noise, both from
    np.random.RandomState(seed), and wrapped into [0, box); [N, 3] float32
    numpy."""
    host_rng = np.random.RandomState(seed)
    r_mat = random_rotation_matrix(host_rng)
    centre = lattice.mean(axis=0)
    pos = (lattice - centre) @ r_mat + centre
    pos = pos + host_rng.randn(*pos.shape).astype(np.float32) * 0.005
    return space.wrap(torch.as_tensor(pos), box).numpy()


def _npz_units(pos, vel, force):
    """Recorded tensors as float32 numpy in the npz units: pos A, vel m/s,
    forces kJ/mol/nm."""
    as_np = lambda t: t.detach().cpu().numpy().astype(np.float32)
    return (as_np(pos), as_np(vel) / units.M_PER_S_TO_INTERNAL,
            as_np(force) / units.KJ_MOL_NM_TO_INTERNAL)


def _write_frames(out_dir, seed, t0, pos_np, vel_np, force_np,
                  postprocess=None):
    """data_{seed}_{t0 + i}.npz of [F, N, 3] numpy frames (pos A, vel m/s,
    forces kJ/mol/nm), each through postprocess(p, v, f) if given."""
    for i in range(pos_np.shape[0]):
        p, v, f = pos_np[i], vel_np[i], force_np[i]
        if postprocess is not None:
            p, v, f = postprocess(p, v, f)
        np.savez(os.path.join(out_dir, f"data_{seed}_{t0 + i}.npz"),
                 pos=np.ascontiguousarray(p), vel=np.ascontiguousarray(v),
                 forces=np.ascontiguousarray(f))


def _record_seed(sim: Simulation, state, out_dir: str, seed: int,
                 frames_per_seed: int, record_interval: int, record_force,
                 frames_per_dispatch: int, log_every_frames: int,
                 postprocess=None):
    """Advance and record one seed's trajectory, frames_per_dispatch frames
    a run_recorded call, and write each frame's npz on the host. Returns
    the final state; a neighbour overflow raises RuntimeError."""
    t = 0
    while t < frames_per_seed:
        n_f = min(frames_per_dispatch, frames_per_seed - t)
        state, ovf, pos_f, vel_f, force_f, temp = sim.run_recorded(
            state, n_f, record_interval, record_force)
        if ovf:
            raise RuntimeError(
                "neighbor capacity overflow during generation; "
                "increase SystemConfig.nbr_capacity")
        _write_frames(out_dir, seed, t, *_npz_units(pos_f, vel_f, force_f),
                      postprocess)
        t += n_f
        if log_every_frames:
            print(f"seed {seed}: frame {t}/{frames_per_seed} "
                  f"T={float(temp[-1]):.1f}K", flush=True)
    return state


def generate_lj_dataset(out_dir, seeds=10, frames_per_seed=1000,
                        record_interval=50, n_particles=258,
                        minimize_steps=2000, log_every_frames=250,
                        frames_per_dispatch=250,
                        params: lj.LJParams = lj.LJParams(),
                        seed_start=0, temperature=None, device="cuda"):
    """Generate the LJ training set on `device` ("cuda" unless the caller
    asks for the CPU); returns the output directory. The protocol: rotate
    and jitter the lattice, FIRE for minimize_steps, NHC 10/5/5 at 100 K
    (or `temperature`), frames_per_seed frames every record_interval
    steps, for seeds seed_start .. seed_start + seeds - 1."""
    proto = lj_protocol(n_particles, params, temperature, device)
    dev = proto.sim.device
    os.makedirs(out_dir, exist_ok=True)
    for seed in range(seed_start, seed_start + seeds):
        pos = torch.as_tensor(lj_start(seed, proto.lattice, proto.box),
                              device=dev)
        pos, _ = fire_minimize(proto.record_force, pos,
                               n_steps=minimize_steps)
        rng = torch.Generator(device=dev)
        rng.manual_seed(1000 + seed)
        state = proto.sim.init_state(pos, rng=rng)
        _record_seed(proto.sim, state, out_dir, seed, frames_per_seed,
                     record_interval, proto.record_force,
                     frames_per_dispatch, log_every_frames)
    return out_dir


def _record_seeds_batched(sim: Simulation, states, out_dir: str, seeds,
                          frames_per_seed: int, record_interval: int,
                          record_force, frames_per_dispatch: int,
                          log_every_frames: int, postprocess=None):
    """Advance all seeds' trajectories in lockstep, the replica state
    `states` (stack_states, one replica a seed), frames_per_dispatch frames
    a run_recorded call, and write each seed's frames on the host.
    record_force takes the stack [R, N, 3]. Returns the final state; a
    neighbour overflow raises RuntimeError."""
    t = 0
    while t < frames_per_seed:
        n_f = min(frames_per_dispatch, frames_per_seed - t)
        states, ovf, pos_f, vel_f, force_f, temp = sim.run_recorded(
            states, n_f, record_interval, record_force)
        if ovf:
            raise RuntimeError(
                "neighbor capacity overflow during generation; "
                "increase SystemConfig.nbr_capacity")
        pos_np, vel_np, force_np = _npz_units(pos_f, vel_f, force_f)
        for s_i, seed in enumerate(seeds):
            _write_frames(out_dir, seed, t, pos_np[s_i], vel_np[s_i],
                          force_np[s_i], postprocess)
        t += n_f
        if log_every_frames:
            temps = " ".join(f"{x:.0f}" for x in temp[:, -1].tolist())
            print(f"frames {t}/{frames_per_seed} x {len(seeds)} seeds "
                  f"T=[{temps}]K", flush=True)
    return states


class WaterProtocol(NamedTuple):
    """A water generator's pieces: the Langevin Simulation (constrained
    when rigid), the recorded force (-grad of the rigid or flexible
    energy), the FIRE force (the flexible one) and the parameters."""
    sim: Simulation
    record_force: Callable
    minimize_force: Callable
    params: NamedTuple
    box: float


def water_protocol(model="tip3p", n_molecules=258, dt_fs=None, rigid=True,
                   electrostatics="ewald", device="cuda") -> WaterProtocol:
    """The TIP3P or TIP4P-Ew generator's protocol on `device`: the preset
    at 3 n_molecules atoms (box 20 A), BAOAB Langevin at 300 K, 2/ps,
    dt 2 fs rigid (0.5 fs flexible), rebuild every 10 steps, and the
    potential of `electrostatics` ("ewald": make_ewald_params(box),
    cutoff 10 A; "dsf": the damped-shifted-force cutoff)."""
    if dt_fs is None:
        dt_fs = 2.0 if rigid else 0.5
    tip4p = model == "tip4p"
    system = get_preset(model, n_atoms=3 * n_molecules)
    params = w.TIP4PEwParams() if tip4p else w.TIP3PParams()
    box = system.box
    constraint = RigidWater(n_molecules, box,
                            tip3p_rigid_params(params.r_oh, params.theta0)) \
        if rigid else None
    md = MDConfig(integrator="langevin", temperature=300.0, dt_fs=dt_fs,
                  friction_per_ps=2.0, rebuild_every=10)
    force_fn = (w.tip4pew_force_fn if tip4p else w.tip3p_force_fn)(
        box, params, rigid=rigid, electrostatics=electrostatics)
    sim = Simulation(force_fn, system, md, constraint=constraint,
                     device=device)
    if electrostatics == "ewald":
        ew = ewald.make_ewald_params(box)
        flexible = w.tip4pew_energy_ewald if tip4p else w.tip3p_energy_ewald
        rigid_e = (w.tip4pew_energy_rigid_ewald if tip4p
                   else w.tip3p_energy_rigid_ewald)
        rec_energy = rigid_e if rigid else flexible
        record_force = lambda p: ewald.neg_grad(rec_energy, p, box, ew,
                                                params)
        minimize_force = lambda p: ewald.neg_grad(flexible, p, box, ew,
                                                  params)
    else:
        fwd = ((w.tip4pew_forces_rigid if rigid else w.tip4pew_forces)
               if tip4p else
               (w.tip3p_forces_rigid if rigid else w.tip3p_forces))
        flexible = w.tip4pew_forces if tip4p else w.tip3p_forces
        record_force = lambda p: fwd(p, box, params)
        minimize_force = lambda p: flexible(p, box, params)
    return WaterProtocol(sim, record_force, minimize_force, params, box)


def water_start(proto: WaterProtocol, seed, n_molecules, minimize_steps,
                rng_seed):
    """One seed's start state: water_box (TIP4P-Ew's monomer for tip4p)
    relaxed by FIRE (trust radius 0.05 A) on the flexible potential,
    snapped onto the constraints, velocities from a generator seeded
    rng_seed."""
    sim, params = proto.sim, proto.params
    monomer = w.TIP3PParams(r_oh=params.r_oh, theta0=params.theta0)
    pos = torch.as_tensor(w.water_box(n_molecules, proto.box, monomer,
                                      seed=seed), device=sim.device)
    pos, _ = fire_minimize(proto.minimize_force, pos,
                           n_steps=minimize_steps, max_step=0.05)
    if sim.constraint is not None:
        pos = sim.constraint.project_initial(pos)
    rng = torch.Generator(device=sim.device)
    rng.manual_seed(rng_seed)
    return sim.init_state(pos, rng=rng)


def _generate_water(model, out_dir, seeds, frames_per_seed, record_interval,
                    n_molecules, minimize_steps, dt_fs, rigid,
                    log_every_frames, frames_per_dispatch, electrostatics,
                    seed_start, device, thermalize_steps, rng_base,
                    postprocess=None):
    os.makedirs(out_dir, exist_ok=True)
    proto = water_protocol(model, n_molecules, dt_fs, rigid, electrostatics,
                           device)
    seed_list = list(range(seed_start, seed_start + seeds))
    states = stack_states([
        water_start(proto, seed, n_molecules, minimize_steps,
                    rng_base + seed) for seed in seed_list])
    states = proto.sim.run(states, thermalize_steps).state
    _record_seeds_batched(proto.sim, states, out_dir, seed_list,
                          frames_per_seed, record_interval,
                          proto.record_force, frames_per_dispatch,
                          log_every_frames, postprocess)
    return out_dir


def generate_water_dataset(out_dir, seeds=10, frames_per_seed=1000,
                           record_interval=50, n_molecules=258,
                           minimize_steps=3000, dt_fs=None, rigid=True,
                           log_every_frames=250, frames_per_dispatch=250,
                           electrostatics="ewald", seed_start=0,
                           device="cuda",
                           thermalize_steps=THERMALIZE_STEPS):
    """TIP3P water ground truth (the reference's WaterBox 2 nm at 300 K,
    rigid, dt 2 fs; the module docstring has the protocol) for seeds
    seed_start .. seed_start + seeds - 1 on `device`; returns out_dir."""
    return _generate_water(
        "tip3p", out_dir, seeds, frames_per_seed, record_interval,
        n_molecules, minimize_steps, dt_fs, rigid, log_every_frames,
        frames_per_dispatch, electrostatics, seed_start, device,
        thermalize_steps, rng_base=2000)


def rpbe_box_sizes(n_molecules=64):
    """The surrogate's three box edges (A): liquid water's at 0.998 g/cm^3
    (V = n M_w / (rho N_A)) times 0.97, 1 and 1.03."""
    base = (n_molecules * 18.015 / (0.998 * 6.02214e23)) ** (1 / 3) * 1e8
    return [base * 0.97, base * 1.0, base * 1.03]


def rpbe_protocol(box, n_molecules=64, rigid=True, friction_per_ps=2.0,
                  device="cuda") -> WaterProtocol:
    """One box of the RPBE surrogate on `device`: the TIP3P preset at 3
    n_molecules atoms in `box` with cutoff min(6 A, box/2 - 0.01) and K=176
    (about 126 atoms lie within the cutoff and skin at liquid density),
    Langevin at 300 K and friction_per_ps (2/ps in the generator), dt 2 fs
    rigid (0.5 fs flexible), rebuild every 10 steps, on the damped-
    shifted-force TIP3P forces at that cutoff; the recorded force is the
    rigid one (the flexible one without constraints), FIRE's the
    flexible one."""
    box = float(box)
    cutoff = min(6.0, box / 2 - 0.01)
    params = w.TIP3PParams(cutoff=cutoff)
    system = get_preset("tip3p", n_atoms=3 * n_molecules, box=box,
                        cutoff=cutoff, nbr_capacity=176)
    constraint = RigidWater(n_molecules, box,
                            tip3p_rigid_params(params.r_oh, params.theta0)) \
        if rigid else None
    md = MDConfig(integrator="langevin", temperature=300.0,
                  dt_fs=2.0 if rigid else 0.5,
                  friction_per_ps=friction_per_ps, rebuild_every=10)
    sim = Simulation(w.tip3p_force_fn(box, params, rigid=rigid), system, md,
                     constraint=constraint, device=device)
    fwd = w.tip3p_forces_rigid if rigid else w.tip3p_forces
    return WaterProtocol(sim, lambda p: fwd(p, box, params),
                         lambda p: w.tip3p_forces(p, box, params), params,
                         box)


def rpbe_start(proto: WaterProtocol, n_molecules, minimize_steps, seed):
    """A box's start positions: water_box(seed) relaxed by FIRE (trust
    radius 0.05 A) on the flexible forces, snapped onto the constraints
    when rigid."""
    sim = proto.sim
    pos = torch.as_tensor(w.water_box(n_molecules, proto.box, proto.params,
                                      seed=seed), device=sim.device)
    pos, _ = fire_minimize(proto.minimize_force, pos,
                           n_steps=minimize_steps, max_step=0.05)
    if sim.constraint is not None:
        pos = sim.constraint.project_initial(pos)
    return pos


def write_rpbe_npz(out_path, pos, force, box, n_molecules, test_fraction=0.1,
                   seed=0):
    """The surrogate's npz from recorded frames in A and kJ/mol/A (pos,
    force [M, N, 3], box [M] numpy): pos in bohr, force in Ha/bohr and box
    in bohr (float32), atom_type [M, N] int32 (1 O, 2 H), and the split of a
    RandomState(seed) permutation, its first max(1, int(M test_fraction))
    frames test_idx and the rest train_idx."""
    pos = pos / units.BOHR_TO_ANGSTROM
    force = force * (units.BOHR_TO_ANGSTROM / units.HARTREE_TO_KJ_MOL)
    box = box / units.BOHR_TO_ANGSTROM
    m = pos.shape[0]
    atom_type = np.tile(np.tile([1, 2, 2], n_molecules)[None, :],
                        (m, 1)).astype(np.int32)
    order = np.random.RandomState(seed).permutation(m)
    n_test = max(1, int(m * test_fraction))
    np.savez(out_path, pos=pos.astype(np.float32),
             force=force.astype(np.float32), box=box, atom_type=atom_type,
             train_idx=order[n_test:], test_idx=order[:n_test])
    return out_path


def generate_rpbe_surrogate(out_path, n_molecules=64, frames_per_box=1000,
                            record_interval=50, box_sizes=None,
                            equil_steps=2000, minimize_steps=2000,
                            test_fraction=0.1, seed=0, rigid=True,
                            frames_per_dispatch=250, log_every_frames=250,
                            device="cuda"):
    """The RPBE/DFT surrogate (gamd_tpu/physics/generate.py:265-345) on
    `device`: for each box of box_sizes (rpbe_box_sizes by default), box
    index b, rpbe_protocol's Simulation from rpbe_start(seed + b) with
    velocities from a generator seeded 4000 + b, equil_steps steps, then
    frames_per_box frames every record_interval steps by run_recorded
    (frames_per_dispatch a call); write_rpbe_npz of all frames. Returns
    out_path; a neighbour overflow raises RuntimeError. The frames are a
    classical stand-in with the published set's layout, not RPBE data."""
    if box_sizes is None:
        box_sizes = rpbe_box_sizes(n_molecules)
    all_pos, all_force, all_box = [], [], []
    for b_i, box in enumerate(box_sizes):
        proto = rpbe_protocol(box, n_molecules, rigid, device=device)
        sim = proto.sim
        rng = torch.Generator(device=sim.device)
        rng.manual_seed(4000 + b_i)
        state = sim.init_state(rpbe_start(proto, n_molecules,
                                          minimize_steps, seed + b_i),
                               rng=rng)
        if equil_steps:
            state = sim.run(state, equil_steps).state
        t = 0
        while t < frames_per_box:
            n_f = min(frames_per_dispatch, frames_per_box - t)
            state, ovf, pos_f, _, force_f, temp = sim.run_recorded(
                state, n_f, record_interval, proto.record_force)
            if ovf:
                raise RuntimeError("neighbor capacity overflow")
            all_pos.append(pos_f.detach().cpu().numpy().astype(np.float32))
            all_force.append(
                force_f.detach().cpu().numpy().astype(np.float32))
            all_box.append(np.full((n_f,), proto.box, np.float32))
            t += n_f
            if log_every_frames:
                print(f"box {proto.box:.2f} A: frame {t}/{frames_per_box} "
                      f"T={float(temp[-1]):.1f}K", flush=True)
    return write_rpbe_npz(out_path, np.concatenate(all_pos),
                          np.concatenate(all_force), np.concatenate(all_box),
                          n_molecules, test_fraction, seed)


def generate_tip4p_dataset(out_dir, seeds=10, frames_per_seed=1000,
                           record_interval=50, n_molecules=251,
                           minimize_steps=3000, dt_fs=None, rigid=True,
                           log_every_frames=250, frames_per_dispatch=250,
                           electrostatics="ewald", seed_start=0,
                           device="cuda",
                           thermalize_steps=THERMALIZE_STEPS):
    """TIP4P-Ew ground truth (the reference's WaterBox model='tip4pew', 251
    molecules, rigid, dt 2 fs) in the 4-site frame layout, O, H, H, M per
    molecule (the M rows the derived position, zero force; the velocity
    rows through the same map, as the JAX generator writes them)."""
    params = w.TIP4PEwParams()
    box = get_preset("tip4p").box

    def to_4site(p, v, f):
        pos4, f4 = w.expand_with_m_sites(p, f, box, params)
        vel4, _ = w.expand_with_m_sites(v, np.zeros_like(v), box, params)
        return pos4, vel4, f4

    return _generate_water(
        "tip4p", out_dir, seeds, frames_per_seed, record_interval,
        n_molecules, minimize_steps, dt_fs, rigid, log_every_frames,
        frames_per_dispatch, electrostatics, seed_start, device,
        thermalize_steps, rng_base=3000, postprocess=to_4site)
