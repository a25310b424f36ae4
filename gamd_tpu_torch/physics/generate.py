"""Classical ground-truth dataset generation for the LJ fluid (port of the
LJ part of gamd_tpu/physics/generate.py: random_rotation_matrix,
_record_seed, generate_lj_dataset).

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

The water, TIP4P and RPBE generators come with ROADMAP Queue 1 item 5 and
raise NotImplementedError here.
"""

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from gamd_tpu_torch.core import space, units
from gamd_tpu_torch.core.config import MDConfig, get_preset
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.physics import lennard_jones as lj
from gamd_tpu_torch.physics.minimize import fire_minimize

#: The refusal names the ROADMAP item (Queue 1) of the slice that ports it.
UNPORTED = "the water, TIP4P and RPBE generators (ROADMAP Queue 1 item 5)"


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
        pos_np = pos_f.cpu().numpy().astype(np.float32)
        vel_np = (vel_f.cpu().numpy().astype(np.float32)
                  / units.M_PER_S_TO_INTERNAL)
        force_np = (force_f.cpu().numpy().astype(np.float32)
                    / units.KJ_MOL_NM_TO_INTERNAL)
        for i in range(n_f):
            p, v, f = pos_np[i], vel_np[i], force_np[i]
            if postprocess is not None:
                p, v, f = postprocess(p, v, f)
            np.savez(os.path.join(out_dir, f"data_{seed}_{t + i}.npz"),
                     pos=np.ascontiguousarray(p),
                     vel=np.ascontiguousarray(v),
                     forces=np.ascontiguousarray(f))
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


def generate_water_dataset(*args, **kwargs):
    raise NotImplementedError(f"generate_water_dataset: {UNPORTED}")


def generate_rpbe_surrogate(*args, **kwargs):
    raise NotImplementedError(f"generate_rpbe_surrogate: {UNPORTED}")


def generate_tip4p_dataset(*args, **kwargs):
    raise NotImplementedError(f"generate_tip4p_dataset: {UNPORTED}")
