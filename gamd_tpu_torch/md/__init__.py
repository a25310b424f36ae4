from gamd_tpu_torch.md.integrators import (
    NVEState,
    LangevinState,
    NoseHooverState,
    AndersenState,
    velocity_verlet,
    baoab_langevin,
    nose_hoover_chain,
    andersen,
    kinetic_energy,
    temperature,
)
from gamd_tpu_torch.md.simulate import Simulation, simulate
from gamd_tpu_torch.md.reporters import StateReporter

__all__ = [
    "NVEState",
    "LangevinState",
    "NoseHooverState",
    "AndersenState",
    "velocity_verlet",
    "baoab_langevin",
    "nose_hoover_chain",
    "andersen",
    "kinetic_energy",
    "temperature",
    "Simulation",
    "simulate",
    "StateReporter",
]
