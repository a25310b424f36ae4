from gamd_tpu_torch.physics.lennard_jones import (
    LJParams,
    lj_energy_dense,
    lj_forces_dense,
    lj_force_fn,
    lj_fluid_box,
)
from gamd_tpu_torch.physics.minimize import fire_minimize
from gamd_tpu_torch.physics.rdf import radial_distribution

__all__ = [
    "LJParams",
    "lj_energy_dense",
    "lj_forces_dense",
    "lj_force_fn",
    "lj_fluid_box",
    "fire_minimize",
    "radial_distribution",
]
