"""Unit system of the PyTorch port (a copy of gamd_tpu/core/units.py).

Internal MD units:

    length : angstrom (A)
    energy : kJ/mol
    mass   : atomic mass unit (amu, g/mol)
    time   : derived  t0 = A * sqrt(amu / (kJ/mol)) = 0.1 ps = 100 fs

With these choices velocities are A/t0, forces kJ/mol/A, and Newton's second
law holds without conversion factors.

Dataset conventions: positions in angstrom, velocities in m/s, forces in
kJ/mol/nm; DFT (RPBE) data uses bohr / Hartree.
"""

# Boltzmann constant in kJ/mol/K (CODATA: kB * N_A)
KB = 0.00831446261815324

# 1 internal time unit in femtoseconds / picoseconds.
T0_FS = 100.0
T0_PS = 0.1

# Convert a timestep given in fs to internal time units.
FS = 1.0 / T0_FS            # 1 fs  = 0.01  t0
PS = 1.0 / T0_PS            # 1 ps  = 10    t0

# Force conversions.
KJ_MOL_NM_TO_INTERNAL = 0.1          # kJ/mol/nm -> kJ/mol/A
HARTREE_PER_BOHR_TO_KJ_MOL_NM = 2625.4996394798254 / 0.052917721067
HARTREE_PER_BOHR_TO_INTERNAL = HARTREE_PER_BOHR_TO_KJ_MOL_NM * KJ_MOL_NM_TO_INTERNAL

# Energy conversions.
HARTREE_TO_KJ_MOL = 2625.4996394798254
KCAL_TO_KJ = 4.184
EV_TO_KJ_MOL = 96.48533212331002
KJ_MOL_NM_TO_EV_A = 1.0 / EV_TO_KJ_MOL / 10.0   # = 0.0010364e0 (notebook factor)

# Length conversions.
BOHR_TO_ANGSTROM = 0.52917721067
NM_TO_ANGSTROM = 10.0

# Velocity: dataset m/s -> A/t0 (1 m/s = 1e10 A/s * 1e-13 s/t0)
M_PER_S_TO_INTERNAL = 1e-3
