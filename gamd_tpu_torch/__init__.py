"""gamd_tpu_torch: the PyTorch/CUDA port of GAMD-TPU for NVIDIA Hopper.

It mirrors gamd_tpu's layout (core, models, neighbors, md, ops, train,
physics) and imports torch, numpy and the standard library only: nothing of
JAX and nothing of the JAX package, which stays the reference the port is
tested against. Its entry points (train.forcefield.GNNForceField,
md.simulate.Simulation) run on the CUDA device unless the caller passes
device="cpu"; the force kernel (ops.mega.mega_forward) is hand-written CUDA
C++ under csrc/, built with nvcc at first use.
"""

__version__ = "0.1.0"
