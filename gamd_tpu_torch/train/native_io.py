"""ctypes binding of the port's native dataset packer
(gamd_tpu_torch/csrc/gamd_io.cpp, the counterpart of
gamd_tpu/train/native_io.py with the same C signature).

Packs a directory of data_{seed}_{t}.npz trajectory frames into contiguous
[n_frames, n_atoms, 3] float32 arrays on all the host's threads: host IO,
not a device kernel.

The library is built at first use with g++ (-O3 -fPIC -shared -pthread,
no -march=native, so it runs on any x86-64 host) into build/gamd_tpu_torch/
at the repository root, named by a hash of the source and the flags, as
ops/build.py names the CUDA library. It is never built at import, and the
JAX package's csrc/ is neither built into nor loaded from. available() is
False where g++ is missing or the build fails; TrajectoryDataset then
packs with numpy.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

from gamd_tpu_torch.ops.build import BUILD_DIR, CSRC

SOURCE = CSRC / "gamd_io.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")


def library_path():
    """The packer's path, named by a hash of its source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgamd_io_{digest.hexdigest()[:16]}.so"


def build():
    """Compile the packer if its hashed library is missing; its path.
    Raises RuntimeError if g++ is missing or fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the packer cannot build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed ({out.returncode}):\n"
                               f"{out.stdout}{out.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


@functools.lru_cache(maxsize=None)
def _load():
    lib = ctypes.CDLL(str(build()))
    lib.gamd_pack_trajectory.restype = ctypes.c_int64
    lib.gamd_pack_trajectory.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def available() -> bool:
    """Whether the packer builds and loads here."""
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


def pack_trajectory(dataset_dir, seed_num, sample_num, n_atoms,
                    drop_m_site=False, prefix="data_"):
    """Pack all frames into (pos, forces) float32 arrays.

    Returns:
        pos:    [seed_num * sample_num, n_atoms, 3], seed-major
        forces: same shape
    Raises RuntimeError if any frame failed to parse.
    """
    lib = _load()
    n_frames = seed_num * sample_num
    pos = np.empty((n_frames, n_atoms, 3), np.float32)
    forces = np.empty((n_frames, n_atoms, 3), np.float32)
    n_failed = ctypes.c_int64(0)
    done = lib.gamd_pack_trajectory(
        os.fsencode(dataset_dir), prefix.encode(),
        seed_num, sample_num, n_atoms, int(drop_m_site),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        forces.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(n_failed))
    if done != n_frames or n_failed.value:
        raise RuntimeError(
            f"packed {done}/{n_frames} frames, {n_failed.value} failed "
            f"(dir={dataset_dir})")
    return pos, forces
