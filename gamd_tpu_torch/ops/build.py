"""Build the port's CUDA sources with nvcc into one shared library and load
it with ctypes (no PyTorch headers, no torch.utils.cpp_extension, no ninja).

The library goes to build/gamd_tpu_torch/ at the repository root, named by
a hash of the sources, headers and flags, so an edited source or header
builds anew and an unchanged one is reused. It is built at first use,
never at import.
"""

import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gamd_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in homes:
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin: the CUDA kernels cannot build")


def sources():
    """The translation units nvcc compiles into the library."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """The library's path, named by a hash of the flags and of every source
    and header under csrc/, so that an edited header builds anew too."""
    digest = hashlib.sha256()
    for src in sorted([*sources(), *CSRC.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgamd_tpu_torch_{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the sources if the hashed library is missing.

    Returns {"path", "seconds", "built", "log"}; `log` holds nvcc's
    ptxas report (registers, shared memory, spills) when it built.
    """
    path = library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources()]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return {"path": str(path), "seconds": seconds, "built": True,
            "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def load_library():
    """The loaded library (built first if needed), with argtypes set."""
    import ctypes

    from gamd_tpu_torch.ops import mega

    lib = ctypes.CDLL(build()["path"])
    mega.declare(lib)
    return lib
