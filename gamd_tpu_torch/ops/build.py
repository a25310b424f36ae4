"""Build the port's CUDA sources with nvcc into one shared library and load
it with ctypes (no PyTorch headers, no torch.utils.cpp_extension, no ninja).
Each source compiles in its own nvcc process, all started together, and
one more nvcc links the objects.

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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: libcuda, for cuTensorMapEncodeTiled (mega_forward.cu's TMA map).
LINK_FLAGS = ("-lcuda",)


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
    digest.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libgamd_tpu_torch_{digest.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands at once; their (returncode, output) in order."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    return [(proc.returncode, out) for proc, out in zip(procs, outs)]


def build() -> dict:
    """Compile the sources if the hashed library is missing: one nvcc per
    source, all at once, then one link.

    Returns {"path", "seconds", "built", "log"}; `log` holds nvcc's
    ptxas report (registers, shared memory, spills) when it built.
    """
    path = library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    nvcc = find_nvcc()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(sources(), objs)]
    link = [nvcc, "-shared", "-o", str(tmp), *[str(o) for o in objs],
            *LINK_FLAGS]
    t0 = time.perf_counter()
    try:
        results = _run_all(compiles)
        if all(rc == 0 for rc, _ in results):
            results += _run_all([link])
        for cmd, (rc, out) in zip([*compiles, link], results):
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                                   f"{out}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return {"path": str(path), "seconds": time.perf_counter() - t0,
            "built": True, "log": "".join(out for _, out in results)}


@functools.lru_cache(maxsize=None)
def load_library():
    """The loaded library (built first if needed), with argtypes set."""
    import ctypes

    from gamd_tpu_torch.ops import (banded, conv_gather, edge_tiles,
                                    encoder, gather_probe, mega, message,
                                    mxu_probe, nhc)

    lib = ctypes.CDLL(build()["path"])
    mega.declare(lib)
    conv_gather.declare(lib)
    edge_tiles.declare(lib)
    encoder.declare(lib)
    banded.declare(lib)
    nhc.declare(lib)
    message.declare(lib)
    mxu_probe.declare(lib)
    gather_probe.declare(lib)
    return lib
