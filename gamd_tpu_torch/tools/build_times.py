"""How long the port's CUDA library takes to build from nothing, two ways:
serial, one nvcc over every source at once (how ops/build.py built before
the kernels numbered four), and ops/build.py's build, one nvcc per source,
all started together, then a link. It runs serial, parallel, parallel,
serial, each into a fresh directory under build/build_times/, and prints
the card line and one JSON line of seconds, with each source's compile
time in the parallel builds (its nvcc's end, all started together).

    python3 -m gamd_tpu_torch.tools.build_times

Needs nvcc; the card is only named.
"""

import json
import shutil
import subprocess
import time

from gamd_tpu_torch.core.device import card_line
from gamd_tpu_torch.ops import build

ROOT = build.BUILD_DIR.parent / "build_times"


def serial(out_dir) -> float:
    out_dir.mkdir(parents=True)
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
           str(out_dir / "lib.so"), *[str(s) for s in build.sources()],
           *build.LINK_FLAGS]
    t0 = time.perf_counter()
    subprocess.run(cmd, capture_output=True, check=True)
    return time.perf_counter() - t0


def parallel(out_dir, by_source) -> float:
    out_dir.mkdir(parents=True)
    build.BUILD_DIR = out_dir       # library_path() reads it at each call
    info = build.build()
    assert info["built"], info
    by_source.append(info["source_seconds"])
    return info["seconds"]


def main():
    print(card_line(), flush=True)
    shutil.rmtree(ROOT, ignore_errors=True)
    saved = build.BUILD_DIR
    times = {"serial": [], "parallel": []}
    by_source = []
    try:
        for i, way in enumerate(("serial", "parallel", "parallel",
                                 "serial")):
            out_dir = ROOT / f"{i}_{way}"
            times[way].append(serial(out_dir) if way == "serial"
                              else parallel(out_dir, by_source))
    finally:
        build.BUILD_DIR = saved
        shutil.rmtree(ROOT, ignore_errors=True)
    print(json.dumps({"sources": [s.name for s in build.sources()],
                      "seconds": times,
                      "parallel_source_seconds": by_source}), flush=True)


if __name__ == "__main__":
    main()
