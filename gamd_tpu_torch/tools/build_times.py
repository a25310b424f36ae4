"""How long the port's CUDA library takes to build from nothing, two ways:
serial, one nvcc over every source at once (how ops/build.py built before
the kernels numbered four), and ops/build.py's build, one nvcc per source,
all started together, then a link. It runs serial, parallel, parallel,
serial, each into a fresh directory under build/build_times/, and prints
the card line and one JSON line of seconds.

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


def parallel(out_dir) -> float:
    out_dir.mkdir(parents=True)
    build.BUILD_DIR = out_dir       # library_path() reads it at each call
    info = build.build()
    assert info["built"], info
    return info["seconds"]


def main():
    print(card_line(), flush=True)
    shutil.rmtree(ROOT, ignore_errors=True)
    saved = build.BUILD_DIR
    times = {"serial": [], "parallel": []}
    try:
        for i, way in enumerate(("serial", "parallel", "parallel",
                                 "serial")):
            fn = serial if way == "serial" else parallel
            times[way].append(fn(ROOT / f"{i}_{way}"))
    finally:
        build.BUILD_DIR = saved
        shutil.rmtree(ROOT, ignore_errors=True)
    print(json.dumps({"sources": [s.name for s in build.sources()],
                      "seconds": times}), flush=True)


if __name__ == "__main__":
    main()
