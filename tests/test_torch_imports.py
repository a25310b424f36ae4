"""The card's installation has torch but no jax, jaxlib, flax, optax,
msgpack or ninja. Every module of gamd_tpu_torch, and chip_smoke imported as
a module (main not run), must import with those blocked, and without the
JAX package gamd_tpu."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "ninja", "gamd_tpu")
#: Modules of the later slices (large N; the integrators and the NHC
#: kernel; the op library; the tensor-core probes; water; the stage
#: decomposition), which the probe must have imported.
NEW_IN_SLICES = ("gamd_tpu_torch.neighbors.cell_list",
                 "gamd_tpu_torch.neighbors.search",
                 "gamd_tpu_torch.ops.banded",
                 "gamd_tpu_torch.tools.bench_large",
                 "gamd_tpu_torch.ops.nhc",
                 "gamd_tpu_torch.tools.probe_nhc_kernel",
                 "gamd_tpu_torch.ops.aggregate",
                 "gamd_tpu_torch.ops.message",
                 "gamd_tpu_torch.tools.op_library",
                 "gamd_tpu_torch.ops.mxu_probe",
                 "gamd_tpu_torch.ops.gather_probe",
                 "gamd_tpu_torch.tools.bench_mxu",
                 "gamd_tpu_torch.tools.probe_gather",
                 "gamd_tpu_torch.neighbors.topology",
                 "gamd_tpu_torch.physics.water",
                 "gamd_tpu_torch.md.constraints",
                 "gamd_tpu_torch.tools.bench_ablate",
                 "gamd_tpu_torch.tools.bounds",
                 "gamd_tpu_torch.tools.sass_diff")

PROBE = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = set(sys.argv[1].split(","))

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is not installed on the card")
            return None

    sys.meta_path.insert(0, Refuse())
    import gamd_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        gamd_tpu_torch.__path__, "gamd_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    print(" ".join(names))
    import chip_smoke
    assert callable(chip_smoke.main)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print(len(names), "modules")
""")


def test_port_and_chip_smoke_import_without_jax_or_msgpack():
    out = subprocess.run(
        [sys.executable, "-c", PROBE, ",".join(BLOCKED)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[-2])
    assert n_modules >= 13, out.stdout
    for name in NEW_IN_SLICES:
        assert name in out.stdout, (name, out.stdout)


def test_probe_refuses_a_blocked_import():
    """The guard itself works: importing the JAX package under it fails."""
    probe = PROBE.replace("import gamd_tpu_torch\n",
                          "import gamd_tpu_torch\nimport gamd_tpu\n", 1)
    out = subprocess.run(
        [sys.executable, "-c", probe, ",".join(BLOCKED)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode != 0
    assert "not installed on the card" in out.stderr
