"""The port's public surface against the JAX package's on the CPU (Queue 1
item 8): the rest of core/space.py, dense.all_pairs_edges and
dense_neighbor_list's include_self, cubic_kernel and RBFExpansion,
physics/pair_bias.py, utils/profiling.py, and every name that a JAX
package's __all__ exports, with the same seeded numpy inputs through both
packages."""

import ast
import importlib
import os

os.environ.setdefault("GAMD_XLA_CACHE", "off")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamd_tpu.core import space as jspace
from gamd_tpu.models import gnn as jgnn
from gamd_tpu.neighbors import dense as jdense
from gamd_tpu.physics.pair_bias import \
    pair_projection_profile as jpair_profile

from gamd_tpu_torch.core import space
from gamd_tpu_torch.models import gnn
from gamd_tpu_torch.neighbors import dense
from gamd_tpu_torch.physics.pair_bias import pair_projection_profile
from gamd_tpu_torch.tools import profile_step
from gamd_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOXES = [pytest.param(7.5, id="cubic"),
         pytest.param((7.5, 6.0, 9.0), id="orthorhombic")]


def _frames(n=20, seed=0, box=7.5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-4.0, 12.0, (n, 3)).astype(np.float32),
            rng.uniform(-4.0, 12.0, (n - 5, 3)).astype(np.float32))


def _box(box):
    return (torch.tensor(box, dtype=torch.float32) if isinstance(box, tuple)
            else box), jnp.asarray(box, jnp.float32)


def _close(got, want, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize("box", BOXES)
def test_space_functions_match_jax(box):
    """displacement, distance2, distance, pairwise_displacement,
    center_positions and pairwise_displacement_two_system (a scalar or a
    [3] box; positions outside the box) within 1e-6 of JAX's."""
    p1, p2 = _frames()
    tb, jb = _box(box)
    t1, t2 = torch.as_tensor(p1), torch.as_tensor(p2)
    j1, j2 = jnp.asarray(p1), jnp.asarray(p2)
    for name in ("displacement", "distance2", "distance"):
        _close(getattr(space, name)(t1[:5], t1[5:10], tb),
               getattr(jspace, name)(j1[:5], j1[5:10], jb))
    _close(space.pairwise_displacement(t1, tb),
           jspace.pairwise_displacement(j1, jb))
    _close(space.pairwise_distance2(t1, tb),
           jspace.pairwise_distance2(j1, jb))
    _close(space.pairwise_displacement_two_system(t1, t2, tb),
           jspace.pairwise_displacement_two_system(j1, j2, jb))
    centred, offset = space.center_positions(t1)
    jcentred, joffset = jspace.center_positions(j1)
    _close(centred, jcentred)
    _close(offset, joffset)


@pytest.mark.parametrize("include_self", [False, True])
def test_dense_neighbor_list_include_self_matches_jax(include_self):
    """dense_neighbor_list with include_self: the same index set a row
    (and padded slots the row's own index), the same mask and overflow as
    JAX's, at a capacity that overflows and one that does not."""
    pos, _ = _frames(30, seed=1)
    for k_max in (6, 30):
        idx, mask, ovf = dense.dense_neighbor_list(
            torch.as_tensor(pos), 7.5, 2.6, k_max, include_self=include_self)
        jidx, jmask, jovf = jdense.dense_neighbor_list(
            jnp.asarray(pos), 7.5, 2.6, k_max, include_self=include_self)
        jidx, jmask = np.asarray(jidx), np.asarray(jmask)
        assert np.array_equal(mask.numpy(), jmask)
        assert bool(ovf) == bool(jovf)
        for row in range(len(pos)):
            live = mask[row].numpy()
            assert set(idx[row].numpy()[live]) == set(jidx[row][live])
            assert (idx[row].numpy()[~live] == row).all()
        assert idx.dtype == torch.int32
    if include_self:
        assert bool(mask[:, 0].all()) and (idx[:, 0].numpy()
                                           == np.arange(len(pos))).all()


@pytest.mark.parametrize("box", BOXES)
def test_all_pairs_edges_matches_jax(box):
    """all_pairs_edges: disp and dist within 1e-6 of JAX's, the mask (dist
    <= cutoff, no self pair) equal."""
    pos, _ = _frames(25, seed=2)
    tb, jb = _box(box)
    disp, dist, mask = dense.all_pairs_edges(torch.as_tensor(pos), tb, 3.0)
    jdisp, jdist, jmask = jdense.all_pairs_edges(jnp.asarray(pos), jb, 3.0)
    _close(disp, jdisp)
    _close(dist, jdist)
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    assert 0 < int(mask.sum()) < 25 * 24


def test_cubic_kernel_and_rbf_expansion_match_jax():
    """cubic_kernel (r past re, under re, at and below its 1e-3 threshold)
    and the RBFExpansion module at JAX's defaults and at the models'
    settings, within 1e-6 of JAX's."""
    r = np.concatenate([np.linspace(0.0, 3.0, 50), [1e-4, 1e-3, 2e-3]]
                       ).astype(np.float32)
    _close(gnn.cubic_kernel(torch.as_tensor(r), 2.0),
           jgnn.cubic_kernel(jnp.asarray(r), 2.0))
    d = np.random.default_rng(3).normal(0.5, 1.0, (4, 7)).astype(np.float32)
    for kw in ({}, dict(low=0.0, high=1.0, gap=0.025)):
        got = gnn.RBFExpansion(**kw)(torch.as_tensor(d))
        want = jgnn.RBFExpansion(**kw).apply({}, jnp.asarray(d))
        _close(got, want)
    assert not list(gnn.RBFExpansion().parameters())


def test_pair_projection_profile_matches_jax():
    """pair_projection_profile on three frames (two as a batch, one as a
    single [N, 3] frame) with an r_min above the first edge: the profile
    within 1e-10 (relative to its max) and the ordered-pair counts equal
    to JAX's, both numpy."""
    rng = np.random.default_rng(4)
    pos = rng.uniform(-2.0, 14.0, (3, 40, 3))
    vec = rng.normal(size=(3, 40, 3))
    edges = np.linspace(1.0, 5.0, 17)
    for p, v in ((pos[:2], vec[:2]), (pos[2], vec[2])):
        prof, cnt = pair_projection_profile(torch.as_tensor(p),
                                            torch.as_tensor(v), 12.0, edges,
                                            r_min=1.5)
        jprof, jcnt = jpair_profile(p, v, 12.0, edges, r_min=1.5)
        assert isinstance(prof, np.ndarray) and cnt.dtype == np.int64
        assert np.array_equal(cnt, jcnt) and cnt.sum() > 0
        _close(prof, jprof, rtol=1e-10)


def _public(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


@pytest.mark.parametrize("module", [
    "core/space.py", "neighbors/dense.py", "models/gnn.py",
    "physics/pair_bias.py", "utils/profiling.py", "parallel/mesh.py",
    "models/normalizer.py"])
def test_no_public_name_of_the_jax_module_is_missing(module):
    """Every top-level public function and class of the JAX module is in
    its port counterpart (by an AST walk of both files), but
    rect_neighbor_list, which comes with the spatial decomposition
    (ROADMAP Queue 1 item 7b)."""
    missing = _public(f"gamd_tpu/{module}") - _public(
        f"gamd_tpu_torch/{module}")
    assert missing <= {"rect_neighbor_list"}, missing


@pytest.mark.parametrize("package", ["models", "md", "physics", "train",
                                     "neighbors", "utils", "parallel",
                                     "core", "ops"])
def test_every_jax_export_imports_from_the_port(package):
    """Each name of the JAX package's __all__ imports from the port's
    package of the same name (the port may export more)."""
    jax_pkg = importlib.import_module(f"gamd_tpu.{package}")
    port = importlib.import_module(f"gamd_tpu_torch.{package}")
    missing = [n for n in jax_pkg.__all__ if not hasattr(port, n)]
    assert not missing, missing
    assert set(jax_pkg.__all__) <= set(port.__all__)


def test_timer_and_profile_trace_on_the_cpu(tmp_path):
    """Timer.stop returns the seconds since the timer was made, for a
    result of nested tensors or none; profile_trace writes a Chrome trace
    into its directory and yields the profiler, whose CPU ops are there
    to parse; the profile parse that the tools share is the one
    profile_step.py imports."""
    t = profiling.Timer()
    out = {"a": (torch.ones(3) * 2,), "b": [torch.zeros(2)], "c": 3}
    seconds = t.stop(out)
    assert 0.0 <= seconds <= t.stop()
    with profiling.profile_trace(str(tmp_path / "tr")) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    assert profiling.kernel_times(prof) == {}   # no device on the CPU
    for name in ("short_name", "exclusive_times", "traced_spans",
                 "device_spans", "kernel_times", "on_device"):
        assert getattr(profile_step, name) is getattr(profiling, name)
