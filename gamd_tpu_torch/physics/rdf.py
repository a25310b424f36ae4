"""Radial distribution function g(r), trajectory unwrapping, mean squared
displacement and self-diffusion for periodic systems (port of
gamd_tpu/physics/rdf.py).

The GAMD paper's physics check is RDF agreement between GNN-driven MD and
a classical run. The pair histograms run on the frames' device (torch ops,
a chunk of frames at a time); the curves come back as numpy arrays.
"""

import numpy as np
import torch

from gamd_tpu_torch.core import space

#: Frames histogrammed per batch of pair distances ([T, N, N] at a time).
FRAME_CHUNK = 32


def _frames(frames):
    return frames if torch.is_tensor(frames) else torch.as_tensor(
        np.asarray(frames))


def radial_distribution(frames, box, r_max=None, n_bins=100,
                        species_a=None, species_b=None):
    """g(r) averaged over trajectory frames.

    Args:
        frames: [T, N, 3] positions (a tensor on any device, or numpy).
        box: cubic box edge.
        r_max: histogram range (default box/2).
        n_bins: number of radial bins.
        species_a, species_b: optional boolean masks [N] selecting the two
            species (e.g. O-O for water); default all-all.

    Returns:
        (r_centers [n_bins], g [n_bins]) numpy arrays. A distance d falls in
        bin i when edges[i] <= d < edges[i+1] (d = r_max in the last bin),
        as jnp.histogram counts it.
    """
    frames = _frames(frames)
    t, n, _ = frames.shape
    dev = frames.device
    if r_max is None:
        r_max = float(box) / 2.0
    edges_np = np.linspace(0.0, r_max, n_bins + 1).astype(np.float32)
    edges = torch.as_tensor(edges_np, device=dev)

    as_mask = lambda s: torch.ones(n, dtype=torch.bool, device=dev) \
        if s is None else torch.as_tensor(np.asarray(s), device=dev)
    sel_a, sel_b = as_mask(species_a), as_mask(species_b)
    pair_mask = sel_a[:, None] & sel_b[None, :] & ~torch.eye(
        n, dtype=torch.bool, device=dev)

    counts = torch.zeros(n_bins, dtype=torch.float64, device=dev)
    for chunk in frames.split(FRAME_CHUNK):
        dr = space.min_image(chunk[:, None, :, :] - chunk[:, :, None, :],
                             box)
        d = torch.sqrt(torch.clamp(torch.sum(dr * dr, dim=-1), min=1e-12))
        d = torch.where(pair_mask, d, 2.0 * r_max)     # drop excluded pairs
        d = d.reshape(-1)
        b = torch.bucketize(d, edges, right=True)
        b = torch.where(d == edges[-1], n_bins, b)
        b = b[(b >= 1) & (b <= n_bins)] - 1
        counts += torch.bincount(b, minlength=n_bins).double()
    counts = counts.cpu().numpy() / t

    # Ideal-gas normalisation: n_a * n_b / V pairs per shell volume.
    r_edges = edges_np.astype(np.float64)
    shell_vol = 4.0 / 3.0 * np.pi * (r_edges[1:] ** 3 - r_edges[:-1] ** 3)
    ideal = shell_vol * float(sel_a.sum()) * float(sel_b.sum()) \
        / float(box) ** 3
    g = np.where(ideal > 0, counts / ideal, 0.0)
    r_centers = 0.5 * (r_edges[1:] + r_edges[:-1])
    return r_centers, g


def rdf_l2(g1, g2):
    """L2 distance between two RDF curves (root mean square over bins)."""
    g1 = np.asarray(g1)
    g2 = np.asarray(g2)
    return float(np.sqrt(np.mean((g1 - g2) ** 2)))


def unwrap_trajectory(frames, box):
    """Remove periodic wrapping from a sampled trajectory: each inter-frame
    displacement is taken min-image and accumulated (valid while no atom
    moves more than box/2 between samples).

    Args:
        frames: [T, N, 3] WRAPPED positions (tensor or numpy).
        box: cubic box edge.

    Returns:
        [T, N, 3] tensor of continuous positions, frame 0 unchanged.
    """
    frames = _frames(frames)
    steps = space.min_image(frames[1:] - frames[:-1], box)
    return torch.cat([frames[:1], frames[:1] + torch.cumsum(steps, dim=0)])


def mean_squared_displacement(frames, box, dt_ps, species=None):
    """MSD(t) over a sampled trajectory, averaged over time origins.

    Args:
        frames: [T, N, 3] wrapped positions (angstrom), uniform sampling.
        box: cubic box edge.
        dt_ps: time between samples (ps).
        species: optional [N] bool mask (e.g. oxygens only).

    Returns:
        (t_ps [T-1], msd [T-1] in A^2) numpy arrays; msd[k-1] is the mean
        over all origins of |r(t0 + k dt) - r(t0)|^2.
    """
    u = unwrap_trajectory(frames, box).cpu().numpy()
    if species is not None:
        u = u[:, np.asarray(species)]
    n_t = u.shape[0]
    lags = np.arange(1, n_t)
    msd = np.empty(n_t - 1)
    for k in lags:
        d = u[k:] - u[:n_t - k]
        msd[k - 1] = (d * d).sum(-1).mean()
    return lags * dt_ps, msd


def diffusion_coefficient(t_ps, msd_a2, fit_lo_frac=0.1, fit_hi_frac=0.5):
    """Self-diffusion D from the linear MSD regime, MSD = 6 D t, fitted
    over the [fit_lo_frac, fit_hi_frac] window of the lag range. Returns D
    in m^2/s (inputs ps and A^2)."""
    n = len(t_ps)
    lo = int(n * fit_lo_frac)
    hi = max(int(n * fit_hi_frac), lo + 2)
    slope = np.polyfit(t_ps[lo:hi], msd_a2[lo:hi], 1)[0]   # A^2 / ps
    return slope / 6.0 * 1e-20 / 1e-12
