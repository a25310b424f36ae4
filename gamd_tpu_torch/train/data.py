"""Trajectory datasets in the reference's .npz layout (port of
gamd_tpu/train/data.py: reference_split, TrajectoryDataset, batch_iterator;
numpy, as in the JAX package, so the same files give the same frames, the
same split and the same batches).

Per-frame files data_{seed}_{t}.npz with keys pos/vel/forces, seed-major,
and a deterministic 90/10 split from a seed-0 numpy shuffle. TIP4P frames
hold a virtual M site every 4th atom, which the loader drops from pos and
forces. Frames of one system share N, so batches stack to dense [B, N, 3]
arrays. An optional pack cache concatenates the per-frame files into one
.npz for fast epoch iteration, built by the port's native packer
(train/native_io.py) where g++ can build it, else by numpy.

RealLargeDataset is the RPBE/DFT single-npz set (md_dataset/
RPBE-surrogate.npz's layout): every frame in one file, with its own box.
"""

import os
from typing import Iterator, Optional

import numpy as np


def reference_split(n_total: int, train_fraction: float = 0.9):
    """(train ids, test ids): a RandomState(0) shuffle of arange(n_total),
    the first train_fraction of it for training."""
    idxs = np.arange(n_total)
    rng = np.random.RandomState(0)
    rng.shuffle(idxs)
    n_train = int(n_total * train_fraction)
    return idxs[:n_train], idxs[n_train:]


def _drop_m_sites(arr):
    """Remove every 4th row (the TIP4P virtual site)."""
    return arr[np.mod(np.arange(arr.shape[0]), 4) < 3]


class TrajectoryDataset:
    """data_{seed}_{t}.npz trajectory frames (LJ / TIP3P / TIP4P)."""

    def __init__(self, dataset_path, sample_num=1000, seed_num=10,
                 mode="train", data_type="lj", case_prefix="data_",
                 split=(0.9, 0.1), pack_cache: Optional[str] = None,
                 extra_seed_num=0):
        """extra_seed_num: trajectories beyond the canonical seed_num
        (files data_{seed_num}_{t}.npz ...) appended to the train set only;
        the split over the first seed_num * sample_num frames is unchanged,
        so the held-out set stays that of the canonical seeds.

        pack_cache: path of the packed .npz; built on first use, and a
        cache whose frame count does not match the dataset raises
        ValueError."""
        if mode not in ("train", "test"):
            raise ValueError(f"mode must be 'train' or 'test', not {mode!r}")
        self.dataset_path = dataset_path
        self.sample_num = sample_num
        self.seed_num = seed_num
        self.extra_seed_num = extra_seed_num
        self.data_type = data_type
        self.case_prefix = case_prefix
        train_idx, test_idx = reference_split(seed_num * sample_num, split[0])
        if mode == "train" and extra_seed_num:
            extra = np.arange(seed_num * sample_num,
                              (seed_num + extra_seed_num) * sample_num)
            train_idx = np.concatenate([train_idx, extra])
        self.idx = train_idx if mode == "train" else test_idx

        self._packed = None
        if pack_cache is not None:
            self._packed = self._load_or_build_pack(pack_cache)

        if data_type in ("tip3p", "tip4p"):
            # One-hot O=1/H=0 node feature from the O,H,H pattern.
            n = self.n_atoms
            self.particle_type_one_hot = (
                (np.arange(n) % 3 == 0).astype(np.float32).reshape(-1, 1))
        else:
            self.particle_type_one_hot = None

    @property
    def n_atoms(self):
        return self._read_raw(0)["pos"].shape[0]

    def __len__(self):
        return len(self.idx)

    def _fname(self, flat_idx):
        seed = flat_idx // self.sample_num
        t = flat_idx % self.sample_num
        return os.path.join(self.dataset_path,
                            f"{self.case_prefix}{seed}_{t}.npz")

    def _read_raw(self, flat_idx):
        if self._packed is not None:
            pos, forces = self._packed
            return {"pos": pos[flat_idx], "forces": forces[flat_idx]}
        with np.load(self._fname(flat_idx)) as raw:
            pos = raw["pos"].astype(np.float32)
            forces = raw["forces"].astype(np.float32)
        if self.data_type == "tip4p":
            pos = _drop_m_sites(pos)
            forces = _drop_m_sites(forces)
        return {"pos": pos, "forces": forces}

    def _load_or_build_pack(self, cache_path):
        """(pos, forces) of every frame, seed-major: read from cache_path,
        or packed and written there (host IO, not a device kernel)."""
        from gamd_tpu_torch.train import native_io

        total_seeds = self.seed_num + self.extra_seed_num
        if os.path.exists(cache_path):
            with np.load(cache_path, mmap_mode="r") as z:
                pos, forces = z["pos"], z["forces"]
            if pos.shape[0] != total_seeds * self.sample_num:
                raise ValueError(
                    f"pack cache {cache_path} holds {pos.shape[0]} frames "
                    f"but the dataset spans {total_seeds * self.sample_num} "
                    f"(seed_num={self.seed_num}, extra={self.extra_seed_num})"
                    " — delete the stale cache or use a distinct cache path")
            return pos, forces

        pos = forces = None
        if native_io.available():
            try:
                pos, forces = native_io.pack_trajectory(
                    self.dataset_path, total_seeds, self.sample_num,
                    self.n_atoms, drop_m_site=self.data_type == "tip4p",
                    prefix=self.case_prefix)
            except RuntimeError as e:
                # The packer reads the stored (uncompressed) npz that
                # np.savez writes; other archives take the numpy path.
                print(f"native packer failed ({e}); numpy fallback")
        if pos is None:
            pos, forces = pack_numpy(self, total_seeds * self.sample_num)
        np.savez(cache_path, pos=pos, forces=forces)
        return pos, forces

    def subtract_from_labels(self, offset_fn, chunk: int = 128):
        """Subtract ``offset_fn([B, N, 3] pos) -> [B, N, 3]`` (dataset force
        units) from every force label, in memory only: the pack cache on
        disk keeps the raw labels. Needs the pack cache."""
        if self._packed is None:
            raise ValueError("subtract_from_labels requires the packed "
                             "dataset cache (drop --no_pack)")
        pos, forces = self._packed
        pos = np.asarray(pos)
        forces = np.array(forces, copy=True)
        for i in range(0, pos.shape[0], chunk):
            forces[i:i + chunk] -= np.asarray(offset_fn(pos[i:i + chunk]))
        self._packed = (pos, forces)

    def __getitem__(self, i):
        frame = self._read_raw(int(self.idx[i]))
        if self.particle_type_one_hot is not None:
            frame["feat"] = self.particle_type_one_hot
        return frame


class RealLargeDataset:
    """The RPBE/DFT set in one npz (gamd_tpu/train/data.py:173-205): pos
    [M, N, 3] (bohr), force [M, N, 3] (Ha/bohr), box [M] (or [M, 3]) a
    frame, atom_type [M, N] (1 = O), and the split train_idx / test_idx.
    mode "train" takes train_idx (its first 1,500 with use_part), "test"
    test_idx. An item: pos and forces float32, feat [N, 1] float32 (1 on
    oxygen), box_size float32 (0-d, or [3])."""

    def __init__(self, dataset_path, mode="train", use_part=False):
        if mode not in ("train", "test"):
            raise ValueError(f"mode must be 'train' or 'test', not {mode!r}")
        with np.load(dataset_path, allow_pickle=True) as z:
            train_idx = z["train_idx"]
            test_idx = z["test_idx"]
            self.pos = z["pos"]
            self.forces = z["force"]
            self.box_size = z["box"]
            self.atom_type = z["atom_type"]
        if mode == "train":
            self.idx = train_idx[:1500] if use_part else train_idx
        else:
            self.idx = test_idx

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        j = self.idx[i]
        atom_type = np.asarray(self.atom_type[j]).reshape(-1)
        return {
            "pos": self.pos[j].astype(np.float32),
            "forces": self.forces[j].astype(np.float32),
            "feat": (atom_type == 1).astype(np.float32).reshape(-1, 1),
            "box_size": np.asarray(self.box_size[j], np.float32),
        }


def pack_numpy(dataset, n_frames):
    """(pos, forces) [n_frames, N, 3] float32 of the dataset's first
    n_frames flat frames, read file by file with numpy (the pack cache's
    path where the native packer is not built)."""
    frames = [dataset._read_raw(flat) for flat in range(n_frames)]
    return (np.stack([f["pos"] for f in frames]),
            np.stack([f["forces"] for f in frames]))


def batch_iterator(dataset, batch_size, shuffle=True, seed=0,
                   drop_last=True) -> Iterator[dict]:
    """Stack frames into dense [B, N, ...] numpy batches."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    end = len(order) - (len(order) % batch_size) if drop_last else len(order)
    for start in range(0, end, batch_size):
        items = [dataset[int(i)] for i in order[start:start + batch_size]]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}
