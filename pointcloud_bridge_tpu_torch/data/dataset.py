"""Block dataset + disk cache + batch iterator.

Mirrors the reference dataset workflow (BriPCDMulti*/BriPCD_gen, SURVEY.md
§2.4): build fixed-shape blocks from LAS/H5 scenes once, cache them keyed by
content (md5 of file names + mtimes + sampler params, BriPCDMulti.py:27-65),
then iterate shuffled batches with optional augmentation.

TPU-first: batches are plain numpy dicts of fixed shape, ready for
jax.device_put / sharding; no per-item torch Dataset indirection.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import augment as aug
from .blocks import Block, make_training_blocks
from .h5io import read_h5
from .lasio import read_las


def _load_scene(path: str):
    """Returns (points [N,3] f32, colors01 [N,3] f32, labels [N] i64)."""
    if path.endswith(".h5") or path.endswith(".hdf5"):
        points, colors, labels = read_h5(path)
        return (
            np.asarray(points, np.float32),
            np.asarray(colors, np.float32),
            np.asarray(labels, np.int64),
        )
    las = read_las(path)
    colors = las.colors01
    if colors is None:
        colors = np.zeros((len(las.xyz), 3), np.float32)
    return (
        las.xyz.astype(np.float32),
        colors,
        las.classification.astype(np.int64),
    )


def _build_blocks_for_file(task: dict) -> "List[Block]":
    """Per-file block construction (top-level so multiprocessing can pickle
    it — the reference forks a Pool over files, BriPCDMulti_new.py:143-153)."""
    pts, cols, labs = _load_scene(task["path"])
    sampler = task["sampler"]
    if sampler == "simple":
        from .samplers_extra import simple_random_blocks

        return simple_random_blocks(
            pts, cols, labs, task["num_points"], task["steps_per_file"],
            file_name=task["name"], seed=task["seed"],
        )
    if sampler == "chunked":
        from .samplers_extra import chunked_blocks

        return chunked_blocks(
            pts, cols, labs, task["num_points"], task["chunk_size"],
            task["overlap"], file_name=task["name"],
        )
    return make_training_blocks(
        pts,
        cols,
        labs,
        num_points=task["num_points"],
        block_size=task["block_size"],
        sample_rate=task["sample_rate"],
        num_classes=task["num_classes"],
        weighted=sampler == "weighted",
        stratified=sampler != "random",
        file_name=task["name"],
        seed=task["seed"],
    )


def _cache_key(files: Sequence[str], params: str) -> str:
    parts = []
    for f in sorted(files):
        mtime = os.path.getmtime(f)
        parts.append(f"{os.path.basename(f)}_{mtime}")
    content = "_".join(parts) + "|" + params
    return hashlib.md5(content.encode()).hexdigest()[:12]


@dataclass
class BlockDataset:
    """Fixed-shape training/eval blocks from one or more scenes."""

    points: np.ndarray  # [NB, P, 3] normalized
    colors: np.ndarray  # [NB, P, 3]
    labels: np.ndarray  # [NB, P]
    original_points: np.ndarray  # [NB, P, 3]
    indices: np.ndarray  # [NB, P]
    file_ids: np.ndarray  # [NB] index into file_names
    file_names: List[str]
    augment: bool = False

    def __len__(self) -> int:
        return len(self.points)

    @property
    def num_points(self) -> int:
        return self.points.shape[1]

    def label_counts(self, num_classes: int) -> np.ndarray:
        return np.bincount(self.labels.reshape(-1), minlength=num_classes)[
            :num_classes
        ].astype(np.float64)

    @classmethod
    def from_blocks(
        cls, blocks: List[Block], file_names: List[str], augment: bool = False
    ) -> "BlockDataset":
        name_to_id = {n: i for i, n in enumerate(file_names)}
        return cls(
            points=np.stack([b.points for b in blocks]),
            colors=np.stack([b.colors for b in blocks]),
            labels=np.stack([b.labels for b in blocks]),
            original_points=np.stack([b.original_points for b in blocks]),
            indices=np.stack([b.indices for b in blocks]),
            file_ids=np.array([name_to_id.get(b.file_name, 0) for b in blocks]),
            file_names=file_names,
            augment=augment,
        )

    @classmethod
    def from_files(
        cls,
        files: Sequence[str],
        num_points: int = 4096,
        block_size: float = 1.0,
        sample_rate: float = 0.5,
        num_classes: Optional[int] = None,
        weighted: bool = False,
        sampler: str = "stratified",
        chunk_size: int = 8192,
        overlap: int = 1024,
        steps_per_file: int = 10,
        cache_dir: Optional[str] = None,
        augment: bool = False,
        seed: int = 0,
        processes: int = 0,
    ) -> "BlockDataset":
        """sampler: 'stratified' (BriPCDMulti) | 'weighted' (BriPCD_gen) |
        'random' (BriPCDMulti_voxel) | 'simple' (SimplePointCloudDataset) |
        'chunked' (data_utils_ver2). `weighted=True` implies 'weighted'.
        processes>1 preprocesses files in a multiprocessing pool (the
        reference's Pool over files, BriPCDMulti_new.py:143-153)."""
        files = list(files)
        if weighted:
            sampler = "weighted"
        params = (
            f"np{num_points}_bs{block_size}_sr{sample_rate}_{sampler}"
            f"_c{chunk_size}_o{overlap}_st{steps_per_file}_s{seed}"
        )
        cache_path = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            cache_path = os.path.join(
                cache_dir, f"blocks_{_cache_key(files, params)}.npz"
            )
            if os.path.exists(cache_path):
                z = np.load(cache_path, allow_pickle=False)
                return cls(
                    points=z["points"],
                    colors=z["colors"],
                    labels=z["labels"],
                    original_points=z["original_points"],
                    indices=z["indices"],
                    file_ids=z["file_ids"],
                    file_names=[os.path.basename(f) for f in files],
                    augment=augment,
                )

        names = [os.path.basename(f) for f in files]
        tasks = [
            dict(
                path=f,
                name=names[i],
                sampler=sampler,
                num_points=num_points,
                block_size=block_size,
                sample_rate=sample_rate,
                num_classes=num_classes,
                chunk_size=chunk_size,
                overlap=overlap,
                steps_per_file=steps_per_file,
                seed=seed + i,
            )
            for i, f in enumerate(files)
        ]
        if processes and processes > 1 and len(files) > 1:
            import multiprocessing as mp

            with mp.Pool(min(processes, len(files))) as pool:
                per_file = pool.map(_build_blocks_for_file, tasks)
        else:
            per_file = [_build_blocks_for_file(t) for t in tasks]
        all_blocks: List[Block] = [b for blocks in per_file for b in blocks]
        ds = cls.from_blocks(all_blocks, names, augment=augment)
        if cache_path:
            np.savez_compressed(
                cache_path,
                points=ds.points,
                colors=ds.colors,
                labels=ds.labels,
                original_points=ds.original_points,
                indices=ds.indices,
                file_ids=ds.file_ids,
            )
        return ds

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        epoch: int = 0,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield dicts {points, colors, labels} of fixed [B, P, ...] shape.

        When the dataset doesn't divide evenly and drop_last=False, the tail
        batch is padded by wrapping around (fixed shapes for jit; a 'mask' key
        marks real rows).
        """
        n = len(self)
        rng = np.random.default_rng(seed + epoch * 10007)
        order = rng.permutation(n) if shuffle else np.arange(n)
        nb = n // batch_size if drop_last else int(np.ceil(n / batch_size))
        for i in range(nb):
            sel = order[i * batch_size : (i + 1) * batch_size]
            mask = np.ones(batch_size, bool)
            if len(sel) < batch_size:
                pad = np.resize(order, batch_size - len(sel))
                mask[len(sel) :] = False
                sel = np.concatenate([sel, pad])
            pts = self.points[sel]
            cols = self.colors[sel]
            if self.augment:
                out_p = np.empty_like(pts)
                out_c = np.empty_like(cols)
                for j, s in enumerate(sel):
                    out_p[j], out_c[j] = aug.apply_transform(
                        pts[j], cols[j], rng
                    )
                pts, cols = out_p, out_c
            yield {
                "points": pts.astype(np.float32),
                "colors": cols.astype(np.float32),
                "labels": self.labels[sel].astype(np.int32),
                "mask": mask,
                "block_ids": sel.astype(np.int32),
            }
