"""Paired dataset for RefineNet training and inference, host-side
(counterpart of mofanerf_tpu/data/refine_dataset.py): A = NeRF renders,
B = ground truth, paired by sorted order. Training walks the id/exp tree
that `render_refine_trainset` writes; inference reads a flat directory.
Images load to float32 in [-1, 1] at load_size (a bicubic resize, clipped),
through the port's reader of every PNG, JPEG, BMP and WebP imageio reads.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from mofanerf_tpu_torch.utils.image_io import imread, resize_cubic

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def walk_render_tree(root: str) -> List[str]:
    """Every image under root, directories and files in sorted order."""
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.lower().endswith(IMG_EXTS):
                out.append(os.path.join(dirpath, f))
    return out


def walk_flat(root: str) -> List[str]:
    return sorted(os.path.join(root, f) for f in os.listdir(root)
                  if f.lower().endswith(IMG_EXTS))


class RefinePairDataset:
    """Sorted-order pairing of renders (A) with ground truth (B)."""

    def __init__(self, a_root: str, b_root: Optional[str] = None, load_size: int = 512,
                 flat: bool = False):
        walk = walk_flat if flat else walk_render_tree
        self.a_paths = walk(a_root)
        self.b_paths = walk(b_root) if b_root else []
        if self.b_paths:
            n = min(len(self.a_paths), len(self.b_paths))
            self.a_paths, self.b_paths = self.a_paths[:n], self.b_paths[:n]
        self.load_size = load_size

    def __len__(self) -> int:
        return len(self.a_paths)

    def _read(self, path: str, flip: bool) -> np.ndarray:
        img = np.asarray(imread(path), np.float32) / 255.0
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img[..., :3]
        if img.shape[0] != self.load_size:
            img = resize_cubic(img, (self.load_size, self.load_size))
            img = np.clip(img, 0.0, 1.0)  # bicubic overshoot
        if flip:
            img = img[:, ::-1]
        return (img * 2.0 - 1.0).astype(np.float32)  # [-1, 1]

    def get(self, idx: int, flip: bool = False) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        a = self._read(self.a_paths[idx], flip)
        b = self._read(self.b_paths[idx], flip) if self.b_paths else None
        return a, b
