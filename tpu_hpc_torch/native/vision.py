"""Real-image classification through the native file loader.

Port of the JAX package's ``native/vision.py``: convert a real on-disk
image dataset once into the binary record format
(``dataloader.write_dataset``), then train from the mmap'd,
epoch-shuffled, thread-prefetched reader on every rank. The same inputs
give the same record files, byte for byte, as the JAX package's.

  * :func:`prepare_digits` -- the bundled real dataset (scikit-learn's
    handwritten digits: 1,797 real 8x8 grayscale images, 10 classes;
    offline, no download; scikit-learn is imported only here) split
    train/test and written as two record files. Any dataset becomes the
    same format via ``--npz`` (arrays ``x`` [N, H, W, C] and ``y`` [N]
    int labels).
  * :func:`prepare_digits_at_scale` -- CIFAR-scale record files grown
    from the same real images by seeded augmentation.
  * :class:`NativeImageClassDataset` -- (image, label) Trainer adapter
    over :class:`~tpu_hpc_torch.native.dataloader.NativeFileDataset`.
    Images go out NHWC ``[B, H, W, C]`` float32, the layout the port's
    vision models take at their boundary (they view it as NCHW
    ``channels_last`` inside, models/resnet.py); labels go out int64,
    as ``datasets.CIFARSynthetic``'s do (torch's losses index with
    int64; the JAX adapter's are int32 of the same values).
  * :func:`prepare_on_host0` -- rank 0 materializes the files, every
    other rank waits at a ``torch.distributed`` barrier.

CLI: ``python -m tpu_hpc_torch.native.vision --out data/digits``
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from tpu_hpc_torch.native.dataloader import (
    NativeFileDataset,
    prepare_on_host0,  # noqa: F401 -- re-export (vision callers)
    write_dataset,
)


def prepare_digits(
    out_prefix: str, test_fraction: float = 0.2, seed: int = 0,
    npz_path: Optional[str] = None,
) -> Dict:
    """Write ``<out_prefix>.train`` / ``.test`` record files + a
    ``.json`` sidecar describing shapes and classes.

    Default source: scikit-learn's real handwritten-digits images
    (normalized to [0, 1]; NHWC with one channel). ``npz_path``
    substitutes any local dataset with arrays ``x`` (``[N, H, W, C]``
    or ``[N, H, W]``) and integer ``y`` (``[N]``).
    """
    if npz_path is not None:
        with np.load(npz_path) as z:
            x, y = np.asarray(z["x"], np.float32), np.asarray(z["y"])
    else:
        from sklearn.datasets import load_digits

        d = load_digits()
        x = (d.images / 16.0).astype(np.float32)  # [N, 8, 8] in [0,1]
        y = d.target
    if x.ndim == 3:
        x = x[..., None]  # NHWC, single channel
    if x.ndim != 4:
        raise ValueError(f"x must be [N, H, W, C], got shape {x.shape}")
    y = np.asarray(y)
    if y.shape != (x.shape[0],):
        raise ValueError(
            f"y must be [N] int labels, got {y.shape} for N={x.shape[0]}"
        )
    n = x.shape[0]
    # Deterministic shuffle-then-split (the reference splits by
    # torchvision's train/test files; a bundled single-array dataset
    # splits here, reproducibly).
    perm = np.random.default_rng(seed).permutation(n)
    n_test = max(int(n * test_fraction), 1)
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    meta = {
        "x_shape": list(x.shape[1:]),
        "n_classes": int(y.max()) + 1,
        "n_train": int(train_idx.size),
        "n_test": int(test_idx.size),
        "source": npz_path or "sklearn.datasets.load_digits",
    }
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    write_dataset(
        out_prefix + ".train",
        x[train_idx], y[train_idx].astype(np.float32)[:, None],
    )
    write_dataset(
        out_prefix + ".test",
        x[test_idx], y[test_idx].astype(np.float32)[:, None],
    )
    with open(out_prefix + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def _augment_batch(
    base: np.ndarray, rng: np.random.Generator, n: int
) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` augmented images drawn from the real ``base`` stack
    [K, H, W]: random affine (rotation +-15 deg, shift +-10%, zoom
    0.9-1.1), brightness/contrast jitter, gaussian noise. Returns
    (images [n, H, W], source indices [n])."""
    from scipy import ndimage

    k, h, w = base.shape
    idx = rng.integers(0, k, size=n)
    out = np.empty((n, h, w), np.float32)
    ang = rng.uniform(-15, 15, size=n)
    zoom = rng.uniform(0.9, 1.1, size=n)
    shift = rng.uniform(-0.1, 0.1, size=(n, 2)) * (h, w)
    c = np.array([h, w], np.float64) / 2 - 0.5
    for i in range(n):
        th = np.deg2rad(ang[i])
        rot = np.array(
            [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        ) / zoom[i]
        offset = c - rot @ (c + shift[i])
        out[i] = ndimage.affine_transform(
            base[idx[i]], rot, offset=offset, order=1, mode="constant",
        )
    gain = rng.uniform(0.8, 1.2, size=(n, 1, 1)).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, size=(n, 1, 1)).astype(np.float32)
    noise = rng.normal(0, 0.02, size=out.shape).astype(np.float32)
    return np.clip(out * gain + bias + noise, 0.0, 1.0), idx


def prepare_digits_at_scale(
    out_prefix: str,
    n_train: int = 50000,
    n_test: int = 10000,
    size: int = 32,
    test_fraction: float = 0.2,
    seed: int = 0,
) -> Dict:
    """CIFAR-SCALE record files from the bundled real images: the
    1,797 real digits upsampled to ``size`` x ``size`` and expanded by
    random affine/photometric augmentation to ``n_train`` + ``n_test``
    images (CIFAR-10's 50k/10k shape at the default sizes), written
    through :func:`~tpu_hpc_torch.native.dataloader.write_dataset` so the
    C++ prefetch ring runs at real-dataset size (role parity: the
    reference's rank-0 CIFAR-10 download + barrier; with no download,
    scale comes from augmenting the real images at hand).

    The split is BY ORIGINAL IMAGE: test augmentations are drawn only
    from originals the train set never sees, so held-out accuracy
    measures generalization to unseen source images, not memorized
    augmentation neighborhoods.
    """
    from scipy import ndimage
    from sklearn.datasets import load_digits

    d = load_digits()
    x = (d.images / 16.0).astype(np.float32)
    y = np.asarray(d.target)
    k = x.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(k)
    n_hold = max(int(k * test_fraction), 1)
    test_orig, train_orig = perm[:n_hold], perm[n_hold:]
    factor = size / x.shape[1]
    xz = ndimage.zoom(x, (1, factor, factor), order=1)
    xtr, itr = _augment_batch(xz[train_orig], rng, n_train)
    xte, ite = _augment_batch(xz[test_orig], rng, n_test)
    meta = {
        "x_shape": [size, size, 1],
        "n_classes": int(y.max()) + 1,
        "n_train": n_train,
        "n_test": n_test,
        "n_source_images": k,
        "source": (
            "sklearn.datasets.load_digits x affine/photometric "
            "augmentation (train/test split by original image)"
        ),
    }
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    write_dataset(
        out_prefix + ".train", xtr[..., None],
        y[train_orig][itr].astype(np.float32)[:, None],
    )
    write_dataset(
        out_prefix + ".test", xte[..., None],
        y[test_orig][ite].astype(np.float32)[:, None],
    )
    with open(out_prefix + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def read_meta(out_prefix: str) -> Dict:
    with open(out_prefix + ".json") as f:
        return json.load(f)


@dataclasses.dataclass
class NativeImageClassDataset:
    """(image, label) batches from a record file, through the C++
    prefetch ring: float records carry the label as one trailing float;
    batches come back as (``[B, H, W, C]`` float32, ``[B]`` int64) CPU
    tensors -- the contract of ``datasets.CIFARSynthetic``."""

    path: str
    batch_size: int
    x_shape: Tuple[int, ...]
    seed: int = 0
    prefetch_depth: int = 4
    n_threads: int = 2

    def __post_init__(self):
        self._ds = NativeFileDataset(
            self.path, self.batch_size, tuple(self.x_shape), (1,),
            seed=self.seed, prefetch_depth=self.prefetch_depth,
            n_threads=self.n_threads,
        )
        self.n_samples = self._ds.n_samples

    @staticmethod
    def _labels(y: torch.Tensor) -> torch.Tensor:
        return torch.round(y.reshape(-1)).to(torch.int64)

    def batch_at(self, step: int, batch_size: int):
        x, y = self._ds.batch_at(step, batch_size)
        return x, self._labels(y)

    def next(self):
        x, y = self._ds.next()
        return x, self._labels(y)

    def close(self) -> None:
        self._ds.close()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="data/digits",
                    help="output prefix (writes .train/.test/.json)")
    ap.add_argument("--npz", default=None,
                    help="convert this npz (arrays x, y) instead of "
                    "the bundled digits")
    ap.add_argument("--test-fraction", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--at-scale", action="store_true",
                    help="write the CIFAR-scale augmented set "
                    "(--n-train/--n-test images at --size px) instead "
                    "of the raw 1,797-image digits")
    ap.add_argument("--n-train", type=int, default=50000)
    ap.add_argument("--n-test", type=int, default=10000)
    ap.add_argument("--size", type=int, default=32)
    args = ap.parse_args(argv)
    if args.at_scale and args.npz:
        # The at-scale path augments the bundled digits only; silently
        # dropping a user's --npz dataset would write the wrong images
        # with exit code 0.
        ap.error("--at-scale and --npz are mutually exclusive")
    if args.at_scale:
        meta = prepare_digits_at_scale(
            args.out, args.n_train, args.n_test, args.size,
            args.test_fraction, args.seed,
        )
    else:
        meta = prepare_digits(
            args.out, args.test_fraction, args.seed, npz_path=args.npz
        )
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
