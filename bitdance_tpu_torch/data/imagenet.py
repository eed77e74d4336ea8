"""ImageNet data pipeline: tar-backed random access and deterministic crops
(port of bitdance_tpu/data/imagenet.py, the reference's
imagenet_gen/src/dataset.py).

numpy and PIL only, so it gives the JAX module's bytes: NHWC float32 batches
in [-1, 1] with int32 labels. The reference's key properties:

  - random access into the UN-extracted official ImageNet tar via a one-time
    flat (offset, size, label) index over the inner tars (dataset.py:41-77),
    per-worker persistent file handle (dataset.py:99-107);
  - ADM center-crop / random-crop(0.8-1.0) chosen by a decaying aug_ratio,
    h-flip, normalize to [-1, 1] (dataset.py:114-164, 199-216);
  - deterministic per-(seed, epoch, idx) sampling (dataset.py:17-38) so any
    example is reproducible regardless of worker layout — this is also the
    checkpoint-resume story for data (skip consumed indices).
"""

from __future__ import annotations

import contextlib
import io
import math
import os
import pickle
import tarfile

import numpy as np


@contextlib.contextmanager
def numpy_seed(seed, *addl_seeds):
    """Seed numpy's PRNG inside the block, restoring state after
    (dataset.py:17-38)."""
    if seed is None:
        yield
        return
    if addl_seeds:
        seed = int(hash((int(seed), *map(int, addl_seeds))) % int(1e8))
    state = np.random.get_state()
    np.random.seed(int(seed))
    try:
        yield
    finally:
        np.random.set_state(state)


def build_flat_index(outer_path: str, idx_path: str, native: bool = True):
    """One-time [(offset, size, label)] index over the nested ImageNet tar,
    cached as a pickle at ``idx_path`` (read back if it exists).

    native=True scans with the C++ indexer (csrc/tar_index.cpp, ~10x faster
    on the full 150 GB tar) and raises if it cannot be built or fails;
    native=False walks the headers with Python's tarfile (the plain
    version). The two give the same index on the official layout, where an
    inner tar's name is its images' class prefix."""
    if os.path.exists(idx_path):
        with open(idx_path, "rb") as f:
            return pickle.load(f)
    if native:
        from bitdance_tpu_torch.data.native import build_tar_index_native

        entries, _classes = build_tar_index_native(outer_path, idx_path)
        flat = [tuple(e) for e in entries]
    else:
        flat = python_tar_index(outer_path)
    os.makedirs(os.path.dirname(idx_path) or ".", exist_ok=True)
    with open(idx_path, "wb") as f:
        pickle.dump(flat, f)
    return flat


def python_tar_index(outer_path: str) -> list[tuple[int, int, int]]:
    """The index by Python's tarfile: each image's class is its file name's
    prefix before "_", classes numbered in sorted order."""
    entries, cats = [], set()
    with tarfile.open(outer_path, "r:") as outer:
        for sub in outer.getmembers():
            if not sub.isfile() or not sub.name.endswith(".tar"):
                continue
            outer_off = sub.offset_data
            sub_fobj = outer.extractfile(sub)
            with tarfile.open(fileobj=sub_fobj, mode="r:") as inner:
                for m in inner.getmembers():
                    if not m.isfile():
                        continue
                    cat = m.name.split("_", 1)[0]
                    cats.add(cat)
                    entries.append((outer_off + m.offset_data, m.size, cat))
    cat2idx = {c: i for i, c in enumerate(sorted(cats))}
    return [(off, size, cat2idx[c]) for off, size, c in entries]


class ImageNetTarDataset:
    """Random access into the un-extracted official ImageNet train tar (one
    file handle per process, opened at the first read)."""

    def __init__(self, tar_file: str):
        self.tar_file = tar_file
        self.tar_handle = None
        self.files = build_flat_index(tar_file, tar_file + ".index")

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int):
        from PIL import Image

        if self.tar_handle is None:
            self.tar_handle = open(self.tar_file, "rb")
        offset, size, label = self.files[index]
        self.tar_handle.seek(offset)
        data = self.tar_handle.read(size)
        return Image.open(io.BytesIO(data)).convert("RGB"), label


class ImageFolderDataset:
    """A folder of class folders (torchvision ImageFolder's layout)."""

    EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")

    def __init__(self, root: str):
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.samples = []
        for ci, c in enumerate(classes):
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(self.EXTS):
                    self.samples.append((os.path.join(cdir, fn), ci))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int):
        from PIL import Image

        path, label = self.samples[index]
        return Image.open(path).convert("RGB"), label


def center_crop_arr(pil_image, image_size: int):
    """ADM center crop (dataset.py:114-134)."""
    from PIL import Image

    while min(*pil_image.size) >= 2 * image_size:
        pil_image = pil_image.resize(
            tuple(x // 2 for x in pil_image.size), resample=Image.BOX)
    scale = image_size / min(*pil_image.size)
    pil_image = pil_image.resize(
        tuple(round(x * scale) for x in pil_image.size), resample=Image.BICUBIC)
    arr = np.array(pil_image)
    cy = (arr.shape[0] - image_size) // 2
    cx = (arr.shape[1] - image_size) // 2
    return arr[cy: cy + image_size, cx: cx + image_size]


def random_crop_arr(pil_image, image_size: int, min_crop_frac=0.8,
                    max_crop_frac=1.0):
    """Random-scale crop (dataset.py:141-164); uses the ambient numpy PRNG."""
    from PIL import Image

    min_s = math.ceil(image_size / max_crop_frac)
    max_s = math.ceil(image_size / min_crop_frac)
    smaller = int(np.random.randint(min_s, max_s + 1))
    while min(*pil_image.size) >= 2 * smaller:
        pil_image = pil_image.resize(
            tuple(x // 2 for x in pil_image.size), resample=Image.BOX)
    scale = smaller / min(*pil_image.size)
    pil_image = pil_image.resize(
        tuple(round(x * scale) for x in pil_image.size), resample=Image.BICUBIC)
    arr = np.array(pil_image)
    cy = int(np.random.randint(0, arr.shape[0] - image_size + 1))
    cx = int(np.random.randint(0, arr.shape[1] - image_size + 1))
    return arr[cy: cy + image_size, cx: cx + image_size]


class ImageCropDataset:
    """Deterministic crop/flip/normalize wrapper (dataset.py:174-226).

    Yields (image NHWC float32 in [-1,1], label int). aug_ratio decays
    linearly over late epochs (train.py:127-156) via set_aug_ratio.
    """

    def __init__(self, raw_dataset, resolution: int, seed: int = 42):
        self.raw_dataset = raw_dataset
        self.resolution = resolution
        self.aug_ratio = 1.0
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_aug_ratio(self, aug_ratio: float):
        self.aug_ratio = aug_ratio

    def __len__(self):
        return len(self.raw_dataset)

    def __getitem__(self, idx: int):
        with numpy_seed(self.seed, self.epoch, idx):
            image, label = self.raw_dataset[idx]
            if np.random.rand() < self.aug_ratio:
                arr = random_crop_arr(image, self.resolution)
            else:
                arr = center_crop_arr(image, self.resolution)
            if int(np.random.randint(0, 2)) == 1:
                arr = arr[:, ::-1, :]
            arr = (arr.astype(np.float32) / 255.0 - 0.5) * 2.0  # NHWC [-1,1]
            return arr, int(label)


def linear_decay_ratio(epoch: int, start: int, end: int) -> float:
    """aug_ratio schedule (train.py:134-143)."""
    if start < 0 or end <= start:
        return 1.0
    if epoch < start:
        return 1.0
    if epoch >= end:
        return 0.0
    return max(0.0, min(1.0, 1.0 - (epoch - start) / float(end - start)))


class ShardedBatchIterator:
    """DistributedSampler analogue: per-host shard, seeded shuffle per epoch,
    drop_last batching. Yields (images [B,H,W,3], labels [B]) numpy arrays.
    """

    def __init__(self, dataset, global_batch_size: int, num_shards: int = 1,
                 shard_index: int = 0, seed: int = 0, drop_last: bool = True):
        assert global_batch_size % num_shards == 0
        self.dataset = dataset
        self.local_batch = global_batch_size // num_shards
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.seed = seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + epoch)
        perm = rng.permutation(n)
        # pad to a multiple of shards like DistributedSampler
        total = (n // self.num_shards) * self.num_shards
        perm = perm[:total]
        return perm[self.shard_index:: self.num_shards]

    def iter_epoch(self, epoch: int, start_batch: int = 0):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        idxs = self.epoch_indices(epoch)
        nb = len(idxs) // self.local_batch
        for b in range(start_batch, nb):
            sel = idxs[b * self.local_batch: (b + 1) * self.local_batch]
            imgs, labels = zip(*(self.dataset[int(i)] for i in sel))
            yield np.stack(imgs), np.asarray(labels, np.int32)


def build_dataset(data_path: str, resolution: int, seed: int = 42):
    """ImageCropDataset over the official tar (``*.tar``, indexed by the
    native indexer) or a folder of class folders."""
    raw = (ImageNetTarDataset(data_path) if data_path.endswith(".tar")
           else ImageFolderDataset(data_path))
    return ImageCropDataset(raw, resolution, seed=seed)
