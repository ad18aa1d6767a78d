"""Host-side data loading: dataset factory, dict collate, epoch-seeded
batch order, per-sample augmentation rngs, worker-process loading and the
copy to the device (counterpart of m3vit_tpu/data/loader.py: get_dataset
and collate :23-82, the epoch order :284-288).

The loader is PyTorch's: a ``torch.utils.data.DataLoader`` over an
``EpochBatchSampler`` that yields each batch as a list of ``(epoch,
index)`` keys, in the JAX loader's order
(``np.random.RandomState(seed + epoch).shuffle``, ``drop_last`` as there).
With ``num_workers`` > 0 the workers persist across epochs, each builds
and collates whole batches, the main process pins them, and ``to_device``
copies each batch to the card with ``non_blocking=True`` one batch ahead.
A worker's exception, or its death, raises in the main process.

Batches are NCHW float32 tensors (the JAX ``collate`` values, transposed)
plus "meta", the list of per-image metadata.  Each sample's augmentation
rng is keyed on (seed, epoch, index) through ``np.random.SeedSequence``, so
an image is augmented afresh every epoch, and a run resumed at any batch
draws what the uninterrupted run drew.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler


def get_dataset(p, split: str, transform, overfit: bool = False):
    """reference: utils/common_config.py:635-716 (get_train/val_dataset)."""
    db = p["train_db_name"] if split == "train" else p["val_db_name"]
    names = set(p["TASK_NAMES"])
    roots = p.get("db_paths", {})
    if db == "PASCALContext":
        from m3vit_tpu_torch.data.pascal_context import PASCALContext

        return PASCALContext(
            root=roots.get("PASCAL_MT", ""),
            split="train" if split == "train" else "val",
            transform=transform,
            overfit=overfit,
            do_edge="edge" in names,
            do_human_parts="human_parts" in names,
            do_semseg="semseg" in names,
            do_normals="normals" in names,
            do_sal="sal" in names,
        )
    if db == "NYUD":
        from m3vit_tpu_torch.data.nyud import NYUD

        return NYUD(
            root=roots.get("NYUD_MT", ""),
            split="train" if split == "train" else "val",
            transform=transform,
            overfit=overfit,
            do_edge="edge" in names,
            do_semseg="semseg" in names,
            do_normals="normals" in names,
            do_depth="depth" in names,
        )
    if db == "CityScapes":
        from m3vit_tpu_torch.data.cityscapes import CityScapes

        return CityScapes(
            root=roots.get("cityscapes", ""),
            split="train" if split == "train" else "val",
            transform=transform,
            overfit=overfit,
            do_semseg="semseg" in names,
            do_depth="depth" in names,
        )
    raise NotImplementedError(db)


def collate(samples) -> Dict:
    """Dict-recursive stack (reference collate_mil, custom_collate.py:32-82)
    of HWC samples into NCHW float32 tensors; meta stays a list."""
    out: Dict = {}
    for key in samples[0]:
        if key == "meta":
            out["meta"] = [s["meta"] for s in samples]
        else:
            stacked = np.stack([s[key] for s in samples]).astype(np.float32)
            out[key] = torch.from_numpy(
                np.ascontiguousarray(stacked.transpose(0, 3, 1, 2)))
    return out


def sample_rng(seed: int, epoch: int, index: int) -> np.random.RandomState:
    """The augmentation rng of sample `index` in `epoch`: one stream per
    (seed, epoch, index), none shared by two keys."""
    return np.random.RandomState(
        np.random.SeedSequence([seed, epoch, index]).generate_state(4))


class TransformedDataset(Dataset):
    """`dataset` read by ``(epoch, index)`` keys, each sample passed through
    `transform` with its ``sample_rng``."""

    def __init__(self, dataset, transform, seed: int):
        self.dataset, self.transform, self.seed = dataset, transform, seed

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, key):
        epoch, index = key
        return self.transform(self.dataset[index],
                              sample_rng(self.seed, epoch, index))


def epoch_order(n: int, epoch: int, seed: int, shuffle: bool) -> np.ndarray:
    """The JAX loader's sample order of `epoch` (loader.py:284-288)."""
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(order)
    return order


class EpochBatchSampler(Sampler):
    """Batches of ``(epoch, index)`` keys in ``epoch_order``; ``set_epoch``
    picks the epoch and the first batch to yield (a mid-epoch resume skips
    the batches before it without reading them).  With ``world`` > 1 the
    batches are global batches of batch_size * world keys and this
    sampler yields rank ``rank``'s contiguous slice of each (the shard
    the JAX package's batch sharding gives that device)."""

    def __init__(self, n: int, batch_size: int, shuffle: bool,
                 drop_last: bool, seed: int, rank: int = 0, world: int = 1):
        self.n, self.batch_size = n, batch_size * world
        self.rank, self.per_rank = rank, batch_size
        self.shuffle, self.drop_last, self.seed = shuffle, drop_last, seed
        self.epoch, self.start = 0, 0

    def num_batches(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int, start: int = 0) -> None:
        self.epoch, self.start = epoch, start

    def __len__(self):
        return max(self.num_batches() - self.start, 0)

    def __iter__(self):
        order = epoch_order(self.n, self.epoch, self.seed, self.shuffle)
        lo = self.rank * self.per_rank
        for b in range(self.start, self.num_batches()):
            keys = order[b * self.batch_size:(b + 1) * self.batch_size]
            if self.batch_size != self.per_rank:
                keys = keys[lo:lo + self.per_rank]
            yield [(self.epoch, int(i)) for i in keys]


def init_worker(_worker_id: int) -> None:
    """worker_init_fn of the port's loaders: a worker forked after the
    parent ran OpenCV must not wait on the parent's thread pool, and one
    thread per worker keeps the cores shared."""
    import cv2

    cv2.setNumThreads(0)


class EpochLoader:
    """Epochs of collated batches of `dataset` under `transform` (with
    ``world`` > 1, rank ``rank``'s slice of each global batch of
    batch_size * world samples).

    num_workers 0 loads in the calling process; above 0, that many
    persistent worker processes with PyTorch's default two batches in
    flight each, every batch pinned in the main process when
    `pin_memory`.  Workers are forked (PyTorch's default; they never touch
    CUDA): spawned ones would import torch and the package afresh at every
    loader start."""

    def __init__(self, dataset, transform, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 num_workers: int = 0, pin_memory: bool = False,
                 rank: int = 0, world: int = 1):
        self.dataset = TransformedDataset(dataset, transform, seed)
        self.sampler = EpochBatchSampler(len(dataset), batch_size, shuffle,
                                         drop_last, seed, rank, world)
        workers = dict(num_workers=num_workers, persistent_workers=True,
                       worker_init_fn=init_worker) if num_workers > 0 \
            else {}
        self.loader = DataLoader(self.dataset, batch_sampler=self.sampler,
                                 collate_fn=collate, pin_memory=pin_memory,
                                 **workers)

    def __len__(self):
        return self.sampler.num_batches()

    def epoch(self, epoch: int, start: int = 0) -> Iterator[Dict]:
        """The batches of `epoch` from batch `start` on."""
        self.sampler.set_epoch(epoch, start)
        return iter(self.loader)

    def close(self) -> None:
        """Stops the worker processes (they persist across epochs)."""
        it = getattr(self.loader, "_iterator", None)
        if it is not None and hasattr(it, "_shutdown_workers"):
            it._shutdown_workers()
        self.loader._iterator = None


def to_device(batches: Iterable[Dict], device: torch.device,
              keys: Optional[Sequence[str]] = None) -> Iterator[Dict]:
    """Each batch with its tensors (those named in `keys`; all when None)
    copied to `device` with ``non_blocking=True``, one batch ahead: the
    copy of the next batch is queued before this one is handed out."""
    prev = None
    for b in batches:
        cur = {k: (v.to(device, non_blocking=True)
                   if isinstance(v, torch.Tensor)
                   and (keys is None or k in keys) else v)
               for k, v in b.items()}
        if prev is not None:
            yield prev
        prev = cur
    if prev is not None:
        yield prev
