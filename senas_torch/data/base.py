"""Dataset base: per-dataset constants, registry, host-side batch loader.

A numpy copy of `senas_tpu/data/base.py`, kept here so that the port
imports nothing of the JAX package. Batches are NHWC float32 images and
int32 label maps; the runner moves them to the device. The datasets
registered are `synthetic`, `promise12` (`data/promise12.py`), `chaos`,
`chaos_mr`, `ultrasound_nerve`, `bladder`, `camvid`
(`data/png_datasets.py`), `heart`, `spleen`, `pancreas`, `hippo`
(`data/msd.py`), `monusac` (`data/monusac.py`), and the generic loaders
`ade20k`, `pascal_voc`, `pascal_aug`, `pcontext`, `coco`, `minc` and
`imagenet` (`data/generic.py`, which adds their specs to SPECS).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Static per-dataset constants."""

    name: str
    base_dir: str
    num_class: int
    in_channels: int
    crop_size: Tuple[int, int]  # (H, W)
    presize: bool
    mean: Optional[Tuple[float, ...]] = None
    std: Optional[Tuple[float, ...]] = None
    class_weights: Optional[Tuple[float, ...]] = None


# Constants verified against the reference dataset classes (file:line in
# SURVEY.md §2.3; e.g. promise12.py:345-354, heart.py:19-23, hippo.py:19-23).
SPECS: Dict[str, DatasetSpec] = {
    "promise12": DatasetSpec("promise12", "PROMISE2012", 2, 1, (256, 256), False),
    "chaos": DatasetSpec("chaos", "CHAOS/CT_data_batch/", 2, 1, (256, 256), True,
                         (0.2389,), (0.2801,)),
    # MR mode: T1DUAL+T2SPIR series, 4 organ classes + background
    # (chaos.py:86-88 TYPE flag)
    "chaos_mr": DatasetSpec("chaos_mr", "CHAOS/MR_data_batch1/", 5, 1,
                            (256, 256), True, (0.2389,), (0.2801,)),
    "heart": DatasetSpec("heart", "Task02_Heart/", 2, 1, (256, 320), False,
                         (0.3949544,), (0.41724333,)),
    "spleen": DatasetSpec("spleen", "Task09_Spleen/", 2, 1, (256, 256), True,
                          (0.072520524,), (0.18196131,)),
    "pancreas": DatasetSpec("pancreas", "Task07_Pancreas/", 2, 1, (256, 256), True,
                            (0.07691266,), (0.18697876,)),
    "hippo": DatasetSpec("hippo", "Task04_Hippocampus/", 2, 1, (32, 48), True,
                         (0.79002064,), (0.14168018,)),
    "monusac": DatasetSpec("monusac", "MoNuSAC/", 2, 1, (256, 256), False,
                           (0.5336434,), (0.2037772,)),
    "ultrasound_nerve": DatasetSpec("ultrasound_nerve", "ultrasound-nerve", 2, 1,
                                    (256, 256), False, (0.3919,), (0.2212,)),
    "bladder": DatasetSpec("bladder", "bladder", 3, 1, (512, 512), False,
                           (0.1355,), (0.1348,)),
    "camvid": DatasetSpec("camvid", "CamVid", 12, 3, (256, 256), False),
    "synthetic": DatasetSpec("synthetic", "", 2, 1, (64, 64), False),
}


class SegmentationDataset:
    """Indexable (image, label) dataset: image float32 [H,W,C] NHWC-ready,
    label int32 [H,W]."""

    spec: DatasetSpec

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    # convenience properties mirroring the reference BaseDataset API
    @property
    def num_class(self):
        return self.spec.num_class

    @property
    def in_channels(self):
        return self.spec.in_channels

    @property
    def crop_size(self):
        return self.spec.crop_size

    @property
    def class_weight(self):
        return self.spec.class_weights


class DataLoader:
    """Host-side batcher: shuffle / drop_last / subset sampling, with the
    samples of a batch fetched by a thread pool.

    `indices` supports the reference's 50/50 SubsetRandomSampler split of one
    trainset for bilevel search (experiments/search_arc.py:78-94).

    `workers` threads fetch the samples of a batch (the reference's
    n_workers DataLoader processes, as threads: numpy and scipy release the
    interpreter lock in the heavy operations); default: the
    SENAS_LOADER_WORKERS environment variable, else min(4, cores); 0 or 1
    fetches serially. With more than one worker the transforms' draws from
    the global `random` and `np.random` interleave in whatever order the
    threads take, in the JAX package too, so a sample depends on the
    threads' timing: tests that hold the two packages' samples together use
    workers=0.
    """

    def __init__(self, dataset: SegmentationDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 indices: Optional[List[int]] = None, seed: int = 0,
                 workers: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.indices = list(indices) if indices is not None else list(range(len(dataset)))
        self._rng = np.random.RandomState(seed)
        if workers is None:
            workers = int(os.environ.get("SENAS_LOADER_WORKERS", min(4, os.cpu_count() or 1)))
        self.workers = workers
        self._pool = None

    def __len__(self):
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(self.indices)
        if self.shuffle:
            self._rng.shuffle(order)
        fetch = self.dataset.__getitem__
        pool = self._get_pool()
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                return
            samples = list(pool.map(fetch, chunk)) if pool else [fetch(i) for i in chunk]
            yield {
                "image": np.stack([s[0] for s in samples]).astype(np.float32),
                "label": np.stack([s[1] for s in samples]).astype(np.int32),
            }

    def _get_pool(self):
        if self.workers <= 1:
            return None
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                            thread_name_prefix="senas-loader")
        return self._pool

    # NOTE on trailing partial batches: the reference evaluates the true
    # partial batch (no padding), and the batch-aggregated dice loss is not
    # decomposable per-sample, so zero-padding would change the numbers.


class PrefetchLoader:
    """Background-thread prefetch wrapper around a DataLoader.

    The stand-in for the reference's DataLoader workers (n_workers: 2,
    senas_promise12.yml:16): batch assembly (augmentation, elastic
    deformation) overlaps the device step. depth=2 keeps one batch in
    flight and one ready. `waits` holds, for each batch, the seconds the
    consumer spent blocked on it: the loader's part of a training loop's
    wall time.
    """

    def __init__(self, loader: "DataLoader", depth: int = 2):
        self.loader = loader
        self.depth = depth
        self.waits: List[float] = []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        _END = object()

        def worker():
            try:
                for batch in self.loader:
                    q.put(batch)
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)
                return
            q.put(_END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            self.waits.append(time.perf_counter() - t0)
            yield item
        t.join()


# ---------------------------------------------------------------------------
# Registry (utils/datasets/__init__.py:21-66)
# ---------------------------------------------------------------------------

_FACTORIES: Dict[str, Callable[..., SegmentationDataset]] = {}


def register_dataset(name: str):
    def deco(fn):
        _FACTORIES[name] = fn
        return fn
    return deco


def get_dataset_spec(name: str) -> DatasetSpec:
    return SPECS[name.lower()]


def get_dataset(name: str, path: Optional[str] = None, **kwargs) -> SegmentationDataset:
    """The dataset `name` under the directory `path` (the data root that
    holds e.g. PROMISE2012/; the synthetic dataset reads no files and takes
    none)."""
    name = name.lower()
    _ensure_registered()
    if name not in _FACTORIES:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(_FACTORIES)}")
    return _FACTORIES[name](root=path, **kwargs)


def require_root(name: str, root: Optional[str]) -> str:
    """The data root of dataset `name`; None raises (the CLIs' --data_root)."""
    if root is None:
        raise ValueError(f"the {name} dataset reads its files under a data root: "
                         "pass --data_root")
    return os.path.expanduser(root)


def _ensure_registered():
    # import side-effect registration, deferred to avoid import cycles
    from senas_torch.data import (generic, monusac, msd, png_datasets,  # noqa: F401
                                  promise12, synthetic)


DATASETS = SPECS
