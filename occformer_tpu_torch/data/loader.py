"""Per-host sharded data loading with static-shape collation.

The port's copy of the numpy parts of ``occformer_tpu/data/loader.py``
(reference datasets/builder.py:19-101, datasets/samplers/group_sampler.py:14):
each host iterates its contiguous shard of an epoch-seeded permutation;
samples are collated into fixed-capacity numpy buffers (LiDAR points padded
to ``max_points`` with a validity mask), so every step sees one shape.
``group_flags`` give group-pure batches, as ``DistributedGroupSampler``'s
aspect-ratio groups do.  ``num_hosts`` / ``host_id`` shard the epoch for
data parallelism (the train and test CLIs pass the process group's world
size and rank; one process passes 1 / 0).  ``set_epoch(epoch, start_batch)``
starts an epoch part-way, skipping its first batches without building them:
a run resumed from a mid-epoch checkpoint sees the batches the uninterrupted
run saw.

``prefetch_to_device`` takes the place of the JAX package's
``prefetch_to_mesh``: batch i+1 goes from pinned host buffers to the card by
``non_blocking`` copies on a copy stream while step i runs.  ``build_dataset``
builds a config's dataset from the registry (``data/nuscenes.py``,
``data/semantic_kitti.py``, ``data/synthetic.py``).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


def pad_points(points: np.ndarray, max_points: int,
               rng: Optional[np.random.RandomState] = None):
    """[P, D] -> ([max_points, D], [max_points] valid).  Overflow is dropped
    uniformly at random (never biased to the scan order).  ``rng`` makes the
    subsampling reproducible (the reference seeds workers via worker_init_fn,
    datasets/builder.py:96-101); None falls back to the global stream."""
    P = points.shape[0]
    out = np.zeros((max_points, points.shape[1]), np.float32)
    valid = np.zeros((max_points,), bool)
    if P > max_points:
        sel = (rng or np.random).choice(P, max_points, replace=False)
        out[:] = points[sel]
        valid[:] = True
    else:
        out[:P] = points
        valid[:P] = True
    return out, valid


def collate_batch(
    samples: List[Dict],
    max_points: int = 35000,
    pc_range: Optional[Sequence[float]] = None,
    rng: Optional[np.random.RandomState] = None,
) -> Dict[str, np.ndarray]:
    """Stack per-sample pipeline outputs into the train-step batch dict."""
    batch: Dict[str, Any] = {}
    for key in ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans",
                "bda", "gt_depth"):
        if key in samples[0] and samples[0][key] is not None:
            batch[key] = np.stack([s[key] for s in samples]).astype(np.float32)
    if samples[0].get("gt_occ") is not None:
        batch["gt_occ"] = np.stack([s["gt_occ"] for s in samples]).astype(np.int32)
    if samples[0].get("panoptic_ids") is not None:
        batch["panoptic_ids"] = np.stack(
            [s["panoptic_ids"] for s in samples]).astype(np.int32)
    meta_keys = ("sample_idx", "sequence", "frame_id", "lidar_token",
                 "scene_token", "timestamp")
    batch["_meta"] = [
        {k: s.get(k) for k in meta_keys if s.get(k) is not None}
        for s in samples
    ]
    if samples[0].get("points_occ") is not None:
        xyz_l, valid_l, label_l = [], [], []
        pcr = np.asarray(
            pc_range if pc_range is not None else samples[0]["pc_range"], np.float32
        )
        for s in samples:
            pts = s["points_occ"]
            padded, valid = pad_points(pts, max_points, rng=rng)
            # normalize xyz to [0, 1] over the point-cloud range, the form the
            # loss consumes (mask2former_nusc_occ.py:233-236)
            xyz = (padded[:, :3] - pcr[:3]) / (pcr[3:] - pcr[:3])
            xyz_l.append(xyz)
            valid_l.append(valid)
            label_l.append(padded[:, -1])
        batch["lidar_xyz"] = np.stack(xyz_l)
        batch["lidar_valid"] = np.stack(valid_l)
        batch["lidar_label"] = np.stack(label_l).astype(np.int32)
    return batch


class ShardedLoader:
    """Epoch-seeded shuffled iterator over this host's shard, with a
    background prefetch thread.

    ``group_flags`` (or a ``dataset.flag`` attribute) enables
    DistributedGroupSampler-equivalent sampling: every batch is drawn from a
    single group (group_sampler.py:55-77), each group padded by in-group
    resampling to a multiple of ``batch_size * num_hosts``, and the
    group-pure batch units are epoch-shuffled then dealt round-robin across
    hosts — equal step counts per host, exactly like the reference's
    rank-sliced indices.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_hosts: int = 1,
        host_id: int = 0,
        max_points: int = 35000,
        drop_last: bool = True,
        prefetch: int = 2,
        collate_fn: Optional[Callable] = None,
        group_flags: Optional[np.ndarray] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.max_points = max_points
        self.drop_last = drop_last
        self.prefetch = prefetch
        if group_flags is None:
            group_flags = getattr(dataset, "flag", None)
        self.group_flags = (
            None if group_flags is None else np.asarray(group_flags))
        if self.group_flags is not None:
            assert len(self.group_flags) == len(dataset), (
                f"group_flags length {len(self.group_flags)} != "
                f"dataset length {len(dataset)}")
        self.collate_fn = collate_fn or (
            lambda s, rng=None: collate_batch(s, max_points=self.max_points,
                                              rng=rng)
        )
        import inspect

        try:
            # only inject the RandomState into collate fns that declare an
            # ``rng`` parameter — a parameter-count heuristic would feed it
            # to e.g. functools.partial(collate, max_points=...) (TypeError)
            # or into an unrelated second parameter (silent misbehavior)
            self._collate_takes_rng = (
                "rng" in inspect.signature(self.collate_fn).parameters)
        except (TypeError, ValueError):
            self._collate_takes_rng = False
        self.epoch = 0
        self.start_batch = 0

    def set_epoch(self, epoch: int, start_batch: int = 0):
        """Epoch-seeded reshuffle (group_sampler.py epoch semantics); its
        iterations start at batch ``start_batch`` of this host's order (a
        resumed epoch), with no sample of the skipped batches built.
        A dataset with a ``set_epoch`` of its own (its augmentation draws
        are addressed by epoch) is told the epoch too."""
        if not 0 <= start_batch <= len(self):
            raise ValueError(f"start_batch {start_batch} outside the epoch's "
                             f"{len(self)} batches")
        self.epoch = epoch
        self.start_batch = start_batch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        """The epoch's batch count, whatever its start batch."""
        if self._grouped:
            bs_nh = self.batch_size * self.num_hosts
            return sum(
                -(-int(n) // bs_nh)
                for n in np.bincount(self.group_flags) if n > 0)
        if self.drop_last:
            per_host = len(self.dataset) // self.num_hosts
            return per_host // self.batch_size
        per_host = len(self._indices())
        return -(-per_host // self.batch_size)

    @property
    def _grouped(self) -> bool:
        # group-pure batching applies to (shuffled) training; ordered eval
        # must cover each sample exactly once, so flags are ignored there
        return self.group_flags is not None and self.shuffle

    def _grouped_indices(self) -> np.ndarray:
        """Group-pure batch units, padded + dealt as in DistributedGroupSampler.

        Per group: epoch-shuffle its indices, pad to a multiple of
        ``batch_size * num_hosts`` by resampling in-group (the reference
        repeats ``indice[:extra]``, group_sampler.py:131-135 — same
        distributional effect), split into batch-size units.  Units are then
        globally shuffled and dealt ``host_id::num_hosts``; every group
        contributes a multiple of ``num_hosts`` units, so shards are equal.
        """
        rng = np.random.RandomState(self.seed + self.epoch)
        bs, nh = self.batch_size, self.num_hosts
        units: List[np.ndarray] = []
        for g in np.unique(self.group_flags):
            gi = np.flatnonzero(self.group_flags == g)
            gi = gi[rng.permutation(len(gi))]
            target = -(-len(gi) // (bs * nh)) * bs * nh
            if target > len(gi):
                extra = gi[rng.randint(0, len(gi), target - len(gi))]
                gi = np.concatenate([gi, extra])
            units.extend(np.split(gi, len(gi) // bs))
        order = rng.permutation(len(units))
        units = [units[i] for i in order]
        mine = units[self.host_id :: nh]
        return np.concatenate(mine) if mine else np.zeros((0,), np.int64)

    def _indices(self) -> np.ndarray:
        """This host's shard of the (epoch-seeded) sample order.

        drop_last=True (training): equal floor-sized shards so every host
        runs the same number of SPMD steps.  drop_last=False (evaluation):
        ``np.array_split`` — every index lands on exactly one host, shard
        sizes differ by at most 1, and the non-divisible tail is covered
        without the reference's pad-with-duplicates trick
        (datasets/samplers/distributed_sampler.py:9); exactness holds
        because eval reduces raw counters, not per-host averages.
        """
        if self._grouped:
            return self._grouped_indices()
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        if self.drop_last:
            per_host = n // self.num_hosts
            return order[self.host_id * per_host : (self.host_id + 1) * per_host]
        return np.array_split(order, self.num_hosts)[self.host_id]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idxs = self._indices()
        nb = len(self)
        start = self.start_batch
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for b in range(start, nb):
                    chunk = idxs[b * self.batch_size : (b + 1) * self.batch_size]
                    if len(chunk) == 0:
                        break
                    samples = [self.dataset[int(i)] for i in chunk]
                    # sample-addressed RNG (seed, epoch, first dataset index):
                    # collation randomness (point subsampling) is reproducible
                    # across runs and independent of host count / step order
                    rng = np.random.RandomState(
                        (self.seed * 1000003 + self.epoch * 8191
                         + int(chunk[0])) % (2 ** 31 - 1))
                    if self._collate_takes_rng:
                        batch = self.collate_fn(samples, rng=rng)
                    else:  # custom 1-arg collate_fn
                        batch = self.collate_fn(samples)
                    q.put(batch)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item


def build_dataloader(dataset, samples_per_gpu=1, shuffle=True, seed=0,
                     num_hosts=1, host_id=0, max_points=35000,
                     drop_last=None, **kwargs):
    """``drop_last`` defaults to ``shuffle``: training (shuffled) needs
    equal per-host step counts for SPMD; evaluation (ordered) must cover
    every sample exactly once, tail included."""
    if drop_last is None:
        drop_last = shuffle
    # forward everything else (collate_fn, prefetch, group_flags, ...) so
    # recognized loader options are never silently dropped; unknown keys
    # raise TypeError at the ShardedLoader constructor
    return ShardedLoader(
        dataset, batch_size=samples_per_gpu, shuffle=shuffle, seed=seed,
        num_hosts=num_hosts, host_id=host_id, max_points=max_points,
        drop_last=drop_last, **kwargs,
    )


def build_dataset(cfg: Dict[str, Any], test_mode: bool = False):
    """The dataset of a config's ``data.train`` / ``data.val`` / ``data.test``
    entry.  Evaluation datasets run in ``test_mode`` (mmdet
    ``build_dataset(..., dict(test_mode=True))``)."""
    from ..registry import DATASETS, build_from_cfg  # filled by data/__init__.py

    cfg = dict(cfg)
    if test_mode:
        cfg["test_mode"] = True
    if cfg.get("type") not in DATASETS:
        raise NotImplementedError(
            f"dataset {cfg.get('type')!r} is not ported: the port builds "
            "CustomNuScenesOccLSSDataset, CustomSemanticKITTILssDataset and "
            "SyntheticOccDataset")
    return build_from_cfg(cfg, DATASETS)


def prefetch_to_device(iterator, device, size: int = 2,
                       skip_keys: Sequence[str] = ("_meta",)):
    """Keep ``size`` batches on ``device`` ahead of the consumer, as tensors.

    On a CUDA device each array is copied into pinned host memory and sent
    with a ``non_blocking`` copy on a side stream, so the upload of batch
    i+1 rides under the compute of batch i; the consumer's stream waits for
    that batch's copies before it is handed out.  On the CPU the arrays become
    tensors in place.  Host-only entries in ``skip_keys`` are dropped.
    """
    import collections

    import torch

    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    buf = collections.deque()

    def put(b):
        b = {k: torch.as_tensor(v) for k, v in b.items() if k not in skip_keys}
        if stream is None:
            return b, None
        with torch.cuda.stream(stream):
            b = {k: v.pin_memory().to(device, non_blocking=True) for k, v in b.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return b, done

    it = iter(iterator)
    for b in it:
        buf.append(put(b))
        if len(buf) == size:
            break
    while buf:
        out, done = buf.popleft()
        if done is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(done)
            for v in out.values():  # the consumer's stream uses them from here
                v.record_stream(current)
        for b in it:
            buf.append(put(b))
            break
        yield out
