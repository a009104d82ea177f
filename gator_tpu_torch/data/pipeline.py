"""Batch pipeline: shuffling, mixed-dataset sampling and batch iteration
with a background prefetch thread (counterpart of
gator_tpu/data/pipeline.py, in its "full" mode: ready batches from
`make_batch`; reference: lib/core/base.py:20-43,
data/multiple_datasets.py).

Streams. The prefetch thread synthesises each batch's GT meshes on the card
while the consumer runs the previous batch's step. Both threads launch on
the device's default stream (the thread never switches streams), so the
card runs the synthesis of batch k+1 after everything the consumer queued
before it and before everything the consumer queues after taking the batch:
a mesh is never read before it is written and no tensor crosses streams.
What overlaps is host work (the batch's numpy assembly and the launches)
with the card's work.
"""
from __future__ import annotations

import threading
from queue import Empty, Queue
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from .base import SmplPoseDataset, mixed_epoch_indices
from .gt_synth import GtSynthesizer


class BatchPipeline:
    """Iterates dict batches over one or more datasets. Several datasets
    are mixed as the reference mixes them: an epoch is max_len * n_dbs
    samples, each from a uniformly drawn dataset, one batch size across the
    mix (reference: base.py:22,40-43)."""

    def __init__(self, datasets: Sequence[SmplPoseDataset],
                 synthesizer: GtSynthesizer, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 stage: str = "gator"):
        """An epoch ends with a ragged last batch (eval keeps every
        sample); two batches are prepared ahead."""
        self.datasets = list(datasets)
        self.synth = synthesizer
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.stage = stage
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        if len(self.datasets) == 1:
            n = len(self.datasets[0])
        else:
            n = max(len(d) for d in self.datasets) * len(self.datasets)
        return -(-n // self.batch_size)

    def _plan(self, rng) -> List[np.ndarray]:
        """List of [B, 2] (dataset_id, index) arrays, one per batch."""
        if len(self.datasets) == 1:
            n = len(self.datasets[0])
            order = rng.permutation(n) if self.shuffle else np.arange(n)
            pairs = np.stack([np.zeros(n, np.int64), order], axis=1)
        else:
            pairs = mixed_epoch_indices(
                [len(d) for d in self.datasets], rng)
            if self.shuffle:
                pairs = pairs[rng.permutation(len(pairs))]
        return [pairs[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def _make(self, pairs: np.ndarray, rng) -> Dict[str, object]:
        parts = []
        order = np.empty(len(pairs), np.int64)
        pos = 0
        for d_id, ds in enumerate(self.datasets):
            sel = np.nonzero(pairs[:, 0] == d_id)[0]
            if len(sel) == 0:
                continue
            parts.append(ds.make_batch(pairs[sel, 1], self.synth, rng,
                                       stage=self.stage))
            order[sel] = np.arange(pos, pos + len(sel))
            pos += len(sel)
        if len(parts) == 1:
            return parts[0]      # one dataset: `order` is the identity

        # restore the interleaved order; a leaf that is on the device in
        # any part (the mesh; the fit mask of a sync-free reader beside a
        # host mask of another) merges there
        def merge(vals):
            dev = next((v.device for v in vals
                        if isinstance(v, torch.Tensor)), None)
            if dev is not None:
                return torch.cat([torch.as_tensor(v, device=dev)
                                  for v in vals])[torch.as_tensor(
                                      order, device=dev)]
            return np.concatenate(vals)[order]

        return {k: merge([p[k] for p in parts]) for k in parts[0]}

    def __iter__(self) -> Iterator[Dict[str, object]]:
        rng = np.random.default_rng((self.seed, self._epoch))
        plan = self._plan(rng)
        # background prefetch: a worker failure re-raises in the consumer
        # (a swallowed error would silently truncate the epoch); leaving
        # the iterator mid-epoch unblocks and stops the worker, and waits
        # for it (at most the batch it is making), so that no batch is
        # still being made on the host after the iterator is closed
        q: Queue = Queue(maxsize=2)
        stop = object()
        abort = threading.Event()

        def worker():
            try:
                for pairs in plan:
                    if abort.is_set():
                        return
                    q.put(self._make(pairs, rng))
                q.put(stop)
            except BaseException as exc:   # noqa: BLE001 — relayed
                q.put(exc)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
            th.join()
        finally:
            abort.set()
            try:                # unblock a worker waiting on a full queue
                while True:
                    q.get_nowait()
            except Empty:
                pass
            th.join()
