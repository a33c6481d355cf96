"""Host data pipeline: background prefetch and device put, deterministic
cursor (port of ``repro.data.pipeline``).

Double-buffered: batch t+1 is made (and copied to the device) on a worker
thread while step t computes.  With a CUDA ``device`` each array goes
through pinned host memory and a non-blocking copy on the worker's current
stream (the default stream, which the training step shares, so a step reads
its batch after the copy).  With ``device=None`` the batches stay as the
maker returns them (numpy), as the reference's do without a sharding.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch


def to_device(batch: dict, device: torch.device) -> dict:
    """Each numpy array of ``batch`` as a tensor on ``device``, through
    pinned host memory when ``device`` is a CUDA device."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


class PrefetchPipeline:
    def __init__(
        self,
        make_batch: Callable[[int], dict],  # step -> host batch
        start_step: int = 0,
        prefetch: int = 2,
        device=None,
    ):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._device = torch.device(device) if device is not None else None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._make(step)
            if self._device is not None:
                batch = to_device(batch, self._device)
            try:
                self._q.put((step, batch), timeout=1.0)
            except queue.Full:
                if self._stop.is_set():
                    return
                continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while not self._stop.is_set():
            yield self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
