"""Device prefetch and generator-fed datasets (segmentation_tpu.data.pipeline).

``DevicePrefetcher`` keeps ``depth`` batches on the card ahead of the
consumer. A staging thread fetches each host batch, copies its arrays into
pinned host buffers (on one core) and issues the host→device copies with
``non_blocking=True`` on a side CUDA stream, so decode, copy and the
training step overlap. The consumer's stream waits on an event recorded
after the copies, and each tensor is recorded on the consumer's stream, so
the caching allocator never hands its memory to the side stream while the
step still reads it. A pinned buffer is reused only once the event of the
copy that read it has completed. With ``device="cpu"`` (tests) the batch
is copied into CPU tensors. One card: there is no mesh.

``GeneratorDataSet`` wraps a user generator in daemon threads feeding a
bounded queue with backpressure and a stop event.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    return None if batch is None else fn(batch)


def _host(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))


def _copy_bytes(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` on one host thread (numpy's copy, which releases
    the GIL). Torch's copy fans out over every core, and while it runs the
    consumer dispatches its step more slowly: on an H100 host the data
    path then added ~11 ms to the B = 128 step, against ~2 ms this way
    (chip_smoke.py phase 7b)."""
    np.copyto(dst.reshape(-1).view(torch.uint8).numpy(),
              src.contiguous().reshape(-1).view(torch.uint8).numpy())


class DevicePrefetcher:
    """Wraps a dataset (``get_batch`` and attributes, which it delegates)
    or an iterator of batch dicts; keeps ``depth`` batches staged on
    ``device``."""

    _SENTINEL = object()

    def __init__(self, source, device="cuda", depth: int = 2):
        self._base = source if hasattr(source, "get_batch") else None
        self.source = iter(source)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.depth = max(1, depth)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._stage, daemon=True, name="seg-device-prefetch"
        )
        self._started = False
        self._done = False
        # pinned buffers, by (shape, dtype): free, or read by a copy that
        # may still run (with the event recorded after it)
        self._free: Dict[tuple, List[torch.Tensor]] = {}
        self._in_flight: List[tuple] = []

    def __getattr__(self, name):
        base = self.__dict__.get("_base")
        if base is not None:
            return getattr(base, name)
        raise AttributeError(name)

    # ---- the staging thread -------------------------------------------
    def _stage(self):
        try:
            stream = None
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                stream = torch.cuda.Stream(self.device)
            while not self._stop.is_set():
                try:
                    batch = next(self.source)
                except StopIteration:
                    self._put(self._SENTINEL)
                    return
                if stream is None:
                    self._put(_map(lambda v: _host(v).clone(), batch))
                else:
                    self._put(self._to_device(batch, stream))
        except BaseException as e:  # the thread's boundary: the consumer
            self._put(e)            # re-raises it

    def _pinned(self, shape, dtype) -> torch.Tensor:
        pending = []
        for event, bufs in self._in_flight:
            if not event.query():
                pending.append((event, bufs))
                continue
            for b in bufs:
                self._free.setdefault((tuple(b.shape), b.dtype), []).append(b)
        self._in_flight = pending
        free = self._free.get((tuple(shape), dtype))
        if free:
            return free.pop()
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def _to_device(self, batch, stream):
        staged = []

        def copy(v):
            host = _host(v)
            if host.device.type != "cpu":
                return host.to(self.device, non_blocking=True)
            buf = self._pinned(host.shape, host.dtype)
            _copy_bytes(buf, host)
            staged.append(buf)
            return buf.to(self.device, non_blocking=True)

        with torch.cuda.stream(stream):
            out = _map(copy, batch)
            event = torch.cuda.Event()
            event.record(stream)
        self._in_flight.append((event, staged))
        return out, event

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    # ---- the consumer ---------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        if not self._started:
            self._started = True
            self._thread.start()
        out = self._q.get()
        if out is self._SENTINEL:
            self._done = True
            raise StopIteration
        if isinstance(out, BaseException):
            raise RuntimeError("prefetch staging thread failed") from out
        if self.device.type != "cuda":
            return out
        batch, event = out
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        _map(lambda t: t.record_stream(consumer), batch)
        return batch

    def get_batch(self):
        return next(self)

    def stop(self):
        """Stop staging: drain the queue, stop the dataset, and wait (up to
        5 s) for the staging thread to leave it, so that the caller may
        close the dataset once this returns."""
        self._stop.set()
        try:  # drain so the staging thread unblocks
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        base = self.__dict__.get("_base")
        if base is not None and hasattr(base, "stop"):
            base.stop()
        if self._started:
            self._thread.join(5.0)


class GeneratorDataSet:
    """Threaded feeder over a user generator function: ``gen_fn(worker_id)``
    returns an iterator of batch dicts, restarted when it ends; ``threads``
    workers run it concurrently into a queue of ``capacity`` batches."""

    has_masks = False

    def __init__(
        self,
        gen_fn: Callable[[int], Iterator[Dict[str, np.ndarray]]],
        batch_size: int,
        capacity: int = 8,
        threads: int = 1,
        has_masks: bool = False,
    ):
        self.gen_fn = gen_fn
        self.batch_size = batch_size
        self.has_masks = has_masks
        self._q: "queue.Queue" = queue.Queue(maxsize=max(2, capacity))
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(
                target=self._main, args=(i,), daemon=True,
                name=f"seg-gen-{i}",
            )
            for i in range(max(1, threads))
        ]
        self._started = False

    def _main(self, worker_id: int):
        it = self.gen_fn(worker_id)
        while not self._stop.is_set():
            try:
                item = next(it)
            except StopIteration:
                it = self.gen_fn(worker_id)  # loop forever
                continue
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def start_threads(self):
        if not self._started:
            self._started = True
            for t in self._threads:
                t.start()

    def request_stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def get_batch(self):
        self.start_threads()
        return self._q.get()

    def __iter__(self):
        while True:
            yield self.get_batch()
