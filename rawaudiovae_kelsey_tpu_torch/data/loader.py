"""Host→device feed: background prefetch from pinned memory — the JAX
package's ``data/loader.py`` ``prefetch_to_device``, ported.

A daemon thread takes upcoming host batches (NumPy), casts them if asked
(``[tpu] feed_dtype``), copies each into pinned host memory and starts a
non-blocking copy to the device on a side stream, then hands the device
tensor and the copy's event to the consumer through a bounded queue of
``depth`` batches.  The consumer's stream waits on the event (on the
device, not the host), so the transfer of batch n+1 rides under the step
of batch n.  On the CPU the batches are handed over as they are.  Under a
mesh each rank runs its own feed of its own rows onto its own device (one
card a process), so nothing is sharded here; :func:`pad_batches_for_mesh`
pads a global batch that every rank cuts the same way.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


class DevicePrefetcher:
    """Wrap a host batch iterator; yields tensors on ``device``."""

    _SENTINEL = object()

    def __init__(self, host_iter: Iterator[np.ndarray], device,
                 depth: int = 2, cast_dtype: Optional[torch.dtype] = None):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._cast = cast_dtype
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=self._worker, args=(host_iter,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        # block until the consumer drains — bounds host and device memory
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, host_iter):
        try:
            stream = (torch.cuda.Stream(self.device) if self._cuda
                      else None)
            for batch in host_iter:
                if self._stop.is_set():
                    return
                t = torch.from_numpy(np.ascontiguousarray(batch))
                if self._cast is not None:
                    t = t.to(self._cast)
                event = None
                if self._cuda:
                    t = t.pin_memory()
                    with torch.cuda.stream(stream):
                        t = t.to(self.device, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(stream)
                if not self._put((t, event)):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            # the sentinel must never be dropped, or __next__ blocks
            # forever and a stored worker exception is never surfaced
            self._put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        if self._done:
            raise StopIteration  # exhausted stays exhausted
        item = self._q.get()
        if item is self._SENTINEL:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        t, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            # the tensor was allocated on the side stream: tell the caching
            # allocator it is in use on this one
            t.record_stream(current)
        return t

    def close(self):
        """Stop the worker and let go of the host iterator.  Safe to call
        twice and on an exhausted feed; an unbounded iterator (the streaming
        dataset under ``islice``) is dropped where it stands."""
        self._stop.set()
        self._done = True  # a post-close __next__ must not block on _q.get
        try:  # drain so the worker can exit
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # the worker sees the flag within one queue timeout; once it has
        # returned, the host iterator (and a decode pool it may hold) is
        # released.  Never block for long: a decode in flight may take a
        # while, and the thread is a daemon
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=2.0)


def prefetch_to_device(host_iter: Iterator[np.ndarray], device,
                       depth: int = 2,
                       cast_dtype: Optional[torch.dtype] = None
                       ) -> DevicePrefetcher:
    """Background device feed of ``depth`` batches.  ``cast_dtype`` (e.g.
    ``torch.bfloat16``) converts batches on the host thread before the
    transfer — half the host→device bytes for bf16 training."""
    return DevicePrefetcher(host_iter, device, depth=depth,
                            cast_dtype=cast_dtype)


def feed_dtype(cfg) -> Optional[torch.dtype]:
    """Host-side cast dtype per ``[tpu] feed_dtype``."""
    return torch.bfloat16 if cfg.tpu.feed_dtype == "bfloat16" else None


def pad_batches_for_mesh(host_iter: Iterator[np.ndarray], n_devices: int
                         ) -> Iterator[np.ndarray]:
    """Make every batch's leading dim divisible by ``n_devices`` by wrapping
    (repeating rows from the batch start) — the JAX package's
    ``data/loader.py:125-146``.  The caller must ensure ``batch_size %
    n_devices == 0`` (the trainers check it), so only a final short batch
    is ever padded: its repeated rows weigh twice in that one mean-reduced
    loss (a divergence the JAX package documents).  Without the check EVERY
    batch would wrap, double-weighting the same rows all run long."""
    for batch in host_iter:
        rem = batch.shape[0] % n_devices
        if rem:
            extra = n_devices - rem
            reps = -(-extra // max(batch.shape[0], 1))
            fill = np.concatenate([batch] * reps, axis=0)[:extra]
            batch = np.concatenate([batch, fill], axis=0)
        yield batch
