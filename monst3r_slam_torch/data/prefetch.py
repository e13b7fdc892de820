"""Host-side frame prefetch: overlap dataset decode/resize with device compute.

The port's counterpart of the JAX package's `data/prefetch.py`. A worker
thread keeps a small bounded queue of preprocessed frames ahead of the
consumer, so while the card runs frame t's encode/decode/track the host is
already reading and resizing frame t+1 (and t+2).

`uploading_preprocess` also uploads each normalized frame from the worker
thread: the array goes into pinned host memory and is copied to the card
with `non_blocking=True`. Ordering: the copy is enqueued on the stream that
was current on the thread that built the preprocess (the main thread, which
runs the encoder), and a frame reaches the consumer only after its copy was
enqueued, so stream order puts the copy before every read of the frame.
PyTorch's pinned-memory allocator keeps the host buffer alive until the
copy has run.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import torch


class FramePrefetcher:
    """Iterate (i, timestamp, preprocessed) over dataset[lo:hi) with
    readahead. `preprocess(img)` runs in the worker thread; an exception of
    the dataset or of preprocess is re-raised in the consumer at the failing
    index."""

    _SENTINEL = object()

    def __init__(self, dataset, preprocess: Callable, lo: int = 0, hi: Optional[int] = None,
                 depth: int = 2):
        self.dataset = dataset
        self.preprocess = preprocess
        self.lo = lo
        self.hi = len(dataset) if hi is None else hi
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, name="frame-prefetch", daemon=True)

    def _work(self):
        try:
            for i in range(self.lo, self.hi):
                if self._stop.is_set():
                    return
                try:
                    timestamp, img = self.dataset[i]
                    item = (i, timestamp, self.preprocess(img))
                except BaseException as e:  # surfaced at the consumer
                    self._put((i, None, e))
                    return
                self._put(item)
        finally:
            self._put(self._SENTINEL)

    def _put(self, item):
        # A bounded put that still honours stop() while the queue is full.
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue
        if item is self._SENTINEL:
            # The sentinel must always land, or a consumer blocked in get()
            # after a stop() from another thread would wait forever; once
            # stopped, the queued frames are moot, so make room.
            while True:
                try:
                    self._q.put_nowait(item)
                    return
                except queue.Full:
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        pass

    def __iter__(self) -> Iterator[Tuple[int, float, dict]]:
        self._thread.start()
        try:
            while True:
                item = self._q.get()
                if item is self._SENTINEL:
                    return
                i, timestamp, payload = item
                if isinstance(payload, BaseException):
                    raise RuntimeError(f"prefetch failed at frame {i}") from payload
                yield i, timestamp, payload
        finally:
            self.stop()

    def stop(self):
        """Stop the worker (early exit)."""
        self._stop.set()


def uploading_preprocess(resize_fn: Callable, device) -> Callable:
    """Wrap a resize preprocess so that the worker thread also uploads the
    normalized (1, h, w, 3) image to `device` ("img_dev" in the payload),
    through pinned memory with a non-blocking copy on the calling thread's
    current stream (see the module notes). On the CPU "img_dev" is the
    array as a tensor."""
    device = torch.device(device)
    stream = torch.cuda.current_stream(device) if device.type == "cuda" else None

    def fn(img):
        out = resize_fn(img)
        host = torch.from_numpy(out["img"])
        if stream is None:
            out["img_dev"] = host.to(device)
            return out
        with torch.cuda.stream(stream):
            out["img_dev"] = host.pin_memory().to(device, non_blocking=True)
        return out

    return fn
