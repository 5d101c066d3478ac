"""Host-side prefetching (port of `rnnpose_tpu/data/loader.py`).

A thread pipeline overlaps host preprocessing (image decode, crop, KD-tree
correspondences, the KPConv pyramid: numpy, scipy and the native ops, which
release the GIL) with device compute:

* `prefetch_map`: an order-preserving map with bounded lookahead, the eval
  path's loader (the caller groups frames itself);
* `PrefetchLoader`: a feeder submits `fetch(idx)` in sampler order, a
  collator takes the results in submission order, drops samples that raise
  `skip_exc`, groups `batch_size` of them and collates off the main thread
  into a bounded queue.

Order preservation makes the output identical to the synchronous loop: the
threads change throughput, not results.
"""
from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, List

__all__ = ["PrefetchLoader", "prefetch_map"]

_DONE = object()


def prefetch_map(
    items: Iterable[Any],
    fn: Callable[[Any], Any],
    num_threads: int = 4,
    depth: int = 8,
    skip_exc: tuple = (),
) -> Iterator[Any]:
    """Yield `fn(item)` in input order, computed by a background thread
    pool at most `depth` items ahead. Items raising `skip_exc` are dropped."""
    pool = ThreadPoolExecutor(max_workers=num_threads, thread_name_prefix="pfmap")
    try:
        it = iter(items)
        futs: "collections.deque" = collections.deque()

        def fill():
            while len(futs) < depth:
                try:
                    x = next(it)
                except StopIteration:
                    return
                futs.append(pool.submit(fn, x))

        fill()
        while futs:
            f = futs.popleft()
            fill()
            try:
                res = f.result()
            except skip_exc:
                continue
            yield res
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


class PrefetchLoader:
    """Iterate collated batches with background prefetch.

    Args:
      indices: iterable of dataset indices (e.g. a sampler).
      fetch: maps one index to one sample (may raise `skip_exc` to drop it).
      batch_size: samples per collated batch; a trailing partial batch is
        dropped (as the synchronous loop does).
      collate: maps a list of `batch_size` samples to a batch.
      num_threads: fetch worker threads.
      prefetch_batches: most finished batches parked ahead of the consumer.
      skip_exc: exception type marking a degenerate sample to skip.
    """

    def __init__(
        self,
        indices: Iterable[int],
        fetch: Callable[[int], Any],
        batch_size: int,
        collate: Callable[[List[Any]], Any],
        num_threads: int = 4,
        prefetch_batches: int = 2,
        skip_exc: type = Exception,
    ):
        assert batch_size >= 1 and num_threads >= 1 and prefetch_batches >= 1
        self._fetch = fetch
        self._bs = batch_size
        self._collate = collate
        self._skip = skip_exc
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=num_threads, thread_name_prefix="prefetch")
        # The future queue's bound limits the outstanding fetches (the
        # pool's own queue is unbounded).
        depth = max(prefetch_batches * batch_size, num_threads)
        self._futs: "queue.Queue" = queue.Queue(maxsize=depth)
        self._out: "queue.Queue" = queue.Queue(maxsize=prefetch_batches)
        self._feeder = threading.Thread(target=self._feed, args=(iter(indices),), daemon=True)
        self._collator = threading.Thread(target=self._run_collate, daemon=True)
        self._feeder.start()
        self._collator.start()

    def _put(self, q: "queue.Queue", item) -> bool:
        """Bounded put that gives up on close() instead of blocking."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _feed(self, it: Iterator[int]):
        try:
            for idx in it:
                if not self._put(self._futs, self._pool.submit(self._fetch, idx)):
                    return
        except Exception as e:  # a sampler error reaches the consumer
            self._put(self._futs, e)
            return
        self._put(self._futs, _DONE)

    def _run_collate(self):
        samples: List[Any] = []
        while not self._stop.is_set():
            try:
                fut = self._futs.get(timeout=0.1)
            except queue.Empty:
                continue
            if fut is _DONE:
                break  # the trailing partial batch is dropped
            if isinstance(fut, Exception):
                self._put(self._out, fut)
                return
            try:
                samples.append(fut.result())
            except self._skip:
                continue
            except Exception as e:
                self._put(self._out, e)
                return
            if len(samples) == self._bs:
                try:
                    batch = self._collate(samples)
                except Exception as e:
                    self._put(self._out, e)
                    return
                samples = []
                if not self._put(self._out, batch):
                    return
        self._put(self._out, _DONE)

    def __iter__(self) -> Iterator[Any]:
        while True:
            item = self._out.get()
            if item is _DONE:
                return
            if isinstance(item, Exception):
                self.close()
                raise item
            yield item

    def close(self):
        """Stop the pipeline and release the worker threads."""
        self._stop.set()
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
