"""Host batching loader and device prefetch of the port (counterpart of
``mvlt_tpu/data/loader.py``).

:class:`DataLoader` is a copy of JAX's (``loader.py:39-181``):

- worker *processes* fetch and collate whole batches (``num_workers > 0``;
  -1 sizes them to the host, ``min(8, cores - 1)``, threaded on hosts of
  two cores or fewer); ``num_workers=0`` fetches on a thread pool. The
  pool forks once per epoch, as JAX's does, from the loader's producer
  thread: the children run numpy only and never touch CUDA;
- a bounded queue overlaps host work with the steps;
- equal per-process shards (the index list is cut to a multiple of
  ``process_count`` first);
- the rows of a data rank (``rows=(data_rank, dp)``, the port's one
  process a device): each batch of ``batch_size`` indices is cut to the
  rank's contiguous block, as ``P('data')`` places a global batch, and only
  those samples are fetched. A ``drop_last`` loader refuses a batch size
  that dp does not divide (JAX's error); an eval loader's tail batch is cut
  into blocks that differ by at most one row, and a rank whose block is
  empty (a tail shorter than dp) gets a zero-row batch of the same keys,
  so that every rank yields the same number of batches;
- the order is keyed by (seed, epoch) and samples by (seed, epoch, index),
  so the worker count never changes the stream;
- an abandoned epoch stops its producer (every put re-checks a stop flag);
- a sample that raises reaches the consumer as that exception (JAX's
  consumer waits for ever).

:func:`device_prefetch` is the CUDA counterpart of JAX's
(``loader.py:184-284``), redesigned where JAX's has a race:

- producer threads pull numbered batches from the host iterator, copy
  them into pinned memory and then to the card on a side stream, and record
  an event per batch; the consumer's stream waits on that event before the
  batch is handed over, and the tensors are marked as used on the
  consumer's stream, so that the caching allocator does not recycle them
  under a running step;
- a resequencer delivers batches in the host iterator's order;
- an exception carries the sequence number of the batch it replaced, so it
  is raised only after every earlier batch has been yielded (JAX queues
  ``(None, e)`` and can raise before batch 0 with two threads);
- ``size`` bounds the batches in flight: taken from the host iterator and
  not yet yielded, whether a producer holds them, the queue or the
  resequencer (JAX's bound is ``size + threads``).

On the CPU it makes plain tensors (no streams, no pinned memory); asked for
``cuda`` without a CUDA device it raises.

Batches are dicts of stacked numpy arrays; non-array fields (ids, raw
strings) are lists under the same key.
"""

from __future__ import annotations

import collections
import heapq
import multiprocessing
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator

import numpy as np
import torch

from mvlt_tpu_torch.data.transforms import sample_rng
from mvlt_tpu_torch.parallel.partition import split_rows


def _no_rows(batch) -> Any:
    """``batch`` cut to zero rows, its keys, dtypes and trailing shapes
    kept."""
    if isinstance(batch, dict):
        return {k: _no_rows(v) for k, v in batch.items()}
    return batch[:0]


def _collate(samples) -> Any:
    first = samples[0]
    if isinstance(first, dict):
        return {k: _collate([s[k] for s in samples]) for k in first}
    if isinstance(first, np.ndarray):
        return np.stack(samples)
    if isinstance(first, (np.integer, int, np.floating, float)):
        return np.asarray(samples)
    return list(samples)


# fork-inherited dataset handle for worker processes: passing the dataset
# through initargs hands it over once per worker, where per-task pickling
# would resend it with every batch
_WORKER_DATASET = None


def _pool_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _pool_batch(args):
    chunk, epoch = args
    samples = [_WORKER_DATASET.__getitem__(int(i), epoch) for i in chunk]
    return _collate(samples)


def auto_workers(num_workers: int) -> int:
    """``num_workers`` as the loader runs it: -1 leaves one core for the
    step loop (``min(8, cores - 1)``), and 0 (threads) on hosts of two cores
    or fewer, where worker IPC costs more than it buys; 0 where the
    platform cannot fork."""
    if num_workers < 0:
        cpus = os.cpu_count() or 1
        num_workers = 0 if cpus <= 2 else min(8, cpus - 1)
    if num_workers > 0:
        try:
            multiprocessing.get_context("fork")
        except ValueError:
            num_workers = 0
    return num_workers


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_threads: int = 8, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 num_workers: int = 0, rows=(0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.num_workers = auto_workers(num_workers)
        self.rows = tuple(rows)
        if drop_last and batch_size % self.rows[1]:
            raise ValueError(
                f"batch leading dim {batch_size} not divisible by "
                f"data-parallel size {self.rows[1]}; pick batch_size as a "
                "multiple")

    def _indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = sample_rng(self.seed, epoch, 0, tag=1)
            rng.shuffle(idx)
        # every process gets the same count: cut to a multiple first
        n_even = n - n % self.process_count
        return idx[:n_even][self.process_index::self.process_count]

    def batches_per_epoch(self) -> int:
        n = len(self._indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        idx = self._indices(epoch)
        nb = self.batches_per_epoch()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a put that re-checks stop: a consumer that abandons the epoch
            # would otherwise leave the producer blocked forever
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def chunk(b):
            """(this rank's indices of batch b, whether its block is empty:
            then the batch's first index, fetched for its structure)."""
            c = idx[b * self.batch_size:(b + 1) * self.batch_size]
            lo, hi = split_rows(len(c), self.rows[1], self.rows[0])
            return (c[lo:hi], False) if hi > lo else (c[:1], True)

        def produce_threads():
            with ThreadPoolExecutor(self.num_threads) as pool:
                for b in range(nb):
                    if stop.is_set():
                        return
                    fetch = lambda i: self.dataset.__getitem__(int(i), epoch)
                    rows, empty = chunk(b)
                    batch = _collate(list(pool.map(fetch, rows)))
                    if not put(_no_rows(batch) if empty else batch):
                        return
            put(None)

        def produce_procs():
            ctx = multiprocessing.get_context("fork")
            with ctx.Pool(self.num_workers, initializer=_pool_init,
                          initargs=(self.dataset,)) as pool:
                # at most workers + prefetch batches submitted ahead, so a
                # slow consumer cannot make the pool buffer the epoch
                pending: "collections.deque" = collections.deque()
                limit = self.num_workers + self.prefetch
                b = 0
                while b < nb or pending:
                    while b < nb and len(pending) < limit \
                            and not stop.is_set():
                        rows, empty = chunk(b)
                        pending.append((pool.apply_async(
                            _pool_batch, ((rows, epoch),)), empty))
                        b += 1
                    if stop.is_set():
                        return
                    result, empty = pending.popleft()
                    batch = result.get()
                    if not put(_no_rows(batch) if empty else batch):
                        return
            put(None)

        def produce():
            try:
                (produce_procs if self.num_workers > 0
                 else produce_threads)()
            except BaseException as e:   # noqa: BLE001 - raised below
                put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()


def _to_tensor(x):
    if isinstance(x, np.ndarray) or (np.isscalar(x) and not isinstance(x, str)):
        a = np.asarray(x)
        return torch.from_numpy(a if a.flags.c_contiguous
                                else np.ascontiguousarray(a))
    return x


def device_prefetch(iterator, *, size: int = 2, device="cuda",
                    transform=None, threads: int = 1):
    """Yield the host iterator's batches as tensors on ``device``, in the
    iterator's order, with up to ``size`` batches in flight ahead of the
    consumer (see the module docstring). ``transform`` maps a host batch
    before its copy (e.g. drops string fields); numpy arrays and scalars
    become tensors, other values pass through. With ``threads > 1`` the
    copies pipeline each other. A producer's exception is raised in the
    consumer after every batch before it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_prefetch(device='cuda') needs a CUDA "
                           "device and torch.cuda.is_available() is False")
    return _prefetch(iter(iterator), max(1, size), device, transform,
                     max(1, threads))


def _prefetch(iterator, size, device, transform, threads):
    cuda = device.type == "cuda"
    slots = threading.Semaphore(size)
    done: "queue.Queue" = queue.Queue()
    stop = threading.Event()
    src_lock = threading.Lock()
    seq = [0]
    _END = object()

    def next_numbered():
        """(seq, batch or exception), or None once the source is done. The
        number is taken with the batch, under one lock: an exception gets
        the number of the batch it replaced."""
        with src_lock:
            s = seq[0]
            try:
                batch = next(iterator)
            except StopIteration:
                return None
            except BaseException as e:       # noqa: BLE001 - re-raised later
                batch = e
            seq[0] += 1
            return s, batch

    def copy(batch, stream):
        if transform is not None:
            batch = transform(batch)
        tensors = {k: _to_tensor(v) for k, v in batch.items()}
        if not cuda:
            return {k: v.to(device) if torch.is_tensor(v) else v
                    for k, v in tensors.items()}, None
        with torch.cuda.stream(stream):
            out = {k: v.pin_memory().to(device, non_blocking=True)
                   if torch.is_tensor(v) else v for k, v in tensors.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def acquire() -> bool:
        while not stop.is_set():
            if slots.acquire(timeout=0.2):
                return True
        return False

    def produce():
        stream = torch.cuda.Stream(device) if cuda else None
        try:
            while acquire():
                item = next_numbered()
                if item is None:
                    slots.release()
                    break
                s, batch = item
                if isinstance(batch, BaseException):
                    done.put((s, batch, None))
                    break
                try:
                    out, event = copy(batch, stream)
                except BaseException as e:   # noqa: BLE001 - re-raised later
                    done.put((s, e, None))
                    break
                done.put((s, out, event))
        finally:
            done.put((None, _END, None))

    workers = [threading.Thread(target=produce, daemon=True)
               for _ in range(threads)]
    for t in workers:
        t.start()
    ends, expect, held = 0, 0, []          # held: heap of (seq, item, event)
    try:
        while True:
            while held and held[0][0] == expect:
                _, item, event = heapq.heappop(held)
                if isinstance(item, BaseException):
                    raise item
                if event is not None:
                    current = torch.cuda.current_stream(device)
                    current.wait_event(event)
                    for v in item.values():
                        if torch.is_tensor(v):
                            v.record_stream(current)
                expect += 1
                slots.release()
                yield item
            if ends == len(workers):
                if held:
                    raise RuntimeError(
                        f"device_prefetch: batch {expect} never arrived")
                return
            s, item, event = done.get()
            if item is _END:
                ends += 1
            else:
                heapq.heappush(held, (s, item, event))
    finally:
        stop.set()
        for t in workers:
            t.join(timeout=5.0)
        close = getattr(iterator, "close", None)
        if close is not None and not any(t.is_alive() for t in workers):
            close()
