"""Host -> device feed (counterpart of nextgen_uia_tpu/data/pipeline.py):
threaded batch assembly (``collate``, ``batches``, in the JAX package's
seeded order) and ``prefetch_to_device``, which reads its iterator on a
producer thread."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def collate(items):
    """Stack item dicts into a batch dict of arrays (strings to lists)."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], (np.ndarray, int, float)) or np.isscalar(vals[0]):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


def batches(dataset, batch_size: int, *, shuffle: bool, drop_last: bool,
            seed: int | None = None, workers: int = 8, skip_batches: int = 0):
    """Yield collated batches; item loading is parallelised across threads.
    The order is ``np.random.RandomState(seed).shuffle`` of the indices, the
    JAX package's, so both packages see the same batches.

    ``skip_batches`` drops the first N batches at the index level - no item
    is decoded for them (mid-epoch resume replays the seeded order from N).
    """
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    limit = (n // batch_size) * batch_size if drop_last else n
    starts = range(skip_batches * batch_size, limit, batch_size)
    if workers <= 0:  # synchronous load (reference num_workers=0 semantics)
        for start in starts:
            yield collate([dataset[i] for i in order[start:start + batch_size]])
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for start in starts:
            yield collate(list(pool.map(dataset.__getitem__, order[start:start + batch_size])))


def prefetch_to_device(iterator, *, device: torch.device, size: int = 2):
    """Yield the batches of ``iterator`` with their numeric numpy leaves as
    tensors on ``device``, staged ``size`` batches ahead; other leaves pass
    through.

    A producer thread reads the iterator, so the decode and collation of the
    next batches overlap the consumer's step. A consumer that stops early
    (closes the generator, or raises) sets a stop event that releases the
    producer from a full queue; an error raised by the iterator is raised in
    the consumer.

    On a CUDA device each leaf is copied from pinned host memory with
    ``non_blocking`` on a side stream, so the copies of the next batches
    overlap the work queued on the current stream; the consumer's stream
    waits on each batch's copy event before the batch is handed out.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:  # the consumer's current device, not the thread's
        device = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(device) if cuda else None

    def transfer(batch):
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and (np.issubdtype(v.dtype, np.number)
                                              or v.dtype == np.bool_):
                t = torch.from_numpy(np.ascontiguousarray(v))
                if cuda:
                    with torch.cuda.device(device), torch.cuda.stream(side):
                        t = t.pin_memory().to(device, non_blocking=True)
                else:
                    t = t.to(device)
                out[k] = t
            else:
                out[k] = v
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    err = []
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not put_or_stop(transfer(batch)):
                    return
        except Exception as e:  # raised in the consumer
            err.append(e)
        finally:
            put_or_stop(sentinel)

    threading.Thread(target=producer, daemon=True, name="nextgen-uia-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        # allocated on the side stream: keep the memory from
                        # reuse until the consumer's queued work on it is done
                        v.record_stream(stream)
            yield batch
    finally:
        stop.set()
