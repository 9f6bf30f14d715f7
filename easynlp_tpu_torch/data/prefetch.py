"""Host-to-device input prefetching for the PyTorch port.

Counterpart of easynlp_tpu/data/prefetch.py: while the current step runs, a
producer thread fetches (featurises) the next batches, and on a CUDA
device stages each array in pinned host memory and copies it on a side
CUDA stream. The consumer makes its stream wait on the copy's event before
it hands the batch out, so the step never reads a batch before it has
landed, and the host never blocks on a copy.

The device tensors are allocated from the consumer stream's memory pool
(the side stream first waits for the consumer stream to pass the point of
their allocation), so they need no `record_stream`: a block recorded on
another stream makes the caching allocator query an event at every
allocation until the device catches up, thousands of times a step.

depth > 0 keeps up to `depth` batches staged (one more may wait in the
producer's hand); depth 0 is no prefetch at all: each batch is fetched and
copied from pageable memory on the caller's thread when asked for. The JAX
Trainer keeps at least one batch in flight (its depth is max(1, n)).
"""

import queue
import threading

import numpy as np
import torch

_SENTINEL = object()


def _to_device(batch, device):
    """{key: numpy array} -> {key: tensor on device}, copied from pageable
    memory on the current stream."""
    return {key: torch.from_numpy(np.ascontiguousarray(value)).to(
        device, non_blocking=True) for key, value in batch.items()}


def _stage(batch, device, consumer, side):
    """({key: tensor on device}, the copies' event): each array staged in
    pinned memory and copied on `side` into a tensor of `consumer`'s
    pool."""
    pinned = {key: torch.from_numpy(np.ascontiguousarray(value)).pin_memory()
              for key, value in batch.items()}
    with torch.cuda.stream(consumer):
        out = {key: torch.empty_like(t, device=device)
               for key, t in pinned.items()}
        allocated = torch.cuda.Event()
        allocated.record(consumer)
    side.wait_event(allocated)
    with torch.cuda.stream(side):
        for key, t in pinned.items():
            out[key].copy_(t, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(side)
    return out, copied


def device_prefetch(iterator, device, depth=2, transform=None):
    """Yield the host batches of `iterator` (after `transform`) as dicts of
    tensors on `device`, keeping up to `depth` of them in flight (see the
    module's docstring). An exception in the producer is raised in the
    consumer. When the consumer stops early (a break, an exception in the
    step, close()), the producer stops and the staged batches are
    dropped."""
    device = torch.device(device)
    if depth < 0:
        raise ValueError("prefetch depth must be >= 0, got %d" % depth)
    if depth == 0:
        for batch in iterator:
            if transform is not None:
                batch = transform(batch)
            yield _to_device(batch, device)
        return
    cuda = device.type == "cuda"
    if cuda:
        consumer = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device=device)
    q = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if stop.is_set():
                    return
                if transform is not None:
                    batch = transform(batch)
                item = (_stage(batch, device, consumer, side) if cuda
                        else (_to_device(batch, device), None))
                if not put(item):
                    return
        except BaseException as err:  # noqa: BLE001 - raised in the consumer
            put(err)
            return
        put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True,
                              name="device_prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            tensors, copied = item
            if copied is not None:
                consumer.wait_event(copied)
            yield tensors
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5)
