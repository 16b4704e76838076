"""Device-side prefetch: batch assembly and the host-to-device copy overlap
the step loop — the port of the JAX package's `data/device_prefetch.py`.

A stager thread pulls host batches (numpy arrays) from the loader, copies
each array into a pinned host buffer, issues its copy to the card
`non_blocking` on a side CUDA stream and records an event there. The
consumer's stream waits on that event before the step uses the batch, and
each device tensor is `record_stream`ed onto the consumer's stream, so the
caching allocator does not hand its memory out while the step still reads
it. A pinned buffer is written again only after the event of the copy
that read it has completed. Up to `depth` staged batches wait in a bounded
queue, each holding device memory.

Depth 0 is the synchronous path: each batch is copied on the consumer
thread when the step loop asks for it. On the CPU a staged batch is the
arrays as tensors (`torch.from_numpy`): the same tensors in the same order
at every depth.

Double-buffered H2D (`overlap`, `data.h2d_overlap`; JAX
`device_prefetch.py:31-39,137-236`): the one stager thread pulls batch
N + 1 from the loader only after it has staged batch N. With `overlap` a
fetcher thread pulls the host batches (and runs `assemble`) into a
one-slot queue, and the stager takes them from there for the pinned fill
and the side-stream copy, so the next fetch runs while a copy is being
issued; the one slot bounds what is fetched ahead. The batches come in
the same order at every setting; depth 0 ignores the flag.

Teardown is the JAX prefetcher's: bounded queues, a stop event that no
producer can deadlock on, the host iterator closed on the thread that
pulls it, a thread's exception re-raised at the iteration site, and
every thread joined when the consumer stops early. `stager_thread` and
`fetch_thread` hold the idents of the last pass's threads (`fetch_thread`
None without overlap; both None at depth 0), as JAX's do.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

Arrays = Tuple[np.ndarray, ...]


class _PinnedSlot:
    """Pinned host buffers for one staged batch, and the event of the copy
    that last read them."""

    def __init__(self):
        self.buffers: List[torch.Tensor] = []
        self.layout: list = []
        self.event: Optional[torch.cuda.Event] = None

    def fill(self, arrays: Arrays) -> List[torch.Tensor]:
        if self.event is not None:
            self.event.synchronize()  # the previous copy out of these is done
        layout = [(a.shape, a.dtype) for a in arrays]
        if layout != self.layout:
            self.buffers = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                            for a in arrays]
            self.layout = layout
        else:
            for buf, a in zip(self.buffers, arrays):
                buf.numpy()[...] = a
        return self.buffers


class DevicePrefetcher:
    """Iterates tuples of tensors on `device` staged from `host_batches`.

    host_batches: a re-iterable of host batches (a `Loader`); each pass
        starts a fresh stager thread, so one prefetcher serves every epoch.
    depth: staged batches kept ahead of the consumer; 0 = synchronous.
    assemble: optional `(batch_idx, host_batch) -> tuple of arrays`, run
        on the thread that pulls the loader (the eval path adds its
        `valid_mask` there).
    overlap: a fetcher thread of its own beside the stager (above);
        ignored at depth 0.

    `waited_s` and `batches` add up, over all passes, the seconds the
    consumer spent waiting for a staged batch and the batches it took."""

    def __init__(self, host_batches: Iterable[Any], device: torch.device,
                 depth: int = 2,
                 assemble: Optional[Callable[[int, Any], Arrays]] = None,
                 overlap: bool = False):
        self.host = host_batches
        self.device = torch.device(device)
        self.depth = max(int(depth), 0)
        self._assemble = assemble or (lambda i, hb: tuple(hb))
        self.overlap = bool(overlap)
        self.waited_s = 0.0
        self.batches = 0
        self.stager_thread: Optional[int] = None
        self.fetch_thread: Optional[int] = None

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        if self.depth == 0:  # the consumer waits for the load and the copy
            self.stager_thread = self.fetch_thread = None
            it, i = iter(self.host), 0
            while True:
                t0 = time.perf_counter()
                hb = next(it, None)
                if hb is None:
                    return
                out = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device, non_blocking=True)
                    for a in self._assemble(i, hb))
                self.waited_s += time.perf_counter() - t0
                self.batches += 1
                i += 1
                yield out

        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        # depth waiting in the queue, one in the consumer's hand, one being
        # staged: a slot comes round again only after depth + 2 batches
        slots = [_PinnedSlot() for _ in range(self.depth + 2)] if cuda else []
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        # the fetcher's one-slot handoff to the stager (overlap only)
        hq: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()
        error: list = []

        def put_or_stop(item, into: "queue.Queue" = q) -> bool:
            """Bounded put that gives up when the consumer has gone."""
            while not stop.is_set():
                try:
                    into.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def get_or_stop():
            """The fetcher's next (i, arrays), or None at its end or when
            the consumer has gone."""
            while not stop.is_set():
                try:
                    return hq.get(timeout=0.1)
                except queue.Empty:
                    continue
            return None

        def stage(i: int, arrays: Arrays):
            if not cuda:
                return tuple(torch.from_numpy(np.ascontiguousarray(a))
                             for a in arrays), None
            slot = slots[i % len(slots)]
            pinned = slot.fill(arrays)
            with torch.cuda.stream(side):
                out = tuple(b.to(self.device, non_blocking=True) for b in pinned)
                slot.event = torch.cuda.Event()
                slot.event.record(side)
            return out, slot.event

        def pull(out: Callable[[Any], bool], into: "queue.Queue") -> None:
            """Pull the loader, handing `out` each batch (assembled) until
            it refuses; the end marker goes `into` the next queue."""
            it = iter(self.host)
            try:
                for i, hb in enumerate(it):
                    if stop.is_set() or not out((i, self._assemble(i, hb))):
                        return
            except BaseException as e:  # re-raised at the iteration site
                error.append(e)
            finally:
                # unwind the loader's own producer thread now, not at GC
                close = getattr(it, "close", None)
                if close is not None:
                    close()
                put_or_stop(None, into)

        def stager():
            if not self.overlap:
                pull(lambda item: put_or_stop(stage(*item)), q)
                return
            try:
                while (item := get_or_stop()) is not None:
                    if not put_or_stop(stage(*item)):
                        return
            except BaseException as e:
                error.append(e)
            finally:
                put_or_stop(None)

        threads = [threading.Thread(target=stager, daemon=True,
                                    name="device-stager")]
        if self.overlap:
            threads.append(threading.Thread(
                target=pull, args=(lambda item: put_or_stop(item, hq), hq),
                daemon=True, name="host-fetcher"))
        for t in threads:
            t.start()
        self.stager_thread = threads[0].ident
        self.fetch_thread = threads[1].ident if self.overlap else None
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.waited_s += time.perf_counter() - t0
                if item is None:
                    break
                out, event = item
                if event is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(event)
                    for x in out:
                        x.record_stream(consumer)
                self.batches += 1
                yield out
            if error:
                raise error[0]
        finally:
            stop.set()
            for qq in (q, hq):  # drain, so a thread blocked on put can exit
                while True:
                    try:
                        qq.get_nowait()
                    except queue.Empty:
                        break
            for t in threads:
                t.join(timeout=10.0)
