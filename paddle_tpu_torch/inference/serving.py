"""Request-queue micro-batching server over the Generator (counterpart of
``paddle_tpu/inference/serving.py``).

Callers submit single requests and get futures; one worker thread drains
the queue, coalesces up to ``max_batch`` requests (waiting at most
``max_wait_ms`` for stragglers), right-pads them into one bucketized
``Generator.generate`` call and resolves each future with its row. The
JAX server's metrics, tracing spans and fault hooks come with the
observability slice.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Sequence

import numpy as np

from paddle_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device


class RequestExpired(TimeoutError):
    """The request's client deadline (``submit(ttl=)``) passed while it
    was still queued: it was shed, not decoded."""


class BatchingGeneratorServer:
    """Micro-batching front-end for ``inference.Generator``.

    >>> srv = BatchingGeneratorServer(generator, max_batch=16)
    >>> fut = srv.submit([5, 17, 42])          # token ids, one request
    >>> tokens = fut.result()                  # [max_len] generated ids
    >>> srv.stop()

    ``device`` must be the generator's device; the default ``"cuda"``
    raises where no card is present."""

    def __init__(self, generator, max_batch: int = 16,
                 max_wait_ms: float = 5.0, device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        if dev.type != generator.device.type:
            raise ValueError(f"server device {dev} differs from the "
                             f"generator's {generator.device}")
        self.gen = generator
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._cancel = threading.Event()   # stop(drain=False)
        self._lock = threading.Lock()      # serializes submit vs stop
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side -----------------------------------------------------

    def submit(self, src_ids: Sequence[int], max_new: int = None,
               ttl: float = None) -> Future:
        """One request (un-padded id sequence). The future resolves to the
        generated row, ``[max_len]`` ids. ``max_new`` zeroes the row past
        that many tokens (the batch still decodes up to cfg.max_len, and
        stops early only when the whole batch has finished).

        ``ttl`` (seconds) is the client's deadline: a request still queued
        when it elapses fails with :class:`RequestExpired` instead of
        being decoded. A request whose batch is decoding completes."""
        if max_new is not None and max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if ttl is not None and ttl <= 0:
            raise ValueError(f"ttl must be > 0 seconds, got {ttl}")
        fut: Future = Future()
        deadline = None if ttl is None else time.perf_counter() + ttl
        with self._lock:  # no request may land after stop() ran
            if self._stop.is_set():
                raise RuntimeError("server is stopped")
            self._q.put((np.asarray(src_ids, np.int32), max_new, deadline,
                         fut))
        return fut

    def stop(self, drain: bool = True):
        """Stop the worker; with drain, outstanding requests complete
        first, otherwise they are cancelled. Idempotent."""
        if self._stop.is_set() and not self._worker.is_alive():
            return
        if drain:
            self._q.join()
        with self._lock:
            if not drain:
                self._cancel.set()  # worker cancels instead of serving
            self._stop.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=60)
        if not self._worker.is_alive():
            # worker is gone: safe to cancel anything left behind
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[-1].cancel()
                self._q.task_done()

    # -- worker side -----------------------------------------------------

    def _collect(self) -> List:
        """Block for the first request, then soak up to max_batch within
        the wait window."""
        first = self._q.get()
        if first is None:
            self._q.task_done()  # balance the sentinel so join() can't hang
            return []
        batch = [first]
        t0 = time.perf_counter()
        while len(batch) < self.max_batch:
            remaining = self.max_wait - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                self._q.task_done()
                self._stop.set()
                break
            batch.append(item)
        return batch

    def _shed_expired(self, batch) -> List:
        """Fail the queued requests whose ttl has passed; return the rest."""
        now = time.perf_counter()
        live = []
        for item in batch:
            deadline, fut = item[2], item[-1]
            if deadline is not None and now >= deadline:
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(RequestExpired(
                        f"request expired {now - deadline:.3f}s past its "
                        "ttl while queued"))
                self._q.task_done()
            else:
                live.append(item)
        return live

    def _run(self):
        while not self._stop.is_set() or not self._q.empty():
            batch = self._collect()
            if not batch:
                continue
            if self._cancel.is_set():
                for *_, fut in batch:
                    fut.cancel()
                for _ in batch:
                    self._q.task_done()
                continue
            batch = self._shed_expired(batch)
            if not batch:
                continue
            try:
                width = max(len(s) for s, *_ in batch)
                src = np.full((len(batch), width), self.gen.cfg.pad_id,
                              np.int32)
                for i, (s, *_) in enumerate(batch):
                    src[i, :len(s)] = s
                out = self.gen.generate(src)
                for (_, mn, _, fut), row in zip(batch, out):
                    row = np.array(row)
                    if mn is not None and mn < len(row):
                        row[mn:] = 0
                    # a client may have cancelled while we computed
                    if fut.set_running_or_notify_cancel():
                        fut.set_result(row)
            except Exception as e:  # noqa: BLE001 -- fail the whole batch
                for *_, fut in batch:
                    if not fut.done():
                        try:
                            fut.set_exception(e)
                        except Exception:  # racing cancel: already done
                            pass
            finally:
                for _ in batch:
                    self._q.task_done()
