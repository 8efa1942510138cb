"""Continuous micro-batching request coalescer (the port's copy of
dalle2_video_tpu/serve/batcher.py).

Accelerator throughput comes from batch: the denoiser is launch- and
bandwidth-bound at small batch, so coalescing concurrent requests into one
device call raises throughput at little latency cost. This batcher implements the standard continuous
micro-batching loop used by production model servers:

  * requests enter a thread-safe queue and receive a Future
  * a single worker thread drains the queue, groups compatible requests
    (same static key: cond_scale / step count / shape bucket — anything
    that would force a retrace must match), and dispatches up to
    ``max_batch`` per group
  * if the queue is empty but a partial batch exists, the worker waits at
    most ``max_wait_ms`` for stragglers before dispatching — bounded
    added latency, unbounded batching upside

No framework in this module: it batches opaque items through a user callable,
so it is testable without a device and reusable for CLIP scoring or
prior-only serving.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Hashable, List, Optional, Sequence


@dataclass
class BatcherStats:
    """Running counters only — O(1) memory for the life of the server."""

    requests: int = 0
    batches: int = 0
    errors: int = 0
    batch_size_sum: int = 0
    batch_size_max: int = 0

    def record_batch(self, n: int) -> None:
        self.batches += 1
        self.requests += n
        self.batch_size_sum += n
        self.batch_size_max = max(self.batch_size_max, n)

    def snapshot(self) -> dict:
        return {
            "requests": self.requests,
            "batches": self.batches,
            "errors": self.errors,
            "mean_batch_size": (
                self.batch_size_sum / self.batches if self.batches else 0.0
            ),
            "max_batch_size": self.batch_size_max,
        }


class MicroBatcher:
    """Coalesce submit() calls into grouped batches for ``run_batch``.

    run_batch(key, items) -> sequence of per-item results (same length,
    same order). Exceptions from run_batch fail every future in that
    batch (callers see the exception; the worker keeps serving).

    ``dispatch_workers > 1`` runs up to that many run_batch calls
    CONCURRENTLY (a thread pool fed by the drain loop, gated by a
    semaphore for backpressure) — the multi-replica serving mode where
    run_batch draws an idle device replica from a pool
    (serve/engine.py). The default of 1 keeps the original fully
    serialized single-worker semantics.
    """

    def __init__(
        self,
        run_batch: Callable[[Hashable, List[Any]], Sequence[Any]],
        *,
        max_batch: int = 8,
        max_wait_ms: float = 10.0,
        key_fn: Callable[[Any], Hashable] = lambda item: None,
        dispatch_workers: int = 1,
    ):
        self._run_batch = run_batch
        self._max_batch = int(max_batch)
        self._max_wait_s = float(max_wait_ms) / 1e3
        self._key_fn = key_fn
        self._q: "queue.Queue" = queue.Queue()
        self.stats = BatcherStats()
        self._stats_lock = threading.Lock()  # errors bump from dispatch threads
        self._dispatch_workers = max(1, int(dispatch_workers))
        self._executor = (
            ThreadPoolExecutor(
                max_workers=self._dispatch_workers,
                thread_name_prefix="batch-dispatch",
            )
            if self._dispatch_workers > 1
            else None
        )
        self._inflight = threading.Semaphore(self._dispatch_workers)
        self._closed = threading.Event()
        self._worker = threading.Thread(
            target=self._loop, name="microbatcher", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------- #
    def submit(self, item: Any) -> Future:
        if self._closed.is_set():
            raise RuntimeError("MicroBatcher is closed")
        fut: Future = Future()
        self._q.put((self._key_fn(item), item, fut))
        return fut

    def close(self, timeout: Optional[float] = 5.0) -> None:
        self._closed.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=timeout)
        if self._executor is not None:
            self._executor.shutdown(wait=True)

    # ------------------------------------------------------------- #
    def _drain(self, first) -> List[tuple]:
        """Collect up to max_batch entries sharing first's key; entries
        with other keys go back on the queue (served next iteration)."""
        key = first[0]
        batch = [first]
        put_back = []
        deadline = time.monotonic() + self._max_wait_s
        while len(batch) < self._max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                # break unconditionally at the deadline: waiting on "queue
                # momentarily non-empty" livelocks under a sustained stream
                # of other-key requests (the in-hand batch never dispatches)
                break
            try:
                entry = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if entry is None:  # close sentinel
                break
            if entry[0] == key:
                batch.append(entry)
            else:
                put_back.append(entry)
        for entry in put_back:
            self._q.put(entry)
        return batch

    def _loop(self) -> None:
        while True:
            try:
                entry = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._closed.is_set():
                    return
                continue
            if entry is None:
                if self._closed.is_set():
                    return
                continue
            batch = self._drain(entry)
            key = batch[0][0]
            items = [item for _, item, _ in batch]
            futures = [fut for _, _, fut in batch]
            self.stats.record_batch(len(items))
            if self._executor is None:
                self._dispatch(key, items, futures)
            else:
                # semaphore backpressure: once every dispatch worker is
                # busy the drain loop blocks here, so the queue (not the
                # pool) absorbs the burst and grouping stays effective
                self._inflight.acquire()

                def run(key=key, items=items, futures=futures):
                    try:
                        self._dispatch(key, items, futures)
                    finally:
                        self._inflight.release()

                self._executor.submit(run)

    def _dispatch(self, key, items, futures) -> None:
        try:
            results = self._run_batch(key, items)
            if len(results) != len(items):
                raise RuntimeError(
                    f"run_batch returned {len(results)} results for "
                    f"{len(items)} items"
                )
            for fut, res in zip(futures, results):
                fut.set_result(res)
        except Exception as exc:  # noqa: BLE001 — fail the batch, keep serving
            with self._stats_lock:
                self.stats.errors += len(items)
            for fut in futures:
                if not fut.done():
                    fut.set_exception(exc)
