"""Background checkpoint writer: one save in flight, backpressure after
(a copy of ``paddle_tpu/checkpoint/async_saver.py``; stdlib only).

The writer is a single daemon thread consuming a depth-1 mailbox. The
train loop's side of a save is only (1) taking the snapshot (issuing
the device-to-host copies, ``snapshot.py``) and (2) handing it to
:meth:`AsyncSaver.submit`. Submit normally returns immediately; when
the PREVIOUS save is still writing, it blocks until that save finishes
— the "at most one in flight" backpressure the checkpoint manager
reports as blocked time. Saves are strictly ordered: a later step's
checkpoint never commits before an earlier one.

Writer errors never kill training: they are recorded (``last_error``,
an error counter via the manager's callback) and the next save
proceeds. Callers that must know a save landed (emergency saves, end of
training) use :meth:`wait`.
"""
from __future__ import annotations

import threading
import time


class AsyncSaver:
    def __init__(self, on_error=None):
        self._on_error = on_error
        self._lock = threading.Lock()
        self._job_ready = threading.Condition(self._lock)
        self._job_done = threading.Condition(self._lock)
        self._job = None  # pending (not yet picked up) job
        self._running = False  # a picked-up job is executing
        self._closed = False
        self.last_error = None
        self._thread = threading.Thread(
            target=self._worker, name="ckpt-writer", daemon=True
        )
        self._thread.start()

    # --------------------------------------------------------------- worker
    def _worker(self):
        while True:
            with self._lock:
                while self._job is None and not self._closed:
                    self._job_ready.wait()
                if self._job is None and self._closed:
                    return
                job, self._job = self._job, None
                self._running = True
                self._job_done.notify_all()  # mailbox slot free
            try:
                job()
            except Exception as e:  # surfaced, never fatal to training
                with self._lock:
                    # writer-thread publication: readers poll last_error
                    # from the train thread (unlocked-shared-write)
                    self.last_error = e
                if self._on_error is not None:
                    try:
                        self._on_error(e)
                    except Exception:
                        pass
            finally:
                with self._lock:
                    self._running = False
                    self._job_done.notify_all()

    # ----------------------------------------------------------------- api
    def submit(self, job):
        """Enqueue ``job`` (a zero-arg callable doing write+commit).
        Blocks while a previous save is in flight; returns the seconds
        spent blocked (0.0 on the fast path)."""
        t0 = time.perf_counter()
        with self._lock:
            if self._closed:
                raise RuntimeError("AsyncSaver is closed")
            while self._job is not None or self._running:
                self._job_done.wait()
            self._job = job
            self._job_ready.notify()
        return time.perf_counter() - t0

    def busy(self):
        with self._lock:
            return self._job is not None or self._running

    def wait(self, timeout=None):
        """Block until no save is pending or in flight. Returns True if
        drained, False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._job is not None or self._running:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._job_done.wait(remaining)
        return True

    def close(self, timeout=30.0):
        """Drain and stop the worker thread."""
        self.wait(timeout)
        with self._lock:
            self._closed = True
            self._job_ready.notify_all()
        self._thread.join(timeout=5.0)
