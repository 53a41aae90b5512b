"""Host-side input pipeline: background prefetch of next batches so host
data prep overlaps device compute (the standard double-buffering trick).

The port's own copy of ``repro/data/pipeline.py``: batches stay numpy
arrays here and go to the device in the train driver.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional


class Prefetcher:
    """Wrap an iterator with an N-deep background prefetch queue."""

    _SENTINEL = object()

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._stopped = threading.Event()
        self._thread.start()

    def _fill(self) -> None:
        try:
            for item in self._it:
                if self._stopped.is_set():
                    return
                self._q.put(item)
        except BaseException as e:  # surfaced on next()
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self) -> Any:
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        self._stopped.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
