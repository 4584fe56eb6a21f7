"""A prefetching map for host work (decoding, resizing) ahead of the device.

Counterpart of followmyhold_tpu/utils/dataloader.py, whose module imports no
JAX; the port keeps its own copy. Standard library only; the results come in
the items' order, and an item's exception is raised where that item's result
would have been yielded.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterator, Sequence, TypeVar

T = TypeVar("T")
U = TypeVar("U")


def prefetch_map(
    fn: Callable[[T], U],
    items: Sequence[T],
    num_workers: int = 2,
    prefetch: int = 4,
) -> Iterator[U]:
    """Yield fn(item) in order, computed ahead by worker threads.

    An exception propagates at the yield of the failing item, so a stage's
    loop can report that item and carry on with the next.
    """
    items = list(items)
    if not items:
        return
    results: dict[int, object] = {}
    cond = threading.Condition()
    next_in = {"i": 0}
    next_out = {"i": 0}
    window = prefetch + max(1, num_workers)

    def worker():
        while True:
            with cond:
                # the window holds back TAKING work, never storing a result:
                # a worker blocked on storing could hold the very item the
                # consumer waits for behind results that came out of order
                while True:
                    i = next_in["i"]
                    if i >= len(items):
                        return
                    if i < next_out["i"] + window:
                        next_in["i"] = i + 1
                        break
                    cond.wait(timeout=0.5)
            try:
                out = (False, fn(items[i]))
            except Exception as e:  # noqa: BLE001 - handed to the consumer
                out = (True, e)
            with cond:
                results[i] = out
                cond.notify_all()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, num_workers))]
    for t in threads:
        t.start()

    for i in range(len(items)):
        with cond:
            while i not in results:
                cond.wait(timeout=0.5)
            is_err, val = results.pop(i)
            next_out["i"] = i + 1
            cond.notify_all()
        if is_err:
            raise val
        yield val
