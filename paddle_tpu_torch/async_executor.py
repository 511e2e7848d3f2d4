"""AsyncExecutor: file-driven training over the native data feed.

Analog of the reference's async_executor.cc (RunFromFile) with
executor_thread_worker.cc and the Python driver async_executor.py: the
reference's CTR path, where worker threads each parse slot files
(MultiSlotDataFeed) and run Hogwild updates on shared CPU params.

Deliberate divergence, as in the JAX package: Hogwild's lock-free racing
updates are not reproduced. The native C++ reader threads
(native/datafeed.cc, built from the port's own source) parse and batch
files concurrently, and each batch is one ordinary synchronous step of
``Executor.run``, on the card unless the caller passes ``CPUPlace()``:
the input pipeline stays off the Python thread and the updates are
deterministic.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .core.executor import Executor
from .core.program import Program, default_main_program
from .core.scope import Scope, global_scope
from .native.data_feed import MultiSlotDataFeed

__all__ = ["AsyncExecutor", "DataFeedDesc"]


# The canonical DataFeedDesc (proto-text OR programmatic slots) lives in
# data_feed_desc.py (reference python/paddle/fluid/data_feed_desc.py);
# re-exported here because AsyncExecutor.run consumes it.
from .data_feed_desc import DataFeedDesc  # noqa: E402


class AsyncExecutor:
    def __init__(self, place=None):
        self.place = place
        self._exe = Executor(place)

    def run(self, program: Optional[Program], data_feed: DataFeedDesc,
            filelist: List[str], thread_num: int = 2,
            fetch: Optional[Sequence] = None, mode: str = "", debug: bool = False,
            scope: Optional[Scope] = None, epochs: int = 1):
        """Train `program` over slot files; returns the last fetch values
        (AsyncExecutor.run / RunFromFile analog — thread_num drives the
        native reader threads, not racing updaters)."""
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = [getattr(v, "name", v) for v in (fetch or [])]
        feed = MultiSlotDataFeed(
            files=filelist, slots=data_feed.slot_descs,
            batch_size=data_feed.batch_size, n_threads=thread_num,
            epochs=epochs)
        last = None
        try:
            for i, batch in enumerate(feed.feed_dict()):
                last = self._exe.run(program, feed=batch,
                                     fetch_list=fetch_names, scope=scope)
                if debug and fetch_names and i % 10 == 0:
                    print("step %d: %s" % (
                        i, {n: np.asarray(v).ravel()[:4]
                            for n, v in zip(fetch_names, last)}))
        finally:
            feed.close()
        return last
