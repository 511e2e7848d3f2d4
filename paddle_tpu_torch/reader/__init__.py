"""Reader decorators (reference: python/paddle/reader/decorator.py —
batch/shuffle/buffered/cache/map_readers/xmap_readers/chain/compose/firstn).
A reader is a zero-arg callable returning a sample generator."""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading

__all__ = ["Fake", "PipeReader",
           "batch", "shuffle", "buffered", "cache", "map_readers",
           "xmap_readers", "chain", "compose", "firstn",
           "multiprocess_reader", "stack_feed_window", "pack_sequences"]


def pack_sequences(seqs, seq_len, n_rows=None):
    """Pack variable-length token sequences into fixed [B, seq_len]
    rows for ``models.gpt.build(packed=True)`` — multiple documents
    per row, no FLOPs on padding. Greedy first-fit in arrival order:
    a document goes WHOLE into the current row if it fits, else a new
    row starts; only documents longer than seq_len are ever split
    (each split tail becomes a new segment in the next row — rows
    cannot attend across). Returns a feed dict with ``ids``,
    ``segment_ids`` (1-based per row, 0 = padding; the gpt packed loss
    hard-masks id 0, so 0 is THE pad token) and ``pos_ids``
    (within-segment positions, for RoPE resets or the learned table).

    ``n_rows`` pins the batch dimension (pad with empty rows / raise
    on overflow): the executor prepares (and on the card captures) a
    plan per feed SHAPE, so steady-state training should hold B
    constant rather than re-prepare on every differently-sized pack."""
    import numpy as np

    rows, segs, poss = [], [], []

    def new_row():
        rows.append([])
        segs.append([])
        poss.append([])

    new_row()
    n_seqs = 0
    for seq in seqs:
        n_seqs += 1
        seq = list(seq)
        while seq:
            space = seq_len - len(rows[-1])
            # a doc that would be NEEDLESSLY split moves whole to a
            # fresh row; docs longer than seq_len must split anyway,
            # so they fill the remaining space first
            if not space or (space < len(seq) <= seq_len):
                new_row()
                space = seq_len
            chunk, seq = seq[:space], seq[space:]
            seg_id = (segs[-1][-1] if segs[-1] else 0) + 1
            rows[-1].extend(chunk)
            segs[-1].extend([seg_id] * len(chunk))
            poss[-1].extend(range(len(chunk)))

    if rows and not rows[-1]:
        # drop the trailing empty row (always present when the last doc
        # exactly filled its row)
        rows.pop(), segs.pop(), poss.pop()
    if not rows:
        # empty input (no documents, or all documents empty) must be an
        # explicit error: silently returning a 0-row batch — or, with
        # n_rows set, an ALL-PADDING batch padded back up to n_rows —
        # would train on pure pad (segment id 0 everywhere)
        raise ValueError(
            "pack_sequences: no tokens to pack (%s) — an empty pack "
            "cannot form a training batch"
            % ("empty sequence iterable" if n_seqs == 0
               else "all %d documents are empty" % n_seqs))
    B = len(rows)
    if n_rows is not None:
        if B > n_rows:
            raise ValueError(
                "pack_sequences: %d sequences need %d rows of length "
                "%d but n_rows=%d — feed fewer documents per pack or "
                "raise n_rows" % (n_seqs, B, seq_len, n_rows))
        B = n_rows
    ids = np.zeros((B, seq_len), dtype="int64")
    seg = np.zeros((B, seq_len), dtype="int64")
    pos = np.zeros((B, seq_len), dtype="int64")
    for i in range(len(rows)):
        n = len(rows[i])
        ids[i, :n] = rows[i]
        seg[i, :n] = segs[i]
        pos[i, :n] = poss[i]
    return {"ids": ids, "segment_ids": seg, "pos_ids": pos}


def stack_feed_window(feed_dicts):
    """Stack K per-step feed dicts into one dict of [K, ...] arrays for
    ``Executor.run_repeated(..., steps=K, feed_stacked=True)`` — K
    different minibatches per call (K replays of the step's CUDA graph
    with no host sync between them). All dicts must share keys and
    per-key shapes/dtypes; K is ``len(feed_dicts)``. Tensors (e.g. a
    ``DevicePrefetcher``'s batches on the card) stack with
    ``torch.stack`` where they lie — no host round-trip; host arrays
    stack with ``np.stack``."""
    import numpy as np

    if not feed_dicts:
        raise ValueError("stack_feed_window: need at least one feed dict")
    keys = set(feed_dicts[0])
    for i, d in enumerate(feed_dicts[1:], 1):
        if set(d) != keys:
            raise ValueError(
                "stack_feed_window: feed dict %d has keys %s, expected %s"
                % (i, sorted(d), sorted(keys)))

    import torch

    def stack(vals):
        if all(isinstance(v, torch.Tensor) for v in vals):
            return torch.stack(vals)
        return np.stack([np.asarray(v) for v in vals])

    return {k: stack([d[k] for d in feed_dicts]) for k in keys}


def batch(reader, batch_size, drop_last=False):
    def batch_reader():
        from ..observe import mark_batch_produced
        from ..observe.families import DATA_BATCHES

        batches = DATA_BATCHES.labels(source="reader.batch")
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                batches.inc()
                mark_batch_produced()
                yield buf
                buf = []
        if buf and not drop_last:
            batches.inc()
            mark_batch_produced()
            yield buf

    return batch_reader


def shuffle(reader, buf_size):
    def shuffle_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        _random.shuffle(buf)
        yield from buf

    return shuffle_reader


def _stop_aware_put(q, item, stop, poll=0.1):
    """Bounded put that gives up when `stop` is set — a producer thread
    must never block forever against a full queue after its consumer
    abandoned the generator. Returns False when stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=poll)
            return True
        except queue.Full:
            continue
    return False


def _drain(q):
    """Empty a queue so a producer blocked in `_stop_aware_put` wakes,
    sees the stop flag, and exits. The other half of the stop-aware
    contract; shared by buffered/multiprocess_reader/DevicePrefetcher."""
    while True:
        try:
            q.get_nowait()
        except queue.Empty:
            break


def buffered(reader, size):
    """Background-thread prefetch (the py_reader/double-buffer analog for
    plain python pipelines). A consumer that abandons the generator
    early (break, GC, .close()) signals the fill thread to stop — the
    put is stop-aware, so the thread exits instead of blocking forever
    on the bounded queue."""
    end = object()

    def buffered_reader():
        from ..observe import mark_batch_produced

        q: queue.Queue = queue.Queue(maxsize=size)
        stop = threading.Event()
        error = []

        def fill():
            try:
                for sample in reader():
                    if not _stop_aware_put(q, sample, stop):
                        return
            except BaseException as e:  # re-raised in the consumer
                error.append(e)
            finally:
                _stop_aware_put(q, end, stop)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        try:
            while True:
                s = q.get()
                if s is end:
                    if error:
                        raise error[0]
                    break
                # the wrapped reader's gap stamp landed in the FILL
                # thread (stamps are thread-local); re-stamp at hand-off
                # so the consumer's feed->run gap still observes
                mark_batch_produced()
                yield s
        finally:
            # GeneratorExit / normal exhaustion / consumer exception all
            # land here: release the producer, then drain so a put
            # blocked on a full queue wakes and sees the stop flag
            stop.set()
            _drain(q)

    return buffered_reader


def cache(reader):
    all_data = []
    filled = [False]

    def cache_reader():
        if not filled[0]:
            all_data.extend(reader())
            filled[0] = True
        yield from all_data

    return cache_reader


def map_readers(func, *readers):
    def reader():
        for vals in zip(*[r() for r in readers]):
            yield func(*vals)

    return reader


def xmap_readers(mapper, reader, process_num=1, buffer_size=1024, order=False):
    # thread-pool map; order preserved when asked
    def xreader():
        if order or process_num <= 1:
            for s in reader():
                yield mapper(s)
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(process_num) as pool:
            yield from pool.map(mapper, reader())

    return xreader


def chain(*readers):
    def chain_reader():
        yield from itertools.chain(*[r() for r in readers])

    return chain_reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, check_alignment=True):
    def compose_reader():
        gens = [r() for r in readers]
        sentinel = object()
        while True:
            vals = [next(g, sentinel) for g in gens]
            done = [v is sentinel for v in vals]
            if all(done):
                return
            if any(done):
                if check_alignment:
                    raise ComposeNotAligned(
                        "composed readers have different lengths")
                return
            out = []
            for v in vals:
                if isinstance(v, tuple):
                    out.extend(v)
                else:
                    out.append(v)
            yield tuple(out)

    return compose_reader


def firstn(reader, n):
    def firstn_reader():
        yield from itertools.islice(reader(), n)

    return firstn_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """reference reader/decorator.py:338 — run several readers
    concurrently and interleave their samples. The reference forks
    processes (GIL-bound cv2 decoding); here readers drive numpy and
    torch, which release the GIL, so worker THREADS give the same
    overlap without the hazards of forking a process that holds a CUDA
    context (documented divergence)."""
    def reader():
        q = queue.Queue(maxsize=queue_size)
        stop = threading.Event()
        sentinel = object()
        errors = []

        def work(r):
            try:
                for sample in r():
                    if not _stop_aware_put(q, sample, stop):
                        return
            except BaseException as e:  # re-raised in the consumer: a
                errors.append(e)       # dead worker must not read as a
            finally:                   # normally-exhausted epoch
                _stop_aware_put(q, sentinel, stop)

        threads = [threading.Thread(target=work, args=(r,), daemon=True)
                   for r in readers]
        for t in threads:
            t.start()
        try:
            from ..observe import mark_batch_produced

            done = 0
            while done < len(readers):
                item = q.get()
                if item is sentinel:
                    done += 1
                    # a worker appends its error BEFORE its sentinel, so
                    # checking here raises at the point of death instead
                    # of after every healthy worker drains its epoch
                    if errors:
                        raise errors[0]
                else:
                    # worker-thread stamps are thread-local: re-stamp at
                    # hand-off so the consumer's feed->run gap observes
                    mark_batch_produced()
                    yield item
        finally:
            # same guard as buffered(): an abandoned consumer must not
            # leave len(readers) drain threads blocked on q.put forever
            stop.set()
            _drain(q)

    return reader


class Fake:
    """Cache the first sample and replay it data_num times (reference
    reader/decorator.py:509) — input-pipeline-free speed testing."""

    def __init__(self):
        self.data = None
        self.yield_num = 0

    def __call__(self, reader, data_num):
        def fake_reader():
            if self.data is None:
                self.data = next(reader())
            while self.yield_num < data_num:
                self.yield_num += 1
                yield self.data
            self.yield_num = 0

        return fake_reader


class PipeReader:
    """Stream samples out of a shell command's stdout (reference
    reader/decorator.py:438): `hadoop fs -cat ...`, `curl ...`,
    `cat f.gz`. get_line() decodes buffered chunks into text lines."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        if not isinstance(command, str):
            raise TypeError("a command string is required")
        if file_type not in ("gzip", "plain"):
            raise TypeError("file_type %s is not allowed" % file_type)
        self.command = command
        self.bufsize = bufsize
        self.file_type = file_type
        self.process = None

    def get_line(self, cut_lines=True, line_break="\n"):
        import subprocess
        import zlib

        self.process = subprocess.Popen(
            self.command.split(" "), bufsize=self.bufsize,
            stdout=subprocess.PIPE)
        decomp = zlib.decompressobj(32 + zlib.MAX_WBITS) \
            if self.file_type == "gzip" else None
        remained = ""
        while True:
            buff = self.process.stdout.read(self.bufsize)
            if not buff:
                break
            if decomp is not None:
                buff = decomp.decompress(buff)
            text = remained + buff.decode("utf8", errors="replace")
            if not cut_lines:
                remained = ""
                yield text
                continue
            lines = text.split(line_break)
            remained = lines.pop()
            for line in lines:
                yield line
        if decomp is not None:
            # emit any tail still buffered in the decompressor
            tail = decomp.flush()
            if tail:
                remained += tail.decode("utf8", errors="replace")
        if remained:
            yield remained
        rc = self.process.wait()
        if rc != 0:
            # a failing command (bad path, auth error, killed pipe) must
            # not look like a clean end-of-stream with truncated data
            raise RuntimeError(
                "PipeReader command %r exited with status %d"
                % (self.command, rc))
