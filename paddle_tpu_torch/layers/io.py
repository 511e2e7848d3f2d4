"""Input layers (reference: python/paddle/fluid/layers/io.py — data:39,
py_reader:636, double_buffer), the port of paddle_tpu/layers/io.py.

py_reader in the reference is an op stack: a LoDTensorBlockingQueue fed
from Python, popped by create_py_reader_op, wrapped by buffered_reader's
async device prefetch (operators/reader/buffered_reader.cc). Here the
executor takes feed dicts directly, so ``PyReader`` is a host-side
prefetcher: a producer thread pulls batches from the user's reader and
copies them to the card ahead of the train loop. It is the executor's
``DevicePrefetcher`` (core/pipeline.py): each batch is converted on the
host (``feeds_to_device``: dtypes, int64 narrowed to int32 with its
range check), staged in pinned memory and copied ``non_blocking`` on the
prefetcher's own stream; the consumer's stream waits on the copy's event
and ``record_stream`` keeps each tensor alive while the step reads it.
Up to ``capacity`` batches wait on the card. The card is the default
place; ``decorate_*_generator(..., places=CPUPlace())`` yields host
tensors instead.
"""

from __future__ import annotations

import numpy as np

from ..core.program import default_main_program, default_startup_program

__all__ = ["data", "PyReader", "py_reader", "double_buffer",
           "create_py_reader_by_data", "read_file", "open_files",
           "random_data_generator", "Preprocessor", "load",
           "shuffle", "batch"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare a feed variable. With append_batch_size, a leading -1 batch
    dim is added (reference io.py:39); the concrete shape comes from the
    feed."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().global_block()
    v = block.create_var(
        name=name, shape=shape, dtype=dtype, is_data=True,
        stop_gradient=stop_gradient, lod_level=lod_level,
    )
    # mirror into startup so program pairs stay consistent (reference parity)
    default_startup_program()
    return v


def _one_place(places):
    """The place a reader copies to: ``places`` (a Place, or a list of
    one), else None, which the prefetcher takes as the card."""
    if isinstance(places, (list, tuple)):
        if len(places) != 1:
            raise NotImplementedError(
                "a reader feeds one device in the port; got places %r"
                % (places,))
        places = places[0]
    return places


def _prefetched(feeds, place, depth, program=None):
    """Iterate the feed dicts of the zero-arg ``feeds`` through a
    ``DevicePrefetcher`` at ``place`` (None: the card) holding up to
    ``depth`` converted batches; the prefetcher's thread retires when
    the consumer walks away."""
    from ..core.pipeline import DevicePrefetcher

    pf = DevicePrefetcher(feeds, place=place, program=program, depth=depth,
                          const_dedup=False)
    try:
        yield from pf
    finally:
        pf.close()


class PyReader:
    """Iterable device-prefetching reader (reference layers/io.py:636
    py_reader + reader/buffered_reader.cc double buffering).

        reader = PyReader(feed_list=[img, label], capacity=64)
        reader.decorate_batch_generator(gen)   # gen yields tuples of arrays
        for feed in reader():
            exe.run(main, feed=feed, fetch_list=[loss])

    Each feed is a dict of tensors on the reader's place (the card unless
    ``decorate_*_generator`` was given ``places=CPUPlace()``), already
    at the feed vars' on-device dtypes, which ``Executor.run`` and the
    compiled step take as they are. ``use_double_buffer=False`` yields
    the host arrays through a bounded thread instead. Breaking out of
    the loop retires the producer; an error in the user's reader is
    raised in the loop.
    """

    def __init__(self, feed_list=None, capacity=64, use_double_buffer=True,
                 iterable=True):
        self.feed_list = feed_list or []
        self.capacity = capacity
        self.use_double_buffer = use_double_buffer
        self._gen = None
        self._place = None

    def decorate_batch_generator(self, reader, places=None):
        self._gen = reader
        self._place = _one_place(places)

    def decorate_sample_list_generator(self, reader, places=None):
        """reader yields lists of per-sample tuples (DataFeeder format)."""
        from ..data_feeder import DataFeeder

        feeder = DataFeeder(self.feed_list)

        def gen():
            for samples in reader():
                fd = feeder.feed(samples)
                yield tuple(fd[v.name] for v in self.feed_list)

        self._gen = gen
        self._place = _one_place(places)

    def __call__(self):
        return iter(self)

    def __iter__(self):
        from ..reader import buffered

        if self._gen is None:
            raise RuntimeError("decorate a generator before iterating")
        names = [v.name for v in self.feed_list]

        def feeds():
            for batch in self._gen():
                yield dict(zip(names, batch))

        if not self.use_double_buffer:
            return buffered(feeds, self.capacity)()
        program = self.feed_list[0].block.program if self.feed_list \
            else None
        return _prefetched(feeds, self._place, self.capacity, program)

    def windows(self, k):
        """Group the reader's feeds into stacked K-windows for
        ``Executor.run_repeated(..., feed_stacked=True)`` — K real
        minibatches per call, K replays of the step's CUDA graph with no
        host sync between them:

            for window, steps in reader.windows(8):
                exe.run_repeated(main, feed=window, fetch_list=[loss],
                                 steps=steps, feed_stacked=True)

        Yields ``(stacked_feed, steps)``; ``steps`` is the window
        length. The tail window may be shorter, and a batch whose
        shapes differ from the window in progress (e.g. the final
        partial batch) flushes the window early so stacking never mixes
        shapes. Card tensors stack on the card (``torch.stack``)."""
        if k < 1:
            raise ValueError("windows(k) needs k >= 1; got %r" % (k,))
        from ..reader import stack_feed_window

        buf, shapes = [], None
        for feed in self:
            sig = {n: tuple(np.shape(v)) for n, v in feed.items()}
            if buf and sig != shapes:
                yield stack_feed_window(buf), len(buf)
                buf = []
            shapes = sig
            buf.append(feed)
            if len(buf) == k:
                yield stack_feed_window(buf), len(buf)
                buf = []
        if buf:
            yield stack_feed_window(buf), len(buf)


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Legacy functional form; returns a PyReader without bound feed vars
    (caller supplies dicts)."""
    r = PyReader(capacity=capacity, use_double_buffer=use_double_buffer)
    r.shapes, r.dtypes = shapes, dtypes
    return r


def double_buffer(reader, place=None, name=None):
    """Decorator form over a plain batch reader (reference layers/io.py
    double_buffer): each batch (a dict, a tuple or list of arrays, or one
    array) is copied to ``place`` (the card by default) one batch ahead
    of consumption, through the same staged copy as ``PyReader``."""

    def buffered():
        kinds = []

        def feeds():
            for b in reader():
                if isinstance(b, dict):
                    kinds.append(None)
                    yield b
                elif isinstance(b, (list, tuple)):
                    kinds.append(type(b))
                    yield dict(enumerate(b))
                else:
                    kinds.append(False)
                    yield {0: b}

        for i, d in enumerate(_prefetched(feeds, place, 2)):
            kind = kinds[i]
            if kind is None:
                yield d
            elif kind is False:
                yield d[0]
            else:
                yield kind(d[j] for j in range(len(d)))

    return buffered


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    """reference layers/io.py create_py_reader_by_data: a PyReader bound
    to existing feed vars."""
    return PyReader(feed_list=feed_list, capacity=capacity,
                    use_double_buffer=use_double_buffer)


def read_file(reader):
    """reference layers/io.py read_file: with op-based file readers gone
    (PyReader feeds the executor directly), this returns the reader's
    bound feed variables — or a Preprocessor's declared outputs."""
    if isinstance(reader, Preprocessor):
        return reader()
    return list(getattr(reader, "feed_list", []) or [])


def open_files(filenames, shapes=None, lod_levels=None, dtypes=None,
               thread_num=None, buffer_size=None, pass_num=1,
               is_test=False):
    """reference layers/io.py open_files over recordio files: returns a
    PyReader-style generator chaining paddle_tpu_torch.recordio_writer
    files (the op-based multi-file reader stack is subsumed by PyReader +
    the native datafeed)."""
    from ..recordio_writer import recordio_reader

    names = [filenames] if isinstance(filenames, str) else list(filenames)

    def gen():
        for _ in range(pass_num):
            for f in names:
                yield from recordio_reader(f)()

    return gen


def random_data_generator(low, high, shapes, lod_levels=None,
                          for_parallel=True):
    """reference layers/io.py random_data_generator: an endless reader of
    uniform random float batches with the given shapes."""
    import numpy as np

    def gen():
        while True:
            yield tuple(np.random.uniform(low, high, s).astype("float32")
                        for s in shapes)

    return gen


class Preprocessor:
    """reference layers/io.py Preprocessor: declare in-graph transforms
    over a reader's outputs. Ops built inside block() are ordinary main-
    program ops; inputs() hands out the reader's feed variables and
    outputs() records the transformed variables, which read_file() (or
    calling the preprocessor) then returns to the model builder.

        p = Preprocessor(py_reader)
        with p.block():
            img, lbl = p.inputs()
            p.outputs(scale(img, 1/255.), lbl)
        img, lbl = p()
    """

    def __init__(self, reader, name=None):
        self._reader = reader
        self._outs = None
        self._in_block = False

    def block(self):
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            self._in_block = True
            yield
            self._in_block = False
            if self._outs is None:
                raise ValueError("Preprocessor.block() ended without "
                                 "outputs()")

        return _ctx()

    def inputs(self):
        if not self._in_block:
            raise RuntimeError("inputs() must be called inside block()")
        return list(getattr(self._reader, "feed_list", []) or [])

    def outputs(self, *outs):
        if not self._in_block:
            raise RuntimeError("outputs() must be called inside block()")
        self._outs = list(outs)

    def __call__(self):
        if self._outs is None:
            raise RuntimeError("define the block() transforms first")
        return list(self._outs)


def load(out, file_path, load_as_fp16=False):
    """reference layers/io.py load: fill `out` from a saved checkpoint
    file (io.py combined format) — immediate scope load. The value
    lands as a tensor on the device of the value it replaces (the
    executor that ran the startup program put it there), else on the
    card."""
    import os

    import torch

    from ..core.place import default_place, require_device
    from ..core.scope import global_scope
    from ..io import _load_blob

    _, data = _load_blob(os.path.dirname(file_path) or ".",
                         os.path.basename(file_path))
    if out.name not in data:
        raise RuntimeError("%s lacks variable %r" % (file_path, out.name))
    arr = np.asarray(data[out.name])
    if load_as_fp16:
        arr = arr.astype(np.float16)
    old = global_scope().find_var(out.name)
    device = old.device if isinstance(old, torch.Tensor) else \
        require_device(default_place().torch_device())
    global_scope().set_var(out.name, torch.from_numpy(
        np.ascontiguousarray(arr)).to(device))
    return out


def shuffle(reader, buffer_size):
    """reference layers/io.py shuffle (op-based reader decorator): works
    over PyReader generators or plain reader creators here."""
    from ..reader import shuffle as _shuffle

    if isinstance(reader, PyReader):
        reader._gen = _shuffle(reader._gen, buffer_size)
        return reader
    return _shuffle(reader, buffer_size)


def batch(reader, batch_size):
    """reference layers/io.py batch decorator (see shuffle)."""
    from ..reader import batch as _batch

    if isinstance(reader, PyReader):
        reader._gen = _batch(reader._gen, batch_size)
        return reader
    return _batch(reader, batch_size)
