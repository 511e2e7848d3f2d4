"""The port's data input path held against the JAX package on the CPU:
``DataFeeder``, ``lod_tensor``, ``recordio_writer``, ``data_feed_desc``,
the ``dataset`` surrogates, the native MultiSlot feed (the port's own
build of its own ``native/datafeed.cc``), ``ctr_reader`` and the
``layers.io`` readers (``PyReader`` over the executor's
``DevicePrefetcher``, ``double_buffer``, ``open_files`` and friends).

Every comparison is bitwise, on the same numpy inputs made from a seed.
The port's readers run with ``places=CPUPlace()`` here; they yield
tensors where the JAX package yields device arrays, and an int64 feed
arrives at its on-device dtype, int32, in both.
"""

import gzip
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu.dataset  # noqa: F401  (not imported by the package)
import paddle_tpu_torch as pt

CPU = pt.CPUPlace()


def _same(a, b, path="sample"):
    """``a`` (the JAX package's) and ``b`` (the port's) are equal bit for
    bit: the same nesting, types, dtypes and values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], "%s[%r]" % (path, k))
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, "%s[%d]" % (path, i))
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _feed_vars(pkg, specs):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        return [pkg.layers.data(n, s, dtype=d) for n, s, d in specs]


# ------------------------------------------------------------ DataFeeder
FEEDER_CASES = {
    "dense": ([("x", [3], "float32"), ("y", [1], "int64")],
              lambda rs: [(rs.rand(3).astype("float32"), [int(rs.randint(9))])
                          for _ in range(5)]),
    # ragged rows pad to the batch max per dim
    "ragged": ([("ids", [-1], "int64"), ("w", [2, -1], "float32")],
               lambda rs: [(rs.randint(0, 50, rs.randint(1, 6)),
                            rs.rand(2, rs.randint(1, 4)))
                           for _ in range(6)]),
    # scalar labels gain the trailing label dim
    "trailing_dim": ([("img", [4], "float32"), ("label", [1], "int64")],
                     lambda rs: [(rs.rand(4).astype("float32"),
                                  int(rs.randint(10))) for _ in range(7)]),
    "cast": ([("a", [2], "float32"), ("b", [1], "int32")],
             lambda rs: [(rs.rand(2), np.int64(rs.randint(5)))
                         for _ in range(3)]),
}


@pytest.mark.parametrize("case", sorted(FEEDER_CASES))
def test_data_feeder_feeds_what_the_jax_package_feeds(case):
    specs, rows = FEEDER_CASES[case]
    want = jf.DataFeeder(_feed_vars(jf, specs)).feed(
        rows(np.random.RandomState(3)))
    got = pt.DataFeeder(_feed_vars(pt, specs)).feed(
        rows(np.random.RandomState(3)))
    _same(want, got)
    if case == "trailing_dim":
        assert got["label"].shape == (7, 1)


# ------------------------------------------------------------ LoDTensor
def test_lod_tensors_match_the_jax_package():
    data = np.random.RandomState(0).rand(9, 2).astype("float32")
    for pkg_t in ((jf, pt),):
        a, b = (p.create_lod_tensor(data, [[4, 2, 3]]) for p in pkg_t)
    assert a.lod() == b.lod() == [[0, 4, 6, 9]]
    assert a.recursive_sequence_lengths() == b.recursive_sequence_lengths()
    _same(a.to_padded(pad_value=-1), b.to_padded(pad_value=-1))
    _same(np.asarray(a), np.asarray(b))
    nested = [[[1, 2], [3, 4]], [[5, 6]], [[7, 8], [9, 0], [1, 1]]]
    a, b = (p.create_lod_tensor(nested, []) for p in (jf, pt))
    _same(a.to_padded(), b.to_padded())
    assert b.recursive_sequence_lengths() == [[2, 1, 3]]
    two = [[2, 1], [1, 3, 2]]
    a, b = (p.create_lod_tensor(np.arange(6)[:, None], two) for p in (jf, pt))
    assert a.has_valid_recursive_sequence_lengths() and \
        b.has_valid_recursive_sequence_lengths()
    for p in (jf, pt):
        with pytest.raises(ValueError):
            p.create_lod_tensor(data, [[4, 4]])
    got = []
    for p in (jf, pt):
        np.random.seed(11)
        got.append(np.asarray(p.create_random_int_lodtensor(
            [[2, 3]], [1], low=0, high=9)))
    _same(*got)
    assert isinstance(pt.LoDTensorArray(), list)
    t = pt.Tensor()
    t.set(np.ones((2, 3)))
    assert t.shape() == (2, 3)


def test_an_executor_takes_a_lod_tensor_feed():
    """The executor's feed path reads a LoDTensor through np.asarray
    (``host_tensor``), as the JAX package's does."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [2])
        y = pt.layers.scale(x, scale=2.0)
    t = pt.create_lod_tensor(np.arange(6, dtype="float32").reshape(3, 2),
                             [[1, 2]])
    (out,) = pt.Executor(CPU).run(main, feed={"x": t}, fetch_list=[y],
                                  scope=pt.Scope())
    np.testing.assert_array_equal(out, 2 * np.asarray(t))


# ------------------------------------------------------------- recordio
def test_recordio_files_cross_between_the_packages(tmp_path):
    def reader():
        rs = np.random.RandomState(2)
        for i in range(12):
            yield (rs.rand(3).astype("float32"), i)

    a, b = str(tmp_path / "a.rec"), str(tmp_path / "b.rec")
    assert jf.recordio_writer.convert_reader_to_recordio_file(a, reader) \
        == pt.recordio_writer.convert_reader_to_recordio_file(b, reader) == 12
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    _same(list(jf.recordio_writer.recordio_reader(b)()),
          list(pt.recordio_writer.recordio_reader(a)()))
    files = pt.recordio_writer.convert_reader_to_recordio_files(
        str(tmp_path / "s"), 5, reader)
    assert len(files) == 3
    # layers.open_files chains them, pass after pass
    back = list(pt.layers.open_files(files, pass_num=2)())
    _same(list(reader()) * 2, back)


# ------------------------------------------------------- data_feed_desc
PROTO = """name: "MultiSlotDataFeed"
batch_size: 2
multi_slot_desc {
    slots {
        name: "words"
        type: "uint64"
        is_dense: false
        is_used: true
        dim: 3
    }
    slots {
        name: "dense"  # a comment
        type: "float"
        is_dense: true
        is_used: false
        dim: 2
    }
    slots { name: "label" type: "uint64" is_dense: false is_used: true }
}
"""


def _desc_state(d):
    return (d.name, d.batch_size, [(s.name, s.type, s.is_dense, s.is_used,
                                    s.dim) for s in d.slots])


def test_data_feed_desc_parses_and_prints_as_the_jax_package(tmp_path):
    path = tmp_path / "data.proto"
    path.write_text(PROTO)
    a, b = jf.DataFeedDesc(str(path)), pt.DataFeedDesc(str(path))
    assert _desc_state(a) == _desc_state(b)
    for d in (a, b):
        d.set_batch_size(7)
        d.set_use_slots(["words", "dense"])
        d.set_dense_slots(["dense"])
    assert a.desc() == b.desc()
    # both ways: each package parses the other's printed desc
    pa, pb = tmp_path / "a.proto", tmp_path / "b.proto"
    pa.write_text(a.desc())
    pb.write_text(b.desc())
    assert _desc_state(pt.DataFeedDesc(str(pa))) == \
        _desc_state(jf.DataFeedDesc(str(pb))) == _desc_state(a)
    assert [(s.name, s.dtype, s.width) for s in a.slot_descs] == \
        [(s.name, s.dtype, s.width) for s in b.slot_descs]
    with pytest.raises(ValueError, match="unknown"):
        b.set_use_slots(["nope"])
    b.set_use_slots([])
    with pytest.raises(ValueError, match="no used slots"):
        b.slot_descs


# --------------------------------------------------------------- dataset
def _common_split(pkg, tmp):
    reader = pkg.dataset.mnist.train(n=10)
    paths = pkg.dataset.common.split(
        reader, 4, suffix=os.path.join(tmp, pkg.__name__ + "-%05d.pickle"))
    back = list(pkg.dataset.common.cluster_files_reader(
        os.path.join(tmp, pkg.__name__ + "-*.pickle"), 2, 1)())
    return [len(paths), back]


def _image(pkg, tmp):
    rs = np.random.RandomState(4)
    im = (rs.rand(40, 30, 3) * 255).astype("uint8")
    img = pkg.dataset.image
    return [img.simple_transform(im, 32, 24, True,
                                 rng=np.random.RandomState(1)),
            img.simple_transform(im, 32, 24, False),
            img.left_right_flip(im), img.to_chw(img.resize_short(im, 20))]


def _first(reader, n):
    out = []
    for i, s in enumerate(reader()):
        if i == n:
            break
        out.append(s)
    return out


DATASETS = {
    "cifar": lambda pkg, tmp: _first(pkg.dataset.cifar.train10(n=6), 6)
    + _first(pkg.dataset.cifar.test100(n=3), 3),
    "common": _common_split,
    "conll05": lambda pkg, tmp: _first(pkg.dataset.conll05.test(), 4)
    + [len(pkg.dataset.conll05.get_dict()[0])],
    "flowers": lambda pkg, tmp: _first(
        pkg.dataset.flowers.train(use_xmap=False), 3),
    "image": _image,
    "imdb": lambda pkg, tmp: _first(pkg.dataset.imdb.train(n=5), 5)
    + [len(pkg.dataset.imdb.word_dict())],
    "imikolov": lambda pkg, tmp: _first(pkg.dataset.imikolov.train(
        pkg.dataset.imikolov.build_dict(), 5), 6),
    "mnist": lambda pkg, tmp: _first(pkg.dataset.mnist.train(n=8), 8)
    + _first(pkg.dataset.mnist.test(n=4), 4),
    "movielens": lambda pkg, tmp: _first(pkg.dataset.movielens.train(), 5)
    + [pkg.dataset.movielens.max_user_id()],
    "mq2007": lambda pkg, tmp: _first(pkg.dataset.mq2007.train(), 4)
    + _first(pkg.dataset.mq2007.test(format="listwise"), 2),
    "sentiment": lambda pkg, tmp: _first(pkg.dataset.sentiment.train(), 4),
    "uci_housing": lambda pkg, tmp: _first(pkg.dataset.uci_housing.train(),
                                           6),
    "voc2012": lambda pkg, tmp: _first(pkg.dataset.voc2012.train(), 2),
    "wmt14": lambda pkg, tmp: _first(pkg.dataset.wmt14.train(100), 4),
    "wmt16": lambda pkg, tmp: _first(pkg.dataset.wmt16.train(100, 120), 4),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_surrogate_matches_the_jax_package(name, tmp_path,
                                                   monkeypatch):
    # no real corpus: both packages read their synthetic surrogates
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path / "none"))
    _same(DATASETS[name](jf, str(tmp_path)), DATASETS[name](pt, str(tmp_path)))


def test_dataset_download_refuses_the_network(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="no network"):
        pt.dataset.common.download("http://example.invalid/x.tgz", "m", "")
    src = tmp_path / "src.bin"
    src.write_bytes(b"abc")
    got = pt.dataset.common.download("file://" + str(src), "m", "")
    assert open(got, "rb").read() == b"abc"
    assert pt.dataset.common.data_home() == str(tmp_path)


# -------------------------------------------------- native MultiSlot feed
def _slot_files(tmp_path, n_files, lines, seed):
    rs = np.random.RandomState(seed)
    files = []
    for i in range(n_files):
        p = str(tmp_path / ("part-%d.txt" % i))
        with open(p, "w") as f:
            for _ in range(lines):
                k = rs.randint(1, 5)
                ids = rs.randint(0, 1000, size=k)
                dense = rs.rand(2)
                f.write("%d %s 2 %s 1 %d\n" % (
                    k, " ".join(map(str, ids)),
                    " ".join("%.5f" % x for x in dense), rs.randint(2)))
        files.append(p)
    return files


def test_multislot_feed_is_the_jax_package_batch_for_batch(tmp_path):
    from paddle_tpu.native import data_feed as jdf
    from paddle_tpu_torch.native import data_feed as tdf

    files = _slot_files(tmp_path, 3, 37, 0)
    got = []
    for mod in (jdf, tdf):
        slots = [mod.SlotDesc("ids", "int64", 3),
                 mod.SlotDesc("dense", "float32", 2),
                 mod.SlotDesc("label", "int64", 1)]
        feed = mod.MultiSlotDataFeed(files, slots, batch_size=8, n_threads=1,
                                     epochs=2)
        got.append(list(feed.feed_dict()))
        feed.close()
    _same(*got)
    assert sum(b["ids"].shape[0] for b in got[1]) == 2 * 3 * 37


def test_multislot_feed_threads_deliver_every_line_once(tmp_path):
    from paddle_tpu_torch.native.data_feed import MultiSlotDataFeed, SlotDesc

    files = _slot_files(tmp_path, 4, 32, 1)
    slots = [SlotDesc("ids", "int64", 4), SlotDesc("dense", "float32", 2),
             SlotDesc("label", "int64", 1)]

    def rows(n_threads):
        feed = MultiSlotDataFeed(files, slots, batch_size=8,
                                 n_threads=n_threads)
        out = sorted(b"".join(a[r].tobytes() for a in b)
                     for b in feed for r in range(len(b[0])))
        feed.close()
        return out

    one = rows(1)
    assert len(one) == 128 and rows(4) == one


def test_native_feed_builds_from_the_ports_source(tmp_path):
    """The port's feed is compiled from paddle_tpu_torch/native/datafeed.cc
    into paddle_tpu_torch/_build/ and exports its C API; the JAX
    package's library is never loaded."""
    from paddle_tpu_torch import native

    lib = native.load("datafeed")
    path = native.lib_path("datafeed")
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("paddle_tpu_torch",
                                                   "_build"))
    assert lib._name == path and os.path.exists(path)
    assert lib.mdf_create and lib.mdf_next_batch


def test_failed_native_build_raises_with_the_compiler_output(tmp_path,
                                                             monkeypatch):
    from paddle_tpu_torch import native

    src = tmp_path / "broken.cc"
    src.write_text("int f( {\n")
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="broken.cc failed"):
        native.load("broken")
    monkeypatch.setattr(native, "_compiler", lambda: str(tmp_path / "cc"))
    (tmp_path / "ok.cc").write_text("int f() { return 1; }\n")
    with pytest.raises((RuntimeError, OSError)):
        native.load("ok")


# ------------------------------------------------------------ ctr_reader
def _batches_np(batches):
    return [{k: np.asarray(v) for k, v in b.items()} for b in batches]


def test_ctr_reader_csv_matches_the_jax_package(tmp_path):
    path = tmp_path / "a.txt"
    rs = np.random.RandomState(5)
    with open(path, "w") as f:
        for i in range(11):
            f.write("%d %0.2f,%0.2f %d,%d\n" % (
                i % 2, rs.rand(), rs.rand(), rs.randint(9), rs.randint(9)))
    got = []
    for pkg, kw in ((jf, {}), (pt, {"places": CPU})):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            feeds = [pkg.layers.data("label", [1], dtype="int64"),
                     pkg.layers.data("dense", [2]),
                     pkg.layers.data("sp", [2], dtype="int64")]
            r = pkg.contrib.ctr_reader.ctr_reader(
                feeds, "plain", "csv", [1], [2], 8, 2, 4, [str(path)], [],
                **kw)
        got.append(_batches_np(r()))
    _same(*got)
    assert len(got[1]) == 3 and got[1][2]["label"].shape == (3, 1)


def test_ctr_reader_svm_gzip_matches_the_jax_package(tmp_path):
    path = tmp_path / "b.txt.gz"
    rs = np.random.RandomState(6)
    with gzip.open(path, "wt") as f:
        for i in range(7):
            signs = " ".join("7:%d" % s for s in rs.randint(0, 50, i % 3 + 1))
            f.write("%d 3:%d %s\n" % (i % 2, rs.randint(50), signs))
    got = []
    for pkg, kw in ((jf, {}), (pt, {"places": CPU})):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            feeds = [pkg.layers.data("l2", [1], dtype="int64"),
                     pkg.layers.data("s3", [1], dtype="int64"),
                     pkg.layers.data("s7", [3], dtype="int64")]
            r = pkg.contrib.ctr_reader.ctr_reader(
                feeds, "gzip", "svm", [], [], 8, 2, 3, [str(path)], [3, 7],
                **kw)
        got.append(_batches_np(r()))
    _same(*got)
    with pytest.raises(ValueError, match="file_type"):
        pt.contrib.ctr_reader.ctr_reader([], "tar", "csv", [], [], 8, 1, 4,
                                         [], [])


# -------------------------------------------------------------- PyReader
def _mnist_reader_pair(batch=16, n=80):
    out = []
    for pkg in (jf, pt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            img = pkg.layers.data("img", [784])
            label = pkg.layers.data("label", [1], dtype="int64")
        r = pkg.layers.PyReader(feed_list=[img, label], capacity=4)
        kw = {"places": CPU} if pkg is pt else {}
        r.decorate_sample_list_generator(
            pkg.batch(pkg.dataset.mnist.train(n=n), batch), **kw)
        out.append(r)
    return out


def test_pyreader_feeds_what_the_jax_package_feeds():
    jr, tr = _mnist_reader_pair()
    want, got = list(jr()), list(tr())
    assert len(want) == len(got) == 5
    for a, b in zip(want, got):
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in b.values())
        assert b["label"].dtype == torch.int32 and \
            b["img"].dtype == torch.float32
        _same({k: np.asarray(v) for k, v in a.items()},
              {k: v.numpy() for k, v in b.items()})


def test_pyreader_feeds_are_the_data_feeders():
    """The reader changes where and when bytes move, not the bytes: its
    CPU feeds are the DataFeeder's numpy dicts, int64 narrowed."""
    _, tr = _mnist_reader_pair(batch=10, n=30)
    feeder = pt.DataFeeder(tr.feed_list)
    for feed, samples in zip(tr(), pt.batch(pt.dataset.mnist.train(n=30),
                                            10)()):
        want = feeder.feed(samples)
        np.testing.assert_array_equal(feed["img"].numpy(), want["img"])
        np.testing.assert_array_equal(feed["label"].numpy(),
                                      want["label"].astype(np.int32))


def test_pyreader_early_exit_retires_producer():
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        x = pt.layers.data("x", [1])
    before = threading.active_count()
    for _ in range(3):
        reader = pt.layers.PyReader(feed_list=[x], capacity=2)
        reader.decorate_batch_generator(
            lambda: ((np.zeros((1, 1), "float32"),) for _ in range(100)),
            places=CPU)
        for _feed in reader():
            break  # abandon with a full queue
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before + 1  # producers retired


def test_pyreader_reraises_a_producer_error():
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        x = pt.layers.data("x", [2])

    def gen():
        for i in range(3):
            if i == 2:
                raise ValueError("reader died at batch 2")
            yield (np.full((2, 2), i, "float32"),)

    for double in (True, False):
        reader = pt.layers.PyReader(feed_list=[x], capacity=2,
                                    use_double_buffer=double)
        reader.decorate_batch_generator(gen, places=CPU)
        seen = []
        with pytest.raises(ValueError, match="batch 2"):
            for feed in reader():
                seen.append(float(np.asarray(feed["x"])[0, 0]))
        assert seen == [0.0, 1.0]


def test_pyreader_without_double_buffer_yields_host_arrays():
    _, tr = _mnist_reader_pair(batch=8, n=16)
    tr.use_double_buffer = False
    feeds = list(tr())
    assert len(feeds) == 2 and isinstance(feeds[0]["img"], np.ndarray)
    assert feeds[0]["label"].dtype == np.int64


def test_pyreader_windows_match_the_jax_package():
    jr, tr = _mnist_reader_pair(batch=16, n=72)  # 4 full batches + 8
    want, got = list(jr.windows(3)), list(tr.windows(3))
    assert [s for _, s in want] == [s for _, s in got] == [3, 1, 1]
    for (a, _), (b, _) in zip(want, got):
        _same({k: np.asarray(v) for k, v in a.items()},
              {k: v.numpy() for k, v in b.items()})
    with pytest.raises(ValueError):
        next(tr.windows(0))


def test_pyreader_windows_drive_run_repeated():
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4])
        loss = pt.layers.mean(pt.layers.fc(x, 2))
        pt.optimizer.SGD(0.1).minimize(loss)
    exe, scope = pt.Executor(CPU), pt.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(0)
    batches = [(rs.rand(3, 4).astype("float32"),) for _ in range(5)]
    reader = pt.layers.PyReader(feed_list=[x], capacity=3)
    reader.decorate_batch_generator(lambda: iter(batches), places=CPU)
    steps = []
    for window, k in reader.windows(2):
        exe.run_repeated(main, feed=window, fetch_list=[loss], steps=k,
                         feed_stacked=True, scope=scope)
        steps.append(k)
    assert steps == [2, 2, 1]
    ref = pt.Scope()
    exe.run(startup, scope=ref)
    for (b,) in batches:
        exe.run(main, feed={"x": b}, fetch_list=[loss], scope=ref)
    w = main.global_block().all_parameters()[0].name
    assert torch.equal(scope.find_var(w), ref.find_var(w))


def test_pyreader_needs_a_generator_and_one_place():
    r = pt.layers.PyReader(feed_list=[], capacity=2)
    with pytest.raises(RuntimeError, match="decorate"):
        next(iter(r()))
    with pytest.raises(NotImplementedError, match="one device"):
        r.decorate_batch_generator(lambda: iter([]),
                                   places=[CPU, pt.CUDAPlace(0)])
    r.decorate_batch_generator(lambda: iter([]), places=[CPU])
    assert list(r()) == []


def test_double_buffer_keeps_each_batch_kind():
    batches = [(np.ones((2, 2), "float32"), np.arange(3)),
               {"a": np.zeros(2, "float32")}, np.ones(3, "float32"),
               [np.full(2, 5.0, "float32")]]
    got = list(pt.layers.double_buffer(lambda: iter(batches), place=CPU)())
    assert [type(g) for g in got] == [tuple, dict, torch.Tensor, list]
    np.testing.assert_array_equal(got[0][0].numpy(), batches[0][0])
    # int64 arrives at its on-device dtype
    assert got[0][1].dtype == torch.int32
    np.testing.assert_array_equal(got[3][0].numpy(), batches[3][0])


def test_reader_layers_match_the_jax_package(tmp_path):
    for pkg in (jf, pt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            x = pkg.layers.data("x", [2])
            y = pkg.layers.data("y", [1])
            r = pkg.layers.create_py_reader_by_data(4, [x, y])
            assert pkg.layers.read_file(r) == [x, y]
            p = pkg.layers.Preprocessor(r)
            with p.block():
                a, b = p.inputs()
                p.outputs(pkg.layers.scale(a, 2.0), b)
            assert [v.name for v in pkg.layers.read_file(p)] == \
                main.global_block().ops[-1].output("Out") + ["y"]
        legacy = pkg.layers.py_reader(8, [[-1, 2]], ["float32"])
        assert legacy.capacity == 8 and legacy.shapes == [[-1, 2]]
    np.random.seed(1)
    a = next(jf.layers.random_data_generator(0, 1, [(2, 3)])())
    np.random.seed(1)
    b = next(pt.layers.random_data_generator(0, 1, [(2, 3)])())
    _same(a, b)
    src = lambda: iter(range(10))  # noqa: E731
    assert list(pt.layers.batch(src, 4)()) == list(jf.layers.batch(src, 4)())
    assert sorted(pt.layers.shuffle(src, 3)()) == list(range(10))


def test_layers_load_fills_the_scope_on_the_values_device(tmp_path):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [3])
        pt.layers.fc(x, 2, param_attr=pt.ParamAttr(name="w_load"))
    exe, scope = pt.Executor(CPU), pt.Scope()
    exe.run(startup, scope=scope)
    with pt.scope_guard(scope):
        pt.io.save_params(exe, str(tmp_path), main_program=main,
                          filename="params")
        saved = scope.find_var("w_load").clone()
        scope.set_var("w_load", torch.zeros(3, 2))
        w = main.global_block().var("w_load")
        pt.layers.load(w, str(tmp_path / "params"))
        assert torch.equal(scope.find_var("w_load"), saved)
        pt.layers.load(w, str(tmp_path / "params"), load_as_fp16=True)
        assert scope.find_var("w_load").dtype == torch.float16
        with pytest.raises(RuntimeError, match="lacks"):
            pt.layers.load(x, str(tmp_path / "params"))
