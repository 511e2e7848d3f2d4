"""RecordIO convert helpers (reference: python/paddle/fluid/
recordio_writer.py wrapping core::RecordIOWriter).

Minimal self-contained record format (no snappy in this image):
  u32 magic 'PREC' | per record: u32 length | pickled sample bytes
convert_reader_to_recordio_file serializes a reader's samples (after
the DataFeeder, like the reference), and recordio_reader streams them
back — enough for file-backed reader pipelines and tests.
"""

from __future__ import annotations

import pickle
import struct

__all__ = ["convert_reader_to_recordio_file",
           "convert_reader_to_recordio_files", "recordio_reader"]

_MAGIC = b"PREC"


def convert_reader_to_recordio_file(filename, reader_creator, feeder=None,
                                    compressor=None, max_num_records=1000,
                                    feed_order=None):
    """Write every sample to one file; returns the record count."""
    n = 0
    with open(filename, "wb") as f:
        f.write(_MAGIC)
        for sample in reader_creator():
            if feeder is not None:
                sample = feeder.feed([sample])
            payload = pickle.dumps(sample, protocol=4)
            f.write(struct.pack("<I", len(payload)))
            f.write(payload)
            n += 1
    return n


def convert_reader_to_recordio_files(filename, batch_per_file,
                                     reader_creator, feeder=None,
                                     compressor=None, max_num_records=1000,
                                     feed_order=None):
    """Shard into numbered files of `batch_per_file` records each."""
    files = []
    buf = []

    def flush():
        if not buf:
            return
        path = "%s-%05d" % (filename, len(files))
        convert_reader_to_recordio_file(path, lambda: iter(buf), feeder=None)
        files.append(path)
        buf.clear()

    for sample in reader_creator():
        if feeder is not None:
            sample = feeder.feed([sample])
        buf.append(sample)
        if len(buf) >= batch_per_file:
            flush()
    flush()
    return files


def recordio_reader(filename):
    """Reader creator over a converted file (the read-side counterpart
    the reference gets from its open_recordio_file layer)."""

    def reader():
        with open(filename, "rb") as f:
            if f.read(4) != _MAGIC:
                raise ValueError("%s is not a PREC recordio file" % filename)
            while True:
                head = f.read(4)
                if len(head) < 4:
                    return
                (length,) = struct.unpack("<I", head)
                yield pickle.loads(f.read(length))

    return reader
