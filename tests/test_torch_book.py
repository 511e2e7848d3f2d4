"""The Fluid book's seven end-to-end trainings (tests/test_book.py) in
the port, held against the JAX package on the CPU.

Each book program (tools/book_programs.py, built alike by both
packages' layers) takes its first 3 training steps in both packages
from the JAX startup's scope (``torch_parity.run_both``): every fetch
agrees within atol 1e-5 plus rtol 1e-5 (f32 sums, convolutions and the
recurrences' loops in another order; fit_a_line's SGD and the rest's
Adam amplify no difference in 3 steps), integers exactly. Then the port
alone, from its own startup (random_seed 5), takes the book's whole
training from its own startup (the programs' default seed, as the
book builds them) and meets the book's end assertion. fit_a_line's
assertion is the JAX package's standing miss (tests/test_book.py
quarantines it: 60 SGD steps converge about 2.6x from its startup, the
assertion wants 5x), and the port's startup misses it too (3.3x): its
whole 60 steps run at parity from the JAX startup instead, and the
port's ratio is the JAX package's.

The label_semantic_roles chapter's ``db_lstm`` runs at small widths
(hidden 16, depth 3) for 3 steps at the same tolerance, as do the
other chapters' networks (``book_programs.chapter``). The books read
their data from the port's dataset surrogates, which
tests/test_torch_data.py holds bitwise to the JAX package's.
"""

import os
import sys

import numpy as np
import pytest

import paddle_tpu as jf
import paddle_tpu_torch as pt

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import book_programs as bp  # noqa: E402
from torch_parity import assert_runs_close, run_both  # noqa: E402


# the two books whose whole trainings take the longest on the CPU
# (machine translation's 160 steps, CIFAR's 32 convolutional steps at
# batch 64): their 3 steps at parity run in the fast tier
# (test_long_book_trains_at_parity), their whole trainings in the slow
# one; chip_smoke.py phase 17 trains both to their assertions on the card
LONG_BOOKS = ("machine_translation_seq2seq_with_beam_decode",
              "image_classification_cifar_conv_bn")


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n in LONG_BOOKS else n
    for n in bp.BOOK])
def test_book_trains_at_parity_then_meets_its_assertion(name):
    book = _book(name)
    if book.reference_fault:
        # the JAX package misses this book's assertion from its own
        # startup (tests/test_book.py quarantines it): the whole training
        # at parity, so the port reproduces the reference's outcome
        jres, tres, _, _ = run_both(lambda pkg: bp.build(pkg, name).fetch,
                                    book.feeds)
        assert_runs_close(jres, tres, atol=1e-5, rtol=1e-5)
        want, got = (book.check(r, [])[0] for r in (jres, tres))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert got < 1.0  # the loss falls
        return
    jres, tres, _, _ = run_both(lambda pkg: bp.build(pkg, name).fetch,
                                book.feeds[:3])
    assert_runs_close(jres, tres, atol=1e-5, rtol=1e-5)
    book, steps, final, (value, bar, ok) = bp.run_book(pt, name,
                                                       pt.CPUPlace())
    assert len(steps) == len(book.feeds)
    assert ok, (name, value, bar)


@pytest.mark.parametrize("name", LONG_BOOKS)
def test_long_book_trains_at_parity(name):
    """A long book's first 3 steps at parity with the JAX package (its
    whole training is in the slow tier)."""
    jres, tres, _, _ = run_both(lambda pkg: bp.build(pkg, name).fetch,
                                _book(name).feeds[:3])
    assert_runs_close(jres, tres, atol=1e-5, rtol=1e-5)


def _book(name):
    """The book's feeds and check (built with the port's layers in a
    throwaway program: the data do not depend on the package)."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        return bp.build(pt, name)


def test_srl_db_lstm_small_trains_at_parity():
    cfg = dict(bp.SRL, hidden_dim=16, depth=3, batch=4)
    feeds = bp.srl_batches(cfg, n=3)

    def build(pkg):
        _, loss, decode = bp.srl_db_lstm(pkg, cfg)
        return [loss, decode]

    jres, tres, _, _ = run_both(build, feeds)
    assert_runs_close(jres, tres, atol=1e-5, rtol=1e-5)
    assert tres[0][1].shape == (4, cfg["max_len"])


# each chapter's network at small widths (chip_smoke.py trains them at
# the chapters' widths, CHAPTER)
CHAPTER_SMALL = {
    "fit_a_line": dict(bp.CHAPTER["fit_a_line"], n=3),
    "understand_sentiment_lstm": dict(
        bp.CHAPTER["understand_sentiment_lstm"], emb=8, hid=16, batch=4,
        max_len=7, n=3),
    "word2vec": dict(bp.CHAPTER["word2vec"], vocab=40, embed=8, hidden=16,
                     batch=8, n=3),
    "machine_translation_seq2seq_with_beam_decode": dict(
        bp.CHAPTER["machine_translation_seq2seq_with_beam_decode"],
        vocab=30, word=8, hidden=8, batch=4, max_len=5, n=3),
    "image_classification_cifar_conv_bn": dict(
        bp.CHAPTER["image_classification_cifar_conv_bn"], depth=8, batch=4,
        n=3),
    "recommender_system": dict(bp.CHAPTER["recommender_system"], fc=16,
                               batch=8, n=3),
}


@pytest.mark.parametrize("name", list(bp.CHAPTER))
def test_chapter_small_trains_at_parity(name):
    """A chapter's network at small widths: 3 steps in both packages from
    the JAX startup, every loss within atol 1e-5 plus rtol 1e-5."""
    cfg = CHAPTER_SMALL[name]
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        feeds, _, _ = bp.chapter(pt, name, cfg)
    assert len(feeds) == 3
    jres, tres, _, _ = run_both(lambda pkg: [bp.chapter(pkg, name, cfg)[1]],
                                feeds)
    assert_runs_close(jres, tres, atol=1e-5, rtol=1e-5)


def test_book_programs_build_alike_in_both_packages():
    """The seven programs, db_lstm and the chapters at their widths:
    the same ops and vars."""
    def program(pkg, fn):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            fn(pkg)
        return main.to_dict(), startup.to_dict()

    for name in bp.BOOK:
        assert program(jf, lambda p: bp.build(p, name)) == program(
            pt, lambda p: bp.build(p, name)), name
    assert program(jf, bp.srl_db_lstm) == program(pt, bp.srl_db_lstm)
    for name in bp.CHAPTER:
        assert program(jf, lambda p: bp.chapter(p, name)) == program(
            pt, lambda p: bp.chapter(p, name)), name
