"""The sequence models and seq2seq decoding in the port against the JAX
package on the CPU.

- ``stacked_lstm`` and ``machine_translation`` (models/, copies) at two
  layers and narrow widths: both packages build the same Program, and 3
  Adam steps on the same numpy batches give losses to a relative 1e-5
  (tests/test_torch_training.py's tolerance for f32 training steps).
- test_contrib_decoder.py's copy task: the JAX package trains the
  ``TrainingDecoder`` program; the port trains it 3 steps alongside
  (losses to a relative 1e-5), then both decode the same weights with
  ``BeamSearchDecoder`` (beam 3) and the beam ids are equal, the scores
  within atol 1e-4 (log-probs summed over 6 steps).
- test_book.py's GRU encoder-decoder analog: ``dynamic_gru`` encoder,
  the decoder's ``gru_unit`` in a ``StateCell``, beam-decoded on trained
  weights; ids equal, scores within atol 1e-4.
- The MT encoder's Predictor: ``save_inference_model`` of the beam
  decoder, served on the CPU, equals the executor's run.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
from torch_parity import (assert_runs_close, build_both, jax_state,
                          port_scope, run_both)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _no_global_gradient_clip():
    """tests/test_grad_accum.py leaves the JAX package's process-global
    gradient clip set; this module runs with neither package's set."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jf.clip, "_global_clip", None)
        mp.setattr(pt.clip, "_global_clip", None)
        yield


def test_stacked_lstm_trains_like_the_jax_package():
    cfg = dict(vocab=60, emb_dim=16, hidden=16, num_layers=2, num_classes=2,
               seq_len=10)

    def build(pkg):
        from importlib import import_module

        m = import_module(pkg.__name__ + ".models.stacked_lstm")
        loss, feeds = m.build(cfg)
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        return [loss, feeds["acc"]]

    progs = build_both(build)
    assert progs["port"][0].to_dict() == progs["jax"][0].to_dict()
    rs = np.random.RandomState(0)
    feeds = [{"words": rs.randint(0, 60, (6, 10)).astype("int64"),
              "label": rs.randint(0, 2, (6, 1)).astype("int64"),
              "length": np.array([1, 10, 4, 7, 10, 2], "int64")}
             for _ in range(3)]
    jres, tres, _, _ = run_both(build, feeds, programs=progs)
    assert_runs_close(jres, tres, 0, rtol=1e-5)


def test_machine_translation_trains_like_the_jax_package():
    cfg = dict(src_vocab=50, trg_vocab=50, emb_dim=16, hidden=16, seq_len=8)

    def build(pkg):
        from importlib import import_module

        m = import_module(pkg.__name__ + ".models.machine_translation")
        loss, _ = m.build(cfg)
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        return [loss]

    progs = build_both(build)
    assert progs["port"][0].to_dict() == progs["jax"][0].to_dict()
    rs = np.random.RandomState(1)
    feeds = [{"src_ids": rs.randint(2, 50, (4, 8)).astype("int64"),
              "trg_ids": rs.randint(2, 50, (4, 8)).astype("int64"),
              "lbl_ids": rs.randint(2, 50, (4, 8)).astype("int64"),
              "src_len": np.array([1, 8, 5, 3], "int64"),
              "trg_len": np.array([8, 2, 6, 1], "int64")}] * 3
    jres, tres, _, _ = run_both(build, feeds, programs=progs)
    assert_runs_close(jres, tres, 0, rtol=1e-5)
    assert tres[2][0] < tres[0][0]


# ------------------------------------------------------------- copy task
V, T, D, H = 18, 5, 24, 48
BOS, EOS = 1, 0


def _copy_data(n=256):
    rng = np.random.RandomState(0)
    src = rng.randint(2, V, (n, T)).astype(np.int64)
    trg_in = np.concatenate([np.full((n, 1), BOS), src], 1).astype(np.int64)
    lbl = np.concatenate([src, np.full((n, 1), EOS)], 1).astype(np.int64)
    return src, trg_in, lbl


def _copy_encoder(pkg, src):
    L = pkg.layers
    emb = L.embedding(src, size=[V, D],
                      param_attr=pkg.ParamAttr(name="word_emb"))
    return L.fc(L.reshape(emb, [-1, T * D]), size=H, act="tanh",
                param_attr=pkg.ParamAttr(name="enc.w_0"),
                bias_attr=pkg.ParamAttr(name="enc.b_0"))


def _copy_cell(pkg, enc_last):
    from importlib import import_module

    dec = import_module(pkg.__name__ + ".contrib.decoder")
    L = pkg.layers
    cell = dec.StateCell(inputs={"x": None},
                         states={"h": dec.InitState(init=enc_last)},
                         out_state="h")

    @cell.state_updater
    def _update(c):
        xh = L.concat([c.get_input("x"), c.get_state("h")], axis=1)
        c.set_state("h", L.fc(xh, size=H, act="tanh",
                              param_attr=pkg.ParamAttr(name="dec_step.w_0"),
                              bias_attr=pkg.ParamAttr(name="dec_step.b_0")))

    return cell


def _copy_train(pkg):
    from importlib import import_module

    dec = import_module(pkg.__name__ + ".contrib.decoder")
    L = pkg.layers
    src = L.data("src", [T], dtype="int64")
    trg = L.data("trg", [T + 1], dtype="int64")
    lbl = L.data("lbl", [T + 1], dtype="int64")
    tlen = L.data("tlen", [], dtype="int64")
    temb = L.embedding(trg, size=[V, D],
                       param_attr=pkg.ParamAttr(name="word_emb"))
    cell = _copy_cell(pkg, _copy_encoder(pkg, src))
    decoder = dec.TrainingDecoder(cell)
    with decoder.block():
        w = decoder.step_input(temb, length=tlen)
        cell.compute_state(inputs={"x": w})
        score = L.fc(cell.get_state("h"), size=V, act="softmax",
                     param_attr=pkg.ParamAttr(name="score.w_0"),
                     bias_attr=pkg.ParamAttr(name="score.b_0"))
        cell.update_states()
        decoder.output(score)
    probs = decoder()
    loss = L.mean(L.cross_entropy(L.reshape(probs, [-1, V]),
                                  L.reshape(lbl, [-1, 1])))
    pkg.optimizer.Adam(0.02).minimize(loss)
    return [loss]


def _copy_decode(pkg, beam=3):
    from importlib import import_module

    dec = import_module(pkg.__name__ + ".contrib.decoder")
    L = pkg.layers
    src = L.data("src", [T], dtype="int64")
    init_ids = L.data("init_ids", [1], dtype="int64")
    init_scores = L.data("init_scores", [1], dtype="float32")
    cell = _copy_cell(pkg, _copy_encoder(pkg, src))
    bsd = dec.BeamSearchDecoder(
        cell, init_ids, init_scores, target_dict_dim=V, word_dim=D,
        max_len=T + 1, beam_size=beam, end_id=EOS,
        word_emb_param_name="word_emb", score_fc_param_name="score")
    bsd.decode()
    return list(bsd())


def _decode_feed(src):
    n = len(src)
    return {"src": src, "init_ids": np.full((n, 1), BOS, np.int64),
            "init_scores": np.zeros((n, 1), np.float32)}


def test_copy_task_trains_and_beam_decodes_like_the_jax_package():
    SRC, TRG, LBL = _copy_data()
    B = 64

    def batch(step):
        i = (step * B) % len(SRC)
        return {"src": SRC[i:i + B], "trg": TRG[i:i + B],
                "lbl": LBL[i:i + B], "tlen": np.full((B,), T + 1, np.int64)}

    # the first 3 steps in both packages from one init
    jres, tres, jscope, _ = run_both(_copy_train,
                                     [batch(s) for s in range(3)], seed=0)
    assert_runs_close(jres, tres, 0, rtol=1e-5)

    # the JAX package trains on; both decode its weights
    progs = build_both(_copy_train, seed=0)
    jmain = progs["jax"][0]
    jexe = jf.Executor(jf.CPUPlace())
    jexe.run(progs["jax"][1], scope=jscope)  # fresh weights, same seed
    for step in range(120):
        jexe.run(jmain, feed=batch(step), fetch_list=[progs["jax"][2][0]],
                 scope=jscope)
    dec = build_both(_copy_decode)
    (jd, _, jfetch), (td, _, tfetch) = dec["jax"], dec["port"]
    state = jax_state(jd, jscope)
    feed = _decode_feed(SRC[:32])
    jids, jsc = [np.asarray(v) for v in jexe.run(
        jd, feed=feed, fetch_list=[v.name for v in jfetch], scope=jscope)]
    tids, tsc = pt.Executor(pt.CPUPlace()).run(
        td, feed=feed, fetch_list=[v.name for v in tfetch],
        scope=port_scope(state, td))
    assert tids.shape == (32, 3, T + 1)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tsc, jsc, atol=1e-4, rtol=0)
    # trained far enough that the best beam copies most of the source
    assert (tids[:, 0, :T] == SRC[:32]).mean() > 0.5


# ------------------------------------------------- test_book.py MT analog
BV, BT, BD, BH = 20, 6, 16, 32


def _book_encoder(pkg, src, length):
    L = pkg.layers
    semb = L.embedding(src, size=[BV, BD],
                       param_attr=pkg.ParamAttr(name="src_emb"))
    sfc = L.fc(semb, size=BH * 3, num_flatten_dims=2,
               param_attr=pkg.ParamAttr(name="enc_fc.w"),
               bias_attr=pkg.ParamAttr(name="enc_fc.b"))
    enc = L.dynamic_gru(sfc, size=BH, seq_len=length,
                        param_attr=pkg.ParamAttr(name="enc_gru.w"),
                        bias_attr=pkg.ParamAttr(name="enc_gru.b"))
    return L.sequence_last_step(enc, length=length)


def _book_cell(pkg, enc_last):
    from importlib import import_module

    dec = import_module(pkg.__name__ + ".contrib.decoder")
    L = pkg.layers
    cell = dec.StateCell(inputs={"x": None},
                         states={"h": dec.InitState(init=enc_last)},
                         out_state="h")

    @cell.state_updater
    def _update(c):
        xp = L.fc(c.get_input("x"), size=BH * 3,
                  param_attr=pkg.ParamAttr(name="dec_in.w"),
                  bias_attr=pkg.ParamAttr(name="dec_in.b"))
        nh, _, _ = L.gru_unit(xp, c.get_state("h"), size=BH * 3,
                              param_attr=pkg.ParamAttr(name="dec_gru.w"),
                              bias_attr=pkg.ParamAttr(name="dec_gru.b"))
        c.set_state("h", nh)

    return cell


def _book_train(pkg):
    from importlib import import_module

    dec = import_module(pkg.__name__ + ".contrib.decoder")
    L = pkg.layers
    src = L.data("src", [BT], dtype="int64")
    trg = L.data("trg", [BT], dtype="int64")
    lbl = L.data("lbl", [BT], dtype="int64")
    length = L.data("length", [], dtype="int64")
    temb = L.embedding(trg, size=[BV, BD],
                       param_attr=pkg.ParamAttr(name="trg_emb"))
    cell = _book_cell(pkg, _book_encoder(pkg, src, length))
    decoder = dec.TrainingDecoder(cell)
    with decoder.block():
        w = decoder.step_input(temb, length=length)
        cell.compute_state(inputs={"x": w})
        score = L.fc(cell.get_state("h"), size=BV, act="softmax",
                     param_attr=pkg.ParamAttr(name="score.w_0"),
                     bias_attr=pkg.ParamAttr(name="score.b_0"))
        cell.update_states()
        decoder.output(score)
    loss = L.mean(L.cross_entropy(L.reshape(decoder(), [-1, BV]),
                                  L.reshape(lbl, [-1, 1])))
    pkg.optimizer.Adam(0.02).minimize(loss)
    return [loss]


def _book_decode(pkg):
    from importlib import import_module

    dec = import_module(pkg.__name__ + ".contrib.decoder")
    L = pkg.layers
    src = L.data("src", [BT], dtype="int64")
    length = L.data("length", [], dtype="int64")
    init_ids = L.data("init_ids", [1], dtype="int64")
    init_scores = L.data("init_scores", [1], dtype="float32")
    cell = _book_cell(pkg, _book_encoder(pkg, src, length))
    bsd = dec.BeamSearchDecoder(
        cell, init_ids, init_scores, target_dict_dim=BV, word_dim=BD,
        max_len=BT, beam_size=3, end_id=EOS, word_emb_param_name="trg_emb",
        score_fc_param_name="score")
    bsd.decode()
    return list(bsd())


def test_book_mt_gru_unit_beam_decode_matches_and_serves(tmp_path):
    rng = np.random.RandomState(0)
    n, B = 128, 32
    SRC = rng.randint(2, BV, (n, BT)).astype(np.int64)
    TRG = np.concatenate([np.full((n, 1), BOS), SRC[:, :-1]], 1)
    LEN = rng.randint(1, BT + 1, (n,)).astype(np.int64)
    progs = build_both(_book_train, seed=1)
    jmain, jstart, jfetch = progs["jax"]
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    for step in range(40):
        i = (step * B) % n
        jexe.run(jmain, feed={"src": SRC[i:i + B], "trg": TRG[i:i + B],
                              "lbl": SRC[i:i + B], "length": LEN[i:i + B]},
                 fetch_list=[jfetch[0].name], scope=jscope)
    dec = build_both(_book_decode)
    (jd, _, jf_), (td, _, tf_) = dec["jax"], dec["port"]
    tscope = port_scope(jax_state(jd, jscope), td)
    feed = dict(_decode_feed(SRC[:8]), length=LEN[:8])
    want = [np.asarray(v) for v in jexe.run(
        jd, feed=feed, fetch_list=[v.name for v in jf_], scope=jscope)]
    exe = pt.Executor(pt.CPUPlace())
    got = exe.run(td, feed=feed, fetch_list=[v.name for v in tf_],
                  scope=tscope)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0)

    # the same decoder through save_inference_model and the Predictor
    with pt.scope_guard(tscope):
        pt.io.save_inference_model(
            str(tmp_path), ["src", "length", "init_ids", "init_scores"],
            tf_, exe, main_program=td)
    cfg = pt.inference.AnalysisConfig(str(tmp_path)).disable_gpu()
    cfg.warmup_batch_sizes = [8]
    pred = pt.inference.create_paddle_predictor(cfg)
    served = pred.run(feed)
    np.testing.assert_array_equal(served[0], got[0])
    np.testing.assert_array_equal(served[1], got[1])
