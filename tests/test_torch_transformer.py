"""The transformer (paddle_tpu_torch/models/transformer.py, a copy) in the
port against the JAX package: 5 Adam steps with label smoothing 0.1
(``one_hot`` + ``label_smooth`` into a soft-label loss) after a scope
transplant (``convert.params_from_jax``), dropout 0, the same numpy
batches with trailing padding in source and target. Losses agree to a
relative 1e-5 and params to atol 1e-4 (tests/test_torch_training.py's
tolerances). The fused build runs the flash kernels three ways per
layer: encoder self-attention, causal decoder self-attention and
cross-attention (the JAX side in interpret mode at every S, the port's
CPU tensors on the kernels' plain versions); the composed build runs
``matmul`` and ``softmax``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import transformer

CPU = torch.device("cpu")
CFG = dict(d_model=64, d_ff=128, n_head=4, n_layer=2, src_vocab=100,
           trg_vocab=90, max_length=32, dropout=0.0)
S, B, LR, STEPS = 32, 3, 1e-3, 5


def _build(pkg, mod, fused, eps):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 17
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, _ = mod.build(CFG, seq_len=S, label_smooth_eps=eps,
                            use_fused_attention=fused)
        pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
    return main, startup, loss


def _batches(seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        feed = {}
        for name, vocab in (("src_ids", CFG["src_vocab"]),
                            ("trg_ids", CFG["trg_vocab"]),
                            ("lbl_ids", CFG["trg_vocab"])):
            feed[name] = rs.randint(1, vocab, (B, S)).astype("int64")
        for i in range(B):
            src_pad, trg_pad = rs.randint(0, S // 4, 2)
            feed["src_ids"][i, S - src_pad:] = 0
            feed["trg_ids"][i, S - trg_pad:] = 0
            feed["lbl_ids"][i, S - trg_pad:] = 0
        out.append(feed)
    return out


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
@pytest.mark.parametrize("eps", [0.1, 0.0], ids=["smoothed", "hard"])
def test_transformer_trains_like_the_jax_package(fused, eps):
    jmain, jstart, jloss = _build(jf, jtr, fused, eps)
    tmain, tstart, tloss = _build(pt, transformer, fused, eps)
    assert tmain.to_dict() == jmain.to_dict()
    types = [op.type for op in tmain.global_block().ops]
    assert ("one_hot" in types) == ("label_smooth" in types) == bool(eps)
    assert types.count("fused_attention") == (3 * CFG["n_layer"] if fused
                                              else 0)
    feeds = _batches()

    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.list_vars() if v.persistable}
    want = [float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                      scope=jscope)[0]).reshape(()))
            for f in feeds]

    scope = pt.Scope()
    for n, v in params_from_jax(state, tmain, CPU).items():
        scope.set_var(n, v)
    exe = pt.Executor(pt.CPUPlace())
    got = [float(np.asarray(exe.run(tmain, feed=f, fetch_list=[tloss],
                                    scope=scope)[0]).reshape(()))
           for f in feeds]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] < got[0]
    for p in tmain.global_block().all_parameters():
        np.testing.assert_allclose(scope.find_var(p.name).numpy(),
                                   np.asarray(jscope.find_var(p.name)),
                                   atol=1e-4, rtol=0, err_msg=p.name)


def test_cross_attention_keeps_the_causal_shape_check():
    """``causal=True`` with Sq != Sk raises in both packages; the
    transformer's cross-attention runs non-causal at Sq = Sk."""
    from paddle_tpu_torch.ops.attention import flash_attention

    q = torch.zeros(1, 2, 8, 16)
    kv = torch.zeros(1, 2, 12, 16)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q, kv, kv, causal=True)
    out = flash_attention(q, kv, kv, causal=False)
    assert out.shape == (1, 2, 8, 16)
