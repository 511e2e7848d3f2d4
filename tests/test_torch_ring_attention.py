"""The port's ring attention (paddle_tpu_torch/parallel/ring_attention.py)
against the JAX package on the CPU.

The standalone ring runs on 8 positions (lists of sequence blocks) and
is held to the JAX package's dense ``_attention_reference`` forward and
gradients (q, k, v, and the bias on the plain path), and once to the
JAX package's own ring under ``shard_map`` on its 8 devices: plain,
flash (the wrapper's plain version on CPU tensors), contiguous and
zigzag, with a travelling pad bias and packed segment ids, atol 1e-4
forward and 3e-4 for grads (tests/test_ring_attention.py's bounds).
Then ``fused_attention`` under a (data 2, seq 4) mesh: the packed GPT
(segment ids on the zigzag ring) against the JAX package's single-device
run, which its own engine matches on that mesh
(tests/test_parallel_engine.py), within that file's bounds (3e-4 /
3e-5); tests/test_torch_parallel.py runs the transformer so.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP
import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.ops.attention import _attention_reference, causal_bias_block
from paddle_tpu.parallel.ring_attention import ring_attention as jax_ring
from paddle_tpu_torch.parallel import ParallelEngine, ShardingRules
from paddle_tpu_torch.parallel.engine import make_mesh
from paddle_tpu_torch.parallel.mesh import P
from paddle_tpu_torch.parallel.ring_attention import (_zigzag_permutes,
                                                     ring_attention)

from torch_parity import jax_state, port_scope

N = 8
FWD_TOL, GRAD_TOL = 1e-4, 3e-4


def _inputs(seed, B=2, H=2, S=64, D=8, pad=None, seg=False):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, H, S, D).astype("float32") for _ in range(3))
    bias = None
    if pad:
        bias = np.zeros((B, 1, 1, S), "float32")
        bias[..., S - S // pad:] = -1e9
    ids = None
    if seg:
        ids = np.zeros((B, S), "int64")
        ids[0, :10], ids[0, 10:25] = 1, 2
        ids[1, :16], ids[1, 16:30] = 1, 2
    return q, k, v, bias, ids


def _dense_bias(S, bias, ids, causal):
    """The JAX package's dense additive mask for the same case."""
    b = None if bias is None else jnp.asarray(bias)
    if ids is not None:
        keep = (ids[:, :, None] == ids[:, None, :]) & (ids[:, None, :] > 0)
        sm = jnp.asarray(np.where(keep, 0.0, -1e9).astype("float32"))[:, None]
        b = sm if b is None else b + sm
    if causal:
        b = causal_bias_block(S) if b is None else b + causal_bias_block(S)
    return b


def _port_ring(q, k, v, bias, ids, causal, use_flash, schedule="auto"):
    split = lambda x, d: list(torch.chunk(x, N, dim=d))  # noqa: E731
    out = ring_attention(
        split(q, 2), split(k, 2), split(v, 2), q.shape[-1] ** -0.5,
        causal=causal, use_flash=use_flash, schedule=schedule,
        kv_bias=None if bias is None else split(bias, 3),
        seg=None if ids is None else split(ids, 1))
    return torch.cat(out, dim=2)


def _real(ids, shape):
    """Rows of real tokens (padding rows are masked garbage both ways)."""
    if ids is None:
        return np.ones(shape, "float32")
    return np.broadcast_to((ids > 0)[:, None, :, None], shape).astype(
        "float32")


CASES = {
    # name: (causal, pad, seg, schedule)
    "full": (False, 4, False, "auto"),
    "causal_zigzag": (True, 8, False, "auto"),
    "causal_contiguous": (True, None, False, "contiguous"),
    "seg": (False, None, True, "auto"),
    "seg_causal_zigzag": (True, None, True, "auto"),
}


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_matches_the_dense_reference(case, use_flash):
    causal, pad, seg, schedule = CASES[case]
    q, k, v, bias, ids = _inputs(7, pad=pad, seg=seg)
    S, scale = q.shape[2], q.shape[-1] ** -0.5
    real = _real(ids, q.shape)
    dense = _dense_bias(S, bias, ids, causal)

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tb = None if bias is None else torch.tensor(bias, requires_grad=True)
    out = _port_ring(tq, tk, tv, tb, None if ids is None
                     else torch.tensor(ids), causal, use_flash, schedule)
    ref = _attention_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), dense, scale)
    np.testing.assert_allclose(out.detach().numpy() * real,
                               np.asarray(ref) * real, atol=FWD_TOL)

    # grads of sum((out * real)^2): q, k, v; and the pad bias' on the
    # plain path (the flash path's bias is a constant mask, as there)
    (out * torch.tensor(real)).pow(2).sum().backward()
    mask = jnp.asarray(real)

    def loss(a, b, c, bb):
        full = dense if bb is None else _dense_bias(S, None, ids, causal)
        if bb is not None:
            full = bb if full is None else full + bb
        return jnp.sum((_attention_reference(a, b, c, full, scale)
                        * mask) ** 2)

    argnums = (0, 1, 2) if tb is None or use_flash else (0, 1, 2, 3)
    grads = jax.grad(loss, argnums)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias))
    got = [tq.grad, tk.grad, tv.grad] + ([tb.grad] if len(argnums) == 4
                                         else [])
    for g, r in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


def test_ring_matches_the_jax_ring_on_eight_devices():
    """The plain zigzag ring with a pad bias and segment ids, against the
    JAX package's ring under ``shard_map`` on its 8 CPU devices."""
    q, k, v, bias, ids = _inputs(5, S=32, pad=8, seg=True)
    scale = q.shape[-1] ** -0.5
    mesh = JaxMesh(np.array(jax.devices()), ("sp",))
    seq = JP(None, None, "sp", None)
    fn = jax.shard_map(
        lambda a, b, c, bb, ss: jax_ring(a, b, c, scale, "sp", causal=True,
                                         kv_bias=bb, seg=ss),
        mesh=mesh, in_specs=(seq,) * 3 + (JP(None, None, None, "sp"),
                                          JP(None, "sp")),
        out_specs=seq, check_vma=False)
    want = np.asarray(jax.jit(fn)(*map(jnp.asarray, (q, k, v, bias, ids))))
    got = _port_ring(*map(torch.tensor, (q, k, v, bias, ids)), causal=True,
                     use_flash=False).numpy()
    real = _real(ids, q.shape)
    np.testing.assert_allclose(got * real, want * real, atol=FWD_TOL)


def test_schedules_and_launches_per_ring(monkeypatch):
    """Each ring step's pairs go to the flash wrapper in one call: n
    calls for a contiguous ring (the causal one skips the later key
    blocks), n + 1 for the zigzag ring (its first step's diagonal pairs
    are causal, its full pair is not); an odd block length falls back to
    the contiguous schedule, and ``schedule='zigzag'`` refuses it and a
    non-causal ring."""
    from paddle_tpu_torch.ops import attention as attn

    calls = []
    real = attn.flash_attention_with_lse

    def counted(q, k, v, bias=None, scale=1.0, causal=False):
        calls.append((q.shape[0], causal))
        return real(q, k, v, bias, scale, causal)

    monkeypatch.setattr(attn, "flash_attention_with_lse", counted)
    q, k, v, _, _ = (torch.tensor(a) if a is not None else None
                     for a in _inputs(1, B=1, S=32))
    for causal, schedule, want in ((False, "auto", [(8, False)] * 8),
                                   (True, "auto",
                                    [(16, True), (8, False)]
                                    + [(16, False)] * 7),
                                   (True, "contiguous",
                                    [(8, True)] + [(8 - i, False)
                                                   for i in range(1, 8)])):
        calls.clear()
        _port_ring(q, k, v, None, None, causal, True, schedule)
        assert calls == want, (causal, schedule, calls)
    odd = torch.randn(1, 2, 24, 8)
    calls.clear()
    _port_ring(odd, odd, odd, None, None, True, True)
    assert len(calls) == 8  # Sl = 3: contiguous
    with pytest.raises(ValueError, match="zigzag"):
        _port_ring(odd, odd, odd, None, None, True, True, "zigzag")
    with pytest.raises(ValueError, match="zigzag"):
        _port_ring(q, k, v, None, None, False, True, "zigzag")
    from paddle_tpu.parallel.ring_attention import _zigzag_permutes as jzz

    for n in (2, 4, 8):
        assert _zigzag_permutes(n) == jzz(n)


def _packed_gpt(pkg):
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch.models import gpt as tgpt

    cfg = dict(d_model=32, d_ff=64, n_head=2, n_layer=1, vocab=64,
               max_length=32, dropout=0.0, pos_emb="rope")
    mod = jgpt if pkg is jf else tgpt
    loss, _ = mod.build(cfg, seq_len=32, packed=True,
                        use_fused_attention=True)
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _both(build, seed=5):
    progs = {}
    for key, pkg in (("jax", jf), ("port", pt)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            progs[key] = (main, startup, build(pkg))
    jmain, jstart, _ = progs["jax"]
    jscope = jf.Scope()
    jf.Executor(jf.CPUPlace()).run(jstart, scope=jscope)
    return progs, jscope, port_scope(jax_state(jmain, jscope),
                                     progs["port"][0])


def _loss(v):
    return float(np.asarray(v).reshape(-1)[0])


def check_ring_run(build, feed, pat, rtol, atol):
    """3 SGD steps of ``build``'s program under a (data 2, seq 4) mesh,
    its ``pat`` feeds split over both axes, against the JAX package's
    single-device run (which its own engine matches on that mesh,
    tests/test_parallel_engine.py); the plan's collectives name one ring
    per attention forward and one per grad. Returns the ring lines."""
    progs, jscope, tscope = _both(build)
    (jmain, _, jl), (tmain, _, tl) = progs["jax"], progs["port"]
    jexe = jf.Executor(jf.CPUPlace())
    te = ParallelEngine(tmain, loss_name=tl.name,
                        mesh=make_mesh([pt.CPUPlace()] * 8, ("data", "seq"),
                                       (2, 4)),
                        rules=ShardingRules(feed_rules=[(pat, P("data",
                                                                "seq"))]))
    jls = [_loss(jexe.run(jmain, feed=feed, fetch_list=[jl],
                          scope=jscope)[0]) for _ in range(3)]
    tls = [_loss(te.run(feed, [tl], tscope)[0]) for _ in range(3)]
    np.testing.assert_allclose(tls, jls, rtol=rtol, atol=atol)
    txt = te.lowered_collectives(feed, [tl], tscope)
    ring = [ln for ln in txt.splitlines() if ln.startswith("ring_ppermute")]
    n_attn = sum(op.type == "fused_attention"
                 for op in tmain.global_block().ops)
    assert n_attn > 0 and len(ring) == 2 * n_attn
    assert all("axis=seq positions=4" in ln and "flash=True" in ln
               for ln in ring)
    plan = next(iter(te._cache.values()))
    assert set(plan.feed_specs.values()) == {P("data", "seq")}
    return ring


def test_packed_gpt_rides_the_zigzag_ring_with_segment_ids():
    """The packed GPT's causal ``fused_attention`` under a (data 2, seq
    4) mesh: its segment ids ride the zigzag ring (the [S, S] pack mask
    is never built), within test_parallel_engine.py's 3e-4 / 3e-5."""
    from paddle_tpu import reader

    rs = np.random.RandomState(3)
    docs = [list(rs.randint(1, 64, rs.randint(5, 14))) for _ in range(10)]
    feed = reader.pack_sequences(docs, seq_len=32, n_rows=4)
    ring = check_ring_run(_packed_gpt, feed, r"^(ids|segment_ids|pos_ids)$",
                          3e-4, 3e-5)
    assert all("schedule=zigzag" in ln for ln in ring)


def test_ring_needs_a_dividing_seq_axis_and_a_key_mask():
    """The JAX package's rule decides the branch: no ring where the seq
    axis does not divide S or the bias is not a key mask; then the op
    computes its global attention, the same numbers."""
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.ops.attention import _ring_positions

    mesh = make_mesh([pt.CPUPlace()] * 8, ("data", "seq"), (2, 4))
    ctx = LowerContext(mesh=mesh)
    q = torch.zeros(2, 2, 16, 8)
    assert _ring_positions(ctx, q, q, None) == 4
    assert _ring_positions(ctx, q, q, torch.zeros(2, 1, 1, 16)) == 4
    assert _ring_positions(ctx, q, q, torch.zeros(2, 1, 16, 16)) == 0
    odd = torch.zeros(2, 2, 18, 8)
    assert _ring_positions(ctx, odd, odd, None) == 0
    assert _ring_positions(LowerContext(), q, q, None) == 0
    assert _ring_positions(ctx, q, torch.zeros(2, 2, 8, 8), None) == 0
