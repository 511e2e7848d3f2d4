"""The port's CUDA kernels and its training step on the card.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
GPU. The file imports neither JAX nor the JAX package, so that it runs
where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

- The flash forward kernel against its plain version
  (``composed_attention_with_lse``), at atol 2e-5 on O and 1e-5 on lse
  at f32 and 2e-2 at bf16, at S = 8, 200 and a causal 1000, two launches
  bitwise equal; and on a batch row whose keys all carry the -1e9 mask
  (uniform weight over the real keys), with a key-pad and a full bias.
- The flash dK/dV and dQ kernels against their plain versions on f32
  copies of the inputs, with the raw score grad (``want_db``) both
  without and with causal masking, at S = 8 (below one tensor-core
  tile), 200 and 1000, at atol 5e-5 at f32 (the JAX package's stated
  backward tolerance) and 2e-2 at bf16; and two launches of each on the
  same inputs give the same bits.
- One training step of a 2-layer BERT MLM with dropout launches the
  forward kernel twice and each backward kernel once per layer.
- The kernel tier's kernels against their plain versions: the fused
  residual + layer norm forward (K4) at atol 1e-5 and its backward (K5,
  through ``torch.autograd``) at 5e-5 at f32, 2e-2 at bf16; the grouped
  Adam (K6) and SGD (K7) updates at 2e-6.
- K5 alone at D = 7, 768, 1000, 2048 and 4096 and N = 1, 17 and 4096
  (a warp per row, a CTA per row, vector and scalar columns), f32 and
  bf16, against its plain version on f32 copies; two launches bitwise
  equal.
- K6 and K7 over odd sizes, a 30522-element param before larger ones
  and one param that is a view at an odd 4-byte offset (its entry takes
  the scalar path, every other one the 16-byte path), at 2e-6; two
  launches bitwise equal; the outputs are views at 128-byte aligned
  offsets, so a second step on them takes the 16-byte path throughout.
- A level-2 training step of the same BERT, with nothing in the tuned
  table, launches K4 once per fused layer norm (2 * n_layer + 1) and K6
  (Adam) or K7 (SGD) once.
- ``Executor.run`` takes CUDA-tensor feeds: the same fetches as the
  numpy feeds, and with ``return_numpy=False`` tensors on the card.
- The tuner measures the flash kernel against the composed attention on
  the card and records the faster.
- bf16 AMP: K4's AMP instantiation against its plain version (s
  bitwise, y / mean / var at 1e-5) for every pair of f32 / bf16 x and r;
  K6 and K7 on bf16 grads bitwise equal to the launch on the grads
  widened to f32, a bf16 grad view 2 bytes into its buffer on the
  scalar loop; one level-2 AMP step of the BERT above launching only
  the bf16 flash kernels, K4's AMP instantiation and K6 / K7, with f32
  masters and level 0's loss within two bf16 ulps.
- The compiled step (core/cuda_graph.py): steps 2-4 of a plan are
  replays of its CUDA graph, bitwise the plan's eager step from the
  same scope (losses, a dropout mask that changes from step to step,
  final params; f32 and AMP, Adam and SGD), with the eager step's
  launches on the card (the kernels' own counts); a replay updates
  the scope's params in place and K6's table is built once, at
  capture; a param replaced between replays is what the next replay
  reads, and a var of another shape or dtype is captured anew; three
  plans of one executor share one pool and alternate bitwise, copying
  no state in; a ``return_numpy=False`` fetch is a copy
  the next run leaves alone; an op that calls ``.item()`` makes the
  capture raise, naming it; ``run_repeated(3)`` is bitwise 3 ``run``
  calls; the Predictor's replayed answers are bitwise its eager step's,
  f32 and AMP; a Program with no op replays its empty graph.
- The step loop (core/pipeline.py): ``train_loop`` at K = 1 and K = 4
  bitwise the ``run`` loop (losses, dropout masks, params, the RNG
  chain) with its launches on the card; a plan captured while the
  prefetch thread allocates and copies on its own stream; handles
  resolved after later replays still hold their own step's values; the
  warm-up + decay schedule under replay against the CPU and its closed
  form; a RecomputeOptimizer program's replays bitwise its eager steps;
  a param replaced in ``on_step`` honoured as in the run loop.
- GPT: a 2-layer GPT's replayed training steps bitwise its eager steps
  with their launches (causal flash kernels, K4 2 a layer, K6); at
  S = 1024 the causal K1-K3 inside the graph, the loss within f32
  rounding of the composed attention's; ``generate``'s prefill and
  decode graphs holding the scope's KV caches and writing them in place,
  the tokens an executor's that never replays; ids past a table's rows
  giving NaN rows and no grad inside a captured step (C8).
- Image classification: conv2d (strides, pads, dilations, groups; its
  grads), pool2d, batch_norm (train, test, NHWC), cross_entropy, top_k,
  accuracy, auc, precision_recall and gaussian_random on the card
  against the CPU (f32 products without TF32 summed in another order:
  1e-4 for the convs and the norms, 1e-6 elsewhere, the metrics exact);
  top_k's ties on the card in the order ``lax.top_k`` gives; a conv
  step under the port's cuDNN flags bitwise repeatable; a small
  ResNet-50's replayed steps bitwise its eager steps, the batch norms'
  running stats included, with K6 once a step on the card.
- Optimizers, checkpoints and serving: the nine new optimizer
  lowerings on the card against the CPU (elementwise at rtol 2e-6, the
  norms' reductions at 1e-5, average_accumulates bitwise); Lamb,
  LarsMomentum and RMSProp steps replayed bitwise eager (no host sync
  in their updates); ``save_persistables_async`` not torn by the
  replayed steps right after it, and the RNG chain saved with it
  resuming the dropout masks bitwise; a small GPT engine whose splices
  write the caches its captured graphs hold, its tokens ``generate()``'s
  for each request alone; a verify step's products per position
  bitwise the decode step's (ops/math.py's ``slot_rows``).
- Sequences and control flow: a ``while`` plan is never captured (it
  reads its condition on the host), runs eagerly at every run with the
  right values, and the executor's uncaptured-plans counter
  (``core.executor.UNCAPTURED_PLANS``, by op) counts it once; a training step holding ``cond`` / ``Switch`` /
  ``IfElse`` is captured and its replays are bitwise its eager steps; a
  StaticRNN / DynamicRNN step with dropout replays bitwise eager (the
  recurrent grad's masks included); ``beam_search`` on the card gives
  the CPU's parents and ids on tied candidates (dead beams, a uniform
  step) at a vocabulary of 10000.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.kernels import build as tbuild
from paddle_tpu_torch.kernels import layernorm as tln
from paddle_tpu_torch.kernels import optimizer_update as topt
from paddle_tpu_torch.kernels import tune
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import attention as tattn

# head dim 64: the kernels take 64 and 128
CFG = dict(d_model=128, d_ff=256, n_head=2, n_layer=2, vocab=100,
           type_vocab=2, max_length=40, dropout=0.1)
S, M, B = 40, 6, 3


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    # no persisted winners: the tuned table holds what a test sets
    monkeypatch.setenv("PADDLE_TPU_KERNEL_CACHE_DIR", "0")
    tune.reset()
    yield torch.device("cuda", 0)
    tune.reset()


def _qkv(shape, dtype, dev):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(shape, generator=g).to(dtype).to(dev)
            for _ in range(3)]


# S: below one mma tile (8), not a multiple of 16 (200), and a causal
# sweep over many tiles that is not a multiple of 64 (1000)
BWD_CASES = [(8, False), (8, True), (200, False), (200, True), (1000, True)]


def _fwd_tols(dtype):
    """(out, lse) tolerances of the forward kernel against its plain
    version on f32 copies."""
    return (2e-5, 1e-5) if dtype == torch.float32 else (2e-2, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("S,causal", BWD_CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, d, S,
                                           causal):
    q, k, v = _qkv((2, 3, S, d), dtype, cuda_device)
    bias = torch.zeros(2, 1, 1, S, device=cuda_device)
    bias[1, ..., S - max(S // 4, 1):] = -1e9  # batch 1's last keys padded
    before = tattn.flash_attention_fwd.launches
    out, lse = tattn.flash_attention_fwd(q, k, v, bias, d ** -0.5, causal)
    assert tattn.flash_attention_fwd.launches == before + 1
    want, want_lse = tattn.composed_attention_with_lse(
        q.float(), k.float(), v.float(), bias, d ** -0.5, causal)
    tol_o, tol_lse = _fwd_tols(dtype)
    torch.testing.assert_close(out.float(), want, atol=tol_o, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=tol_lse, rtol=0)
    # two launches on the same inputs give the same bits
    again = tattn.flash_attention_fwd(q, k, v, bias, d ** -0.5, causal)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind", ["keypad", "full"])
def test_cuda_kernel_fully_masked_row_matches_plain_version(cuda_device,
                                                            dtype, d, kind):
    """Every key of batch row 1 carries the -1e9 mask: the kernel spreads
    the weight uniformly over the real keys, as the plain version does,
    and its lse is the mask value's (S = 200, a ragged key tile)."""
    S = 200
    q, k, v = _qkv((2, 3, S, d), dtype, cuda_device)
    g = torch.Generator().manual_seed(3)
    shape = (2, 1, 1, S) if kind == "keypad" else (2, 1, S, S)
    bias = torch.randn(shape, generator=g).to(cuda_device)
    bias[1] = -1e9
    out, lse = tattn.flash_attention_fwd(q, k, v, bias, d ** -0.5)
    want, want_lse = tattn.composed_attention_with_lse(
        q.float(), k.float(), v.float(), bias, d ** -0.5)
    tol_o, tol_lse = _fwd_tols(dtype)
    torch.testing.assert_close(out.float(), want, atol=tol_o, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=tol_lse, rtol=0)
    uniform = v[1].float().mean(1, keepdim=True).expand(3, S, d)
    torch.testing.assert_close(out[1].float(), uniform, atol=tol_o, rtol=0)


def _bwd_inputs(dtype, d, S, causal, dev):
    """q, k, v, g and the kernels' remaining arguments (bias, g, lse,
    delta, scale, causal), with the f32 copies the plain versions take.
    The bias is a full [2, 1, S, S] one, -1e9 on the last quarter of batch
    1's keys."""
    q, k, v = _qkv((2, 3, S, d), dtype, dev)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    g = g.to(dtype).to(dev)
    bias = torch.randn(2, 1, S, S, generator=torch.Generator().manual_seed(2))
    bias = bias.to(dev)
    bias[1, ..., S - S // 4:] = -1e9
    f32 = [t.float() for t in (q, k, v, g)]
    o, lse = tattn.composed_attention_with_lse(*f32[:3], bias, d ** -0.5,
                                               causal)
    delta = (f32[3] * o).sum(-1)
    return (q, k, v), (bias, g, lse, delta, d ** -0.5, causal), f32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("S,causal", BWD_CASES)
def test_cuda_backward_kernels_match_plain_versions(cuda_device, dtype, d,
                                                    S, causal):
    (q, k, v), args, f32 = _bwd_inputs(dtype, d, S, causal, cuda_device)
    tol = 5e-5 if dtype == torch.float32 else 2e-2
    before = (tattn.flash_attention_dkv.launches,
              tattn.flash_attention_dq.launches)
    dk, dv, ds = tattn.flash_attention_dkv(q, k, v, *args, want_db=True)
    dq = tattn.flash_attention_dq(q, k, v, *args)
    assert (tattn.flash_attention_dkv.launches,
            tattn.flash_attention_dq.launches) == (before[0] + 1,
                                                   before[1] + 1)
    ref_args = (*f32[:3], args[0], f32[3], *args[2:])
    rdk, rdv, rds = tattn.flash_attention_dkv_reference(*ref_args,
                                                        want_db=True)
    rdq = tattn.flash_attention_dq_reference(*ref_args)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)
    # under causal the tiles above the diagonal are skipped: their
    # score grad is written as 0, as the plain version gives
    torch.testing.assert_close(ds, rds, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_backward_kernels_are_bitwise_repeatable(cuda_device, dtype,
                                                      d):
    """No atomics: two launches on the same inputs give the same bits."""
    for S, causal in ((200, False), (1000, True)):
        (q, k, v), args, _ = _bwd_inputs(dtype, d, S, causal, cuda_device)
        runs = [(*tattn.flash_attention_dkv(q, k, v, *args, want_db=True),
                 tattn.flash_attention_dq(q, k, v, *args))
                for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


def _feed(rs):
    mask = np.ones((B, S), "float32")
    pos = np.zeros((B, M), "int64")
    weight = np.zeros((B, M), "float32")
    for i in range(B):
        real = S - rs.randint(S // 10, 2 * S // 5 + 1)
        mask[i, real:] = 0.0
        picks = rs.choice(real, M - i, replace=False)
        pos[i, :M - i] = i * S + picks
        weight[i, :M - i] = 1.0
    return {"src_ids": rs.randint(0, CFG["vocab"], (B, S)).astype("int64"),
            "sent_ids": rs.randint(0, 2, (B, S)).astype("int64"),
            "input_mask": mask, "mask_pos": pos,
            "mask_label": rs.randint(0, CFG["vocab"], (B, M)).astype("int64"),
            "mask_weight": weight}


@pytest.mark.cuda
def test_cuda_training_step_launches_the_flash_kernels(cuda_device,
                                                      monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")  # flash at S = 40
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 11
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = tbert.build(CFG, seq_len=S, max_mask=M)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    before = (tattn.flash_attention_fwd.launches,
              tattn.flash_attention_dkv.launches,
              tattn.flash_attention_dq.launches)
    (val,) = exe.run(main, feed=_feed(np.random.RandomState(0)),
                     fetch_list=[loss], scope=scope)
    after = (tattn.flash_attention_fwd.launches,
             tattn.flash_attention_dkv.launches,
             tattn.flash_attention_dq.launches)
    n = CFG["n_layer"]
    assert tuple(a - b for a, b in zip(after, before)) == (2 * n, n, n)
    assert np.isfinite(val).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(300, 768), (64, 1000), (40, 5000)])
def test_cuda_layernorm_kernels_match_plain_versions(cuda_device, dtype, n,
                                                     d):
    g = torch.Generator().manual_seed(1)
    x, r, gy, gs = (torch.randn(n, d, generator=g).to(dtype).to(cuda_device)
                    for _ in range(4))
    sc, b = (torch.randn(d, generator=g).to(dtype).to(cuda_device)
             for _ in range(2))
    fwd_tol, bwd_tol = (1e-5, 5e-5) if dtype == torch.float32 else (2e-2,
                                                                     2e-2)
    ins = [t.clone().requires_grad_(True) for t in (x, r, sc, b)]
    before = (tln.layernorm_residual_fwd.launches,
              tln.layernorm_residual_bwd.launches)
    outs = tln.layernorm_residual(*ins, eps=1e-5)
    want = tln.composed_layernorm_residual(x, r, sc, b, eps=1e-5)
    for got, w in zip(outs, want):
        torch.testing.assert_close(got.detach().float(), w.float(),
                                   atol=fwd_tol, rtol=0)
    torch.autograd.backward(outs[:2], [gy, gs])
    assert (tln.layernorm_residual_fwd.launches,
            tln.layernorm_residual_bwd.launches) == (before[0] + 1,
                                                     before[1] + 1)
    # K5 on the rows and statistics K4 saved, against its plain version
    # on f32 copies. dscale / dbias come out in f32; dx is stored in the
    # rows' dtype, and rounding to bf16 moves a value by up to 2^-8 of it
    _, s, mean, var = (t.detach() for t in outs)
    got = tln.layernorm_residual_bwd(s, mean, var, sc, gy, gs, 1e-5)
    want = tln.layernorm_residual_bwd_reference(
        s.float(), mean, var, sc.float(), gy.float(), gs.float(), 1e-5)
    rtol = 0 if dtype == torch.float32 else 2 ** -8
    for a, w, rt in zip(got, want, (rtol, 0, 0)):
        torch.testing.assert_close(a.float(), w, atol=bwd_tol, rtol=rt)
    # autograd ran the same kernel: its grads are K5's outputs, in the
    # inputs' dtype
    dx, dsc, db = got
    for t, w in zip(ins, (dx, dx, dsc.to(dtype), db.to(dtype))):
        assert torch.equal(t.grad, w)


@pytest.mark.cuda
def test_cuda_optimizer_group_kernels_match_plain_versions(cuda_device):
    g = torch.Generator().manual_seed(2)
    shapes = [(768, 768), (768,), (5, 3), (1,), (4099,)]
    mk = lambda s: torch.rand(s, generator=g).to(cuda_device) + 0.1  # noqa
    lr = torch.full((1,), 1e-3, device=cuda_device)
    ins = {"Param": [mk(s) for s in shapes],
           "Grad": [mk(s) - 0.6 for s in shapes],
           "Moment1": [mk(s) * 0.1 for s in shapes],
           "Moment2": [mk(s) * 0.01 for s in shapes],
           "Beta1Pow": [torch.full((1,), 0.9 ** (i + 1), device=cuda_device)
                        for i in range(len(shapes))],
           "Beta2Pow": [torch.full((1,), 0.999 ** (i + 1),
                                   device=cuda_device)
                        for i in range(len(shapes))],
           "LearningRate": [lr] * len(shapes)}
    hyper = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
             "weight_decay": 0.01}
    before = (topt.adam_group.launches, topt.sgd_group.launches)
    got = topt.adam_group(ins, hyper)
    sgd = topt.sgd_group(ins)
    assert (topt.adam_group.launches, topt.sgd_group.launches) == (
        before[0] + 1, before[1] + 1)
    for out, want in ((got, topt.adam_group_reference(ins, hyper)),
                      (sgd, topt.sgd_group_reference(ins))):
        for slot in want:
            for a, w in zip(out[slot], want[slot]):
                torch.testing.assert_close(a, w, atol=2e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [7, 768, 1000, 2048, 4096])
@pytest.mark.parametrize("n", [1, 17, 4096])
def test_cuda_layernorm_bwd_kernel_matches_plain_version(cuda_device, dtype,
                                                        d, n):
    g = torch.Generator().manual_seed(n * 10007 + d)
    x, r, gy, gs = (0.5 * torch.randn(n, d, generator=g)
                    for _ in range(4))
    x, r, gy, gs = (t.to(dtype).to(cuda_device) for t in (x, r, gy, gs))
    sc = (1 + 0.1 * torch.randn(d, generator=g)).to(dtype).to(cuda_device)
    b = (0.1 * torch.randn(d, generator=g)).to(dtype).to(cuda_device)
    _, s, mean, var = tln.layernorm_residual_fwd(x, r, sc, b, 1e-5)
    before = tln.layernorm_residual_bwd.launches
    got = tln.layernorm_residual_bwd(s, mean, var, sc, gy, gs, 1e-5)
    again = tln.layernorm_residual_bwd(s, mean, var, sc, gy, gs, 1e-5)
    assert tln.layernorm_residual_bwd.launches == before + 2
    want = tln.layernorm_residual_bwd_reference(
        s.float(), mean, var, sc.float(), gy.float(), gs.float(), 1e-5)
    tol = 5e-5 if dtype == torch.float32 else 2e-2
    rtol = 0 if dtype == torch.float32 else 2 ** -8  # dx's bf16 rounding
    for a, w, rt in zip(got, want, (rtol, 0, 0)):
        torch.testing.assert_close(a.float(), w, atol=tol, rtol=rt)
    assert all(torch.equal(a, a2) for a, a2 in zip(got, again))


# odd sizes: one-element params, sizes one past a tile, a size no tile
# divides
EDGE_SHAPES = [(1,), (3,), (4097,), (16385,), (1000, 7), (123457,)]


@pytest.mark.cuda
def test_cuda_optimizer_groups_take_the_vector_path(cuda_device):
    g = torch.Generator().manual_seed(4)
    shapes = [(30522,), (768, 768), (30522, 64)] + EDGE_SHAPES
    odd = shapes.index((4097,))
    mk = lambda s: torch.rand(s, generator=g).to(cuda_device) + 0.1  # noqa
    k = len(shapes)
    ins = {"Param": [mk(s) for s in shapes],
           "Grad": [mk(s) - 0.6 for s in shapes],
           "Moment1": [mk(s) * 0.1 for s in shapes],
           "Moment2": [mk(s) * 0.01 for s in shapes],
           "Beta1Pow": [torch.full((1,), 0.9, device=cuda_device)] * k,
           "Beta2Pow": [torch.full((1,), 0.999, device=cuda_device)] * k,
           "LearningRate": [torch.full((1,), 1e-3, device=cuda_device)] * k}
    # a param that is a view 4 bytes into its buffer: the scalar path
    ins["Param"][odd] = mk((4098,))[1:]
    assert ins["Param"][odd].data_ptr() % 16 == 4
    hyper = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    for kind, fn, ref in (
            ("adam", lambda i: topt.adam_group(i, hyper),
             lambda i: topt.adam_group_reference(i, hyper)),
            ("sgd", topt.sgd_group, topt.sgd_group_reference)):
        wrapper = topt.adam_group if kind == "adam" else topt.sgd_group
        before = (wrapper.launches, wrapper.vector_entries)
        got, again = fn(ins), fn(ins)
        assert (wrapper.launches - before[0],
                wrapper.vector_entries - before[1]) == (2, 2 * (k - 1))
        want = ref(ins)
        for slot in want:
            for a, a2, w in zip(got[slot], again[slot], want[slot]):
                torch.testing.assert_close(a, w, atol=2e-6, rtol=0)
                assert torch.equal(a, a2)
        outs = [t for slot in ("ParamOut", "Moment1Out", "Moment2Out")
                if slot in got for t in got[slot]]
        assert all(t.data_ptr() % 128 == 0 for t in outs)
        assert [tuple(t.shape) for t in got["ParamOut"]] == shapes
    # the second step reads the first one's outputs: every entry vectors
    step2 = dict(ins, Param=got["ParamOut"], Grad=[mk(s) - 0.6
                                                   for s in shapes])
    before = topt.sgd_group.vector_entries
    out2 = topt.sgd_group(step2)
    assert topt.sgd_group.vector_entries - before == k
    for a, w in zip(out2["ParamOut"],
                    topt.sgd_group_reference(step2)["ParamOut"]):
        torch.testing.assert_close(a, w, atol=2e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["Adam", "SGD"])
def test_cuda_level2_step_launches_the_tier_kernels(cuda_device,
                                                   monkeypatch, opt):
    monkeypatch.delenv("PADDLE_TPU_OPTIMIZE", raising=False)
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 11
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = tbert.build(CFG, seq_len=S, max_mask=M)
        getattr(pt.optimizer, opt)(learning_rate=1e-3).minimize(loss)
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    group = topt.adam_group if opt == "Adam" else topt.sgd_group
    counts = lambda: (tln.layernorm_residual_fwd.launches,  # noqa: E731
                      group.launches)
    before = counts()
    (val,) = exe.run(main, feed=_feed(np.random.RandomState(0)),
                     fetch_list=[loss], scope=scope)
    after = counts()
    assert (after[0] - before[0], after[1] - before[1]) == (
        2 * CFG["n_layer"] + 1, 1)
    assert np.isfinite(val).all()


@pytest.mark.cuda
def test_cuda_tensor_feeds_match_numpy_feeds(cuda_device):
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 11
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = tbert.build(CFG, seq_len=S, max_mask=M)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    snap = {n: scope.find_var(n) for n in scope.local_var_names()}

    def fresh():
        sc = pt.Scope()
        for n, v in snap.items():
            sc.set_var(n, v)
        return sc

    feed = _feed(np.random.RandomState(1))
    want = exe.run(main, feed=feed, fetch_list=[loss], scope=fresh())
    got = exe.run(main, feed={n: torch.from_numpy(v).to(cuda_device)
                              for n, v in feed.items()},
                  fetch_list=[loss], scope=fresh(), return_numpy=False)
    assert got[0].device.type == "cuda"
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0])


@pytest.mark.cuda
def test_cuda_tune_measures_flash_against_composed(cuda_device,
                                                   monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC", raising=False)
    before = tattn.flash_attention_fwd.launches
    dec = tune.tune("attention", (256, 256), {"scale": 0.125})
    assert tattn.flash_attention_fwd.launches > before
    assert [t["label"] for t in dec["timings"]] == ["cuda:[]", "composed"]
    assert all(t["seconds"] > 0 for t in dec["timings"])
    best = min(dec["timings"], key=lambda t: t["seconds"])
    assert dec["choice"] == best["choice"]
    assert tune.lookup("attention", (256, 256))["choice"] == dec["choice"]


# ------------------------------------------------------------------ AMP
@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,r_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32)])
@pytest.mark.parametrize("n,d", [(300, 768), (64, 1000), (40, 5000)])
def test_cuda_layernorm_amp_kernel_matches_plain_version(cuda_device,
                                                         x_dtype, r_dtype,
                                                         n, d):
    """K4's AMP instantiation: s = bf16(bf16(x) + bf16(r)) bitwise equal
    to its plain version, y, mean and var (f32) at K4's f32 tolerance;
    two launches bitwise equal."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(n, d, generator=g).to(x_dtype).to(cuda_device)
    r = torch.randn(n, d, generator=g).to(r_dtype).to(cuda_device)
    sc, b = (torch.randn(d, generator=g).to(cuda_device) for _ in range(2))
    before = tln.layernorm_residual_fwd_amp.launches
    got = tln.layernorm_residual_fwd_amp(x, r, sc, b, 1e-5)
    again = tln.layernorm_residual_fwd_amp(x, r, sc, b, 1e-5)
    assert tln.layernorm_residual_fwd_amp.launches == before + 2
    want = tln.composed_layernorm_residual(x, r, sc, b, eps=1e-5, amp=True)
    y, s, mean, var = got
    assert (y.dtype, s.dtype, mean.dtype) == (torch.float32, torch.bfloat16,
                                              torch.float32)
    assert torch.equal(s, want[1])
    for a, w in zip((y, mean, var), (want[0], want[2], want[3])):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=0)
    assert all(torch.equal(a, a2) for a, a2 in zip(got, again))


def _amp_group(shapes, dev, bf16):
    g = torch.Generator().manual_seed(6)
    mk = lambda s: torch.rand(s, generator=g).to(dev) + 0.1  # noqa: E731
    k = len(shapes)
    return {"Param": [mk(s) for s in shapes],
            "Grad": [(mk(s) - 0.6).to(torch.bfloat16 if bf else
                                       torch.float32)
                     for s, bf in zip(shapes, bf16)],
            "Moment1": [mk(s) * 0.1 for s in shapes],
            "Moment2": [mk(s) * 0.01 for s in shapes],
            "Beta1Pow": [torch.full((1,), 0.9, device=dev)] * k,
            "Beta2Pow": [torch.full((1,), 0.999, device=dev)] * k,
            "LearningRate": [torch.full((1,), 1e-3, device=dev)] * k}


@pytest.mark.cuda
def test_cuda_optimizer_groups_take_bf16_grads(cuda_device):
    """K6 / K7 on an AMP step's grads (bf16 but two f32 ones): the same
    bits as the launch on the grads widened to f32, the plain version at
    2e-6, two launches bitwise equal; a bf16 grad view 2 bytes into its
    buffer (not 8-byte aligned) takes the scalar loop, every other entry
    the vector path."""
    shapes = [(30522, 64), (768,), (768, 768), (3,), (4097,), (123457,)]
    bf16 = [True, False, True, True, True, False]
    ins = _amp_group(shapes, cuda_device, bf16)
    odd = shapes.index((4097,))
    ins["Grad"][odd] = torch.randn(4098, device=cuda_device).to(
        torch.bfloat16)[1:]
    assert ins["Grad"][odd].data_ptr() % 8 == 2
    # the widened grads take the same paths: the odd entry's f32 grad is
    # a view 4 bytes into its buffer, on the scalar loop too
    wide_odd = torch.empty(4098, device=cuda_device)[1:]
    wide_odd.copy_(ins["Grad"][odd])
    assert wide_odd.data_ptr() % 16 == 4
    widened = dict(ins, Grad=[wide_odd if i == odd else t.float()
                              for i, t in enumerate(ins["Grad"])])
    hyper = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
             "weight_decay": 0.01}
    k = len(shapes)
    for wrapper, fn, ref in (
            (topt.adam_group, lambda i: topt.adam_group(i, hyper),
             lambda i: topt.adam_group_reference(i, hyper)),
            (topt.sgd_group, topt.sgd_group, topt.sgd_group_reference)):
        before = (wrapper.launches, wrapper.vector_entries,
                  wrapper.bf16_grad_entries)
        got, again = fn(ins), fn(ins)
        assert (wrapper.launches - before[0],
                wrapper.vector_entries - before[1],
                wrapper.bf16_grad_entries - before[2]) == (
                    2, 2 * (k - 1), 2 * sum(bf16))
        wide, want = fn(widened), ref(ins)
        for slot in want:
            for i, (a, a2, aw, w) in enumerate(zip(
                    got[slot], again[slot], wide[slot], want[slot])):
                torch.testing.assert_close(a, w, atol=2e-6, rtol=0)
                assert torch.equal(a, a2), (slot, i, "two launches")
                assert torch.equal(a, aw), (slot, i, "widened grads")


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["Adam", "SGD"])
def test_cuda_amp_level2_step_launches_the_amp_kernels(cuda_device,
                                                       monkeypatch, opt):
    """One level-2 step of the small BERT under bf16 AMP: the bf16 flash
    kernels (2 * n_layer forward, n_layer each backward), K4's AMP
    instantiation once per fused layer norm, K6 or K7 once on the bf16
    grads; params and moments stay f32, the loss is finite and, from the
    same scope, equals level 0's within two ulps of a bf16 value (the
    loss is one: 2^-6 relative)."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")  # flash at S = 40
    monkeypatch.delenv("PADDLE_TPU_OPTIMIZE", raising=False)
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 11
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = tbert.build(CFG, seq_len=S, max_mask=M)
        pt.contrib.mixed_precision.decorate(
            getattr(pt.optimizer, opt)(learning_rate=1e-3)).minimize(loss)
    assert main.amp
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    snap = {n: scope.find_var(n) for n in scope.local_var_names()}
    group = topt.adam_group if opt == "Adam" else topt.sgd_group
    wrappers = (tattn.flash_attention_fwd, tattn.flash_attention_dkv,
                tattn.flash_attention_dq)
    counts = lambda: tuple(  # noqa: E731
        [w.launches for w in wrappers] + [w.bf16_launches for w in wrappers]
        + [tln.layernorm_residual_fwd_amp.launches,
           tln.layernorm_residual_fwd.launches, group.launches])
    feed = _feed(np.random.RandomState(0))
    before = counts()
    (val,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    n = CFG["n_layer"]
    assert tuple(a - b for a, b in zip(counts(), before)) == (
        2 * n, n, n, 2 * n, n, n, 2 * n + 1, 0, 1)
    assert np.isfinite(val).all()
    for p in main.global_block().all_parameters():
        assert scope.find_var(p.name).dtype == torch.float32, p.name
    for name in scope.local_var_names():
        if "moment" in name:
            assert scope.find_var(name).dtype == torch.float32, name
    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", "0")
    scope0 = pt.Scope()
    for k, v in snap.items():
        scope0.set_var(k, v)
    (val0,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope0)
    np.testing.assert_allclose(np.asarray(val).reshape(()),
                               np.asarray(val0).reshape(()), rtol=2 ** -6)


# ------------------------------------------------------- the compiled step
def _train_program(opt, amp=False):
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 11
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = tbert.build(CFG, seq_len=S, max_mask=M)
        o = getattr(pt.optimizer, opt)(learning_rate=1e-3)
        if amp:
            o = pt.contrib.mixed_precision.decorate(o)
        o.minimize(loss)
    return main, startup, loss


def _started(main, startup):
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    return exe, _clone_scope(scope)


def _clone_scope(scope):
    """A scope of copies of ``scope``'s values: under a CUDA graph the
    executor updates state tensors in place."""
    sc = pt.Scope()
    for n in scope.local_var_names():
        v = scope.find_var(n)
        sc.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
    return sc


def _dropout_mask(main):
    """The Mask output of the program's first dropout op."""
    op = next(op for op in main.global_block().ops if op.type == "dropout")
    return op.output("Mask")[0]


def _params(main, scope):
    return {p.name: scope.find_var(p.name).clone()
            for p in main.global_block().all_parameters()}


def _device_launches(fn):
    """``fn()``'s result and the launches of the port's kernels the card
    ran in it, per library and slot, as the kernels count themselves on
    the device (a CUDA graph's replay included)."""
    libs = (("flash_attention_fwd", 2), ("flash_attention_bwd", 4),
            ("layernorm_residual", 2), ("optimizer_update", 2))

    def read():
        torch.cuda.synchronize()
        return [n for lib, k in libs
                for n in tbuild.device_launches(lib, k)]

    before = read()
    out = fn()
    return out, [b - a for a, b in zip(before, read())]


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["Adam", "SGD"])
@pytest.mark.parametrize("amp", [False, True])
def test_cuda_replayed_steps_equal_eager_steps(cuda_device, monkeypatch, opt,
                                               amp):
    """Steps 2-4 of a plan are replays of its CUDA graph (step 1 is its
    eager run); with dropout 0.1 each replay's loss, dropout mask and
    final params equal, bit for bit, the plan's eager step run from the
    same scope, and the masks differ from step to step. The card runs
    the same launches of the port's kernels in a replayed step as in an
    eager one (as the kernels count themselves on the device), and each
    wrapper counts its host launch calls in the eager run and the
    capture only."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")  # flash at S = 40
    main, startup, loss = _train_program(opt, amp)
    exe, scope = _started(main, startup)
    eager_scope = _clone_scope(scope)
    mask = _dropout_mask(main)
    feeds = [_feed(np.random.RandomState(i)) for i in range(4)]
    group = topt.adam_group if opt == "Adam" else topt.sgd_group
    replayed, eager = [], []
    for i, f in enumerate(feeds):
        host = group.launches
        r, on_card = _device_launches(lambda: exe.run(
            main, feed=f, fetch_list=[loss, mask], scope=scope,
            return_numpy=False))
        replayed.append(r)
        # the eager run and the capture (step 1) call the launch
        assert group.launches - host == (1 if i < 2 else 0), i
        e, on_card_e = _device_launches(lambda: exe._run_eager(
            main, feed=f, fetch_list=[loss, mask], scope=eager_scope,
            return_numpy=False))
        eager.append(e)
        assert on_card == on_card_e, (i, on_card, on_card_e)
        n = CFG["n_layer"]
        # per slot: flash fwd f32 / bf16, dK/dV and dQ f32, dK/dV and dQ
        # bf16, K4 / K4-AMP, K6 / K7
        assert on_card == ([0, 2 * n, 0, 0, n, n, 0, 2 * n + 1] if amp else
                           [2 * n, 0, n, n, 0, 0, 2 * n + 1, 0]) + \
            ([1, 0] if opt == "Adam" else [0, 1]), (i, on_card)
    plan = next(p for p in exe._cache.values() if p.graph is not None)
    assert plan.compiled_sigs == {"run"}
    for i, (r, e) in enumerate(zip(replayed, eager)):
        assert torch.equal(r[0], e[0]), (i, r[0], e[0])
        assert torch.equal(r[1], e[1]), i
    assert not torch.equal(replayed[2][1], replayed[3][1])
    assert not torch.equal(replayed[1][1], replayed[2][1])
    got, want = _params(main, scope), _params(main, eager_scope)
    for n in got:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.cuda
def test_cuda_replay_updates_the_scope_state_in_place(cuda_device,
                                                      monkeypatch):
    """From the capture on, the scope keeps its param tensors: a replay
    writes the new values into them (K6 in place); the optimizer table
    is built once, at capture, and kept by the plan."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup, loss = _train_program("Adam")
    exe, scope = _started(main, startup)
    feed = _feed(np.random.RandomState(0))
    built = []
    orig = topt.table_rows
    monkeypatch.setattr(topt, "table_rows", lambda *a, **kw: (
        built.append(1), orig(*a, **kw))[1])
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)  # eager
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)  # capture
    assert len(built) == 2
    name = main.global_block().all_parameters()[0].name
    held = scope.find_var(name)
    before = held.clone()
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert len(built) == 2  # replays build no table
    assert scope.find_var(name) is held
    assert not torch.equal(held, before)
    plan = next(p for p in exe._cache.values() if p.graph is not None)
    assert len(plan.graph.tables) == 1


@pytest.mark.cuda
def test_cuda_capture_out_of_memory_captures_once_more(cuda_device,
                                                      monkeypatch):
    """A capture whose step runs out of memory part way (inside an op's
    lowering, which wraps the error) hands the cached free blocks back
    and captures once more: the plan's graph took two attempts, holds
    one optimizer table, and its replays are the eager steps, bitwise."""
    from paddle_tpu_torch.core import registry

    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup, loss = _train_program("Adam")
    exe, scope = _started(main, startup)
    eager_scope = _clone_scope(scope)
    mul, failed = registry.get_op("mul"), []
    lowering = mul.lowering

    def out_of_memory_once(ctx, ins, attrs):
        if not failed and torch.cuda.is_current_stream_capturing():
            failed.append(1)
            raise torch.cuda.OutOfMemoryError("planted")
        return lowering(ctx, ins, attrs)

    monkeypatch.setattr(mul, "lowering", out_of_memory_once)
    for i in range(4):
        feed = _feed(np.random.RandomState(i))
        (got,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        (want,) = exe._run_eager(main, feed=feed, fetch_list=[loss],
                                 scope=eager_scope)
        assert got.tobytes() == want.tobytes(), i
    graph = next(p.graph for p in exe._cache.values()
                 if p.graph is not None)
    assert failed and graph.attempts == 2 and len(graph.tables) == 1
    got, want = _params(main, scope), _params(main, eager_scope)
    for n in got:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.cuda
def test_cuda_a_replaced_param_is_honoured(cuda_device, monkeypatch):
    """A param the user replaces between replays with a tensor of its
    shape and dtype is copied into the captured tensor: the next step
    reads it, as the eager step would, and the graph is kept."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup, loss = _train_program("SGD")
    exe, scope = _started(main, startup)
    eager_scope = _clone_scope(scope)
    feed = _feed(np.random.RandomState(0))
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        exe._run_eager(main, feed=feed, fetch_list=[loss], scope=eager_scope)
    name = main.global_block().all_parameters()[0].name
    held = scope.find_var(name)
    new = torch.full_like(held, 0.25)
    scope.set_var(name, new.clone())
    eager_scope.set_var(name, new.clone())
    graph = next(p.graph for p in exe._cache.values()
                 if p.graph is not None)
    (got,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    (want,) = exe._run_eager(main, feed=feed, fetch_list=[loss],
                             scope=eager_scope)
    np.testing.assert_array_equal(got, want)
    assert scope.find_var(name) is held  # the captured tensor, updated
    assert torch.equal(held, eager_scope.find_var(name))
    assert graph.adopted == 1
    assert next(p.graph for p in exe._cache.values()
                if p.graph is not None) is graph


@pytest.mark.cuda
def test_cuda_a_var_of_another_shape_or_dtype_recaptures(cuda_device):
    """A state var replaced by a tensor of another shape, then of another
    dtype, makes the next run capture the plan anew (a new graph, on the
    new tensor), and its answer is the eager step's; a tensor of the new
    shape and dtype is then copied in, with no capture."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4])
        block = main.global_block()
        block.create_var(name="w", shape=[4], dtype="float32",
                         persistable=True)
        y = block.create_var(name="y", shape=[-1, 4], dtype="float32")
        block.append_op(type="elementwise_mul",
                        inputs={"X": [x], "Y": [block.var("w")]},
                        outputs={"Out": [y]}, attrs={"axis": -1})
    exe = pt.Executor(pt.CUDAPlace(0))
    scope, eager_scope = pt.Scope(), pt.Scope()
    dev = torch.device("cuda", 0)
    feed = {"x": np.arange(8, dtype="float32").reshape(2, 4)}

    def step():
        (got,) = exe.run(main, feed=feed, fetch_list=["y"], scope=scope)
        (want,) = exe._run_eager(main, feed=feed, fetch_list=["y"],
                                 scope=eager_scope)
        np.testing.assert_array_equal(got, want)
        plan = next(iter(exe._cache.values()))
        return plan.graph, got

    def put(value):
        for sc in (scope, eager_scope):
            sc.set_var("w", value.clone())

    put(torch.arange(4, dtype=torch.float32, device=dev))
    step()  # eager
    g1, _ = step()  # captured
    put(torch.full((1,), 3.0, device=dev))  # another shape
    g2, got = step()
    assert g2 is not g1 and scope.find_var("w").shape == (1,)
    np.testing.assert_array_equal(got, feed["x"] * 3.0)
    put(torch.full((1,), 0.5, dtype=torch.float64, device=dev))
    g3, got = step()  # another dtype: the step's own type promotion
    assert g3 is not g2 and got.dtype == np.float64
    np.testing.assert_array_equal(got, feed["x"] * 0.5)
    put(torch.full((1,), 2.0, dtype=torch.float64, device=dev))
    g4, got = step()  # the captured shape and dtype: copied in
    assert g4 is g3 and g4.adopted == 1
    np.testing.assert_array_equal(got, feed["x"] * 2.0)


@pytest.mark.cuda
def test_cuda_plans_share_one_pool_and_alternate_bitwise(cuda_device,
                                                         monkeypatch):
    """Three plans of one executor (two fetch lists and a smaller batch)
    capture into one memory pool; run in turns on one scope they give,
    bit for bit, the eager step's losses and params, and copy no state
    when they switch (each reads the scope's tensors in place)."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup, loss = _train_program("Adam")
    exe, scope = _started(main, startup)
    eager_scope = _clone_scope(scope)
    name = main.global_block().all_parameters()[0].name
    feeds = [_feed(np.random.RandomState(i)) for i in range(3)]
    runs = [(feeds[0], [loss]), (feeds[1], [loss, name]),
            ({k: v[:2] for k, v in feeds[2].items()}, [loss])]
    for _ in range(3):
        for feed, fetch in runs:
            got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            want = exe._run_eager(main, feed=feed, fetch_list=fetch,
                                  scope=eager_scope)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    graphs = [p.graph for p in exe._cache.values() if p.graph is not None]
    assert len(graphs) == 3
    assert len({tuple(g.graph.pool()) for g in graphs}) == 1
    assert sum(g.adopted for g in graphs) == 0
    got_p, want_p = _params(main, scope), _params(main, eager_scope)
    for n in got_p:
        assert torch.equal(got_p[n], want_p[n]), n


@pytest.mark.cuda
def test_cuda_device_fetches_are_copies(cuda_device, monkeypatch):
    """A ``return_numpy=False`` fetch of a replay is unchanged by the
    next run (the graph overwrites its outputs, and the scope's params
    are updated in place)."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup, loss = _train_program("Adam")
    exe, scope = _started(main, startup)
    name = main.global_block().all_parameters()[0].name
    feeds = [_feed(np.random.RandomState(i)) for i in range(4)]
    for f in feeds[:2]:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    got = exe.run(main, feed=feeds[2], fetch_list=[loss, name], scope=scope,
                  return_numpy=False)
    exe.run(main, feed=feeds[2], fetch_list=[loss, name], scope=scope)
    kept = [t.clone() for t in got]
    exe.run(main, feed=feeds[3], fetch_list=[loss, name], scope=scope)
    for a, b in zip(got, kept):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_a_step_that_launches_nothing_replays(cuda_device):
    """A Program with no op (a fetch of scope state) captures an empty
    graph: its replays fetch the state, and no warning is raised."""
    main, startup, _ = _train_program("SGD")
    exe, scope = _started(main, startup)
    name = main.global_block().all_parameters()[0].name
    empty = pt.Program()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        outs = [exe.run(empty, fetch_list=[name], scope=scope)[0]
                for _ in range(3)]
    assert len([p for p in exe._cache.values() if p.graph is not None]) == 1
    for out in outs:
        np.testing.assert_array_equal(out, scope.find_var(name).cpu())


_HOST_SYNC_OP = "test_host_sync_scale"


def _register_host_sync_op():
    from paddle_tpu_torch.core.registry import has_op, register_op

    if not has_op(_HOST_SYNC_OP):
        @register_op(_HOST_SYNC_OP)
        def _host_sync(ctx, ins, attrs):
            x = ins["X"][0]
            return {"Out": [x * float(x.sum().item())]}


@pytest.mark.cuda
def test_cuda_capture_names_an_op_that_syncs_the_host(cuda_device):
    """An op that reads a value on the host (``.item()``) runs eagerly,
    and its plan's capture then raises, naming the op."""
    _register_host_sync_op()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4])
        y = main.global_block().create_var(name="synced", shape=[-1, 4],
                                           dtype="float32")
        main.global_block().append_op(type=_HOST_SYNC_OP,
                                      inputs={"X": [x]},
                                      outputs={"Out": [y]})
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    feed = {"x": np.ones((2, 4), "float32")}
    (first,) = exe.run(main, feed=feed, fetch_list=["synced"], scope=scope)
    np.testing.assert_array_equal(first, np.full((2, 4), 8.0, "float32"))
    with pytest.raises(RuntimeError, match=_HOST_SYNC_OP + ".*synced"):
        exe.run(main, feed=feed, fetch_list=["synced"], scope=scope)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("stacked,reduce", [(False, "last"), (True, "last"),
                                            (True, "mean"), (False, "sum")])
def test_cuda_run_repeated_equals_k_runs(cuda_device, monkeypatch, stacked,
                                         reduce):
    """``run_repeated(K=3)`` on the card (the eager first step, then
    replays) is bitwise K ``run`` calls from the same scope, RNG chain
    included; "mean" / "sum" reduce the K losses on the card."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup, loss = _train_program("Adam")
    exe, scope = _started(main, startup)
    other = _clone_scope(scope)
    feeds = [_feed(np.random.RandomState(i)) for i in range(3)]
    losses = [exe.run(main, feed=feeds[i] if stacked else feeds[0],
                      fetch_list=[loss], scope=scope, return_numpy=False)[0]
              for i in range(3)]
    window = ({k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
              if stacked else feeds[0])
    exe2 = pt.Executor(pt.CUDAPlace(0))
    (got,) = exe2.run_repeated(main, feed=window, fetch_list=[loss],
                               scope=other, steps=3, feed_stacked=stacked,
                               reduce_fetches=reduce, return_numpy=False)
    want = {"last": losses[2], "sum": losses[0] + losses[1] + losses[2],
            "mean": (losses[0] + losses[1] + losses[2]) / 3}[reduce]
    assert torch.equal(got, want), (got, want)
    got_p, want_p = _params(main, other), _params(main, scope)
    for n in got_p:
        assert torch.equal(got_p[n], want_p[n]), n
    assert torch.equal(other.find_var("@RNG_STATE@").get_state(),
                       scope.find_var("@RNG_STATE@").get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_cuda_predictor_replays_equal_eager_answers(cuda_device, monkeypatch,
                                                    tmp_path, amp):
    """The Predictor captures each warm-up bucket at load; its answers
    (replays) equal, bit for bit, the plan's eager step on the same
    padded feeds."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 11
    with pt.program_guard(main, startup), pt.unique_name.guard():
        tbert.build(CFG, seq_len=S, is_test=True)
    if amp:
        main.set_amp(True)
    gather = next(op for op in main.global_block().ops
                  if op.type == "gather")
    out = next(op for op in main.global_block().ops
               if op.type == "reshape2" and
               gather.input("X")[0] in op.output("Out")).input("X")[0]
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    names = ["src_ids", "sent_ids", "input_mask"]
    with pt.scope_guard(scope):
        exe.run(startup)
        pt.io.save_inference_model(str(tmp_path), names,
                                   [main.global_block().var(out)], exe,
                                   main_program=main)
    config = pt.inference.AnalysisConfig(str(tmp_path))
    config.warmup_batch_sizes = [1, 4]
    pred = pt.inference.create_paddle_predictor(config)
    graphs = [p.graph for p in pred._exe._cache.values()]
    assert len(graphs) == 2 and all(g is not None for g in graphs)
    for b, bucket in ((1, 1), (3, 4)):
        feed = {k: v[:b] for k, v in _feed(np.random.RandomState(b)).items()
                if k in names}
        (got,) = pred.run(feed)
        padded = {k: np.concatenate([v, np.zeros((bucket - b,) + v.shape[1:],
                                                  v.dtype)])
                  for k, v in feed.items()}
        (want,) = pred._exe._run_eager(pred.program, feed=padded,
                                       fetch_list=pred.fetch_names,
                                       scope=pred.scope)
        np.testing.assert_array_equal(got, want[:b])


# ------------------------------------------------------------ the step loop
def _loop_values(exe, main, fetch, scope, feeds, k, **kw):
    seen = {}
    n, _ = exe.train_loop(main, iter(feeds), fetch_list=fetch, scope=scope,
                          steps_per_call=k,
                          on_step=lambda i, v: seen.__setitem__(i, v), **kw)
    assert n == len(feeds)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4])
def test_cuda_train_loop_is_bitwise_the_run_loop(cuda_device, monkeypatch,
                                                 k):
    """``train_loop`` on the card (the prefetch thread's stream, fetch
    handles copied on the compute stream, nothing waiting for the card
    but the in-flight cap) takes the run loop's steps bitwise: losses,
    dropout masks, params and the RNG chain over 6 steps (at K = 4 a
    window and a ragged tail of 2), with the run loop's launches on the
    card."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup, loss = _train_program("Adam")
    exe, scope = _started(main, startup)
    other = _clone_scope(scope)
    mask = _dropout_mask(main)
    feeds = [_feed(np.random.RandomState(i)) for i in range(6)]
    want, on_card = _device_launches(lambda: [
        exe.run(main, feed=f, fetch_list=[loss, mask], scope=scope)
        for f in feeds])
    exe2 = pt.Executor(pt.CUDAPlace(0))
    got, on_card2 = _device_launches(lambda: _loop_values(
        exe2, main, [loss, mask], other, feeds, k, max_in_flight=2,
        prefetch_depth=2))
    assert on_card2 == on_card
    assert sorted(got) == (list(range(6)) if k == 1 else [3, 4, 5])
    for i, vals in got.items():
        for a, b in zip(vals, want[i]):
            assert a.tobytes() == b.tobytes(), i
    got_p, want_p = _params(main, other), _params(main, scope)
    for n in got_p:
        assert torch.equal(got_p[n], want_p[n]), n
    assert torch.equal(other.find_var("@RNG_STATE@").get_state(),
                       scope.find_var("@RNG_STATE@").get_state())


@pytest.mark.cuda
def test_cuda_capture_with_the_fill_thread_mid_copy(cuda_device,
                                                    monkeypatch):
    """The plan captures at its second step while the prefetch thread
    allocates pinned and device memory and copies on its own stream (the
    capture waits until it is copying, and the thread copies until the
    capture ends): the capture's thread-local mode lets it, and the
    steps are the run loop's, bitwise."""
    import threading

    from paddle_tpu_torch.core import cuda_graph
    from paddle_tpu_torch.core.pipeline import DevicePrefetcher

    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup, loss = _train_program("Adam")
    exe, scope = _started(main, startup)
    other = _clone_scope(scope)
    feeds = [_feed(np.random.RandomState(i)) for i in range(5)]
    want = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
            for f in feeds]
    copying, captured = threading.Event(), threading.Event()
    batches, copies = [0], [0]
    to_device = DevicePrefetcher._to_device

    def busy_to_device(self, feed):
        out = to_device(self, feed)
        batches[0] += 1
        if batches[0] > 2:  # converted while steps 0 and 1 run
            with torch.cuda.stream(self._stream):
                while not captured.is_set() and copies[0] < 20000:
                    # fresh pinned and device blocks of changing sizes
                    n = (1 << 16) + 4096 * (copies[0] % 64)
                    torch.empty(n, pin_memory=True).to(self._device,
                                                       non_blocking=True)
                    copies[0] += 1
                    copying.set()
        return out

    init = cuda_graph.StepGraph.__init__

    def capture_mid_copy(self, *a, **kw):
        assert copying.wait(30), "the fill thread never copied"
        try:
            init(self, *a, **kw)
        finally:
            captured.set()

    monkeypatch.setattr(DevicePrefetcher, "_to_device", busy_to_device)
    monkeypatch.setattr(cuda_graph.StepGraph, "__init__", capture_mid_copy)
    exe2 = pt.Executor(pt.CUDAPlace(0))
    got = _loop_values(exe2, main, [loss], other, feeds, 1, max_in_flight=2,
                       prefetch_depth=2)
    assert captured.is_set() and copies[0] > 0
    for i in range(5):
        assert got[i][0].tobytes() == want[i].tobytes(), i
    got_p, want_p = _params(main, other), _params(main, scope)
    for n in got_p:
        assert torch.equal(got_p[n], want_p[n]), n


@pytest.mark.cuda
def test_cuda_handles_survive_later_replays(cuda_device, monkeypatch):
    """Every handle of a pipelined run, resolved only after the last
    step, holds its own step's loss and param value (a replay overwrites
    its outputs and K6 writes params in place; the handle took copies on
    the compute stream before the next step), device tensors and numpy
    alike."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup, loss = _train_program("Adam")
    exe, scope = _started(main, startup)
    other = _clone_scope(scope)
    param = main.global_block().all_parameters()[0].name
    feeds = [_feed(np.random.RandomState(i)) for i in range(5)]
    want = [[v.copy() for v in exe.run(main, feed=f,
                                       fetch_list=[loss, param],
                                       scope=scope)]
            for f in feeds]
    exe2 = pt.Executor(pt.CUDAPlace(0))
    for return_numpy in (False, True):
        sc = _clone_scope(other)
        handles = list(exe2.run_pipelined(
            main, iter(feeds), fetch_list=[loss, param], scope=sc,
            max_in_flight=len(feeds), return_numpy=return_numpy))
        for i, h in enumerate(handles):
            vals = h.result()
            if not return_numpy:
                assert all(v.device.type == "cuda" for v in vals)
                vals = [v.cpu().numpy() for v in vals]
            for a, b in zip(vals, want[i]):
                assert a.tobytes() == b.tobytes(), (return_numpy, i)


def _scheduled_program():
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 11
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = tbert.build(CFG, seq_len=S, max_mask=M)
        lr = pt.layers.linear_lr_warmup(
            pt.layers.polynomial_decay(1e-3, 20, 0.0, 1.0), 4, 0.0, 1e-3)
        pt.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, lr


@pytest.mark.cuda
def test_cuda_schedule_under_replay(cuda_device, monkeypatch):
    """The warm-up + decay rate of replayed steps is its closed form and
    the CPU's (the same f32 ops, to a relative 1e-6); the step counter is
    state the graph writes back each replay; and the replays are bitwise
    the plan's eager steps, rates and params, so each replay's K6 read
    that step's rate through its device pointer."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup, loss, lr = _scheduled_program()
    exe, scope = _started(main, startup)
    eager_scope = _clone_scope(scope)
    cpu_exe, cpu_scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    feeds = [_feed(np.random.RandomState(i)) for i in range(6)]
    rates = [exe.run(main, feed=f, fetch_list=[lr], scope=scope)[0]
             for f in feeds]
    eager = [exe._run_eager(main, feed=f, fetch_list=[lr],
                            scope=eager_scope)[0] for f in feeds]
    cpu = [cpu_exe.run(main, feed=f, fetch_list=[lr], scope=cpu_scope)[0]
           for f in feeds]
    assert any(p.graph is not None for p in exe._cache.values())
    closed = [1e-3 * (2 * s + 2) / 4 if 2 * s + 2 < 4
              else 1e-3 * (1 - (2 * s + 1) / 20) for s in range(6)]
    for s, (a, b, c) in enumerate(zip(rates, eager, cpu)):
        assert a.tobytes() == b.tobytes(), s
        np.testing.assert_allclose(a, c, rtol=1e-6, atol=0)
        np.testing.assert_allclose(float(a.reshape(())), closed[s],
                                   rtol=1e-6)
    assert float(scope.find_var("@LR_DECAY_COUNTER@").reshape(())) == 12.0
    got, want = _params(main, scope), _params(main, eager_scope)
    for n in got:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.cuda
def test_cuda_recompute_replays_equal_eager_steps(cuda_device, monkeypatch):
    """A RecomputeOptimizer program (a checkpoint per encoder layer,
    dropout 0.1): replayed steps are bitwise the plan's eager steps (the
    grads' re-run draws the forward's dropout streams under replay too)
    and each launches the flash kernels as the plain program does."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 11
    with pt.program_guard(main, startup), pt.unique_name.guard():
        ckpts = []
        loss, _ = tbert.build(CFG, seq_len=S, max_mask=M, checkpoints=ckpts)
        opt = pt.optimizer.RecomputeOptimizer(
            pt.optimizer.Adam(learning_rate=1e-3))
        opt._set_checkpoints(ckpts)
        opt.minimize(loss)
    exe, scope = _started(main, startup)
    eager_scope = _clone_scope(scope)
    n = CFG["n_layer"]
    for i in range(4):
        f = _feed(np.random.RandomState(i))
        r, on_card = _device_launches(lambda: exe.run(
            main, feed=f, fetch_list=[loss], scope=scope))
        e = exe._run_eager(main, feed=f, fetch_list=[loss],
                           scope=eager_scope)
        assert r[0].tobytes() == e[0].tobytes(), i
        assert on_card[:6] == [2 * n, 0, n, n, 0, 0], (i, on_card)
    got, want = _params(main, scope), _params(main, eager_scope)
    for p in got:
        assert torch.equal(got[p], want[p]), p


@pytest.mark.cuda
def test_cuda_a_var_replaced_in_on_step_is_honoured(cuda_device,
                                                    monkeypatch):
    """A param the ``on_step`` callback replaces (a new tensor of its
    shape) is copied into the graph's tensor before the next step that
    was not yet enqueued: bitwise the run loop that replaces it at the
    same point."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup, loss = _train_program("Adam")
    exe, scope = _started(main, startup)
    other = _clone_scope(scope)
    param = main.global_block().all_parameters()[0].name
    feeds = [_feed(np.random.RandomState(i)) for i in range(6)]
    for i, f in enumerate(feeds):
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        if i == 2:  # step 1 resolves after step 2 is enqueued
            scope.set_var(param, torch.zeros_like(scope.find_var(param)))

    def on_step(i, vals):
        if i == 1:
            other.set_var(param, torch.zeros_like(other.find_var(param)))

    exe2 = pt.Executor(pt.CUDAPlace(0))
    exe2.train_loop(main, iter(feeds), fetch_list=[loss], scope=other,
                    max_in_flight=1, on_step=on_step)
    got, want = _params(main, other), _params(main, scope)
    for p in got:
        assert torch.equal(got[p], want[p]), p


# ------------------------------------------------ GPT and its decoding
GPT_CFG = dict(d_model=128, d_ff=256, n_head=2, n_layer=2, vocab=100,
               max_length=64, dropout=0.1)


def _gpt_train_program(cfg, seq_len):
    from paddle_tpu_torch.models import gpt

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 11
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = gpt.build(cfg, seq_len=seq_len)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def _gpt_ids(rs, batch, seq_len, vocab):
    ids = rs.randint(1, vocab, (batch, seq_len)).astype("int64")
    ids[0, seq_len - seq_len // 10:] = 0  # trailing padding
    return {"ids": ids}


@pytest.mark.cuda
def test_cuda_gpt_replayed_steps_equal_eager_steps(cuda_device, monkeypatch):
    """GPT's training steps 2-4 are replays of the plan's graph, bitwise
    the plan's eager step from the same scope (dropout 0.1, causal flash
    attention with the pad-row bias), with the eager step's launches on
    the card: the flash forward 2 a layer, dK/dV and dQ 1, K4 2 a layer,
    K6 once."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup, loss = _gpt_train_program(GPT_CFG, 48)
    exe, scope = _started(main, startup)
    eager_scope = _clone_scope(scope)
    n = GPT_CFG["n_layer"]
    for i in range(4):
        f = _gpt_ids(np.random.RandomState(i), 3, 48, GPT_CFG["vocab"])
        r, on_card = _device_launches(lambda: exe.run(
            main, feed=f, fetch_list=[loss], scope=scope,
            return_numpy=False)[0])
        e, on_card_e = _device_launches(lambda: exe._run_eager(
            main, feed=f, fetch_list=[loss], scope=eager_scope,
            return_numpy=False)[0])
        assert on_card == on_card_e == [2 * n, 0, n, n, 0, 0, 2 * n, 0, 1,
                                        0], (i, on_card)
        assert torch.equal(r, e), (i, r, e)
    plan = next(p for p in exe._cache.values() if p.graph is not None)
    assert plan.compiled_sigs == {"run"}
    got, want = _params(main, scope), _params(main, eager_scope)
    for name in got:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.cuda
def test_cuda_causal_flash_kernels_at_1024_inside_the_graph(cuda_device,
                                                           monkeypatch):
    """At S = 1024 (the static threshold picks flash) a replayed GPT step
    runs K1 twice, K2 and K3 once, causal, inside the graph; its loss is
    the eager step's and, within f32 rounding, the composed attention's
    (the causal mask folded into a dense bias)."""
    cfg = dict(GPT_CFG, n_layer=1, max_length=1024, dropout=0.0)
    main, startup, loss = _gpt_train_program(cfg, 1024)
    exe, scope = _started(main, startup)
    snap = _clone_scope(scope)
    feed = _gpt_ids(np.random.RandomState(0), 2, 1024, cfg["vocab"])
    losses = []
    for _ in range(3):
        r, on_card = _device_launches(lambda: exe.run(
            main, feed=feed, fetch_list=[loss], scope=_clone_scope(snap),
            return_numpy=False)[0])
        losses.append(r)
        assert on_card[:4] == [2, 0, 1, 1], on_card
    plan = next(p for p in exe._cache.values() if p.graph is not None)
    assert plan.graph is not None
    assert torch.equal(losses[1], losses[2])
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "100000")
    composed, on_card = _device_launches(lambda: exe._run_eager(
        main, feed=feed, fetch_list=[loss], scope=_clone_scope(snap),
        return_numpy=False)[0])
    assert on_card[:6] == [0] * 6
    assert torch.equal(losses[0], losses[2])
    torch.testing.assert_close(losses[2], composed, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_cuda_decode_replays_write_the_cache_in_place(cuda_device):
    """``generate`` with a prefill and a decode program on one scope:
    from their second run on both plans replay their graphs, which hold
    the scope's cache tensors and write them in place (no copy in, the
    same objects), the decode graph reading what the prefill wrote; the
    tokens equal an executor's that never replays (``_run_eager``)."""
    from paddle_tpu_torch.models import gpt

    cfg = dict(GPT_CFG, dropout=0.0)
    dec, dstart = pt.Program(), pt.Program()
    with pt.program_guard(dec, dstart), pt.unique_name.guard():
        logits, caches = gpt.build_decode_step(cfg, batch=2, max_len=32)
    pre, pstart = pt.Program(), pt.Program()
    with pt.program_guard(pre, pstart), pt.unique_name.guard():
        plogits, _ = gpt.build_prefill_step(cfg, batch=2, prompt_len=6,
                                            max_len=32)
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe.run(dstart, scope=scope)
    exe.run(pstart, scope=scope)
    eager_scope = _clone_scope(scope)
    held = [scope.find_var(c) for c in caches]
    prompt = np.random.RandomState(1).randint(1, 100, (2, 6)).astype("int64")

    class Eager:
        run = staticmethod(exe._run_eager)

    kw = dict(prefill_prog=pre, prefill_logits=plogits)
    want = gpt.generate(Eager, dec, logits, prompt, 8, eager_scope, **kw)
    for _ in range(3):
        got = gpt.generate(exe, dec, logits, prompt, 8, scope, **kw)
        np.testing.assert_array_equal(got, want)
    plans = [p for p in exe._cache.values() if p.graph is not None]
    assert len(plans) == 2
    for p in plans:
        assert p.graph.adopted == 0
        for c, t in zip(caches, held):
            assert p.graph.state[c] is t and scope.find_var(c) is t
    rows = (held[0].abs().sum(dim=(0, 1, 3)) > 0).nonzero().flatten()
    assert rows.tolist() == list(range(6 + 8 - 1))


@pytest.mark.cuda
def test_cuda_ids_past_the_table_give_nan_rows_in_a_captured_step(
        cuda_device):
    """C8 on the card: ids past the table's rows give NaN rows and take
    no grad inside a captured step (no device assert), -1 wraps; the
    replays give the eager step's values."""
    from paddle_tpu_torch.core.backward import append_backward

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        ids = pt.layers.data("ids", [3], dtype="int64")
        emb = pt.layers.embedding(ids, [6, 4],
                                  param_attr=pt.ParamAttr(name="emb"))
        append_backward(pt.layers.reduce_sum(emb))
    exe, scope = _started(main, startup)
    feed = {"ids": np.array([[1, 6, 2], [11, 1, -1]], "int64")}
    outs = [exe.run(main, feed=feed, fetch_list=[emb, "emb@GRAD"],
                    scope=scope) for _ in range(3)]
    torch.cuda.synchronize()
    for out, g in outs:
        assert np.isnan(out[0, 1]).all() and np.isnan(out[1, 0]).all()
        assert np.isfinite(out[0, [0, 2]]).all()
        np.testing.assert_array_equal(out[1, 2],
                                      scope.find_var("emb").cpu()[5].numpy())
        want = np.zeros((6, 4), "float32")
        for i in (1, 2, 1, 5):
            want[i] += 1.0
        np.testing.assert_array_equal(g, want)
    plan = next(p for p in exe._cache.values() if p.graph is not None)
    assert plan.compiled_sigs == {"run"}


# ------------------------------------------------- image classification
def _lower(op_type, ins, attrs, dev, rng=None):
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.core.registry import get_op

    ctx = LowerContext(None, rng, dev)
    return get_op(op_type).lowering(
        ctx, {k: [v.to(dev) for v in vs] for k, vs in ins.items()},
        dict(attrs))


def _image_op_cases():
    g = torch.Generator().manual_seed(3)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x = rnd(4, 8, 15, 14)
    probs = torch.softmax(rnd(16, 10), -1)
    label = torch.randint(0, 10, (16, 1), generator=g, dtype=torch.int32)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :5]
    bn = lambda c: {"Scale": [rnd(c)], "Bias": [rnd(c)],  # noqa: E731
                    "Mean": [rnd(c)], "Variance": [rnd(c).abs() + 0.5]}
    return [
        ("conv2d", {"Input": [x], "Filter": [rnd(6, 8, 3, 3)]},
         {"strides": [2, 1], "paddings": [1, 1]}, 1e-4),
        ("conv2d", {"Input": [x], "Filter": [rnd(8, 2, 3, 3)]},
         {"paddings": [2, 2], "dilations": [2, 2], "groups": 4}, 1e-4),
        ("pool2d", {"X": [x]}, {"pooling_type": "max", "ksize": [3, 3],
                                "strides": [2, 2], "paddings": [1, 1]}, 0),
        ("pool2d", {"X": [x]}, {"pooling_type": "avg", "ksize": [3, 3],
                                "strides": [2, 2], "paddings": [1, 1]},
         1e-6),
        ("pool2d", {"X": [x]}, {"pooling_type": "avg",
                                "global_pooling": True}, 1e-6),
        ("batch_norm", dict(bn(8), X=[x]), {}, 1e-4),
        ("batch_norm", dict(bn(8), X=[x]), {"is_test": True}, 1e-6),
        ("batch_norm", dict(bn(14), X=[x]), {"data_layout": "NHWC"}, 1e-4),
        ("cross_entropy", {"X": [probs], "Label": [label]}, {}, 1e-6),
        ("top_k", {"X": [probs]}, {"k": 5}, 0),
        ("accuracy", {"Out": [probs[:, :5]], "Indices": [order.int()],
                      "Label": [label]}, {}, 0),
        ("auc", {"Predict": [probs[:, :2]], "Label": [label % 2],
                 "StatPos": [torch.zeros(51, dtype=torch.int32)],
                 "StatNeg": [torch.zeros(51, dtype=torch.int32)]},
         {"num_thresholds": 50}, 1e-6),
        ("precision_recall", {"Indices": [order[:, :1].int()],
                              "Label": [label]}, {"class_number": 10}, 1e-6),
    ]


@pytest.mark.cuda
def test_cuda_image_ops_match_the_cpu(cuda_device):
    """Each image-classification lowering on the card against the same
    lowering on the CPU, and conv2d's and batch_norm's grads too."""
    from paddle_tpu_torch.core.autodiff import (ATTR_DIFF, ATTR_FWD_IN,
                                                ATTR_FWD_OUT)
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.core.registry import get_op

    cpu = torch.device("cpu")
    for op_type, ins, attrs, atol in _image_op_cases():
        got = _lower(op_type, ins, attrs, cuda_device)
        want = _lower(op_type, ins, attrs, cpu)
        for slot, vals in want.items():
            for a, b in zip(vals, got[slot]):
                assert b.device.type == "cuda" and b.dtype == a.dtype
                torch.testing.assert_close(b.cpu(), a, atol=atol, rtol=0,
                                           msg=lambda m: "%s %s %s" % (
                                               op_type, slot, m))
        if op_type not in ("conv2d", "batch_norm"):
            continue
        diff = ([("Input", 0), ("Filter", 0)] if op_type == "conv2d" else
                [("X", 0), ("Scale", 0), ("Bias", 0)])
        out_slot = "Output" if op_type == "conv2d" else "Y"
        gattrs = dict(attrs, **{ATTR_FWD_IN: {k: 1 for k in ins},
                                ATTR_FWD_OUT: {k: 1 for k in want},
                                ATTR_DIFF: [list(d) for d in diff]})
        cot = torch.randn(want[out_slot][0].shape,
                          generator=torch.Generator().manual_seed(4))
        gins = dict(ins, **{k: v for k, v in want.items()},
                    **{out_slot + "@GRAD": [cot]})
        grads = [get_op(op_type + "_grad").lowering(
            LowerContext(None, None, dev),
            {k: [v.to(dev) for v in vs] for k, vs in gins.items()},
            dict(gattrs)) for dev in (cpu, cuda_device)]
        for slot, i in diff:
            torch.testing.assert_close(grads[1][slot + "@GRAD"][i].cpu(),
                                       grads[0][slot + "@GRAD"][i],
                                       atol=1e-4, rtol=1e-4)
    # gaussian_random on the card: its shape, moments and seed
    rng = torch.Generator().manual_seed(5)
    attrs = {"shape": [512, 256], "mean": 1.0, "std": 3.0, "seed": 0}
    a = _lower("gaussian_random", {}, attrs, cuda_device, rng)["Out"][0]
    assert a.device.type == "cuda" and tuple(a.shape) == (512, 256)
    assert abs(float(a.mean()) - 1.0) < 0.05
    assert abs(float(a.std()) - 3.0) < 0.05
    seeded = [_lower("gaussian_random", {}, dict(attrs, seed=7),
                     cuda_device, torch.Generator().manual_seed(i))["Out"][0]
              for i in (1, 2)]
    assert torch.equal(seeded[0], seeded[1])


@pytest.mark.cuda
def test_cuda_top_k_ties_put_the_lower_index_first(cuda_device):
    """Rows of 1000 values from 4 levels (hundreds of ties each): the k
    largest and their indices on the card, the lower index first among
    equal values, as ``lax.top_k`` orders them (a stable sort on the
    host is the reference)."""
    x = torch.randint(0, 4, (32, 1000),
                      generator=torch.Generator().manual_seed(6)).float()
    out = _lower("top_k", {"X": [x]}, {"k": 5}, cuda_device)
    want = np.argsort(-x.numpy(), axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(out["Indices"][0].cpu().numpy(), want)
    assert out["Indices"][0].dtype == torch.int32


@pytest.mark.cuda
def test_cuda_conv_step_is_bitwise_repeatable(cuda_device):
    """A conv's forward and its grads (the op's grad lowering, under the
    port's cuDNN flags) twice on the same inputs: the same bits."""
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.core.registry import get_op

    g = torch.Generator().manual_seed(7)
    x = torch.randn(16, 64, 28, 28, generator=g).to(cuda_device)
    w = torch.randn(64, 64, 3, 3, generator=g).to(cuda_device) * 0.05
    cot = torch.randn(16, 64, 28, 28, generator=g).to(cuda_device)
    attrs = {"paddings": [1, 1]}
    ctx = LowerContext(None, None, cuda_device)
    runs = []
    for _ in range(2):
        y = get_op("conv2d").lowering(ctx, {"Input": [x], "Filter": [w]},
                                      dict(attrs))["Output"][0]
        gr = get_op("conv2d").grad_lowering(
            ctx, {"Input": [x], "Filter": [w], "Output@GRAD": [cot]},
            dict(attrs))
        runs.append((y, gr["Input@GRAD"][0], gr["Filter@GRAD"][0]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_resnet_replayed_steps_equal_eager_steps(cuda_device):
    """A ResNet-50 at 32 x 32 (batch 4, Adam): steps 2-4 are replays of
    the plan's graph, bitwise the plan's eager step from the same scope,
    params and the batch norms' running stats (written by batch_norm,
    not by the optimizer) included; each step runs K6 once on the card
    and no other kernel of the port."""
    from paddle_tpu_torch.models import resnet

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 11
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _, _ = resnet.build(class_dim=10, depth=50,
                                  image_shape=(3, 32, 32))
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    stats = [n for op in main.global_block().ops if op.type == "batch_norm"
             for n in op.input("Mean") + op.input("Variance")]
    exe, scope = _started(main, startup)
    eager_scope = _clone_scope(scope)
    start = {n: scope.find_var(n).clone() for n in stats}
    for i in range(4):
        rs = np.random.RandomState(i)
        f = {"img": rs.randn(4, 3, 32, 32).astype("float32"),
             "label": rs.randint(0, 10, (4, 1)).astype("int64")}
        r, on_card = _device_launches(lambda: exe.run(
            main, feed=f, fetch_list=[loss], scope=scope,
            return_numpy=False)[0])
        e, on_card_e = _device_launches(lambda: exe._run_eager(
            main, feed=f, fetch_list=[loss], scope=eager_scope,
            return_numpy=False)[0])
        assert on_card == on_card_e == [0] * 8 + [1, 0], (i, on_card)
        assert torch.equal(r, e), (i, r, e)
    plan = next(p for p in exe._cache.values() if p.graph is not None)
    assert plan.compiled_sigs == {"run"}
    got, want = _params(main, scope), _params(main, eager_scope)
    for name in got:
        assert torch.equal(got[name], want[name]), name
    for n in stats:
        assert torch.equal(scope.find_var(n), eager_scope.find_var(n)), n
        assert not torch.equal(scope.find_var(n), start[n]), n


# ------------------------------------- optimizers, checkpoints and serving
def _opt_case(op_type, dev, rs):
    """Seeded inputs of one update of ``op_type`` on ``dev`` and its
    attrs (the variants of tests/test_torch_optimizer_ops.py)."""
    shape = (300, 257)

    def t(positive=False, scale=1.0):
        a = rs.randn(*shape).astype("float32") * scale
        return torch.from_numpy(np.abs(a) + 0.1 if positive else a).to(dev)

    lr = torch.tensor([0.05], device=dev)
    pw = lambda v: torch.tensor([v], device=dev)  # noqa: E731
    cases = {
        "lars_momentum": ({"Param": t(), "Grad": t(), "Velocity": t(),
                           "LearningRate": lr}, dict(mu=0.9)),
        "adamax": ({"Param": t(), "Grad": t(), "Moment": t(),
                    "InfNorm": t(True), "Beta1Pow": pw(0.729),
                    "LearningRate": lr}, {}),
        "adagrad": ({"Param": t(), "Grad": t(), "Moment": t(True),
                     "LearningRate": lr}, {}),
        "decayed_adagrad": ({"Param": t(), "Grad": t(), "Moment": t(True),
                             "LearningRate": lr}, {}),
        "adadelta": ({"Param": t(), "Grad": t(), "AvgSquaredGrad": t(True),
                      "AvgSquaredUpdate": t(True)}, {}),
        # centered needs MeanSquare - MeanGrad^2 + eps > 0
        "rmsprop": ({"Param": t(), "Grad": t(), "MeanSquare": t(True),
                     "Moment": t(), "MeanGrad": t(scale=0.01),
                     "LearningRate": lr}, dict(centered=True, momentum=0.5)),
        "ftrl": ({"Param": t(), "Grad": t(), "SquaredAccumulator": t(True),
                  "LinearAccumulator": t(), "LearningRate": lr},
                 dict(l1=0.5, l2=0.1, lr_power=-0.6)),
        "lamb": ({"Param": t(), "Grad": t(), "Moment1": t(),
                  "Moment2": t(True), "Beta1Pow": pw(0.81),
                  "Beta2Pow": pw(0.998), "LearningRate": lr}, {}),
    }
    if op_type == "average_accumulates":
        zeros = torch.zeros(shape, device=dev)
        i32 = lambda v: torch.tensor([v], dtype=torch.int32,  # noqa: E731
                                     device=dev)
        return ({"param": t(), "in_sum_1": t(), "in_sum_2": zeros,
                 "in_sum_3": zeros, "in_num_accumulates": i32(2),
                 "in_old_num_accumulates": i32(0),
                 "in_num_updates": i32(16383)},
                dict(average_window=0.5, min_average_window=2,
                     max_average_window=3))
    return cases[op_type]


@pytest.mark.cuda
@pytest.mark.parametrize("op_type", [
    "lars_momentum", "adamax", "adagrad", "decayed_adagrad", "adadelta",
    "rmsprop", "ftrl", "lamb", "average_accumulates"])
def test_cuda_optimizer_lowering_matches_the_cpu(cuda_device, op_type):
    """Each of the nine lowerings on the card against the CPU on the same
    inputs (N(0, 1) params and grads, lr 0.05): each float output within
    2e-6 of its largest magnitude (a param minus its update can cancel,
    so an operand's one-ulp difference shows against a small result),
    1e-5 for the norms' reductions (lars_momentum, lamb);
    average_accumulates bitwise."""
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.core.registry import get_op

    ins, attrs = _opt_case(op_type, cuda_device, np.random.RandomState(0))
    lower = get_op(op_type).lowering
    got = lower(LowerContext(None, None, cuda_device),
                {k: [v] for k, v in ins.items()}, dict(attrs))
    want = lower(LowerContext(None, None, torch.device("cpu")),
                 {k: [v.cpu()] for k, v in ins.items()}, dict(attrs))
    assert sorted(got) == sorted(want)
    share = 1e-5 if op_type in ("lars_momentum", "lamb") else 2e-6
    for slot in want:
        g, w = got[slot][0].cpu(), want[slot][0]
        if op_type == "average_accumulates":
            assert torch.equal(g, w), slot
        else:
            assert bool(torch.isfinite(w).all()), slot
            scale = float(w.abs().max())
            diff = float((g - w).abs().max())
            assert diff <= share * scale, (slot, diff, scale)


def _mlp_program(opt):
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.layers.data("x", [64], dtype="float32")
        y = pt.layers.data("y", [1], dtype="float32")
        h = pt.layers.dropout(pt.layers.fc(x, 128, act="relu"),
                              dropout_prob=0.1)
        loss = pt.layers.mean(pt.layers.square(pt.layers.fc(h, 1) - y))
        opt.minimize(loss)
    return main, startup, loss


def _mlp_feed(i):
    rs = np.random.RandomState(i)
    return {"x": rs.randn(32, 64).astype("float32"),
            "y": rs.randn(32, 1).astype("float32")}


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["Lamb", "LarsMomentum", "RMSProp"])
def test_cuda_new_optimizers_replay_bitwise_eager(cuda_device, opt):
    """Their updates take no host sync: steps 2-4 are replays of the
    plan's graph, bitwise the eager step's from the same scope."""
    kw = dict(momentum=0.9) if opt == "LarsMomentum" else {}
    main, startup, loss = _mlp_program(
        getattr(pt.optimizer, opt)(learning_rate=1e-3, **kw))
    exe, scope = _started(main, startup)
    eager_scope = _clone_scope(scope)
    for i in range(4):
        r = exe.run(main, feed=_mlp_feed(i), fetch_list=[loss], scope=scope)
        e = exe._run_eager(main, feed=_mlp_feed(i), fetch_list=[loss],
                           scope=eager_scope)
        np.testing.assert_array_equal(r[0], e[0])
    assert any(p.graph is not None for p in exe._cache.values())
    for v in main.list_vars():
        if v.persistable:
            assert torch.equal(scope.find_var(v.name),
                               eager_scope.find_var(v.name)), v.name


@pytest.mark.cuda
def test_cuda_async_snapshot_is_not_torn_by_the_next_replay(cuda_device,
                                                            tmp_path):
    """``save_persistables_async`` copies every value off the card
    before it returns: replayed steps that overwrite the scope's tensors
    in place right after it leave the file at the call's state, and the
    RNG chain saved beside it resumes the dropout masks bitwise."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core.executor import RNG_VAR
    from paddle_tpu_torch.native.tensor_store import load_tensors

    main, startup, loss = _mlp_program(pt.optimizer.Adam(1e-3))
    exe, scope = _started(main, startup)
    for i in range(3):  # eager, capture, replay
        exe.run(main, feed=_mlp_feed(i), fetch_list=[loss], scope=scope)
    snap = {v.name: scope.find_var(v.name).clone()
            for v in main.list_vars() if v.persistable}
    ckpt = io.save_persistables_async(exe, str(tmp_path / "ck"), main,
                                      scope=scope, extra_vars=[RNG_VAR])
    later = [exe.run(main, feed=_mlp_feed(3 + i), fetch_list=[loss],
                     scope=scope)[0] for i in range(3)]
    ckpt.wait()
    saved = load_tensors(str(tmp_path / "ck" / "__model_combined__"))
    for n, v in snap.items():
        np.testing.assert_array_equal(saved[n], v.cpu().numpy(), err_msg=n)
    params = [p.name for p in main.global_block().all_parameters()]
    assert all(not torch.equal(scope.find_var(n), snap[n]) for n in params)
    exe2, fresh = _started(main, startup)
    io.load_persistables(exe2, str(tmp_path / "ck"), main, scope=fresh)
    io.load_vars(exe2, str(tmp_path / "ck"), main, vars=[RNG_VAR],
                 scope=fresh)
    resumed = [exe2.run(main, feed=_mlp_feed(3 + i), fetch_list=[loss],
                        scope=fresh)[0] for i in range(3)]
    np.testing.assert_array_equal(np.stack(resumed), np.stack(later))


@pytest.mark.cuda
def test_cuda_engine_replays_with_its_splices_in_place(cuda_device):
    """A small GPT engine on the card: requests of one prompt length
    admitted over time, so the prefill and decode plans are replays of
    their graphs; the splices write the very cache tensors the graphs
    hold (no state copied in), and every request's tokens equal
    ``generate()``'s for it alone on the card."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeEngine

    cfg = dict(d_model=64, d_ff=128, n_head=2, n_layer=2, vocab=97,
               max_length=64, dropout=0.0)
    prog, start = pt.Program(), pt.Program()
    with pt.program_guard(prog, start):
        logits, caches = gpt.build_decode_step(cfg, batch=1, max_len=64)
    pre, pstart = pt.Program(), pt.Program()
    with pt.program_guard(pre, pstart):
        plogits, _ = gpt.build_prefill_step(cfg, batch=1, prompt_len=6,
                                            max_len=64)
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe.run(start, scope=scope)
    exe.run(pstart, scope=scope)
    params = {n: scope.find_var(n).clone() for n in prog.global_block().vars
              if n.startswith("gpt_") and n not in caches}
    for n, v in params.items():
        scope.set_var(n, v.clone())
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, 97, (6,)).astype("int64") for _ in range(6)]
    want = [gpt.generate(exe, prog, logits, p[None], 10, scope,
                         prefill_prog=pre, prefill_logits=plogits)[0]
            for p in prompts]
    eng = DecodeEngine(cfg, params=params, b_max=2, max_len=64).start()
    try:
        lane = eng._lane
        held = [lane.scope.find_var(c) for c in lane.cache_names]
        got = [eng.submit(p, 10).result(timeout=300) for p in prompts[:2]]
        got += [r.result(timeout=300) for r in
                [eng.submit(p, 10) for p in prompts[2:]]]
    finally:
        eng.stop()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    graphs = [p.graph for p in eng._exe._cache.values()
              if p.graph is not None]
    assert len(graphs) == 2  # the prefill at P = 6 and the decode step
    for c, t in zip(lane.cache_names, held):
        assert lane.scope.find_var(c) is t
    decode = next(g for g in graphs if g.bound_to(lane.scope))
    assert all(decode.state[c] is t
               for c, t in zip(lane.cache_names, held))
    assert all(g.adopted == 0 for g in graphs)


@pytest.mark.cuda
def test_cuda_verify_products_are_the_decode_steps(cuda_device):
    """ops/math.py's ``slot_rows``: a verify step's ``mul`` over 8 slots
    x 5 positions runs one product per position, each the bits of the
    decode step's product over the 8 slots at that position; without the
    attr, one product over the 40 rows, within f32 rounding of it."""
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.core.registry import get_op

    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 5, 768, generator=g).to(cuda_device)
    w = (torch.randn(768, 2304, generator=g) * 0.02).to(cuda_device)
    ctx = LowerContext(None, None, cuda_device)

    def mul(a, **attrs):
        return get_op("mul").lowering(
            ctx, {"X": [a], "Y": [w]}, dict(x_num_col_dims=2, **attrs)
        )["Out"][0]

    verify = mul(x, slot_rows=8)
    for s in range(5):
        step = mul(x[:, s:s + 1].contiguous())
        assert torch.equal(verify[:, s], step[:, 0]), s
    torch.testing.assert_close(mul(x), verify, rtol=1e-5, atol=1e-5)


# ------------------------------------------- artifacts and dygraph
def _serving_bert_program():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        tbert.build(CFG, seq_len=S, max_mask=M, is_test=True)
    blk = main.global_block()
    gather = next(op for op in blk.ops if op.type == "gather")
    reshape = next(op for op in blk.ops if op.type == "reshape2"
                   and gather.input("X")[0] in op.output("Out"))
    return main, startup, blk.var(reshape.input("X")[0])


@pytest.mark.cuda
def test_cuda_aot_section_replays_bitwise_the_plan(cuda_device, tmp_path,
                                                   monkeypatch):
    """A small serving BERT frozen on the card with its AOT section: its
    requests run the exported program (K1 and K4 as operators), the
    first captured and replayed, the rest replayed; bitwise the seeded
    plan path; a request runs n_layer K1 and 2 * n_layer + 1 K4 launches
    on the card."""
    from paddle_tpu_torch import export

    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    main, startup, enc = _serving_bert_program()
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    path = str(tmp_path / "b.pdz")
    export.save_artifact(main, path, feed_names=["src_ids", "sent_ids",
                                                 "input_mask"],
                         fetch_names=[enc.name], scope=scope,
                         batch_sizes=(B,))
    art = export.load_artifact(path)
    assert art.degraded == [] and art.aot_meta["platform"] == "cuda"
    pred = art.predictor()
    rs = np.random.RandomState(0)
    mask = np.ones((B, S), "float32")
    mask[1, S - 7:] = 0.0
    feed = {"src_ids": rs.randint(0, 100, (B, S)).astype("int64"),
            "sent_ids": rs.randint(0, 2, (B, S)).astype("int64"),
            "input_mask": mask}
    outs, counts = [], []
    for _ in range(3):
        (out,), n = _device_launches(lambda: pred.run(feed))
        outs.append(out)
        counts.append(n)
    per = CFG["n_layer"]
    k4 = 2 * CFG["n_layer"] + 1
    # the first request runs the program once, captures it, replays it
    assert counts[0][0] == 2 * per and counts[0][6] == 2 * k4
    assert all(c[0] == per and c[6] == k4 for c in counts[1:])
    assert pred._aot[B].graph is not None
    pred._aot = {}
    for _ in range(2):
        np.testing.assert_array_equal(pred.run(feed)[0], outs[0])
    assert all(np.array_equal(o, outs[0]) for o in outs)


@pytest.mark.cuda
def test_cuda_dygraph_capture_bitwise_eager(cuda_device):
    """Dygraph on the card: an MLP train step with dropout and Adam,
    eager and through ``imperative.jit``: the captured steps bitwise the
    eager ones (losses, params, the generator chain); with
    ``exact_numerics=False`` the replays launch K6 once a step."""
    from paddle_tpu_torch import imperative
    from paddle_tpu_torch.imperative import nn as inn
    from paddle_tpu_torch.imperative import optimizer as iopt

    def run(mode):
        rs = np.random.RandomState(0)
        X = rs.rand(8, 16).astype(np.float32)
        Y = rs.rand(8, 1).astype(np.float32)
        np.random.seed(42)
        with imperative.guard(seed=7):
            fc1, fc2 = inn.FC("fc1", 16, act="relu"), inn.FC("fc2", 1)
            adam = iopt.Adam(learning_rate=1e-2)

            def step(x, y):
                h = imperative.trace_op(
                    "dropout", {"X": [fc1(x)]},
                    {"dropout_prob": 0.3, "is_test": False})["Out"][0]
                d = imperative.trace_op("elementwise_sub",
                                        {"X": [fc2(h)], "Y": [y]},
                                        {})["Out"][0]
                loss = imperative.trace_op(
                    "reduce_mean", {"X": [imperative.trace_op(
                        "square", {"X": [d]}, {})["Out"][0]]}, {})["Out"][0]
                loss.backward()
                adam.step(fc1.parameters() + fc2.parameters())
                return loss

            fn = step if mode is None else imperative.jit(
                step, exact_numerics=mode)
            losses, k6 = [], []
            for _ in range(5):
                x, y = imperative.to_variable(X), imperative.to_variable(Y)
                x.stop_gradient = y.stop_gradient = True
                loss, n = _device_launches(lambda: fn(x, y).numpy())
                losses.append(loss)
                k6.append(n[8])
            params = [p.numpy() for p in fc1.parameters() + fc2.parameters()]
            chain = imperative.get_tracer()._rng.get_state().numpy()
        return losses, params, chain, k6

    e = run(None)
    c = run(True)
    f = run(False)
    for a, b in zip(e[0] + e[1], c[0] + c[1]):
        assert a.tobytes() == b.tobytes()
    assert e[2].tobytes() == c[2].tobytes() == f[2].tobytes()
    assert e[3] == [0] * 5 and f[3][1:] == [1] * 4
    for a, b in zip(e[1], f[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_captured_replay_2x_faster_than_eager(cuda_device):
    """With ``exact_numerics=False`` (level 2 and the plan's CUDA graph) a
    captured MLP train step runs at least twice the eager tape's steps
    per second: best of 5 rounds of 10 steps, a ratio within one
    process, no absolute time."""
    import time

    from paddle_tpu_torch import imperative
    from paddle_tpu_torch.imperative import nn as inn
    from paddle_tpu_torch.imperative import optimizer as iopt

    def measure(captured):
        np.random.seed(0)
        with imperative.guard(seed=0):
            fc1, fc2 = inn.FC("fc1", 32, act="relu"), inn.FC("fc2", 1)
            adam = iopt.Adam(learning_rate=1e-3)

            def step(x, y):
                d = imperative.trace_op("elementwise_sub",
                                        {"X": [fc2(fc1(x))], "Y": [y]},
                                        {})["Out"][0]
                loss = imperative.trace_op(
                    "reduce_mean", {"X": [imperative.trace_op(
                        "square", {"X": [d]}, {})["Out"][0]]}, {})["Out"][0]
                loss.backward()
                adam.step(fc1.parameters() + fc2.parameters())
                return loss

            fn = imperative.jit(step, exact_numerics=False) \
                if captured else step
            rs = np.random.RandomState(0)
            vx = imperative.to_variable(rs.rand(32, 64).astype(np.float32))
            vy = imperative.to_variable(rs.rand(32, 1).astype(np.float32))
            vx.stop_gradient = vy.stop_gradient = True
            for _ in range(3):
                fn(vx, vy)
            best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(10):
                    loss = fn(vx, vy)
                float(loss.numpy().reshape(-1)[0])
                best = min(best, time.perf_counter() - t0)
        return 10.0 / best

    eager_rate = measure(False)
    captured_rate = measure(True)
    assert captured_rate >= 2.0 * eager_rate, \
        "captured %.1f steps/s vs eager %.1f steps/s" % (captured_rate,
                                                         eager_rate)



# ------------------------------------------------ sequences, control flow
def _uncaptured(op):
    from paddle_tpu_torch.core.executor import UNCAPTURED_PLANS

    return UNCAPTURED_PLANS.labels(op=op).value


@pytest.mark.cuda
def test_cuda_while_plan_is_never_captured_and_counted(cuda_device):
    from paddle_tpu_torch.core import executor as texe

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        L = pt.layers
        n = L.data("n", [1], append_batch_size=False)
        x = L.data("x", [512], append_batch_size=False)
        i = L.fill_constant([1], "float32", 0.0)
        acc = L.fill_constant([512], "float32", 0.0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(L.elementwise_add(acc, x), output=acc)
            L.increment(i, 1.0)
            L.assign(L.less_than(i, n), output=cond)
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    texe._WARNED_UNCAPTURED.discard("while")
    before = _uncaptured("while")
    xv = np.arange(512, dtype=np.float32)
    with pytest.warns(RuntimeWarning, match="while"):
        exe.run(main, feed={"n": np.array([1.0], "float32"), "x": xv},
                fetch_list=[acc], scope=scope)
    for k in (3.0, 7.0, 0.0):
        (got,) = exe.run(main, feed={"n": np.array([k], "float32"),
                                     "x": xv}, fetch_list=[acc],
                         scope=scope)
        np.testing.assert_array_equal(got, k * xv)
    (plan,) = exe._cache.values()
    assert plan.graph is None and plan.host_sync == ["while"]
    assert _uncaptured("while") - before == 1


def _cond_program():
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 5
    with pt.program_guard(main, startup), pt.unique_name.guard():
        L = pt.layers
        x = L.data("x", [64])
        lab = L.data("lab", [1], dtype="int64")
        gate = L.data("gate", [1], append_batch_size=False)
        scale = L.fill_constant([1], "float32", 1.0)
        L.cond(L.greater_than(gate, L.fill_constant([1], "float32", 0.0)),
               true_fn=lambda: L.assign(L.fill_constant([1], "float32", 2.0),
                                        output=scale),
               false_fn=lambda: L.assign(
                   L.fill_constant([1], "float32", 0.5), output=scale))
        sw = L.fill_constant([1], "float32", 0.0)
        s = L.Switch()
        with s.case(L.less_than(gate, L.fill_constant([1], "float32",
                                                      -0.5))):
            L.assign(L.fill_constant([1], "float32", 1.0), output=sw)
        with s.default():
            L.assign(L.fill_constant([1], "float32", 3.0), output=sw)
        cnd = L.less_than(lab, L.fill_constant([1], "int64", 1))
        ie = L.IfElse(cnd)
        with ie.true_block():
            ie.output(L.fc(ie.input(x), size=32, act="tanh"))
        with ie.false_block():
            ie.output(L.dropout(L.fc(ie.input(x), size=32, act="relu"),
                                dropout_prob=0.2))
        merged, = ie()
        h = L.elementwise_mul(merged, L.elementwise_add(scale, sw))
        loss = L.mean(L.square(h))
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


@pytest.mark.cuda
def test_cuda_cond_switch_ifelse_step_replays_equal_eager_steps(cuda_device):
    main, startup, loss = _cond_program()
    exe, scope = _started(main, startup)
    eager_scope = _clone_scope(scope)
    rs = np.random.RandomState(0)
    for i in range(4):
        feed = {"x": rs.randn(16, 64).astype("float32"),
                "lab": rs.randint(0, 2, (16, 1)).astype("int64"),
                "gate": np.array([(-1.0, 0.3, -0.2, 1.0)[i]], "float32")}
        (r,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        (e,) = exe._run_eager(main, feed=feed, fetch_list=[loss],
                              scope=eager_scope, return_numpy=False)
        assert torch.equal(r, e), (i, r, e)
    plan = next(p for p in exe._cache.values() if p.graph is not None)
    assert plan.host_sync == []
    got, want = _params(main, scope), _params(main, eager_scope)
    for n in got:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_cuda_rnn_dropout_step_replays_equal_eager_steps(cuda_device, kind):
    T, B, D, H = 6, 8, 16, 32
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 7
    with pt.program_guard(main, startup), pt.unique_name.guard():
        L = pt.layers
        if kind == "static":
            x = L.data("x", [T, B, D], append_batch_size=False)
            rnn = L.StaticRNN()
            with rnn.step():
                word = rnn.step_input(x)
                prev = rnn.memory(shape=[-1, H], batch_ref=word,
                                  ref_batch_dim_idx=1)
                h = L.dropout(L.fc([word, prev], size=H, act="tanh"),
                              dropout_prob=0.3)
                rnn.update_memory(prev, h)
                rnn.step_output(h)
        else:
            x = L.data("x", [B, T, D], append_batch_size=False)
            ln = L.data("ln", [B], dtype="int64", append_batch_size=False)
            rnn = L.DynamicRNN()
            with rnn.block():
                word = rnn.step_input(x, length=ln)
                prev = rnn.memory(shape=[H], value=0.0, dtype="float32")
                h = L.dropout(L.fc([word, prev], size=H, act="tanh"),
                              dropout_prob=0.3)
                rnn.update_memory(prev, h)
                rnn.output(h)
        loss = L.mean(L.square(rnn()))
        pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    exe, scope = _started(main, startup)
    eager_scope = _clone_scope(scope)
    rs = np.random.RandomState(1)
    for i in range(4):
        feed = {"x": rs.randn(*x.shape).astype("float32")}
        if kind == "dynamic":
            feed["ln"] = rs.randint(1, T + 1, (B,)).astype("int64")
        (r,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        (e,) = exe._run_eager(main, feed=feed, fetch_list=[loss],
                              scope=eager_scope, return_numpy=False)
        assert torch.equal(r, e), (i, r, e)
    assert any(p.graph is not None for p in exe._cache.values())
    got, want = _params(main, scope), _params(main, eager_scope)
    for n in got:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.cuda
def test_cuda_beam_search_ties_match_the_cpu(cuda_device):
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.core.registry import get_op

    B, K, V = 4, 4, 10000
    rs = np.random.RandomState(3)
    cases = [
        (np.ones((B, K), "int32"),
         np.array([[0.0] + [-1e9] * (K - 1)] * B, "float32"),
         np.log(np.full((B, K, V), 1.0 / V, "float32"))),
        (np.array([[1, 0, 2, 0]] * B, "int32"), np.zeros((B, K), "float32"),
         np.round(np.log(rs.dirichlet(np.ones(V), (B, K))), 1)
         .astype("float32"))]
    for pre_ids, pre_sc, sc in cases:
        outs = []
        for dev in (torch.device("cpu"), cuda_device):
            ins = {"pre_ids": [torch.from_numpy(pre_ids).to(dev)],
                   "pre_scores": [torch.from_numpy(pre_sc).to(dev)],
                   "scores": [torch.from_numpy(sc).to(dev)]}
            o = get_op("beam_search").lowering(
                LowerContext(None, None, dev), ins,
                {"beam_size": K, "end_id": 0})
            outs.append({k: v[0].cpu() for k, v in o.items()})
        for k in outs[0]:
            assert torch.equal(outs[0][k], outs[1][k]), k
