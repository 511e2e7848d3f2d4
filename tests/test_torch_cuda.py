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
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
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
