"""The port's CUDA kernels and its training step on the card.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
GPU. The file imports neither JAX nor the JAX package, so that it runs
where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

- The flash forward kernel against its plain version
  (``composed_attention_with_lse``), at atol 2e-5 on O and 1e-5 on lse
  at f32 and 2e-2 at bf16.
- The flash dK/dV and dQ kernels against their plain versions, with the
  raw score grad (``want_db``) both without and with causal masking,
  at atol 5e-5 at f32 (the JAX package's stated backward tolerance) and
  2e-2 at bf16.
- One training step of a 2-layer BERT MLM with dropout launches the
  forward kernel twice and each backward kernel once per layer.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import attention as tattn

# head dim 64: the kernels take 64 and 128
CFG = dict(d_model=128, d_ff=256, n_head=2, n_layer=2, vocab=100,
           type_vocab=2, max_length=40, dropout=0.1)
S, M, B = 40, 6, 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv(shape, dtype, dev):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(shape, generator=g).to(dtype).to(dev)
            for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, d):
    q, k, v = _qkv((2, 3, 200, d), dtype, cuda_device)
    bias = torch.zeros(2, 1, 1, 200, device=cuda_device)
    bias[1, ..., 150:] = -1e9
    for causal in (False, True):
        before = tattn.flash_attention_fwd.launches
        out, lse = tattn.flash_attention_fwd(q, k, v, bias, d ** -0.5, causal)
        assert tattn.flash_attention_fwd.launches == before + 1
        want, want_lse = tattn.composed_attention_with_lse(
            q.float(), k.float(), v.float(), bias, d ** -0.5, causal)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(out.float(), want, atol=tol, rtol=0)
        torch.testing.assert_close(lse, want_lse,
                                   atol=1e-5 if tol == 2e-5 else tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_backward_kernels_match_plain_versions(cuda_device, dtype, d):
    q, k, v = _qkv((2, 3, 200, d), dtype, cuda_device)
    g = torch.randn(q.shape, device=cuda_device).to(dtype)
    bias = torch.randn(2, 1, 200, 200, device=cuda_device)
    bias[1, ..., 150:] = -1e9
    tol = 5e-5 if dtype == torch.float32 else 2e-2
    f32 = [t.float() for t in (q, k, v, g)]
    for causal in (False, True):
        o, lse = tattn.composed_attention_with_lse(*f32[:3], bias,
                                                   d ** -0.5, causal)
        delta = (f32[3] * o).sum(-1)
        args = (bias, g, lse, delta, d ** -0.5, causal)
        before = (tattn.flash_attention_dkv.launches,
                  tattn.flash_attention_dq.launches)
        dk, dv, ds = tattn.flash_attention_dkv(q, k, v, *args, want_db=True)
        dq = tattn.flash_attention_dq(q, k, v, *args)
        assert (tattn.flash_attention_dkv.launches,
                tattn.flash_attention_dq.launches) == (before[0] + 1,
                                                       before[1] + 1)
        ref_args = (*f32[:3], bias, f32[3], lse, delta, d ** -0.5, causal)
        rdk, rdv, rds = tattn.flash_attention_dkv_reference(*ref_args,
                                                            want_db=True)
        rdq = tattn.flash_attention_dq_reference(*ref_args)
        for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
            torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)
        # under causal the tiles above the diagonal are skipped: their
        # score grad is written as 0, as the plain version gives
        torch.testing.assert_close(ds, rds, atol=tol, rtol=0)


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
