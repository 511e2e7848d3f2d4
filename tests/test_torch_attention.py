"""The port's flash attention against the JAX package's.

On the CPU the port's kernel wrapper (``flash_attention_fwd``) computes
its plain version; it is held against the JAX package's Pallas forward
kernel (``_forward_pallas``, interpret mode on the CPU) for O and the
per-row logsumexp, and against its ``composed_attention`` for O.
Tolerance: atol 2e-5 on O and lse at f32, the JAX package's own kernel
tolerance. Inputs are unit normal and every row keeps at least one
unmasked key, where the JAX kernel's padded keys and the port's
bounds-checked keys give the same answer.

The flash backward (``flash_attention_bwd``: delta, then the dK/dV and
dQ wrappers, their plain versions on CPU tensors) is held against the
JAX package's ``_backward_pallas`` (interpret mode) at atol 5e-5, the
JAX package's stated backward tolerance; the trainable-bias and
differentiable-lse variants against ``_fa_trainbias`` and
``_fa_with_lse`` through ``jax.vjp``, and the port's
``torch.autograd.Function``s through both ``torch.func.vjp`` and
``.backward()``.

The CUDA kernels are held against their plain versions on the card in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops import attention as jattn
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels.common import SMEM_PER_BLOCK, check_launch
from paddle_tpu_torch.ops import attention as tattn

B, H, D = 2, 3, 64
SCALE = D ** -0.5
ATOL = 2e-5
BWD_ATOL = 5e-5


def _bias(kind, rs, S):
    if kind == "none":
        return None
    if kind == "keypad":  # [B,1,1,S]: -1e9 on the last keys of batch 1
        b = np.zeros((B, 1, 1, S), "float32")
        b[1, ..., S - S // 4:] = -1e9
        return b
    shape = {"head": (1, H, S, S), "batch": (B, 1, S, S)}[kind]
    return rs.randn(*shape).astype("float32")


CASES = [(kind, False) for kind in ("none", "keypad", "head", "batch")] + \
    [("keypad", True)]


@pytest.mark.parametrize("S", [40, 128, 200])
@pytest.mark.parametrize("kind,causal", CASES)
def test_flash_forward_matches_jax(kind, causal, S):
    rs = np.random.RandomState(S)
    q, k, v = (rs.randn(B, H, S, D).astype("float32") for _ in range(3))
    bias = _bias(kind, rs, S)
    jb = None if bias is None else jnp.asarray(bias)
    j_out, j_lse = jattn._forward_pallas(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jb, SCALE,
                                         causal=causal)
    j_comp = jattn.composed_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jb, SCALE, causal)
    tb = None if bias is None else torch.from_numpy(bias)
    launches = tattn.flash_attention_fwd.launches
    out, lse = tattn.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tb,
        SCALE, causal)
    assert tattn.flash_attention_fwd.launches == launches  # CPU: no kernel
    assert out.dtype == torch.float32 and lse.shape == (B, H, S)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(j_lse).reshape(B, H, S),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_comp), atol=ATOL,
                               rtol=0)


def _bwd_inputs(kind, S, seed):
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.randn(B, H, S, D).astype("float32") for _ in range(4))
    return q, k, v, g, _bias(kind, rs, S), rs


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("kind,causal,S", [
    ("keypad", False, 128), ("none", True, 128), ("keypad", True, 200),
    ("batch", False, 40), ("head", False, 40)])
def test_flash_backward_matches_jax(kind, causal, S):
    q, k, v, g, bias, _ = _bwd_inputs(kind, S, S + 7)
    j_o, j_lse = jattn._forward_pallas(_j(q), _j(k), _j(v), _j(bias), SCALE,
                                       causal=causal)
    want = jattn._backward_pallas(_j(q), _j(k), _j(v), _j(bias), j_o, j_lse,
                                  _j(g), SCALE, causal=causal)
    counts = (tattn.flash_attention_dkv.launches,
              tattn.flash_attention_dq.launches)
    o, lse = tattn.flash_attention_fwd(_t(q), _t(k), _t(v), _t(bias), SCALE,
                                       causal)
    got = tattn.flash_attention_bwd(_t(q), _t(k), _t(v), _t(bias), o, lse,
                                    _t(g), SCALE, causal)
    assert (tattn.flash_attention_dkv.launches,
            tattn.flash_attention_dq.launches) == counts  # CPU: no kernel
    assert got[3] is None and want[3] is None
    for name, a, b in zip(("dq", "dk", "dv"), want[:3], got[:3]):
        assert b.dtype == torch.float32 and b.shape == (B, H, S, D)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=BWD_ATOL,
                                   rtol=0, err_msg=name)
    # the plain version of the whole backward gives the same answer
    ref = tattn.flash_attention_bwd_reference(_t(q), _t(k), _t(v), _t(bias),
                                              o, lse, _t(g), SCALE, causal)
    for a, b in zip(ref[:3], got[:3]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_trainable_bias_grad_matches_jax():
    S = 40
    q, k, v, g, bias, _ = _bwd_inputs("batch", S, 3)
    _, vjp = jax.vjp(lambda a, b, c, d: jattn._fa_trainbias(a, b, c, d,
                                                           SCALE),
                     _j(q), _j(k), _j(v), _j(bias))
    want = vjp(_j(g))
    args = [_t(x).requires_grad_(True) for x in (q, k, v, bias)]
    _, tvjp = torch.func.vjp(
        lambda a, b, c, d: tattn._fa_trainbias(a, b, c, d, SCALE),
        *[a.detach() for a in args])
    via_func = tvjp(_t(g))
    out = tattn.flash_attention(*args, scale=SCALE, bias_grad=True)
    out.backward(_t(g))
    via_backward = [a.grad for a in args]
    for name, a, b, c in zip(("dq", "dk", "dv", "db"), want, via_func,
                             via_backward):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=BWD_ATOL,
                                   rtol=0, err_msg=name)
        torch.testing.assert_close(b, c, atol=0, rtol=0)
    # the raw score grad of the dK/dV wrapper, before the bias reduction
    o, lse = tattn.flash_attention_fwd(*(_t(x) for x in (q, k, v, bias)),
                                       SCALE)
    dq, dk, dv, ds = tattn.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(bias), o, lse, _t(g), SCALE, want_db=True)
    assert ds.shape == (B, H, S, S) and ds.dtype == torch.float32
    np.testing.assert_allclose(ds.sum(1, keepdim=True).numpy(),
                               np.asarray(want[3]), atol=BWD_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_cotangent_matches_jax(causal):
    S = 40
    q, k, v, g, bias, rs = _bwd_inputs("keypad", S, 5)
    g_lse = rs.randn(B, H, S).astype("float32")
    _, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention_with_lse(
        a, b, c, _j(bias), SCALE, causal), _j(q), _j(k), _j(v))
    want = vjp((_j(g), _j(g_lse)))
    _, tvjp = torch.func.vjp(lambda a, b, c: tattn.flash_attention_with_lse(
        a, b, c, _t(bias), SCALE, causal), _t(q), _t(k), _t(v))
    via_func = tvjp((_t(g), _t(g_lse)))
    args = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out, lse = tattn.flash_attention_with_lse(*args, _t(bias), SCALE, causal)
    torch.autograd.backward((out, lse), (_t(g), _t(g_lse)))
    for name, a, b, c in zip(("dq", "dk", "dv"), want, via_func, args):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=BWD_ATOL,
                                   rtol=0, err_msg=name)
        torch.testing.assert_close(b, c.grad, atol=0, rtol=0)


def test_mask_bias_flash_attention_grads_match_jax():
    S = 40
    q, k, v, g, bias, _ = _bwd_inputs("keypad", S, 9)
    _, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention(
        a, b, c, _j(bias), SCALE), _j(q), _j(k), _j(v))
    want = vjp(_j(g))
    tb = _t(bias).requires_grad_(True)
    args = [_t(x).requires_grad_(True) for x in (q, k, v)]
    tattn.flash_attention(*args, tb, SCALE).backward(_t(g))
    for name, a, b in zip(("dq", "dk", "dv"), want, args):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a),
                                   atol=BWD_ATOL, rtol=0, err_msg=name)
    assert tb.grad is None  # a constant mask takes no grad


def test_backward_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v = _qkv()
    g = torch.randn_like(q)
    lse = torch.zeros(q.shape[:3])
    for fn in (tattn.flash_attention_dkv, tattn.flash_attention_dq):
        with pytest.raises(ValueError, match="g .* does not match"):
            fn(q, k, v, None, g[:, :, :32].contiguous(), lse, lse, SCALE)
        with pytest.raises(ValueError, match="delta"):
            fn(q, k, v, None, g, lse, lse[:, :1].contiguous(), SCALE)
        with pytest.raises(ValueError, match="dtype"):
            fn(q, k, v, None, g.double(), lse, lse, SCALE)
        with pytest.raises(ValueError, match="contiguous"):
            fn(q, k, v, None, g.transpose(1, 2), lse, lse, SCALE)
    for what in ("flash_attention_dkv", "flash_attention_dq"):
        with pytest.raises(ValueError, match="head dim"):
            tattn.check_bwd_kernel_launch(
                what, *_qkv((B, H, 64, 32)), None,
                torch.zeros(B, H, 64, 32), lse, lse)


@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 4),
                                          (torch.float32, 2)])
def test_backward_kernels_require_16_byte_alignment(dtype, offset):
    """The backward kernels copy q / k / v / g by 16-byte cp.async at
    either dtype: a view ``offset`` elements (8 bytes) into its storage
    is refused by the launch check, before any kernel is built."""
    q, k, v = _qkv(dtype=dtype)
    g = torch.randn(q.shape).to(dtype)
    lse = torch.zeros(q.shape[:3])
    flat = torch.zeros(q.numel() + offset, dtype=dtype)
    shifted = flat[offset:].view(q.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 8
    for what in ("flash_attention_dkv", "flash_attention_dq"):
        for i in range(4):
            args = [q, k, v, g]
            args[i] = shifted
            with pytest.raises(ValueError, match="16-byte aligned"):
                tattn.check_bwd_kernel_launch(what, *args[:3], None,
                                              args[3], lse, lse)
    assert "flash_attention_bwd" not in build._LOADED


@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 4),
                                          (torch.float32, 2)])
def test_forward_kernel_requires_16_byte_alignment(dtype, offset):
    """The forward kernel copies q / k / v by 16-byte cp.async at either
    dtype: a view ``offset`` elements (8 bytes) into its storage is
    refused by the launch check, before the kernel is built."""
    q, k, v = _qkv(dtype=dtype)
    flat = torch.zeros(q.numel() + offset, dtype=dtype)
    shifted = flat[offset:].view(q.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 8
    for i in range(3):
        args = [q, k, v]
        args[i] = shifted
        with pytest.raises(ValueError, match="16-byte aligned"):
            tattn.check_kernel_launch(*args)
    assert "flash_attention_fwd" not in build._LOADED


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_row_takes_uniform_weight_as_in_jax(causal):
    """A batch row whose every key carries the -1e9 mask: the port's plain
    version (what ``flash_attention_fwd`` computes on CPU tensors) spreads
    the weight uniformly over the keys, as the JAX package's
    ``composed_attention`` does; the lse is the mask value's."""
    S = 40
    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(B, H, S, D).astype("float32") for _ in range(3))
    bias = np.zeros((B, 1, 1, S), "float32")
    bias[1] = -1e9
    want = jattn.composed_attention(_j(q), _j(k), _j(v), _j(bias), SCALE,
                                    causal)
    out, lse = tattn.flash_attention_fwd(_t(q), _t(k), _t(v), _t(bias),
                                         SCALE, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    if not causal:
        np.testing.assert_allclose(
            out[1].numpy(), np.broadcast_to(v[1].mean(1, keepdims=True),
                                            (H, S, D)), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(lse[1].numpy(), -1e9)


def test_dispatch_threshold(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FLASH_MIN_SEQ", raising=False)
    assert tattn.flash_min_seq() == 256
    assert tattn.flash_effective(256) and not tattn.flash_effective(255)
    assert tattn.flash_effective(100, 300)
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "100000")
    assert not tattn.flash_effective(512)
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "x")
    with pytest.raises(ValueError, match="decimal integer"):
        tattn.flash_min_seq()


def _qkv(shape=(B, H, 64, D), dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(shape, generator=g).to(dtype) for _ in range(3)]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = _qkv()
    with pytest.raises(ValueError, match="contiguous"):
        tattn.flash_attention_fwd(q.transpose(1, 2), k, v)
    for dt in (torch.float64, torch.float16):
        with pytest.raises(ValueError, match="dtype"):
            tattn.flash_attention_fwd(*_qkv(dtype=dt))
    with pytest.raises(ValueError, match="dtypes differ"):
        tattn.flash_attention_fwd(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="do not match"):
        tattn.flash_attention_fwd(q, k[:, :2].contiguous(),
                                  v[:, :2].contiguous())
    with pytest.raises(ValueError, match="Sq == Sk"):
        tattn.flash_attention_fwd(q, k[:, :, :32].contiguous(),
                                  v[:, :, :32].contiguous(), causal=True)
    with pytest.raises(ValueError, match="broadcast"):
        tattn.flash_attention_fwd(q, k, v, torch.zeros(B, H, 64, 7))
    with pytest.raises(ValueError, match="dtype"):
        tattn.flash_attention_fwd(q, k, v, torch.zeros(B, 1, 1, 64,
                                                       dtype=torch.float64))
    # head dims the CUDA kernel has no configuration for
    for d in (16, 32, 96, 256):
        with pytest.raises(ValueError, match="head dim"):
            tattn.check_kernel_launch(*_qkv((B, H, 64, d)))


def test_launch_limits_and_build_inputs():
    check_launch("k", (8, 96, 1), (128, 1, 1), SMEM_PER_BLOCK)
    with pytest.raises(ValueError, match="shared memory"):
        check_launch("k", (8, 96, 1), (128, 1, 1), SMEM_PER_BLOCK + 1)
    with pytest.raises(ValueError, match="grid.y"):
        check_launch("k", (8, 70000, 1), (128, 1, 1), 0)
    with pytest.raises(ValueError, match="threads"):
        check_launch("k", (8, 1, 1), (2048, 1, 1), 0)
    assert {"flash_attention_fwd", "flash_attention_bwd"} <= set(
        build.sources())
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    path = build._lib_path("flash_attention_fwd")
    assert path.startswith(build.BUILD_DIR) and path.endswith(".so")
