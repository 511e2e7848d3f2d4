"""Ring attention: sequence parallelism over a mesh axis.

The port of paddle_tpu/parallel/ring_attention.py. The sequence is split
over the n positions of a ring axis: position i holds query, key and
value block i ([B, H, Sl, D]). Each ring step is a round: every
position computes its partial attention against the K/V block it holds,
then the K/V blocks hop one position round the ring (``ppermute``).
After n steps every query block has seen every key block, and no
position ever held the whole sequence.

The partials merge by log-sum-exp weights. On the flash path
(``use_flash=True``, what ``fused_attention`` takes under a ``seq``
axis) each step's pairs from every position go to the flash forward
kernel (K1, ``flash_attention_with_lse``) in one launch, stacked along
its batch dim (the positions share a device), and return normalized
(out, lse) partials; its backward (autograd through the merge) runs the
dK/dV and dQ kernels (K2, K3) with the lse cotangent folded into delta.
On CPU tensors the wrapper computes K1's plain version. The plain path
(``use_flash=False``) materializes each [Sl, Sl] score block and keeps
running (max, sum, numerator) partials, as the JAX package's does.

A causal ring takes the zigzag (striped) assignment by default
(``schedule="auto"``): position d holds chunks {d, 2n-1-d} of Sl/2
rows, so every step has the same visible work (two of four chunk pairs,
three on the first step). A position's visibility is known on the host,
so a pair that is wholly in the future is skipped, not computed and
discarded as under ``lax.cond``. The contiguous causal ring skips the
key blocks later than a position's own the same way.

``ring_attention`` takes and returns lists: entry i is position i's
block. ``kv_bias`` is a list of [B|1, 1, 1, Sl] additive key biases that
travel with the K/V blocks; ``seg`` a list of [B, Sl] packed segment ids
(0 = padding), which travel as the key side while each position keeps
its own as the query side, so the [S, S] pack mask is never built: each
pair applies the same-segment mask of its two id vectors.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops.attention import causal_bias_block, seg_mask
from .mesh import note_collective, ppermute

__all__ = ["ring_attention"]

_MASK = -1e9


def _block_partials(q, k, v, scale, mask):
    """Unnormalised partials for one K/V block: o_hat = sum_j exp(s - m)
    v_j, m the row max, l the row sum. q, k, v [B, H, Sq|Sk, D]; mask
    additive, broadcast to [B, H, Sq, Sk], or None."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s + mask
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o, m, l


def _rotate(perm, *vals):
    """One ring hop for every (possibly absent) list of block values."""
    return [None if v is None else ppermute(v, perm) for v in vals]


def _pairs(qs, ks, vs, biases, q_segs, k_segs, scale, causal, use_flash):
    """Normalized (out f32, lse) partials of the attention pairs
    (qs[i], ks[i], vs[i]), all of one shape, stacked along the batch dim
    into one computation (one K1 launch on the flash path). ``biases``
    and the segment ids are lists or None."""
    B = qs[0].shape[0]
    q, k, v = torch.cat(qs), torch.cat(ks), torch.cat(vs)
    bias = None
    if biases is not None or q_segs is not None:
        per = []
        for i in range(len(qs)):
            b = None if biases is None else biases[i].float()
            if q_segs is not None:
                sm = seg_mask(q_segs[i], k_segs[i])
                b = sm if b is None else b + sm
            per.append(b.expand(B, 1, b.shape[2], b.shape[3]))
        bias = torch.cat(per)
    if use_flash:
        from ..ops.attention import flash_attention_with_lse

        o, lse = flash_attention_with_lse(q, k, v, bias, scale,
                                          causal=causal)
        o = o.float()
    else:
        mask = causal_bias_block(q.shape[2], device=q.device) \
            if causal else None
        if bias is not None:
            mask = bias if mask is None else mask + bias
        o_hat, m, l = _block_partials(q, k, v, scale, mask)
        o, lse = o_hat / l[..., None], m + torch.log(l)
    return list(zip(o.split(B), lse.split(B)))


def _neutral(q):
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full(q.shape[:3], float("-inf"), dtype=torch.float32,
                       device=q.device))


def _merge(acc, part):
    """Log-sum-exp merge of two normalized partials; a row with no
    visible key yet (lse -inf on both sides) stays empty."""
    o_a, l_a = acc
    o_i, l_i = part
    new = torch.logaddexp(l_a, l_i)
    safe = torch.where(torch.isneginf(new), torch.zeros_like(new), new)
    w_a = torch.exp(l_a - safe)[..., None]
    w_i = torch.exp(l_i - safe)[..., None]
    return o_a * w_a + o_i * w_i, new


def ring_attention(q: Sequence[torch.Tensor], k: Sequence[torch.Tensor],
                   v: Sequence[torch.Tensor], scale: float,
                   axis_name: str = "seq", causal: bool = False,
                   kv_bias: Optional[Sequence[torch.Tensor]] = None,
                   use_flash: bool = False, schedule: str = "auto",
                   seg: Optional[Sequence[torch.Tensor]] = None
                   ) -> List[torch.Tensor]:
    """Attention over a sequence split on the ring axis ``axis_name``:
    q, k, v are the n positions' blocks [B, H, Sl, D] (lists, entry i
    position i's); returns the n output blocks. ``causal=True`` applies
    the global lower-triangular mask by ring position.

    schedule: "auto" (default) takes the zigzag assignment for a causal
    ring (more than one position and an even Sl; else the contiguous
    one); "contiguous" forces the plain assignment; "zigzag" demands the
    striped one and raises where it does not apply. Notes one
    ``ring_ppermute`` collective (parallel/mesh.py)."""
    if schedule not in ("auto", "contiguous", "zigzag"):
        raise ValueError("schedule must be auto|contiguous|zigzag")
    n = len(q)
    want_zigzag = (schedule == "zigzag"
                   or (schedule == "auto" and causal))
    zigzag = want_zigzag and causal and n > 1 and q[0].shape[2] % 2 == 0
    if schedule == "zigzag" and not zigzag:
        raise ValueError(
            "zigzag schedule requires causal=True, >1 ring devices "
            "and an even local shard length")
    note_collective("ring_ppermute", axis_name, n,
                    schedule="zigzag" if zigzag else "contiguous",
                    flash=bool(use_flash))
    if zigzag:
        return _ring_attention_zigzag(q, k, v, scale, kv_bias, use_flash,
                                      seg)
    if use_flash:
        return _ring_attention_flash(q, k, v, scale, causal, kv_bias, seg)
    return _ring_attention_plain(q, k, v, scale, causal, kv_bias, seg)


def _ring_attention_plain(q, k, v, scale, causal, kv_bias, seg):
    """Materialized score blocks with running (max, sum, numerator)
    partials, position by position."""
    n = len(q)
    B, H, Sl, D = q[0].shape
    dev = q[0].device
    perm = [(j, (j + 1) % n) for j in range(n)]
    o_acc = [torch.zeros((B, H, Sl, D), dtype=torch.float32, device=dev)
             for _ in range(n)]
    m_acc = [torch.full((B, H, Sl), float("-inf"), dtype=torch.float32,
                        device=dev) for _ in range(n)]
    l_acc = [torch.zeros((B, H, Sl), dtype=torch.float32, device=dev)
             for _ in range(n)]
    k_cur, v_cur, b_cur, s_cur = list(k), list(v), kv_bias, seg
    ar = torch.arange(Sl, device=dev)
    for i in range(n):
        for idx in range(n):
            src = (idx - i) % n  # origin block of k_cur[idx]
            mask = None
            if causal:
                q_pos, k_pos = idx * Sl + ar, src * Sl + ar
                mask = torch.where(k_pos[None, :] > q_pos[:, None],
                                   _MASK, 0.0)[None, None]
            if s_cur is not None:
                sm = seg_mask(seg[idx], s_cur[idx])
                mask = sm if mask is None else mask + sm
            if b_cur is not None:
                bm = b_cur[idx].float()
                mask = bm if mask is None else mask + bm
            o, m, l = _block_partials(q[idx], k_cur[idx], v_cur[idx],
                                      scale, mask)
            new_m = torch.maximum(m_acc[idx], m)
            a = torch.exp(m_acc[idx] - new_m)
            b = torch.exp(m - new_m)
            o_acc[idx] = o_acc[idx] * a[..., None] + o * b[..., None]
            l_acc[idx] = l_acc[idx] * a + l * b
            m_acc[idx] = new_m
        k_cur, v_cur, b_cur, s_cur = _rotate(perm, k_cur, v_cur, b_cur,
                                             s_cur)
    return [(o / l[..., None]).to(q[0].dtype) for o, l in zip(o_acc, l_acc)]


def _ring_attention_flash(q, k, v, scale, causal, kv_bias, seg):
    """Flash partials merged by lse. Causality needs no position mask:
    with equal blocks only the diagonal block (step 0) is partly masked,
    in-kernel; at step i > 0 position idx's key block is earlier than
    its own (visible) iff idx >= i, and a later one is skipped."""
    n = len(q)
    perm = [(j, (j + 1) % n) for j in range(n)]
    acc = [_neutral(x) for x in q]
    k_cur, v_cur, b_cur, s_cur = list(k), list(v), kv_bias, seg
    for i in range(n):
        vis = [d for d in range(n) if not (causal and i > 0 and d < i)]
        pick = lambda xs: None if xs is None else [xs[d] for d in vis]  # noqa: E731
        parts = _pairs(pick(q), pick(k_cur), pick(v_cur), pick(b_cur),
                       pick(seg), pick(s_cur), scale, causal and i == 0,
                       True)
        for d, part in zip(vis, parts):
            acc[d] = _merge(acc[d], part)
        k_cur, v_cur, b_cur, s_cur = _rotate(perm, k_cur, v_cur, b_cur,
                                             s_cur)
    return [o.to(x.dtype) for (o, _), x in zip(acc, q)]


# ------------------------------------------------------- zigzag schedule
def _zigzag_permutes(n):
    """Chunk-routing permutations between the contiguous layout (device
    i holds global chunks {2i, 2i+1}) and the zigzag layout (device d
    holds {d, 2n-1-d}). Even-gid chunks and odd-gid chunks each move as
    a unit, so two ppermutes realize the re-shard."""
    def z(g):
        return g if g < n else 2 * n - 1 - g

    fwd_even = [(i, z(2 * i)) for i in range(n)]
    fwd_odd = [(i, z(2 * i + 1)) for i in range(n)]
    inv_even = [(d, s) for s, d in fwd_even]
    inv_odd = [(d, s) for s, d in fwd_odd]
    return fwd_even, fwd_odd, inv_even, inv_odd


def _ring_attention_zigzag(q, k, v, scale, kv_bias, use_flash, seg):
    """The causal ring on the zigzag assignment: two ppermute pairs
    re-shard contiguous -> zigzag -> contiguous at the ends; each step
    merges the visible chunk pairs of every position (one computation
    per step, two on the first: its diagonal pairs are causal)."""
    n = len(q)
    fwd_even, fwd_odd, inv_even, inv_odd = _zigzag_permutes(n)
    even = [d % 2 == 0 for d in range(n)]

    def to_zigzag(xs, axis):
        """contiguous blocks -> (c0 [gid d], c1 [gid 2n-1-d]) lists."""
        lo, hi = zip(*(x.chunk(2, dim=axis) for x in xs))
        recv_e, recv_o = ppermute(lo, fwd_even), ppermute(hi, fwd_odd)
        return ([recv_e[d] if even[d] else recv_o[d] for d in range(n)],
                [recv_o[d] if even[d] else recv_e[d] for d in range(n)])

    def from_zigzag(c0, c1, axis):
        send_e = [c0[d] if even[d] else c1[d] for d in range(n)]
        send_o = [c1[d] if even[d] else c0[d] for d in range(n)]
        lo, hi = ppermute(send_e, inv_even), ppermute(send_o, inv_odd)
        return [torch.cat([lo[d], hi[d]], dim=axis) for d in range(n)]

    q0, q1 = to_zigzag(q, 2)
    k0, k1 = to_zigzag(k, 2)
    v0, v1 = to_zigzag(v, 2)
    b0 = b1 = None
    if kv_bias is not None:
        b0, b1 = to_zigzag([b.float() for b in kv_bias], 3)
    qs0 = qs1 = None
    if seg is not None:
        # the ids split like the sequence: one kept copy per q chunk, one
        # travelling copy per kv chunk
        qs0, qs1 = to_zigzag(seg, 1)
    qc, qsc = (q0, q1), (qs0, qs1)
    kc, vc, bc, sc = [k0, k1], [v0, v1], [b0, b1], [qs0, qs1]
    perm = [(j, (j + 1) % n) for j in range(n)]
    acc = [[_neutral(q0[d]), _neutral(q1[d])] for d in range(n)]

    def run(pairs, causal):
        """Merge the partials of ``pairs`` (position, q chunk, kv chunk),
        computed together, into their accumulators, in order."""
        def col(lists, which):
            if lists[0] is None:
                return None
            return [lists[which(a, c)][d] for d, a, c in pairs]

        parts = _pairs(col(qc, lambda a, c: a), col(kc, lambda a, c: c),
                       col(vc, lambda a, c: c), col(bc, lambda a, c: c),
                       col(qsc, lambda a, c: a), col(sc, lambda a, c: c),
                       scale, causal, use_flash)
        for (d, a, _), part in zip(pairs, parts):
            acc[d][a] = _merge(acc[d][a], part)

    for j in range(n):
        if j == 0:
            # the self step: both diagonals causal; (q1, k0) always
            # visible in full; (q0, k1) never
            run([(d, a, a) for d in range(n) for a in (0, 1)], True)
            run([(d, 1, 0) for d in range(n)], False)
        else:
            pairs = []
            for d in range(n):
                p = (d - j) % n
                qg, kg = (d, 2 * n - 1 - d), (p, 2 * n - 1 - p)
                pairs += [(d, a, c) for a in (0, 1) for c in (0, 1)
                          if qg[a] > kg[c]]
            run(pairs, False)
        for c in (0, 1):
            kc[c], vc[c], bc[c], sc[c] = _rotate(perm, kc[c], vc[c], bc[c],
                                                 sc[c])

    out = from_zigzag([acc[d][0][0] for d in range(n)],
                      [acc[d][1][0] for d in range(n)], 2)
    return [o.to(x.dtype) for o, x in zip(out, q)]
