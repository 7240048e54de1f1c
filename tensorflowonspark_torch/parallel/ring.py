"""Sequence parallelism: ring attention and all-to-all (Ulysses) attention
(the port of :mod:`tensorflowonspark_tpu.parallel.ring`).

Each process holds its chunk ``[B, S/P, H, D]`` of a sequence sharded over
the mesh's ``seq`` axis (P processes, chunk i at global positions
``i*S/P ...``), and attention runs as

- :func:`ring_attention`: blockwise attention with an online (running-max)
  softmax; the key/value blocks travel around the ring of the ``seq`` group
  (rank r sends to ``(r+1) % P`` with ``batch_isend_irecv``), so a process
  only ever holds its ``S/P x S/P`` score block.  The backward recomputes
  the probabilities from the saved log-sum-exp; dQ accumulates locally and
  the dK/dV accumulators travel with their blocks, arriving home after P
  hops.  The JAX ring is einsum inside XLA, so the block step here is eager
  torch ops (cuBLAS on the card), in fp32;
- :func:`ulysses_attention`: two ``all_to_all_single`` calls re-shard from
  sequence-sharded to head-sharded, ordinary attention runs over the full
  sequence for H/P heads (``impl="flash"``: the hand-written flash kernels),
  and two more switch back (the backward's).

Both are exact (not approximations) and match full attention to numerical
tolerance.  :func:`reference_attention` is the plain contraction: the
transformer's ``attention="full"`` path and the tests' oracle.
"""

import math

import torch
import torch.distributed as dist

from tensorflowonspark_torch.parallel import mesh as mesh_mod

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp() NaN-free


def reference_attention(q, k, v, causal=False, scale=None):
    """Plain full attention over ``[batch, seq, heads, dim]`` inputs,
    computed in fp32 and returned in ``q``'s dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        seq_q, seq_k = q.shape[1], k.shape[1]
        mask = torch.ones(seq_q, seq_k, dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _causal_mask(sq, sk, q_offset, kv_offset, device):
    """``[Sq, Sk]`` bool: global query position >= global key position."""
    q_pos = q_offset + torch.arange(sq, device=device)
    kv_pos = kv_offset + torch.arange(sk, device=device)
    return q_pos[:, None] >= kv_pos[None, :]


def _scores(q, k, q_offset, kv_offset, causal, scale):
    """fp32 scores ``[B, H, Sq, Sk]`` of one block and its causal mask
    (None when not causal)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if not causal:
        return s, None
    mask = _causal_mask(q.shape[1], k.shape[1], q_offset, kv_offset, q.device)
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def _block_attention(q, k, v, o, m, l, q_offset, kv_offset, causal, scale):
    """One blockwise-attention accumulation step with online softmax (the
    JAX ``_block_attention``).

    Shapes: q [B,Sq,H,D], k/v [B,Sk,H,D] (fp32); running state o
    [B,Sq,H,D], m/l [B,Sq,H].  Offsets are the global sequence positions of
    the local q block and the block of k/v held now (for causal
    masking)."""
    s, mask = _scores(q, k, q_offset, kv_offset, causal, scale)
    m_blk = s.amax(dim=-1).movedim(1, -1)                # [B,Sq,H]
    m_new = torch.maximum(m, m_blk)
    p = torch.exp(s - m_new.movedim(-1, 1)[..., None])   # [B,H,Sq,Sk]
    if causal:
        # fully-masked rows: keep their contribution exactly zero
        p = torch.where(mask, p, torch.zeros_like(p))
    alpha = torch.exp(m - m_new)                         # [B,Sq,H]
    l_new = l * alpha + p.sum(dim=-1).movedim(1, -1)
    o_new = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o_new, m_new, l_new


def _block_grads(q, k, v, dout, lse, delta, q_offset, kv_offset, causal,
                 scale):
    """The gradients one block contributes, all fp32: ``(dq, dk, dv)`` of
    ``q [B,Sq,H,D]`` against the block ``k/v [B,Sk,H,D]``, from the
    probabilities recomputed with the row log-sum-exp ``lse [B,Sq,H]`` and
    ``delta = rowsum(dout * out) [B,Sq,H]``."""
    s, mask = _scores(q, k, q_offset, kv_offset, causal, scale)
    p = torch.exp(s - lse.movedim(-1, 1)[..., None])
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout, v)
    ds = p * (dp - delta.movedim(-1, 1)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return dq, dk, dv


class _Ring(object):
    """This process's place in the ring of a ``seq`` group: its index, the
    group's size, and the global ranks it sends to and receives from."""

    def __init__(self, group):
        self.group = group
        if group is None:
            self.index, self.size = 0, 1
            return
        ranks = dist.get_process_group_ranks(group)
        self.index = ranks.index(dist.get_rank())
        self.size = len(ranks)
        self.next = ranks[(self.index + 1) % self.size]
        self.prev = ranks[(self.index - 1) % self.size]

    def rotate(self, *tensors):
        """Send ``tensors`` to the next rank and return the previous rank's
        (fresh buffers, same shapes and dtypes)."""
        received = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                    for t in tensors]
        ops = [dist.P2POp(dist.isend, t.contiguous(), self.next, self.group)
               for t in tensors]
        ops += [dist.P2POp(dist.irecv, r, self.prev, self.group)
                for r in received]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return received


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        ring = _Ring(group)
        chunk, kv_chunk = q.shape[1], k.shape[1]
        q32 = q.float()
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        m = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        for i in range(ring.size):
            kv_idx = (ring.index - i) % ring.size   # who made this block
            o, m, l = _block_attention(
                q32, k_blk.float(), v_blk.float(), o, m, l,
                q_offset=ring.index * chunk, kv_offset=kv_idx * kv_chunk,
                causal=causal, scale=scale)
            if i + 1 < ring.size:
                k_blk, v_blk = ring.rotate(k_blk, v_blk)
        l = l.clamp_min(1e-30)
        out = (o / l[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        ring, chunk, kv_chunk = ctx.ring, q.shape[1], k.shape[1]
        q32, dout32 = q.float(), dout.float()
        delta = (dout32 * out.float()).sum(-1)          # [B,Sq,H]
        dq = torch.zeros_like(q32)
        k_blk, v_blk = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for i in range(ring.size):
            kv_idx = (ring.index - i) % ring.size
            dq_i, dk_i, dv_i = _block_grads(
                q32, k_blk.float(), v_blk.float(), dout32, lse, delta,
                q_offset=ring.index * chunk, kv_offset=kv_idx * kv_chunk,
                causal=ctx.causal, scale=ctx.scale)
            dq = dq + dq_i
            dk, dv = dk + dk_i, dv + dv_i
            if i + 1 < ring.size:
                k_blk, v_blk, dk, dv = ring.rotate(k_blk, v_blk, dk, dv)
            elif ring.size > 1:
                # the accumulators' last hop takes them home
                dk, dv = ring.rotate(dk, dv)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def _seq_axis_size(mesh, seq_axis):
    names = mesh.mesh_dim_names or ()
    assert seq_axis in names, "mesh {} has no {!r} axis".format(
        dict(zip(names, mesh.shape)), seq_axis)
    return mesh_mod.axis_size(mesh, seq_axis)


def ring_attention(q, k, v, mesh, seq_axis="seq", batch_axis="data",
                   causal=False, scale=None):
    """Exact multi-head attention over sequence-sharded q/k/v.

    Args:
      q, k, v: this process's ``[batch, seq/P, heads, head_dim]`` chunks
        (may be bf16) of sequences sharded over ``seq_axis`` in rank order.
      mesh: the device mesh; must contain ``seq_axis``.
      batch_axis: the JAX signature's; the batch here is already local.
      causal: apply causal masking using *global* sequence positions.
      scale: score scale (default 1/sqrt(head_dim)).

    Returns this process's chunk of the output, shaped like ``q``."""
    del batch_axis
    _seq_axis_size(mesh, seq_axis)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _RingAttention.apply(q, k, v, mesh_mod.group(mesh, seq_axis),
                                causal, scale)


def _exchange(x, group):
    """``all_to_all_single`` over ``group`` of a ``[P, ...]`` tensor: slot r
    goes to rank r, and slot r of the result came from rank r."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads(x, group, size):
    """``[B, S/P, H, D] -> [B, S, H/P, D]``: head group r to rank r, the
    sequence chunks concatenated in rank order."""
    b, chunk, h, d = x.shape
    slots = x.reshape(b, chunk, size, h // size, d).permute(2, 0, 1, 3, 4)
    got = _exchange(slots, group)                # [P, B, S/P, H/P, D]
    return got.permute(1, 0, 2, 3, 4).reshape(b, size * chunk, h // size, d)


def _heads_to_seq(x, group, size):
    """``[B, S, H/P, D] -> [B, S/P, H, D]``: the inverse of
    :func:`_seq_to_heads`."""
    b, seq, hp, d = x.shape
    chunk = seq // size
    slots = x.reshape(b, size, chunk, hp, d).permute(1, 0, 2, 3, 4)
    got = _exchange(slots, group)                # [P, B, S/P, H/P, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, chunk, size * hp, d)


class _SeqToHeads(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return _seq_to_heads(x, group, size)

    @staticmethod
    def backward(ctx, grad):
        return _heads_to_seq(grad, ctx.group, ctx.size), None, None


class _HeadsToSeq(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return _heads_to_seq(x, group, size)

    @staticmethod
    def backward(ctx, grad):
        return _seq_to_heads(grad, ctx.group, ctx.size), None, None


def ulysses_attention(q, k, v, mesh, seq_axis="seq", batch_axis="data",
                      causal=False, scale=None, impl="einsum"):
    """All-to-all ("Ulysses"-style) sequence-parallel attention.

    Requires ``heads % mesh.shape[seq_axis] == 0``; each process attends
    over the full sequence for its slice of heads, with two all-to-alls
    doing the re-sharding.  ``impl="flash"`` runs the local attention
    through the hand-written flash kernels
    (:func:`~tensorflowonspark_torch.ops.flash_attention`), ``"einsum"``
    through :func:`reference_attention`.  Same signature and semantics as
    :func:`ring_attention`."""
    del batch_axis
    size = _seq_axis_size(mesh, seq_axis)
    assert q.shape[2] % size == 0, (
        "heads {} not divisible by seq-parallel degree {}".format(
            q.shape[2], size))
    if impl not in ("einsum", "flash"):
        raise ValueError("impl must be 'einsum' or 'flash', got {!r}".format(
            impl))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = mesh_mod.group(mesh, seq_axis)
    if group is not None:
        q, k, v = (_SeqToHeads.apply(x, group, size) for x in (q, k, v))
    if impl == "flash":
        from tensorflowonspark_torch.ops import flash_attention

        out = flash_attention(q, k, v, causal=causal, scale=scale)
    else:
        out = reference_attention(q, k, v, causal=causal, scale=scale)
    if group is not None:
        out = _HeadsToSeq.apply(out, group, size)
    return out


def chained_ring_attention(q, k, v, num_chunks, causal=False, scale=None):
    """The ring's arithmetic over ``num_chunks`` sequence chunks in one
    process, forward and backward: what ``num_chunks`` ranks of a ``seq``
    group compute, each chunk's queries against every key/value block with
    the ring's global offsets, its accumulators handed from block to block
    as the ring hands them, and the backward of :func:`ring_attention`'s
    block steps.  For checks of the recurrence where a world of that size
    is not at hand."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _ChainedRing.apply(q, k, v, num_chunks, causal, scale)


class _ChainedRing(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, num_chunks, causal, scale):
        qs, ks, vs = (x.float().chunk(num_chunks, dim=1) for x in (q, k, v))
        chunk = qs[0].shape[1]
        outs, lses = [], []
        for r in range(num_chunks):
            o = torch.zeros_like(qs[r])
            m = torch.full(qs[r].shape[:3], NEG_INF, dtype=torch.float32,
                           device=q.device)
            l = torch.zeros_like(m)
            for i in range(num_chunks):
                j = (r - i) % num_chunks
                o, m, l = _block_attention(qs[r], ks[j], vs[j], o, m, l,
                                           r * chunk, j * chunk, causal,
                                           scale)
            l = l.clamp_min(1e-30)
            outs.append(o / l[..., None])
            lses.append(m + torch.log(l))
        out = torch.cat(outs, dim=1).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, torch.cat(lses, dim=1))
        ctx.num_chunks, ctx.causal, ctx.scale = num_chunks, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        n = ctx.num_chunks
        qs, ks, vs, dos, lses = (x.float().chunk(n, dim=1)
                                 for x in (q, k, v, dout, lse))
        deltas = (dout.float() * out.float()).sum(-1).chunk(n, dim=1)
        chunk = qs[0].shape[1]
        dq = [torch.zeros_like(x) for x in qs]
        dk = [torch.zeros_like(x) for x in ks]
        dv = [torch.zeros_like(x) for x in vs]
        for r in range(n):
            for i in range(n):
                j = (r - i) % n
                dq_i, dk_i, dv_i = _block_grads(
                    qs[r], ks[j], vs[j], dos[r], lses[r], deltas[r],
                    r * chunk, j * chunk, ctx.causal, ctx.scale)
                dq[r] = dq[r] + dq_i
                dk[j] = dk[j] + dk_i
                dv[j] = dv[j] + dv_i
        return (torch.cat(dq, 1).to(q.dtype), torch.cat(dk, 1).to(k.dtype),
                torch.cat(dv, 1).to(v.dtype), None, None, None)
