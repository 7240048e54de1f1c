"""Attention contractions (the port of
:mod:`tensorflowonspark_tpu.parallel.ring`).

Only :func:`reference_attention` is ported so far: it is the transformer's
``attention="full"`` path and the tests' oracle.  Ring and Ulysses
sequence parallelism wait for the parallelism slice (ROADMAP.md, Queue 1).
"""

import math

import torch

NEG_INF = -1e30


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
