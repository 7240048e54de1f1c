"""Decoder-only transformer LM (the port of
:mod:`tensorflowonspark_tpu.models.transformer`).

The same model as the flax one, with its numerics:

- params are fp32; ``dtype`` is the compute dtype.  Dense layers and
  embeddings cast inputs and params to ``dtype`` (flax ``promote_dtype``);
  LayerNorm takes its statistics in fp32 (mean of squares minus squared
  mean, clipped at 0) with eps 1e-6 and returns ``dtype``;
- the MLP's gelu is the tanh approximation (flax ``nn.gelu``);
- the readout is weight-tied to the token embedding, computed in ``dtype``
  and returned as fp32.

``attention`` picks the core contraction: ``"full"`` is
:func:`~tensorflowonspark_torch.parallel.ring.reference_attention`,
``"flash"`` the hand-written CUDA kernel
(:mod:`tensorflowonspark_torch.ops.flash_attention`).  Both read the same
weights, as in the JAX package.  :mod:`~tensorflowonspark_torch.convert`
maps a flax param tree onto this module's ``state_dict`` and back.
:func:`loss_fn` is the next-token loss the Trainer takes.

One numeric difference from flax in bf16: flax ``nn.Embed`` casts the
table to bf16 before the gather, so its embedding gradient is scatter-added
in bf16; :class:`Embed` here gathers from the fp32 table and casts after,
so the same forward values get an fp32 scatter-add (ROADMAP.md, Queue 3).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.models import register_model
from tensorflowonspark_torch.ops import flash_attention
from tensorflowonspark_torch.parallel import ring

_ATTENTIONS = ("full", "flash", "ring", "ulysses")


def _torch_dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` is ``[out, in]`` (the transpose of the
    flax kernel); inputs and params are cast to ``dtype``."""

    def __init__(self, in_features, out_features, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator):
        # flax's lecun_normal scale, untruncated
        self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[1]),
                            generator=generator)
        self.bias.zero_()

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class Embed(nn.Module):
    """flax ``nn.Embed``: the table is cast to ``dtype`` on lookup."""

    def __init__(self, num_embeddings, features, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator):
        self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[1]),
                            generator=generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: fp32 statistics by the fast variance, eps
    1e-6, scale and bias in fp32, result in ``dtype``."""

    def __init__(self, features, dtype=torch.float32, eps=1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator=None):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, num_heads, head_dim, attention="full", mesh=None,
                 dtype=torch.float32):
        super().__init__()
        if attention not in _ATTENTIONS:
            raise ValueError("attention must be one of {}, got {!r}".format(
                _ATTENTIONS, attention))
        if attention in ("ring", "ulysses"):
            raise NotImplementedError(
                "attention={!r} is not ported yet (ROADMAP.md, Queue 1, "
                "the parallelism slice)".format(attention))
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.attention = attention
        features = num_heads * head_dim
        self.qkv = Dense(features, 3 * features, dtype)
        self.proj = Dense(features, features, dtype)

    def forward(self, x):
        batch, seq, _ = x.shape
        qkv = self.qkv(x).view(batch, seq, 3, self.num_heads, self.head_dim)
        # strided views into the one projection output: the kernel reads
        # them in place
        q, k, v = qkv.unbind(2)
        if self.attention == "flash":
            out = flash_attention(q, k, v, causal=True)
        else:
            out = ring.reference_attention(q, k, v, causal=True)
        return self.proj(out.reshape(batch, seq, -1))


class Block(nn.Module):
    def __init__(self, num_heads, head_dim, mlp_ratio=4, attention="full",
                 mlp="dense", num_experts=8, capacity_factor=1.25,
                 ep_mode="gspmd", mesh=None, ep_batch_axes=None,
                 dtype=torch.float32):
        super().__init__()
        if mlp != "dense":
            raise NotImplementedError(
                "mlp={!r} is not ported yet (ROADMAP.md, Queue 1, "
                "MoE)".format(mlp))
        d_model = num_heads * head_dim
        self.ln1 = LayerNorm(d_model, dtype)
        self.attn = Attention(num_heads, head_dim, attention, mesh, dtype)
        self.ln2 = LayerNorm(d_model, dtype)
        self.mlp_in = Dense(d_model, d_model * mlp_ratio, dtype)
        self.mlp_out = Dense(d_model * mlp_ratio, d_model, dtype)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerLM(nn.Module):
    """Token ids ``[batch, seq]`` -> fp32 logits ``[batch, seq, vocab]``.

    Parameters are allocated but not initialised: call
    :meth:`init_weights` with an explicit generator, or load a
    ``state_dict``."""

    def __init__(self, vocab_size=32000, num_layers=4, num_heads=8,
                 head_dim=64, max_seq_len=2048, attention="full",
                 mlp="dense", num_experts=8, capacity_factor=1.25,
                 ep_mode="gspmd", mesh=None, ep_batch_axes=None, remat=False,
                 dtype=torch.float32):
        super().__init__()
        if remat:
            raise NotImplementedError(
                "remat (recompute each block's activations in the "
                "backward) is not ported yet (ROADMAP.md, Queue 1, the "
                "module queue: remat)")
        dtype = _torch_dtype(dtype)
        self.dtype = dtype
        d_model = num_heads * head_dim
        self.embed = Embed(vocab_size, d_model, dtype)
        self.pos_embed = Embed(max_seq_len, d_model, dtype)
        self.blocks = nn.ModuleList(
            Block(num_heads, head_dim, attention=attention, mlp=mlp,
                  num_experts=num_experts, capacity_factor=capacity_factor,
                  ep_mode=ep_mode, mesh=mesh, ep_batch_axes=ep_batch_axes,
                  dtype=dtype)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(d_model, dtype)

    @torch.no_grad()
    def init_weights(self, generator):
        """Initialise every parameter from ``generator`` (on the params'
        device), with flax's default scales."""
        for module in self.modules():
            if isinstance(module, (Dense, Embed, LayerNorm)):
                module.reset_parameters(generator)
        return self

    def forward(self, tokens):
        seq = tokens.shape[1]
        x = self.embed(tokens.long()) + self.pos_embed.weight[:seq].to(self.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x)
        return (x @ self.embed.weight.to(self.dtype).t()).float()


@register_model("transformer_lm")
def build_transformer(vocab_size=32000, num_layers=4, num_heads=8,
                      head_dim=64, max_seq_len=2048, attention="full",
                      mlp="dense", num_experts=8, capacity_factor=1.25,
                      ep_mode="gspmd", mesh=None, ep_batch_axes=None,
                      remat=False, dtype="float32"):
    return TransformerLM(vocab_size=vocab_size, num_layers=num_layers,
                         num_heads=num_heads, head_dim=head_dim,
                         max_seq_len=max_seq_len, attention=attention,
                         mlp=mlp, num_experts=num_experts,
                         capacity_factor=capacity_factor, ep_mode=ep_mode,
                         mesh=mesh, ep_batch_axes=ep_batch_axes,
                         remat=remat, dtype=dtype)


def loss_fn(model, moe_aux_weight=0.01):
    """Next-token cross-entropy with per-row masking, as
    ``fn(params, batch, mask) -> (loss, aux)`` over a name->tensor dict of
    ``model``'s params (applied with ``torch.func.functional_call``).

    The model is applied to the full sequence; targets are the tokens
    rolled by -1 and the last position, which has no target, is masked
    out.  The cross entropy is taken on the fp32 logits, averaged over
    positions per row, then over rows weighted by ``mask`` (divided by
    ``max(mask.sum(), 1)``).  ``moe_aux_weight`` is kept for the JAX
    signature: MoE blocks are not ported, so ``aux`` is empty."""
    del moe_aux_weight

    def loss(params, batch, mask):
        tokens = batch["tokens"].long()
        logits = torch.func.functional_call(model, params, (tokens,))
        batch_size, seq = tokens.shape
        targets = torch.roll(tokens, -1, dims=1)
        ce = F.cross_entropy(logits.float().reshape(batch_size * seq, -1),
                             targets.reshape(-1), reduction="none")
        # 1 for every position but the last; built on the device with no
        # host copy, so a CUDA graph can capture it
        pos_mask = (torch.arange(seq, device=logits.device)
                    < seq - 1).float()
        ce = (ce.reshape(batch_size, seq) * pos_mask).sum(-1) / pos_mask.sum()
        mask = mask.to(ce.dtype)
        ce = (ce * mask).sum() / mask.sum().clamp_min(1.0)
        return ce, {}

    return loss
