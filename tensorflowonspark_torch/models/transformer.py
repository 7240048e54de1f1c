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

``remat=True`` recomputes each block's activations in the backward instead
of keeping them (flax ``nn.remat(Block)``, which renames no param, so the
converter maps the same tree): every block runs under
``torch.utils.checkpoint`` while gradients are recorded, so a training step
runs the flash forward twice per layer and a server (no gradients) never
pays for the recompute.

``mlp="moe"`` replaces each block's dense MLP with :class:`MoEMlp`, the
Switch-style top-1 mixture of experts: routing as dense one-hot products,
grouped per batch row, with the JAX layer's two expert-parallel modes
(``ep_mode="gspmd"``, the dense dispatch partitioned over an ``expert``
axis, and ``"shard_map"``, the explicit all-to-all schedule of
:func:`~tensorflowonspark_torch.parallel.ep.moe_ffn`), and the load-balance
term of every block summed and returned beside the logits
(``forward(tokens, return_aux=True)``), which :func:`loss_fn` weights in.
Each block returns its term instead of keeping it in module state, so the
recompute of ``remat=True`` does not count it twice.

On a mesh with a ``tensor`` axis each block splits its heads and its MLP's
hidden features over that axis (Megatron's layout; the flash kernels run
on the rank's H/T heads), whatever layout the params are stored in
(:mod:`~tensorflowonspark_torch.parallel.tp`).

``attention`` picks the core contraction: ``"full"`` is
:func:`~tensorflowonspark_torch.parallel.ring.reference_attention`,
``"flash"`` the hand-written CUDA kernel
(:mod:`tensorflowonspark_torch.ops.flash_attention`), ``"ring"`` and
``"ulysses"`` the sequence-parallel contractions of
:mod:`~tensorflowonspark_torch.parallel.ring` over the ``mesh``'s ``seq``
axis (Ulysses with the JAX model's default ``impl="einsum"``).  All read the
same weights, as in the JAX package.  On a mesh whose ``seq`` axis is P > 1
each process holds ``[B, S/P]`` tokens, the chunk of its ``seq`` rank: the
position embedding reads the chunk's global positions, and :func:`loss_fn`
takes each row's mean over the global sequence.  :mod:`~tensorflowonspark_torch.convert`
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
import torch.utils.checkpoint
from torch import nn

from tensorflowonspark_torch.models import register_model
from tensorflowonspark_torch.ops import flash_attention
from tensorflowonspark_torch.parallel import comm
from tensorflowonspark_torch.parallel import ep as ep_mod
from tensorflowonspark_torch.parallel import mesh as mesh_mod
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


def _tensor_split(mesh):
    """``(T, rank, group)`` of the mesh's ``tensor`` axis: ``(1, 0, None)``
    without a mesh or with an axis of 1, where the split products are the
    whole ones, to the bit."""
    size = 1 if mesh is None else mesh_mod.axis_size(mesh, "tensor")
    if size == 1:
        return 1, 0, None
    return size, mesh.get_local_rank("tensor"), mesh_mod.group(mesh,
                                                                "tensor")


def _row_parallel(x, dense, rank, width, group, dtype):
    """``x`` (this rank's ``width`` input features) through its columns of
    ``dense``, the partial products summed over ``group`` in fp32, then the
    bias (every rank uses every leaf, so their gradients line up); with one
    rank this is ``dense(x)`` to the bit."""
    weight = dense.weight.narrow(1, rank * width, width).to(dtype)
    if group is None:
        return F.linear(x, weight, dense.bias.to(dtype))
    part = comm.all_reduce(F.linear(x, weight).float(), group)
    return part.to(dtype) + dense.bias.to(dtype)


def _row_block(weight, bias, rank, size, dtype):
    """Rows ``rank`` of ``size`` blocks of a Dense weight (and its bias):
    the output features of a column-parallel product, in ``dtype``."""
    rows = weight.shape[0] // size
    return (weight.narrow(0, rank * rows, rows).to(dtype),
            bias.narrow(0, rank * rows, rows).to(dtype))


class Attention(nn.Module):
    """qkv projection, causal attention, output projection (the
    :class:`Dense` modules hold the params; the products read them).

    On a mesh whose ``tensor`` axis is T > 1 the heads split over it
    (Megatron's attention): rank r projects and attends over heads
    ``r*H/T ... (r+1)*H/T`` only (the flash kernels take whole heads, so the
    q/k/v activations are head-sharded whatever the qkv weight's stored
    layout) and applies the matching columns of ``proj``; the partial
    products are summed over the ``tensor`` group in fp32.  H must divide
    by T."""

    def __init__(self, num_heads, head_dim, attention="full", mesh=None,
                 dtype=torch.float32):
        super().__init__()
        if attention not in _ATTENTIONS:
            raise ValueError("attention must be one of {}, got {!r}".format(
                _ATTENTIONS, attention))
        if attention in ("ring", "ulysses") and mesh is None:
            raise ValueError("{} attention needs a mesh".format(attention))
        tensor = 1 if mesh is None else mesh_mod.axis_size(mesh, "tensor")
        if num_heads % tensor:
            raise ValueError(
                "heads {} not divisible by the tensor axis {}".format(
                    num_heads, tensor))
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.attention = attention
        self.mesh = mesh
        self.dtype = dtype
        features = num_heads * head_dim
        self.qkv = Dense(features, 3 * features, dtype)
        self.proj = Dense(features, features, dtype)

    def _core(self, q, k, v):
        if self.attention == "flash":
            return flash_attention(q, k, v, causal=True)
        if self.attention == "ring":
            return ring.ring_attention(q, k, v, self.mesh, causal=True)
        if self.attention == "ulysses":
            return ring.ulysses_attention(q, k, v, self.mesh, causal=True)
        return ring.reference_attention(q, k, v, causal=True)

    def forward(self, x):
        batch, seq, _ = x.shape
        size, rank, group = _tensor_split(self.mesh)
        heads = self.num_heads // size
        d_model = x.shape[-1]
        w = self.qkv.weight.view(3, self.num_heads, self.head_dim, d_model)
        w = w.narrow(1, rank * heads, heads).reshape(-1, d_model)
        b = self.qkv.bias.view(3, self.num_heads, self.head_dim).narrow(
            1, rank * heads, heads).reshape(-1)
        qkv = F.linear(x.to(self.dtype), w.to(self.dtype),
                       b.to(self.dtype)).view(batch, seq, 3, heads,
                                              self.head_dim)
        # strided views into the one projection output: the kernel reads
        # them in place
        q, k, v = qkv.unbind(2)
        out = self._core(q, k, v).reshape(batch, seq, -1)
        width = heads * self.head_dim
        return _row_parallel(out, self.proj, rank, width, group, self.dtype)


class MoEMlp(nn.Module):
    """Switch-style top-1 mixture-of-experts FFN with GShard dispatch and
    combine (flax ``MoEMlp``): ``x [G, S, D] -> (y [G, S, D], load-balance
    term)``, a group per batch row.

    The router is a fp32 ``Dense(D, E)`` on ``x`` cast to fp32; each token
    goes to its most probable expert, in that expert's buffer of
    ``capacity = max(int(capacity_factor * S / E), 1)`` slots at its
    position among the group's tokens routed there
    (:func:`~tensorflowonspark_torch.parallel.ep.route`, shared with the
    explicit schedule).  Tokens past capacity get no slot: they contribute
    zero and ride the block's residual.  The layer is three products in
    ``dtype`` (dispatch, the expert FFN with tanh gelu, combine), the
    one-hot dispatch and combine tensors ``[G, S, E, C]`` built by
    comparison, with no data-dependent shape and no host readback, so a
    CUDA graph captures it.  Params keep flax's layout: ``router`` (a
    :class:`Dense`), ``w1 [E, D, H]``, ``b1 [E, H]``, ``w2 [E, H, D]``,
    ``b2 [E, D]``.

    On a mesh:

    - a ``seq`` axis above 1: the capacity comes from the global sequence
      (as in the JAX layer, which sees it whole), so the group's chunks are
      all-gathered, routed and computed whole, and this rank keeps its
      chunk;
    - ``ep_mode="gspmd"`` on an ``expert`` axis above 1: this rank applies
      its E/ep experts (its block of the dispatch tensor's E dim) and the
      partial combines are summed over the ``expert`` group; when
      ``expert`` carries distinct rows (it is in ``ep_batch_axes``) the
      group's rows are gathered first and the sum reduce-scattered back;
    - ``ep_mode="shard_map"``: :func:`~tensorflowonspark_torch.parallel.ep.moe_ffn`,
      the explicit all-to-all schedule, with ``ep_batch_axes`` (which needs
      a mesh with an ``expert`` axis).

    ``ep_batch_axes`` names the mesh axes over which this process's rows
    are distinct (JAX's "mesh axes the caller's batch sharding puts on the
    group dim"); None is the Trainer's default, the mesh's ``data`` and
    ``fsdp`` axes.  The load-balance term averages ``fraction`` and
    ``mean_prob`` over them, so it is the global batch's, as the JAX
    layer's.  The expert leaves may hold all E experts or this rank's E/ep
    block (placed over ``expert``, see
    :func:`~tensorflowonspark_torch.parallel.ep.merge_ep_shardings`)."""

    def __init__(self, d_model, num_experts=8, mlp_ratio=4,
                 capacity_factor=1.25, ep_mode="gspmd", mesh=None,
                 ep_batch_axes=None, dtype=torch.float32):
        super().__init__()
        if ep_mode not in ("gspmd", "shard_map"):
            raise ValueError("ep_mode must be 'gspmd' or 'shard_map', got "
                             "{!r}".format(ep_mode))
        if ep_mode == "shard_map" and (
                mesh is None or "expert" not in (mesh.mesh_dim_names or ())):
            raise ValueError("ep_mode='shard_map' needs a mesh with an "
                             "'expert' axis")
        ep = 1 if mesh is None else mesh_mod.axis_size(mesh, "expert")
        if num_experts % ep:
            raise ValueError(
                "num_experts {} not divisible by expert axis size {}".format(
                    num_experts, ep))
        hidden = d_model * mlp_ratio
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.ep_mode = ep_mode
        self.mesh = mesh
        if ep_batch_axes is None:
            ep_batch_axes = () if mesh is None else tuple(
                a for a in mesh_mod.BATCH_AXES if a in mesh.mesh_dim_names)
        self.ep_batch_axes = ((ep_batch_axes,)
                              if isinstance(ep_batch_axes, str)
                              else tuple(ep_batch_axes))
        self.dtype = dtype
        self.router = Dense(d_model, num_experts, torch.float32)
        self.w1 = nn.Parameter(torch.empty(num_experts, d_model, hidden))
        self.b1 = nn.Parameter(torch.empty(num_experts, hidden))
        self.w2 = nn.Parameter(torch.empty(num_experts, hidden, d_model))
        self.b2 = nn.Parameter(torch.empty(num_experts, d_model))

    def reset_parameters(self, generator):
        # flax's lecun_normal counts every dim but the last into the fan-in:
        # E * D for w1, E * H for w2 (the router is a Dense of its own)
        for w in (self.w1, self.w2):
            fan_in = w.shape[0] * w.shape[1]
            w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
        self.b1.zero_()
        self.b2.zero_()

    def capacity(self, seq):
        """Slots per expert in a group of ``seq`` tokens."""
        return max(int(self.capacity_factor * seq / self.num_experts), 1)

    def route(self, x):
        """``(probs [G, S, E] fp32, expert_idx [G, S], expert_prob [G, S],
        pos [G, S])`` (see :func:`~tensorflowonspark_torch.parallel.ep.route`)."""
        return ep_mod.route(self.router(x.float()), self.num_experts)

    def _group(self, axis):
        return None if self.mesh is None else mesh_mod.group(self.mesh, axis)

    def forward(self, x):
        seq_group = self._group("seq")
        if seq_group is not None:
            chunk = x.shape[1]
            x = comm.all_gather(x, seq_group, dim=1)
        if self.ep_mode == "shard_map":
            params = {"router.weight": self.router.weight,
                      "router.bias": self.router.bias, "w1": self.w1,
                      "b1": self.b1, "w2": self.w2, "b2": self.b2}
            y, aux = ep_mod.moe_ffn(
                x, params, self.mesh, self.num_experts,
                capacity_factor=self.capacity_factor, dtype=self.dtype,
                batch_axes=self.ep_batch_axes)
        else:
            y, aux = self._gspmd(x)
        if seq_group is not None:
            y = y.narrow(1, self.mesh.get_local_rank("seq") * chunk, chunk)
        return y, aux

    def _gspmd(self, x):
        expert_group = self._group("expert")
        distinct = "expert" in self.ep_batch_axes
        if expert_group is not None and distinct:
            x = comm.all_gather(x, expert_group, dim=0)
        dispatch, expert_prob, (fraction, mean_prob) = ep_mod._route(
            x, self.router(x.float()), self.num_experts,
            self.capacity(x.shape[1]))
        if expert_group is None:
            w1, b1, w2, b2 = self.w1, self.b1, self.w2, self.b2
        else:
            w1, b1, w2, b2 = (ep_mod.local_experts(
                t, self.mesh, "expert", self.num_experts)
                for t in (self.w1, self.b1, self.w2, self.b2))
            local = w1.shape[0]
            dispatch = dispatch.narrow(
                2, self.mesh.get_local_rank("expert") * local, local)
        expert_in = torch.einsum("gsec,gsd->gecd", dispatch, x)
        out = ep_mod.expert_ffn(expert_in, w1, b1, w2, b2, self.dtype)
        combine = dispatch * expert_prob.to(x.dtype)[..., None, None]
        mixed = torch.einsum("gsec,gecd->gsd", combine, out)
        if expert_group is not None:
            mixed = (comm.reduce_scatter(mixed, expert_group, dim=0)
                     if distinct else comm.all_reduce(mixed, expert_group))
        # Switch load balance: E * sum_e fraction_e * mean_prob_e, the
        # means over the rows of every axis that carries distinct rows
        axes = tuple(a for a in self.ep_batch_axes if a != "expert")
        if axes:
            mean_group = mesh_mod.groups(self.mesh, axes)
            fraction = comm.pmean(fraction, mean_group)
            mean_prob = comm.pmean(mean_prob, mean_group)
        aux = self.num_experts * (fraction * mean_prob).sum()
        return mixed, aux


class Block(nn.Module):
    """Pre-LayerNorm attention and MLP (dense, or :class:`MoEMlp` with
    ``mlp="moe"``), each with a residual: ``x -> (x, aux)``, ``aux`` the
    MoE load-balance term (None for a dense block)."""

    def __init__(self, num_heads, head_dim, mlp_ratio=4, attention="full",
                 mlp="dense", num_experts=8, capacity_factor=1.25,
                 ep_mode="gspmd", mesh=None, ep_batch_axes=None,
                 dtype=torch.float32):
        super().__init__()
        if mlp not in ("dense", "moe"):
            raise ValueError("mlp must be 'dense' or 'moe', got {!r}".format(
                mlp))
        d_model = num_heads * head_dim
        self.ln1 = LayerNorm(d_model, dtype)
        self.attn = Attention(num_heads, head_dim, attention, mesh, dtype)
        self.ln2 = LayerNorm(d_model, dtype)
        self.mesh = mesh
        self.dtype = dtype
        if mlp == "moe":
            self.moe = MoEMlp(d_model, num_experts, mlp_ratio,
                              capacity_factor, ep_mode, mesh, ep_batch_axes,
                              dtype)
        else:
            self.moe = None
            self.mlp_in = Dense(d_model, d_model * mlp_ratio, dtype)
            self.mlp_out = Dense(d_model * mlp_ratio, d_model, dtype)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = self.ln2(x)
        if self.moe is not None:
            h, aux = self.moe(h)
            return x + h, aux
        # Megatron's MLP: rank r's block of the hidden features, the
        # second product's partial sums added over the tensor group
        size, rank, group = _tensor_split(self.mesh)
        w, b = _row_block(self.mlp_in.weight, self.mlp_in.bias, rank, size,
                          self.dtype)
        h = F.gelu(F.linear(h.to(self.dtype), w, b), approximate="tanh")
        return x + _row_parallel(h, self.mlp_out, rank, h.shape[-1], group,
                                 self.dtype), None


def _remat_block(block, x):
    """``block(x)`` under ``torch.utils.checkpoint``: only ``x`` is kept
    for the backward, which runs the block's forward again.  The params
    are passed in explicitly, as the tensors the block holds now (the
    ones ``torch.func.functional_call`` swapped in), so the recompute,
    which runs after that call has returned, reads the same tensors."""
    names, tensors = zip(*block.named_parameters())

    def run(x, *tensors):
        return torch.func.functional_call(block, dict(zip(names, tensors)),
                                          (x,))

    return torch.utils.checkpoint.checkpoint(run, x, *tensors,
                                             use_reentrant=False)


class TransformerLM(nn.Module):
    """Token ids ``[batch, seq]`` -> fp32 logits ``[batch, seq, vocab]``;
    with ``return_aux=True``, ``(logits, aux)``, ``aux`` the sum of the MoE
    blocks' load-balance terms (None without MoE blocks).

    Parameters are allocated but not initialised: call
    :meth:`init_weights` with an explicit generator, or load a
    ``state_dict``."""

    def __init__(self, vocab_size=32000, num_layers=4, num_heads=8,
                 head_dim=64, max_seq_len=2048, attention="full",
                 mlp="dense", num_experts=8, capacity_factor=1.25,
                 ep_mode="gspmd", mesh=None, ep_batch_axes=None, remat=False,
                 dtype=torch.float32):
        super().__init__()
        self.remat = bool(remat)
        dtype = _torch_dtype(dtype)
        self.dtype = dtype
        self.mesh = mesh
        d_model = num_heads * head_dim
        if mesh is not None:
            if self.seq_parallel > 1 and attention not in ("ring",
                                                            "ulysses"):
                raise ValueError(
                    "attention={!r} sees only this process's chunk of a "
                    "sequence sharded over the mesh's seq axis: use ring "
                    "or ulysses".format(attention))
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
            if isinstance(module, (Dense, Embed, LayerNorm, MoEMlp)):
                module.reset_parameters(generator)
        return self

    @property
    def batch_axes(self):
        """The mesh axes over which this process's rows are distinct, as
        the MoE blocks read them (their ``ep_batch_axes``); None for a
        dense model, whose layers do not depend on it.  The Trainer takes
        this value through :func:`loss_fn` and raises on another."""
        for block in self.blocks:
            if block.moe is not None:
                return block.moe.ep_batch_axes
        return None

    def flax_views(self):
        """``{name: (view shape, perm)}`` of the params laid out otherwise
        than their flax counterparts: ``param.view(shape).permute(perm)``
        is the flax leaf (shape None: the param's own).  A :class:`Dense`
        weight is the flax kernel transposed; the fused qkv projection is
        flax's ``DenseGeneral`` kernel ``[D, 3, H, Dh]`` and bias ``[3, H,
        Dh]``.  The sharding rules read the flax layout through these
        (:func:`~tensorflowonspark_torch.parallel.tp.tp_param_shardings`)."""
        views = {}
        for prefix, module in self.named_modules():
            dot = prefix + "." if prefix else ""
            if isinstance(module, Attention):
                heads, width = module.num_heads, module.head_dim
                views[dot + "qkv.weight"] = ((3, heads, width,
                                              heads * width), (3, 0, 1, 2))
                views[dot + "qkv.bias"] = ((3, heads, width), (0, 1, 2))
            elif isinstance(module, Dense) and dot + "weight" not in views:
                views[dot + "weight"] = (None, (1, 0))
        return views

    @property
    def seq_parallel(self):
        """P, the size of the mesh's ``seq`` axis (1 without a mesh)."""
        return 1 if self.mesh is None else mesh_mod.axis_size(self.mesh,
                                                               "seq")

    def seq_offset(self, chunk):
        """The global position of this process's first token, for chunks of
        ``chunk`` tokens (0 unless the ``seq`` axis is above 1)."""
        if self.seq_parallel == 1:
            return 0
        return self.mesh.get_local_rank("seq") * chunk

    def forward(self, tokens, return_aux=False):
        seq = tokens.shape[1]
        start = self.seq_offset(seq)
        x = (self.embed(tokens.long())
             + self.pos_embed.weight[start:start + seq].to(self.dtype))
        remat = self.remat and torch.is_grad_enabled()
        aux_sum = None
        for block in self.blocks:
            x, aux = _remat_block(block, x) if remat else block(x)
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
        x = self.ln_f(x)
        logits = (x @ self.embed.weight.to(self.dtype).t()).float()
        return (logits, aux_sum) if return_aux else logits


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
    ``max(mask.sum(), 1)``).

    On a mesh whose ``seq`` axis is P > 1 the batch is this process's
    ``[B, S/P]`` chunk of its ``seq`` group's rows (the group's members hold
    the same rows and mask): the target of a chunk's last token is the
    first token of the next chunk (one all-gather over the group), only the
    global last position is masked out, and each row's sum is divided by
    the global S - 1.  The loss is this chunk's share: the group's losses
    sum to the masked mean over its rows.  A model with MoE blocks adds
    ``moe_aux_weight`` (Switch Transformer's alpha) times the summed
    load-balance term, taken over every row (each rank of a ``seq`` group
    holds the whole sequence's term and adds 1/P of it), and reports it as
    ``aux["moe_aux_loss"]``; ``aux`` is empty otherwise.  The function's
    ``batch_axes`` is the model's (:attr:`TransformerLM.batch_axes`), which
    the Trainer adopts."""

    parts = model.seq_parallel

    def loss(params, batch, mask):
        tokens = batch["tokens"].long()
        logits, balance = torch.func.functional_call(
            model, params, (tokens,), {"return_aux": True})
        batch_size, seq = tokens.shape
        targets = torch.roll(tokens, -1, dims=1)
        if parts > 1:
            targets[:, -1] = _next_chunk_first(tokens, model.mesh)
        ce = F.cross_entropy(logits.float().reshape(batch_size * seq, -1),
                             targets.reshape(-1), reduction="none")
        # 1 for every global position but the last; built on the device
        # with no host copy, so a CUDA graph can capture it
        start = model.seq_offset(seq)
        pos_mask = (torch.arange(start, start + seq, device=logits.device)
                    < parts * seq - 1).float()
        ce = (ce.reshape(batch_size, seq) * pos_mask).sum(-1) / (
            parts * seq - 1)
        mask = mask.to(ce.dtype)
        ce = (ce * mask).sum() / mask.sum().clamp_min(1.0)
        aux = {}
        if balance is not None:
            aux["moe_aux_loss"] = balance
            # every rank of a seq group holds the whole sequence's term:
            # its chunk's loss carries 1/P of it
            ce = ce + moe_aux_weight * balance / parts
        return ce, aux

    # the rows' layout the model was built for: the Trainer adopts it
    loss.batch_axes = model.batch_axes
    return loss


def _next_chunk_first(tokens, mesh):
    """The first token of every row of the next ``seq`` rank's chunk (the
    last rank's next is the first chunk, as a roll wraps): one all-gather of
    ``[B]`` tokens over the ``seq`` group."""
    group = mesh_mod.group(mesh, "seq")
    parts = mesh_mod.axis_size(mesh, "seq")
    firsts = torch.empty(parts * tokens.shape[0], dtype=tokens.dtype,
                         device=tokens.device)
    torch.distributed.all_gather_into_tensor(
        firsts, tokens[:, 0].contiguous(), group=group)
    return firsts.view(parts, -1)[(mesh.get_local_rank("seq") + 1) % parts]
