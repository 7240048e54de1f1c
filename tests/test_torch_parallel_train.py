"""The port's Trainer on a mesh against the JAX package's on the CPU:
three Adam steps under ``param_sharding="fsdp"`` and of the LM with its
sequence split over a ``seq`` axis (ring and Ulysses attention), against the
JAX Trainer on its mesh of 8 virtual devices; the ``seq`` group's pooled
feed; K = 5 against K = 1 under FSDP.  (The re-pointed cases of
``tests/test_parallel.py``'s ``TestFSDP`` and ``TestFSDPStateSharding`` and
``tests/test_models.py``'s ``test_forward_modes_agree`` and
``test_sequence_parallel_training_step``;
``tests/test_torch_parallel_ckpt.py`` holds the checkpoints across world
sizes.)

The port runs in a gloo world of 4 (``tests/torch_world.run_world``), its
ranks a module-level function of this file; jax is imported inside the
tests only, since the ranks import this module."""

import functools

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import train
from tensorflowonspark_torch.models import transformer
from tensorflowonspark_torch.parallel import infeed, mesh as mesh_mod

from torch_world import run_world

# d_model 64 and vocab 256: the token table and both MLP weights reach the
# FSDP rule's 2^14 elements and shard; the rest replicates
CFG = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=16,
           max_seq_len=32)
SEQ, BATCH = 32, 8
# a padded final step: 6 valid rows of 8
MASK = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
LR = 1e-3
# fp32 on both sides, the sums in another order: 1e-5 relative on the
# loss, 1e-5 on the params after three Adam steps, except the key bias of
# the qkv projection, whose gradient is zero in exact arithmetic: Adam
# turns either side's rounding noise into steps of up to lr, so that slice
# is held to 3 steps x lr x 2 (tests/test_torch_train.py's allowance)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
KEY_BIAS_ATOL = 3 * LR * 2


def _tokens(seed):
    """The JAX LM example's learnable stream: rows counting up from random
    offsets."""
    offs = np.random.default_rng(seed).integers(0, CFG["vocab_size"],
                                                (BATCH, 1))
    return ((np.arange(SEQ)[None] + offs) % CFG["vocab_size"]).astype(
        np.int32)


def _init_state():
    """The seed-0 init of the port's model, as numpy."""
    model = transformer.build_transformer(**CFG)
    model.init_weights(torch.Generator().manual_seed(0))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _block(x, mesh):
    """This rank's block of a global ``[B, ...]`` array: its rows of the
    data-like axes and, for ``[B, S]``, its chunk of the ``seq`` axis."""
    index, count = mesh_mod.row_shard(mesh)
    rows = x.shape[0] // count
    x = x[index * rows:(index + 1) * rows]
    parts = mesh_mod.axis_size(mesh, "seq")
    if x.ndim > 1 and parts > 1:
        chunk = x.shape[1] // parts
        r = mesh.get_local_rank("seq")
        x = x[:, r * chunk:(r + 1) * chunk]
    return x


def _trainer(state, mesh=None, attention="full", param_sharding=None,
             **kwargs):
    model = transformer.build_transformer(**CFG, attention=attention,
                                          mesh=mesh)
    return train.Trainer(
        transformer.loss_fn(model),
        {k: torch.from_numpy(v) for k, v in state.items()},
        functools.partial(torch.optim.Adam, lr=LR), batch_size=BATCH,
        device="cpu", mesh=mesh, param_sharding=param_sharding, **kwargs)


def _params(tr):
    return {k: v.detach().numpy().copy() for k, v in tr.state.params.items()}


def _three_steps(state, mesh, attention, param_sharding):
    tr = _trainer(state, mesh, attention, param_sharding)
    losses = [tr.step({"tokens": _block(_tokens(10 + i), mesh)},
                      _block(MASK, mesh))[0].item() for i in range(3)]
    return {"losses": losses, "params": _params(tr),
            "grad_norm": float(tr._health_grad_norm),
            "opt_shapes": {
                name: tuple(tr.state.optimizer.state[p]["exp_avg"].shape)
                for name, p in zip(tr.state.params,
                                   tr.state.optimizer.param_groups[0][
                                       "params"])}}


class _RankRows(object):
    """A DataFeed stand-in for ``ShardedFeed``'s columnar path: this rank's
    ``n`` rows of ``[SEQ]`` tokens, ``rank * 100 + row`` in column 0."""

    def __init__(self, rank, n):
        tokens = np.tile(np.arange(SEQ, dtype=np.int32), (n, 1))
        tokens[:, 0] = rank * 100 + np.arange(n)
        self.tokens, self.pos = tokens, 0

    def next_batch_arrays(self, n):
        rows = self.tokens[self.pos:self.pos + n]
        self.pos += len(rows)
        return {"tokens": rows}, len(rows)

    def should_stop(self):
        return self.pos >= len(self.tokens)

    def interrupt(self):
        pass

    def terminate(self):
        pass


def _pooled_feed(rank, mesh):
    """The ``seq`` group's pooled batches of a feed of 5 rows a rank, 2 a
    step (a global batch of 8): as single steps (2 full, then a padded
    one), then in groups of 2."""
    out = {}
    for key, k in (("single", 1), ("grouped", 2)):
        feed = infeed.ShardedFeed(_RankRows(rank, 5), 8, device="cpu",
                                  mesh=mesh, prefetch=0)
        items = (feed.batches() if k == 1 else
                 (item[1:] for item in feed.grouped_batches(k)))
        out[key] = [(b["tokens"].numpy().copy(), m.numpy().copy())
                    for b, m in items]
    return out


# test_forward_modes_agree's sequence-parallel modes, on four ranks
FORWARD_MODES = {"ring": {"seq": 4}, "ulysses": {"data": 2, "seq": 2}}


def _world4(rank, state):
    """Everything a world of four does: the FSDP, ring and Ulysses steps,
    the pooled feed, K = 5 against K = 1 under FSDP."""
    torch.set_num_threads(1)
    out = {}
    for key, spec, attention, sharding in (
            ("fsdp_d2f2", {"data": 2, "fsdp": 2}, "full", "fsdp"),
            ("fsdp_f4", {"fsdp": 4}, "full", "fsdp"),
            ("ring_d2s2", {"data": 2, "seq": 2}, "ring", None),
            ("ulysses_d2s2", {"data": 2, "seq": 2}, "ulysses", None),
            ("ring_fsdp_f2s2", {"fsdp": 2, "seq": 2}, "ring", "fsdp")):
        mesh = mesh_mod.build_mesh(spec, keep_trivial_axes=True,
                                   device="cpu")
        out[key] = _three_steps(state, mesh, attention, sharding)
    mesh = mesh_mod.build_mesh({"data": 2, "seq": 2}, device="cpu")
    out["feed"] = _pooled_feed(rank, mesh)
    for attention, spec in FORWARD_MODES.items():
        mesh = mesh_mod.build_mesh(spec, keep_trivial_axes=True,
                                   device="cpu")
        model = transformer.build_transformer(**CFG, attention=attention,
                                              mesh=mesh)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        with torch.no_grad():
            out["logits_" + attention] = model(torch.from_numpy(
                _block(_tokens(50), mesh))).numpy()
    mesh = mesh_mod.build_mesh({"fsdp": 4}, device="cpu")
    for k in (1, 5):
        tr = _trainer(state, mesh, param_sharding="fsdp", log_steps=5)
        batches = [{"tokens": _block(_tokens(20 + i), mesh)}
                   for i in range(10)]
        if k == 1:
            losses = [tr.step(b)[0].item() for b in batches]
        else:
            losses = [tr.multi_step(
                {"tokens": np.stack([b["tokens"] for b in group])},
                np.ones((5, BATCH // 4), np.float32)).item()
                for group in (batches[:5], batches[5:])]
            losses = [None] * 4 + [losses[0]] + [None] * 4 + [losses[1]]
        out["k%d" % k] = {"losses": losses, "params": _params(tr)}
    return out


@pytest.fixture(scope="module")
def state():
    return _init_state()


@pytest.fixture(scope="module")
def world4(state):
    return run_world(_world4, 4, state)


@functools.lru_cache(maxsize=None)
def _jax_three_steps(mesh_items, attention, param_sharding):
    """Three steps of the JAX Trainer from the same init on its mesh; the
    batch sharded over its data-like axes, and its sequence over ``seq``:
    the losses and the params under the port's names."""
    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec

    from tensorflowonspark_tpu import train as jax_train
    from tensorflowonspark_tpu.models import transformer as jax_transformer
    from tensorflowonspark_tpu.parallel import build_mesh
    from tensorflowonspark_torch import convert

    mesh = build_mesh(dict(mesh_items))
    model = jax_transformer.build_transformer(**CFG, attention=attention,
                                              mesh=mesh)
    params = convert.transformer_params_to_flax(
        {k: torch.from_numpy(v) for k, v in _init_state().items()},
        CFG["num_heads"])
    tr = jax_train.Trainer(jax_transformer.loss_fn(model), params,
                           optax.adam(LR), mesh=mesh, batch_size=BATCH,
                           param_sharding=param_sharding,
                           step_flops_override=1)
    rows = tuple(a for a in ("data", "fsdp") if a in mesh.axis_names)
    seq = "seq" if "seq" in mesh.axis_names else None
    losses = []
    for i in range(3):
        batch = {"tokens": jax.device_put(
            _tokens(10 + i), NamedSharding(mesh, PartitionSpec(rows, seq)))}
        mask = jax.device_put(MASK, NamedSharding(mesh, PartitionSpec(rows)))
        losses.append(float(tr.step(batch, mask)[0]))
    got = convert.transformer_params_from_flax(jax.device_get(
        tr.state.params))
    return losses, {k: np.asarray(v) for k, v in got.items()}


def _assert_params(got, want, spread=None):
    """``got`` within :data:`PARAM_ATOL` of ``want``, the key bias within
    :data:`KEY_BIAS_ATOL`.  ``spread``: a second JAX run that is exact in
    arithmetic too (full attention for a sequence-parallel one); where the
    JAX package's two runs differ by more than PARAM_ATOL, Adam has
    amplified rounding noise of a near-zero gradient there, and the port
    is held to twice that spread instead."""
    for name, w in want.items():
        atol = np.full(w.shape, PARAM_ATOL, np.float32)
        if spread is not None:
            atol = np.maximum(atol, 2 * np.abs(spread[name] - w))
        have = got[name]
        if name.endswith("attn.qkv.bias"):   # (3, H, Dh): q, k, v
            atol = atol.reshape(3, -1)
            atol[1] = np.maximum(atol[1], KEY_BIAS_ATOL)
        assert np.all(np.abs(have - w) <= atol.reshape(w.shape)), (
            name, np.abs(have - w).max())


def _assert_matches(got, want_losses, want_params, spread=None):
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    _assert_params(got["params"], want_params, spread)


@pytest.mark.parametrize("key", ["fsdp_d2f2", "fsdp_f4"])
def test_fsdp_three_adam_steps_match_jax_trainer(world4, key):
    """``TestFSDPStateSharding.test_fsdp_matches_replicated_training``:
    ``Trainer(mesh, param_sharding="fsdp")`` over four ranks (data 2 x
    fsdp 2, and fsdp 4) steps as the JAX Trainer with FSDP on data 2 x
    fsdp 4; every rank ends with the same full params."""
    want_losses, want_params = _jax_three_steps(
        (("data", 2), ("fsdp", 4)), "full", "fsdp")
    for rank in world4:
        _assert_matches(rank[key], want_losses, want_params)


@pytest.mark.parametrize("key", ["fsdp_d2f2", "fsdp_f4"])
def test_fsdp_shards_optimizer_state(world4, key):
    """``TestFSDPStateSharding.test_state_shards_and_memory_drops``: the
    token table and both MLP weights shard their largest dim over the
    fsdp axis (Adam's moments follow); the small leaves replicate."""
    n = 2 if key == "fsdp_d2f2" else 4
    d, v = CFG["num_heads"] * CFG["head_dim"], CFG["vocab_size"]
    shapes = world4[0][key]["opt_shapes"]
    assert shapes["embed.weight"] == (v // n, d)
    for i in range(CFG["num_layers"]):
        block = "blocks.{}.".format(i)
        assert shapes[block + "mlp_in.weight"] == (4 * d // n, d)
        assert shapes[block + "mlp_out.weight"] == (d, 4 * d // n)
        assert shapes[block + "attn.qkv.weight"] == (3 * d, d)
        assert shapes[block + "ln1.weight"] == (d,)
    assert shapes["pos_embed.weight"] == (SEQ, d)


@pytest.mark.parametrize("key,attention", [("ring_d2s2", "ring"),
                                           ("ulysses_d2s2", "ulysses")])
def test_sequence_parallel_steps_match_jax_trainer(world4, key, attention):
    """``test_sequence_parallel_training_step``: the LM with its sequence
    over a seq axis of 2 (and rows over data 2) steps as the JAX Trainer
    with ``attention`` on data 4 x seq 2: the position embedding at global
    positions, the targets across chunks, the global last position
    masked, each row over S - 1, the mask's mean over the global batch."""
    want_losses, want_params = _jax_three_steps(
        (("data", 4), ("seq", 2)), attention, None)
    _, full = _jax_three_steps((("data", 8),), "full", None)
    for rank in world4:
        _assert_matches(rank[key], want_losses, want_params, spread=full)


def test_ring_under_fsdp_matches_jax_trainer(world4):
    """fsdp 2 x seq 2 with ring attention against the JAX Trainer on fsdp
    4 x seq 2."""
    want_losses, want_params = _jax_three_steps(
        (("fsdp", 4), ("seq", 2)), "ring", "fsdp")
    _, full = _jax_three_steps((("data", 8),), "full", None)
    for rank in world4:
        _assert_matches(rank["ring_fsdp_f2s2"], want_losses, want_params,
                        spread=full)


def test_grad_norms_agree_across_meshes(world4):
    """The grad norm of the last step (the health gauge) is the one-process
    step's under every mesh: FSDP counts each leaf once."""
    norms = [world4[r][key]["grad_norm"] for r in range(4)
             for key in ("fsdp_d2f2", "fsdp_f4", "ring_d2s2",
                         "ulysses_d2s2", "ring_fsdp_f2s2")]
    np.testing.assert_allclose(norms, norms[0], rtol=1e-5)


def test_seq_group_feed_pools_its_members_rows(world4):
    """Each rank of a seq group feeds its own 2 rows a step; the group
    trains on its members' 4 rows in rank order (the padded tail too),
    each rank on its half of the sequence; groups of 2 steps stack
    likewise."""
    for rank in range(4):
        feed = world4[rank]["feed"]
        group = rank // 2 * 2                # the group's first rank
        s = rank % 2
        for step, (tokens, mask) in enumerate(feed["single"]):
            assert tokens.shape == (4, SEQ // 2)
            want = np.tile(np.arange(SEQ // 2) + s * SEQ // 2, (4, 1))
            if s == 0:                       # column 0 names the row
                want[:, 0] = [(group + m) * 100 + 2 * step + j
                              for m in range(2) for j in range(2)]
            valid = [int(2 * step + j < 5) for m in range(2)
                     for j in range(2)]
            np.testing.assert_array_equal(mask, valid)
            np.testing.assert_array_equal(tokens * np.array(valid)[:, None],
                                          want * np.array(valid)[:, None])
        assert len(feed["single"]) == 3
        tokens, mask = feed["grouped"][0]
        assert tokens.shape == (2, 4, SEQ // 2) and mask.shape == (2, 4)


def test_fsdp_k5_equals_k1(world4):
    """``multi_step`` groups of 5 under fsdp 4 give K = 1's losses and
    params (captured graphs on the card; here eager steps)."""
    for rank in world4:
        k1, k5 = rank["k1"], rank["k5"]
        for a, b in zip(k1["losses"], k5["losses"]):
            if b is not None:
                assert a == pytest.approx(b, rel=1e-6)
        for name, t in k1["params"].items():
            np.testing.assert_allclose(k5["params"][name], t, rtol=0,
                                       atol=1e-7, err_msg=name)


@pytest.mark.parametrize("attention", sorted(FORWARD_MODES))
def test_forward_modes_agree(world4, state, attention):
    """``test_forward_modes_agree``: the LM's logits with its sequence over
    four ranks (ring on seq 4, Ulysses on data 2 x seq 2), each rank its
    rows and chunk, put together, equal the JAX model's with full
    attention on the same params and tokens (1e-4 of the largest logit,
    fp32: the two frameworks sum in another order)."""
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models import transformer as jax_transformer
    from tensorflowonspark_torch import convert

    params = convert.transformer_params_to_flax(
        {k: torch.from_numpy(v) for k, v in state.items()},
        CFG["num_heads"])
    want = np.asarray(jax_transformer.build_transformer(
        **CFG, attention="full").apply({"params": params},
                                       jnp.asarray(_tokens(50))))
    parts = FORWARD_MODES[attention]["seq"]
    blocks = [rank["logits_" + attention] for rank in world4]
    got = np.concatenate(
        [np.concatenate(blocks[g:g + parts], axis=1)
         for g in range(0, len(blocks), parts)], axis=0)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
