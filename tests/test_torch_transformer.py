"""The port's transformer LM and weight converter against the JAX package's
flax model: the same params (converted) and the same tokens (numpy) give
the same logits."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import transformer as jax_transformer
from tensorflowonspark_torch import convert
from tensorflowonspark_torch.models import transformer

# S=256 with the JAX kernel's 128 blocks: its flash runs 2 x 2 blocks
CFG = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=16,
           max_seq_len=256)
SEQ = 256


@pytest.fixture(scope="module")
def flax_params():
    """An initialised flax param tree as numpy, every leaf perturbed so that
    zero-initialised biases and unit LayerNorm scales are exercised too."""
    model = jax_transformer.build_transformer(**CFG, attention="full")
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, SEQ), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x))
                   ).astype(np.float32), params)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(
        0, CFG["vocab_size"], (2, SEQ), dtype=np.int32)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_flat(val, prefix + (key,)))
        return out
    return {prefix: np.asarray(tree)}


def test_converter_round_trip_is_exact(flax_params):
    sd = convert.transformer_params_from_flax(flax_params)
    back = convert.transformer_params_to_flax(sd, num_heads=CFG["num_heads"])
    want, got = _flat(dict(flax_params)), _flat(back)
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert got[path].shape == arr.shape, path
        np.testing.assert_array_equal(got[path], arr, err_msg=str(path))


def test_state_dict_names_match_module(flax_params):
    model = transformer.build_transformer(**CFG)
    sd = convert.transformer_params_from_flax(flax_params)
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd)   # strict: every name and shape


# fp32: the two frameworks sum matmuls in another order; 1e-4 of the logit
# range covers that through 2 layers.  bf16: both round activations to bf16
# at their own places (flax gelu runs in bf16 arithmetic, torch's rounds
# once), a few bf16 steps (2^-8 relative) per layer: 3e-2 of the range.
@pytest.mark.parametrize("attention,dtype,tol", [
    ("full", "float32", 1e-4),
    ("flash", "float32", 1e-4),
    ("flash", "bfloat16", 3e-2),
])
def test_logits_match_flax(flax_params, tokens, attention, dtype, tol):
    jax_model = jax_transformer.build_transformer(**CFG, attention=attention,
                                                  dtype=dtype)
    want = np.asarray(jax_model.apply({"params": flax_params},
                                      jnp.asarray(tokens)))
    model = transformer.build_transformer(**CFG, attention=attention,
                                          dtype=dtype)
    model.load_state_dict(convert.transformer_params_from_flax(flax_params))
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert got.shape == (2, SEQ, CFG["vocab_size"])
    limit = tol * np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= limit


def test_init_weights_is_seeded():
    def make(seed):
        model = transformer.build_transformer(vocab_size=32, num_layers=1,
                                              num_heads=2, head_dim=8,
                                              max_seq_len=16)
        return model.init_weights(torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    for name, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[name]), name
    assert not torch.equal(a.embed.weight, c.embed.weight)
    assert torch.equal(a.blocks[0].ln1.weight, torch.ones(16))


class _Mesh(object):
    """A stand-in for a mesh: its axis names and sizes, all the model reads
    before it refuses one."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = tuple(sizes.values())

    def size(self, dim):
        return self._sizes[dim]


# ring and Ulysses attention are ported; without a mesh they refuse as the
# JAX model asserts ("ring attention needs a mesh"); a tensor axis splits
# the heads, so it must divide them (tests/test_torch_tp.py runs it)
@pytest.mark.parametrize("kwargs,error,match", [
    ({"attention": "ring"}, ValueError, "ring attention needs a mesh"),
    ({"attention": "ulysses"}, ValueError, "ulysses attention needs a mesh"),
    ({"attention": "ring", "mesh": _Mesh(data=1, tensor=3)},
     ValueError, "not divisible by the tensor axis"),
])
def test_unported_options_raise(kwargs, error, match):
    with pytest.raises(error, match=match):
        transformer.build_transformer(**dict(CFG, **kwargs))


def test_unknown_attention_raises():
    with pytest.raises(ValueError):
        transformer.build_transformer(**dict(CFG, attention="sparse"))
