"""The LM twin (``examples/transformer/transformer_lm_torch.py``, the twin of
``examples/transformer/transformer_lm.py``) on the CPU through
``cluster.run`` in FILES mode at tiny flags: the MoE LM and the dense LM,
on the synthetic stream and on byte files (``--data_dir``); each export is
served by the port's ``ModelServer`` and its loss on the stream is below
the initial model's.  Also the stream against the JAX example's formula
the mesh flags over gloo (``--fsdp 2``, ``--data 1 --seq 2``; and for
the MoE LM ``--expert 2`` in both ep modes, ``--tensor 2`` and ``--seq
2``) against ``--data 2``, and a mesh that does not span the cluster."""

import argparse
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tensorflowonspark_torch import checkpoint, serving
from tensorflowonspark_torch.models import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "transformer",
                       "transformer_lm_torch.py")
sys.path.insert(0, os.path.dirname(EXAMPLE))
import transformer_lm_torch as twin  # noqa: E402

TINY = ["--device", "cpu", "--cluster_size", "1", "--num_layers", "2",
        "--num_heads", "2", "--head_dim", "8", "--seq_len", "32",
        "--batch_size", "8", "--train_steps", "12", "--lr", "1e-2",
        "--log_steps", "4"]
MOE = ["--mlp", "moe", "--num_experts", "4"]


def _run(args):
    # one intra-op thread a run: four runs share the machine's cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, EXAMPLE] + TINY + args,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _wait(proc):
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    return out


def _next_token_loss(logits, tokens):
    """Mean cross entropy of each position's logits on the next token."""
    logits = torch.from_numpy(np.asarray(logits[:, :-1]))
    targets = torch.from_numpy(tokens[:, 1:]).long()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1)).item()


def _served_loss_falls(export_dir, tokens, mlp):
    """Serve ``tokens`` from the export and from the twin's initial model
    (the same config, the seed-0 init): the trained loss is lower."""
    state, descriptor = checkpoint.load_model(export_dir, validate=True)
    config = descriptor["model_config"]
    assert config["mlp"] == mlp
    assert config["num_experts"] == (4 if mlp == "moe" else 8)
    assert config["capacity_factor"] == twin.CAPACITY_FACTOR
    server = serving.ModelServer(export_dir, batch_size=4, device="cpu")
    assert (server.model.blocks[0].moe is not None) == (mlp == "moe")
    trained = server.predict_feed({"tokens": tokens}, len(tokens))["output"]
    init = get_model("transformer_lm", **config)
    init.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        first = init(torch.from_numpy(tokens)).numpy()
    assert np.isfinite(trained).all()
    assert _next_token_loss(trained, tokens) < (
        _next_token_loss(first, tokens) - 0.1)


def test_moe_and_dense_runs_export_and_serve(tmp_path):
    """Four runs side by side (MoE and dense; synthetic and byte files,
    the bytes of a repeated text, vocab 256): each trains 12 steps and
    exports, and the export serves with a loss below the init's."""
    data = tmp_path / "text"
    data.mkdir()
    text = b"the quick brown fox jumps over the lazy dog. " * 64
    for i in range(3):
        (data / "part-{}.txt".format(i)).write_bytes(text[i:])
    runs = {}
    for mlp in ("moe", "dense"):
        extra = MOE if mlp == "moe" else []
        runs[mlp, "synthetic"] = _run(extra + [
            "--vocab_size", "64", "--attention", "flash",
            "--export_dir", str(tmp_path / (mlp + "_synthetic"))])
        runs[mlp, "files"] = _run(extra + [
            "--vocab_size", "256", "--data_dir", str(data), "--epochs", "4",
            "--shuffle_buffer", "16",
            "--export_dir", str(tmp_path / (mlp + "_files"))])
    outs = {key: _wait(proc) for key, proc in runs.items()}
    for key, out in outs.items():
        assert "trained 12 steps" in out, (key, out[-2000:])
    synthetic = twin.SyntheticTokens(32, 64, 9).next_batch_arrays(4)[0][
        "tokens"]
    rows = np.frombuffer(text[:4 * 32], np.uint8).reshape(4, 32).astype(
        np.int32)
    for mlp in ("moe", "dense"):
        _served_loss_falls(str(tmp_path / (mlp + "_synthetic")), synthetic,
                           mlp)
        _served_loss_falls(str(tmp_path / (mlp + "_files")), rows, mlp)


def test_synthetic_stream_is_the_jax_examples():
    """The JAX example's next_batch (transformer_lm.py): rng =
    default_rng(process index), offsets (batch, 1) a batch, tokens
    (base + offs) % vocab."""
    seq_len, vocab, batch = 48, 40, 6
    rng = np.random.default_rng(0)
    base = np.arange(seq_len) % vocab
    source = twin.SyntheticTokens(seq_len, vocab, 0)
    for _ in range(3):
        offs = rng.integers(0, vocab, (batch, 1))
        want = ((base[None, :] + offs) % vocab).astype(np.int32)
        got, n = source.next_batch_arrays(batch)
        assert n == batch and got["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want)


# every mesh axis is ported: a mesh that does not span --cluster_size (1
# here) refuses before any node starts, whatever the axis or the MoE mode
@pytest.mark.parametrize("flags,error,match", [
    (["--data", "2"], ValueError, "cluster_size"),
    (["--fsdp", "2"], ValueError, "cluster_size"),
    (["--seq", "2"], ValueError, "cluster_size"),
    (["--expert", "2"], ValueError, "cluster_size"),
    (["--tensor", "2"], ValueError, "cluster_size"),
    (["--attention", "ring", "--seq", "2"] + MOE, ValueError,
     "cluster_size"),
    (["--attention", "ulysses", "--seq", "2"], ValueError, "cluster_size"),
    (MOE + ["--ep_mode", "shard_map", "--expert", "2"], ValueError,
     "cluster_size")])
def test_parallel_flags_wait_for_the_parallelism_slice(flags, error, match):
    args = twin.parse_args(TINY + ["--vocab_size", "64"] + flags)
    with pytest.raises(error, match=match):
        twin.train_lm(args, argparse.Namespace())


# d_model 64 and vocab 256: the token table and MLP weights shard under
# --fsdp 2; 4 rows a node a step
MESH_RUN = ["--device", "cpu", "--cluster_size", "2", "--num_layers", "2",
            "--num_heads", "4", "--head_dim", "16", "--vocab_size", "256",
            "--seq_len", "32", "--batch_size", "8", "--train_steps", "4",
            "--lr", "1e-3", "--log_steps", "2"]
# the last step's loss as printed (4 decimals), fp32 sums in another order
MESH_LOSS_TOL = 2e-4
# the exports' token tables after 4 AdamW steps of lr 1e-3
MESH_PARAM_TOL = 1e-5


def test_mesh_flags_train_as_data_parallel(tmp_path):
    """Two nodes over gloo: ``--fsdp 2`` (the Adam state sharded) and
    ``--data 1 --seq 2`` (each sequence split over both nodes, ring
    attention, the nodes' rows pooled) train on the global batch that
    ``--data 2`` trains on, to the same loss; each chief exports the full
    params."""
    runs = {}
    for name, flags in (("data", ["--data", "2"]),
                        ("fsdp", ["--data", "1", "--fsdp", "2"]),
                        ("seq", ["--data", "1", "--seq", "2"])):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        runs[name] = subprocess.Popen(
            [sys.executable, EXAMPLE] + MESH_RUN + flags + [
                "--export_dir", str(tmp_path / name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    outs = {name: _wait(proc) for name, proc in runs.items()}
    losses = {}
    for name, out in outs.items():
        # one a node; the nodes share a stdout, so lines may interleave
        losses[name] = [float(x) for x in re.findall(
            r"trained 4 steps, loss ([0-9.]+)", out)]
        assert len(losses[name]) == 2, (name, out[-2000:])
    want = losses["data"][0]
    for name, got in losses.items():
        assert max(abs(x - want) for x in got) <= MESH_LOSS_TOL, losses
    tables = {name: checkpoint.load_model(str(tmp_path / name))[0][
        "embed.weight"].numpy() for name in runs}
    for name, table in tables.items():
        assert table.shape == (256, 64)
        np.testing.assert_allclose(table, tables["data"], rtol=0,
                                   atol=MESH_PARAM_TOL, err_msg=name)


# the MoE LM on two gloo nodes under the J2 axes: rows over data, expert
# (its rows distinct, as the JAX example lays them), pooled under tensor
# and seq; every run trains on --data 2's global batch
MOE_MESH_RUNS = (("data", ["--data", "2"]),
                 ("expert", ["--data", "1", "--expert", "2"]),
                 ("expert_shard_map", ["--data", "1", "--expert", "2",
                                       "--ep_mode", "shard_map"]),
                 ("tensor", ["--data", "1", "--tensor", "2"]),
                 ("seq", ["--data", "1", "--seq", "2"]))


def test_moe_mesh_flags_train_as_data_parallel(tmp_path):
    """Two nodes over gloo, the MoE LM: ``--expert 2`` (each node its two
    experts and their Adam state; gspmd and ``--ep_mode shard_map``),
    ``--tensor 2`` (heads and MLP split, params replicated, as the JAX
    example lays them) and ``--seq 2`` (each MoE layer routing the whole
    sequence) train to ``--data 2``'s loss; each chief exports the full
    params."""
    runs = {}
    for name, flags in MOE_MESH_RUNS:
        env = dict(os.environ, OMP_NUM_THREADS="1")
        runs[name] = subprocess.Popen(
            [sys.executable, EXAMPLE] + MESH_RUN + MOE + flags + [
                "--export_dir", str(tmp_path / name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    outs = {name: _wait(proc) for name, proc in runs.items()}
    losses = {}
    for name, out in outs.items():
        losses[name] = [float(x) for x in re.findall(
            r"trained 4 steps, loss ([0-9.]+)", out)]
        assert len(losses[name]) == 2, (name, out[-2000:])
    want = losses["data"][0]
    for name, got in losses.items():
        assert max(abs(x - want) for x in got) <= MESH_LOSS_TOL, losses
    # the token tables as test_mesh_flags_train_as_data_parallel holds
    # them; the expert leaves whole (an expert's near-zero gradients turn
    # rounding noise into Adam steps, so they are held by shape)
    exports = {name: checkpoint.load_model(str(tmp_path / name))[0]
               for name in runs}
    for name, sd in exports.items():
        assert sd["blocks.0.moe.w1"].shape == (4, 64, 256), name
        np.testing.assert_allclose(sd["embed.weight"].numpy(),
                                   exports["data"]["embed.weight"].numpy(),
                                   rtol=0, atol=MESH_PARAM_TOL, err_msg=name)
