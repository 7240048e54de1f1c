"""The train-to-serve handoff end to end on a small flash LM: the port's
``fit_supervised(publish=...)`` trains it (2 layers, narrow widths,
``attention="flash"``: the kernels' plain versions on the CPU) and
publishes its final params to a ``fleet.ModelRegistry`` as ``staging``;
``inference_cli --serve --registry R --model lm@V`` serves that entry in a
subprocess, and its logits are the JAX ``serving.ModelServer``'s over the
same params (converted to flax), within ``tests/test_torch_serving.py``'s
tolerance."""

import functools
import os
import signal
import subprocess
import sys

import numpy as np
import torch

from tensorflowonspark_tpu import checkpoint as jax_checkpoint
from tensorflowonspark_tpu import serving as jax_serving
from tensorflowonspark_torch import checkpoint, convert, fleet, gateway, \
    telemetry, train
from tensorflowonspark_torch.models import get_model, transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"vocab_size": 64, "num_layers": 2, "num_heads": 2, "head_dim": 16,
       "max_seq_len": 32, "attention": "flash", "dtype": "float32"}
SEQ = 32
SIGNATURE = {"tokens": {"shape": [None, SEQ], "dtype": "int32"}}
# fp32 on both sides; matmul summation order differs: 1e-4 of the range
LOGIT_TOL = 1e-4
BATCH = 8
STEPS = 4
READY_SECS = 60


class _Feed(object):
    """``STEPS`` batches of learnable token rows (each row counts up)."""

    def __init__(self):
        rng = np.random.default_rng(11)
        start = rng.integers(0, CFG["vocab_size"], (STEPS * BATCH, 1))
        self.tokens = ((start + np.arange(SEQ)) % CFG["vocab_size"]).astype(
            np.int32)
        self.terminated = False

    def batches(self):
        for i in range(STEPS):
            if self.terminated:
                return
            yield ({"tokens": self.tokens[i * BATCH:(i + 1) * BATCH]},
                   np.ones(BATCH, np.float32))

    def terminate(self):
        self.terminated = True


def _serve(registry_root, model, tokens):
    """One ``inference_cli --serve --registry --model`` replica: its ready
    line, the logits of one request, its exit code after SIGTERM."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorflowonspark_torch.inference_cli",
         "--serve", "--registry", registry_root, "--model", model,
         "--device", "cpu", "--max-batch", "4", "--port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        ready = proc.stdout.readline()
        assert "ready on" in ready, ready
        addr = ready.split("ready on ")[1].split()[0]
        ch = gateway.GatewayChannel(addr, timeout=READY_SECS)
        try:
            got = ch.predict({"tokens": tokens}, len(tokens))["output"]
        finally:
            ch.close()
        proc.send_signal(signal.SIGTERM)
        return ready, got, proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_fit_supervised_publish_served_by_a_registry_replica(tmp_path):
    model = get_model("transformer_lm", **CFG)
    model.init_weights(torch.Generator().manual_seed(0))
    trainer = train.Trainer(transformer.loss_fn(model),
                            dict(model.state_dict()),
                            functools.partial(torch.optim.Adam, lr=1e-3),
                            batch_size=BATCH, device="cpu")
    ckpt = checkpoint.CheckpointManager(str(tmp_path / "ckpt"),
                                        save_interval_steps=2)
    registry = fleet.ModelRegistry(tmp_path / "registry", publisher="fit")
    tracer = telemetry.configure(True, str(tmp_path / "telemetry"))
    try:
        stats = train.fit_supervised(
            trainer, _Feed, ckpt,
            publish={"registry": registry, "model": "lm",
                     "model_name": "transformer_lm", "model_config": CFG,
                     "input_signature": SIGNATURE})
        spans = [e["name"] for e in list(tracer._events)
                 if e.get("ph") == "X"]
    finally:
        telemetry.configure(False)
        ckpt.close()
    assert "publish_error" not in stats, stats["publish_error"]
    entry = stats["published"]
    assert (entry["model"], entry["version"], entry["status"]) == \
        ("lm", "step-%d" % STEPS, "staging")
    assert "train/publish" in spans
    assert registry.resolve("lm", entry["version"]) == entry
    assert registry.default_version("lm") is None
    registry.close()
    # the published params are the trained ones
    state, desc = checkpoint.load_model(entry["export_dir"], validate=True)
    assert desc["model_name"] == "transformer_lm"
    assert sorted(state) == sorted(trainer.state.params)
    for name, t in trainer.state.params.items():
        assert torch.equal(state[name], t.detach().cpu()), name

    tokens = np.random.default_rng(5).integers(
        0, CFG["vocab_size"], (3, SEQ), dtype=np.int32)
    ready, got, code = _serve(registry.root, "lm@" + entry["version"],
                              tokens)
    assert code == 0
    jax_dir = str(tmp_path / "jax")
    jax_checkpoint.export_model(
        jax_dir, convert.transformer_params_to_flax(state, CFG["num_heads"]),
        "transformer_lm", model_config=CFG, input_signature=SIGNATURE)
    want = np.asarray(jax_serving.ModelServer(jax_dir, batch_size=4)
                      .predict_feed({"tokens": tokens}, 3)["output"])
    assert got.shape == want.shape == (3, SEQ, CFG["vocab_size"])
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
