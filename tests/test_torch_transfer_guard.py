"""The hot-loop transfer guard of the port's ``Trainer.fit_feed``
(``transfer_guard=``, ``TFOS_TRANSFER_GUARD``): the level resolution
against the JAX package's ``_resolve_transfer_guard`` for every value, a
guarded CPU ``fit_feed`` equal to the unguarded one at K = 1 and K = 2, the
copies the guard flags (a CPU tensor of more than zero dims copied to
another device: ``_to_copy``, ``copy_``, ``_copy_from``; the ``meta``
device stands in for a card here), a planted copy raising under
``"disallow"`` and logged under ``"log"``, and on a card (``cuda``-marked,
skipped elsewhere) the same planted copy in a step on the card.

The JAX package is imported inside the tests only, so the card's machine,
which has no jax, can run the ``cuda`` case."""

import functools
import logging

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import train

VALUES = [None, "", "0", "off", "allow", "allow_explicit", False, "1", "on",
          True, "disallow", "log", "log_explicit"]


@pytest.mark.parametrize("value,env", [(v, None) for v in VALUES] + [
    (None, e) for e in ("", "disallow", "log", "1", "off")], ids=repr)
def test_resolve_transfer_guard_matches_jax(monkeypatch, value, env):
    """Every value, and the environment variable where the value is None."""
    from tensorflowonspark_tpu import train as jax_train

    assert train.TRANSFER_GUARD_ENV == jax_train.TRANSFER_GUARD_ENV
    if env is None:
        monkeypatch.delenv(train.TRANSFER_GUARD_ENV, raising=False)
    else:
        monkeypatch.setenv(train.TRANSFER_GUARD_ENV, env)
    assert (train._resolve_transfer_guard(value)
            == jax_train._resolve_transfer_guard(value))


def test_flagged_copies():
    """What the guard flags: CPU -> another device of more than zero dims,
    by each of the three ATen copies; not 0-dim scalars, not CPU -> CPU,
    not device -> CPU."""
    x = torch.ones(3)
    meta = torch.empty(3, device="meta")
    aten = torch.ops.aten
    flagged = [
        (aten._to_copy.default, (x,), {"device": torch.device("meta")}),
        (aten.copy_.default, (meta, x), {}),
        (aten._copy_from.default, (x, meta), {}),
    ]
    passed = [
        (aten._to_copy.default, (torch.tensor(2.0),),
         {"device": torch.device("meta")}),
        (aten._to_copy.default, (x,), {"dtype": torch.float64}),
        (aten.copy_.default, (torch.empty(3), x), {}),
        (aten._to_copy.default, (meta,), {"device": torch.device("cpu")}),
        (aten.add.Tensor, (x, x), {}),
    ]
    for func, args, kwargs in flagged:
        assert train._host_to_device(func, args, kwargs) is x, func
    for func, args, kwargs in passed:
        assert train._host_to_device(func, args, kwargs) is None, func


def _loss(params, batch, mask):
    pred = batch["x"] @ params["w"]
    err = (pred - batch["y"]) ** 2 * mask
    return err.sum() / mask.sum().clamp_min(1.0), {}


#: where the planted copy sends its CPU tensor (``meta`` stands in for a
#: card on the CPU)
_PLANT = {"device": "meta"}


def _planted_loss(params, batch, mask):
    """The loss with one implicit host->device copy in it."""
    torch.ones(mask.shape[0]).to(_PLANT["device"])
    return _loss(params, batch, mask)


class _Feed(object):
    """Six batches of 8 rows of a linear regression (numpy, seeded), on
    ``device``; ``grouped_batches(k)`` stacks full groups of k, as a
    ShardedFeed does."""

    def __init__(self, n=6, device="cpu"):
        rng = np.random.RandomState(0)
        self.x = torch.from_numpy(rng.rand(n * 8, 4).astype(np.float32))
        self.y = self.x @ torch.arange(1.0, 5.0)
        self.device = device

    def batches(self):
        for i in range(len(self.x) // 8):
            part = slice(i * 8, (i + 1) * 8)
            yield ({"x": self.x[part].to(self.device),
                    "y": self.y[part].to(self.device)},
                   torch.ones(8, device=self.device))

    def grouped_batches(self, k):
        items = list(self.batches())
        full = len(items) - len(items) % k
        for i in range(0, full, k):
            group = items[i:i + k]
            yield ("multi",
                   {key: torch.stack([b[key] for b, _ in group])
                    for key in ("x", "y")},
                   torch.stack([m for _, m in group]))
        for batch, mask in items[full:]:
            yield "single", batch, mask


def _trainer(loss=_loss, device="cpu"):
    return train.Trainer(loss, {"w": np.zeros(4, np.float32)},
                         functools.partial(torch.optim.SGD, lr=0.05),
                         batch_size=8, log_steps=2, device=device)


@pytest.mark.parametrize("k", [1, 2])
def test_guarded_fit_feed_equals_unguarded(monkeypatch, k):
    """On the CPU the host is the device: the guard flags nothing, and the
    guarded run's params and stats equal the unguarded run's."""
    monkeypatch.delenv(train.TRANSFER_GUARD_ENV, raising=False)
    runs = []
    for guard in (None, "disallow"):
        tr = _trainer()
        stats = tr.fit_feed(_Feed(), steps_per_call=k, transfer_guard=guard)
        runs.append((tr.state.params["w"].clone(), stats["global_steps"]))
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    assert runs[0][1] == runs[1][1] == 6


def test_env_arms_the_guard(monkeypatch):
    monkeypatch.setenv(train.TRANSFER_GUARD_ENV, "disallow")
    with pytest.raises(RuntimeError, match="host->device copy"):
        _trainer(_planted_loss).fit_feed(_Feed())


def test_planted_copy_raises_under_disallow_and_logs_under_log(
        monkeypatch, caplog):
    monkeypatch.delenv(train.TRANSFER_GUARD_ENV, raising=False)
    with pytest.raises(RuntimeError, match=r"\[8\] torch.float32 CPU"):
        _trainer(_planted_loss).fit_feed(_Feed(), transfer_guard="disallow")
    with caplog.at_level(logging.WARNING, logger=train.logger.name):
        stats = _trainer(_planted_loss).fit_feed(_Feed(),
                                                 transfer_guard="log")
    assert stats["global_steps"] == 6
    flagged = [r for r in caplog.records if "host->device copy" in r.message]
    assert len(flagged) == 6      # one a step
    # the loss function alone (outside a dispatch) is never guarded
    _trainer(_planted_loss).fit_feed(_Feed())


@pytest.mark.cuda
def test_planted_copy_on_the_card(monkeypatch, caplog):
    """On a card: a step whose loss copies a CPU tensor to the card raises
    under ``"disallow"`` and is logged under ``"log"``; device-resident
    batches pass the guard at K = 1 and K = 2 with the unguarded losses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda:0")
    monkeypatch.delenv(train.TRANSFER_GUARD_ENV, raising=False)
    monkeypatch.setitem(_PLANT, "device", card)
    with pytest.raises(RuntimeError, match="host->device copy"):
        _trainer(_planted_loss, card).fit_feed(_Feed(device=card),
                                               transfer_guard="disallow")
    with caplog.at_level(logging.WARNING, logger=train.logger.name):
        _trainer(_planted_loss, card).fit_feed(_Feed(device=card),
                                               transfer_guard="log")
    assert any("host->device copy" in r.message for r in caplog.records)
    for k in (1, 2):
        got, want = _trainer(device=card), _trainer(device=card)
        got.fit_feed(_Feed(device=card), steps_per_call=k,
                     transfer_guard="disallow")
        want.fit_feed(_Feed(device=card), steps_per_call=k)
        torch.testing.assert_close(got.state.params["w"],
                                   want.state.params["w"], rtol=0, atol=0)
