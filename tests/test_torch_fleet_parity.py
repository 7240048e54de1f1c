"""The port's fleet against the JAX package's, on the same inputs:

- the canary decision stream: the same scripted ticks (fake clock, fake
  replica metrics, the same registry contents) through both
  ``CanaryController``s give equal decisions, knob pushes and journal
  records apart from ``time``, and either package's ``replay_journal``
  re-derives the other's journal alike;
- the registry journal: a journal written by one package's
  ``ModelRegistry`` reads back in the other's to the same ``snapshot()``;
- ``publish_trained``: the same params, converted with the port's
  ``convert``, published through both packages give entries that agree
  apart from paths and times, a port replica serves the port's export as
  the JAX ``ModelServer`` serves the JAX export (fp32, 1e-5), and
  nonfinite params are refused on both sides.
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import checkpoint as jax_checkpoint
from tensorflowonspark_tpu import fleet as jax_fleet
from tensorflowonspark_tpu import serving as jax_serving
from tensorflowonspark_torch import checkpoint, convert, fleet, gateway, \
    serving
from test_torch_fleet import _FakeFleet

TOL = 1e-5
CONFIG = {"architecture": "linear", "features": 1}
SIGNATURE = {"x": [None, 2]}


def test_public_names_and_signatures_match_jax():
    """Every public name of the JAX fleet module is in the port's, with
    the same signature (functions, constructors and public methods)."""
    names = [n for n in vars(jax_fleet) if not n.startswith("_")
             and getattr(getattr(jax_fleet, n), "__module__", None)
             == jax_fleet.__name__]
    assert "CanaryController" in names and "publish_trained" in names
    for name in names:
        want, got = getattr(jax_fleet, name), getattr(fleet, name)
        if inspect.isclass(want):
            members = [m for m in vars(want) if not m.startswith("_")
                       or m == "__init__"]
            for m in members:
                if callable(getattr(want, m)):
                    assert inspect.signature(getattr(got, m)) == \
                        inspect.signature(getattr(want, m)), (name, m)
        elif callable(want):
            assert inspect.signature(got) == inspect.signature(want), name
    for name in ("STATUSES", "ROUTER_SHEDS", "DEFAULT_CANARY_CONFIG"):
        assert getattr(fleet, name) == getattr(jax_fleet, name)


def _flax_linear(kernel, bias=0.0):
    return {"dense": {"kernel": np.asarray(kernel, np.float32),
                      "bias": np.full((1,), bias, np.float32)}}


def _export(side, path, kernel, bias=0.0):
    """A linear export of y = k0*a + k1*b + bias in ``side``'s layout."""
    path = str(path)
    params = _flax_linear(kernel, bias)
    if side == "jax":
        jax_checkpoint.export_model(path, params, "lin", model_config=CONFIG,
                                    input_signature=SIGNATURE)
    else:
        checkpoint.export_model(path, convert.linear_params_from_flax(params),
                                "lin", model_config=CONFIG,
                                input_signature=SIGNATURE)
    return path


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _untimed(records):
    return [{k: v for k, v in r.items() if k != "time"} for r in records]


#: the scripted walk: (versions published before it, its ticks); a tick is
#: (replica traffic kwargs or None, alert or None)
CANARY_SCRIPT = [
    # a clean canary: proposed, applied, a thin window (no verdict), 3
    # clean windows -> kept
    ("2", [(None, None), (None, None), ({"total": 2}, None), ({}, None),
           ({}, None), ({}, None), (None, None)]),
    # a poisoned canary after the cooldown: one clean window, then a
    # nonfinite delta -> instant rollback
    ("3", [(None, None), (None, None), ({}, None),
           ({"nonfinite": 2}, None), (None, None)]),
    # after the revert cooldown: an err-rate burn is hysteresis, the
    # confirming second burn rolls back
    ("4", [(None, None), (None, None), ({"good": 5}, None),
           ({"good": 5}, None)]),
    # a version-labeled nonfinite alert on clean counters -> rollback
    ("5", [(None, None), (None, None), ({}, None),
           ({}, {"rule": "nonfinite", "model": "lin", "version": "5",
                 "executor": "r0"})]),
]

#: seconds the clock jumps before each walk: past the promote cooldown
#: (5 s) and the revert cooldown (30 s)
CANARY_GAPS = (0.0, 6.0, 31.0, 31.0)


def _canary_walk(mod, side, root):
    """Drive ``mod``'s ``CanaryController`` through :data:`CANARY_SCRIPT`
    over exports in ``side``'s layout; returns its decisions, its knob
    pushes (export dirs relative to ``root``) and its journal's path."""
    clock = {"now": 1000.0}
    registry = mod.ModelRegistry(os.path.join(root, "reg"), publisher="test",
                                 clock=lambda: clock["now"])
    kernels = {"1": [[2.0], [3.0]], "2": [[4.0], [5.0]], "3": [[1e38], [1e38]],
               "4": [[6.0], [7.0]], "5": [[8.0], [9.0]]}
    registry.publish("lin", "1", _export(side, os.path.join(root, "v1"),
                                         kernels["1"]), status="live")
    fake = _FakeFleet()
    router = mod.FleetRouter(registry=registry)
    for rid, port in (("r0", 1), ("r1", 2)):
        fake.add(rid, "lin", "1")
        router.register_replica(rid, "h:%d" % port, "lin", "1")
    journal = os.path.join(root, "canary.jsonl")
    ctl = mod.CanaryController(
        registry, router, metrics_fn=fake.metrics,
        push_knobs=fake.push_knobs, journal_path=journal,
        clock=lambda: clock["now"],
        config={"clean_windows": 3, "min_requests": 5,
                "confirm_windows": 2, "cooldown_secs": 5.0,
                "revert_cooldown_secs": 30.0})
    try:
        for gap, (version, ticks) in zip(CANARY_GAPS, CANARY_SCRIPT):
            clock["now"] += gap
            registry.publish("lin", version, _export(
                side, os.path.join(root, "v" + version), kernels[version]))
            for traffic, alert in ticks:
                clock["now"] += 1.0
                if traffic is not None:
                    target = fake.pushes[-1][0]
                    kwargs = dict({"total": 10}, **traffic)
                    fake.traffic(target, **kwargs)
                if alert is not None:
                    ctl.observe_alert(alert)
                ctl.tick()
        status = ctl.status()
    finally:
        ctl._journal.close()
        registry.close()
    pushes = []
    for rid, knobs in fake.pushes:
        swap = dict(knobs["serving_load_version"])
        swap["export_dir"] = os.path.relpath(swap["export_dir"], root)
        pushes.append((rid, swap))
    return list(ctl.decisions), pushes, journal, status


def test_canary_decision_stream_matches_jax(tmp_path):
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_out = _canary_walk(jax_fleet, "jax", jax_root)
    port_out = _canary_walk(fleet, "port", port_root)
    decisions = [("kept", "lin", "2"), ("reverted", "lin", "3"),
                 ("reverted", "lin", "4"), ("reverted", "lin", "5")]
    assert port_out[0] == jax_out[0] == decisions
    assert port_out[1] == jax_out[1]
    assert len(port_out[1]) == 8   # 4 canaries, a promote, 3 rollbacks
    assert port_out[3] == jax_out[3]
    jax_records, port_records = _records(jax_out[2]), _records(port_out[2])
    assert _untimed(port_records) == _untimed(jax_records)
    reasons = [r["reason"] for r in port_records
               if r.get("stage") == "reverted"]
    assert reasons == ["nonfinite", "err_rate", "nonfinite_alert"]
    # either package's replay re-derives either package's journal
    replays = [mod.replay_journal(path)
               for mod in (jax_fleet, fleet)
               for path in (jax_out[2], port_out[2])]
    for replay in replays:
        assert replay["decisions"] == replay["journaled"] == decisions
        assert replay["matches"] is True
        assert replay["config"] == replays[0]["config"]


def _registry_story(mod, side, root):
    """Publishes, a promote, a retire and a torn-free reopen in ``mod``'s
    registry; returns its root and snapshot."""
    clock = {"now": 50.0}

    def tick():
        clock["now"] += 1.0
        return clock["now"]

    reg = mod.ModelRegistry(os.path.join(root, "reg"), publisher="p",
                            clock=tick)
    reg.publish("a", "1", _export(side, os.path.join(root, "a1"),
                                  [[1.0], [2.0]]),
                model_config=CONFIG, status="live")
    reg.publish("a", "2", _export(side, os.path.join(root, "a2"),
                                  [[3.0], [4.0]]),
                model_config=CONFIG, warm_dir="/warm/a2")
    reg.publish("b", "1", _export(side, os.path.join(root, "b1"),
                                  [[5.0], [6.0]]), status="canary")
    reg.set_status("a", "2", "live")
    reg.set_status("b", "1", "retired", reason="bad canary")
    reg.close()
    # a second publisher appends to the same journal
    reg = mod.ModelRegistry(os.path.join(root, "reg"), publisher="q",
                            clock=tick)
    reg.publish("b", "2", _export(side, os.path.join(root, "b2"),
                                  [[7.0], [8.0]]), status="live")
    snapshot = reg.snapshot()
    reg.close()
    return reg.root, snapshot


def _relative(snapshot, root):
    out = json.loads(json.dumps(snapshot))
    for slot in out.values():
        for entry in slot["versions"]:
            entry["export_dir"] = os.path.relpath(entry["export_dir"], root)
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_registry_journal_reads_back_across_packages(tmp_path, writer):
    """One package writes the registry journal; the other's
    ``ModelRegistry`` rebuilds the same ``snapshot()`` from it, and both
    packages' stories agree apart from paths."""
    mods = {"jax": jax_fleet, "port": fleet}
    root, snapshot = _registry_story(mods[writer], writer, str(tmp_path))
    reader = mods["port" if writer == "jax" else "jax"]
    reread = reader.ModelRegistry(root)
    try:
        assert reread.snapshot() == snapshot
        assert reread.default_version("a") == "2"
        assert reread.resolve("a", "2")["warm_dir"] == "/warm/a2"
        assert reread.resolve("b", "1")["status"] == "retired"
    finally:
        reread.close()
    other = "port" if writer == "jax" else "jax"
    _, twin = _registry_story(mods[other], other, str(tmp_path / "twin"))
    assert _relative(twin, str(tmp_path / "twin")) == \
        _relative(snapshot, str(tmp_path))


def test_publish_trained_matches_jax_and_serves_alike(tmp_path):
    """The same trained params (a flax tree of numpy arrays, converted for
    the port) published through both packages: equal entries apart from
    paths and times, and the port replica's answers are the JAX
    ``ModelServer``'s."""
    params = _flax_linear([[2.5], [-1.25]], bias=0.75)
    spec = {"model": "lin", "version": "7", "model_name": "lin",
            "model_config": CONFIG, "input_signature": SIGNATURE,
            "flax_model": None}
    jax_reg = jax_fleet.ModelRegistry(tmp_path / "jax", publisher="p")
    port_reg = fleet.ModelRegistry(tmp_path / "port", publisher="p")
    try:
        want = jax_fleet.publish_trained(dict(spec, registry=jax_reg),
                                         params, step=30)
        got = fleet.publish_trained(
            dict(spec, registry=port_reg),
            convert.linear_params_from_flax(params), step=30)
        strip = ("export_dir", "time")
        assert {k: v for k, v in got.items() if k not in strip} == \
            {k: v for k, v in want.items() if k not in strip}
        assert got["status"] == "staging" and got["version"] == "7"
        assert got["export_dir"] == os.path.join(port_reg.root, "lin", "7")
        # nonfinite params are refused on both sides, nothing published
        bad = _flax_linear([[np.inf], [1.0]])
        with pytest.raises(ValueError, match="nonfinite"):
            jax_fleet.publish_trained(
                dict(spec, registry=jax_reg, version="8"), bad, step=31)
        with pytest.raises(ValueError, match="nonfinite"):
            fleet.publish_trained(
                dict(spec, registry=port_reg, version="8"),
                convert.linear_params_from_flax(bad), step=31)
        assert [e["version"] for e in port_reg.versions("lin")] == \
            [e["version"] for e in jax_reg.versions("lin")] == ["7"]
    finally:
        jax_reg.close()
        port_reg.close()

    x = np.random.default_rng(3).standard_normal((5, 2)).astype(np.float32)
    expect = np.asarray(jax_serving.ModelServer(
        want["export_dir"], batch_size=8).predict_feed({"x": x}, 5)["output"])
    gw = gateway.GatewayServer(
        serving.ModelServer(got["export_dir"], batch_size=8, device="cpu"),
        max_wait_ms=1.0, model_version=got["version"], replica_id="p0")
    router = fleet.FleetRouter(registry=None)
    client = fleet.FleetClient(router, timeout=10.0)
    try:
        host, port = gw.start()
        router.register_replica("p0", "%s:%d" % (host, port), "lin", "7")
        answers = [client.predict("lin", {"x": x[i:i + n]}, n)["output"]
                   for i, n in ((0, 2), (2, 3))]
    finally:
        client.close()
        gw.stop()
    np.testing.assert_allclose(np.concatenate(answers), expect, rtol=0,
                               atol=TOL)
    assert torch.is_tensor(checkpoint.load_model(got["export_dir"])[0][
        "dense.weight"])
