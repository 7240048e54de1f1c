"""The JAX package's fleet control-plane tests (``tests/test_fleet.py``),
re-pointed case for case at the port's ``fleet``: registry publish
atomicity + torn-tail journal recovery, router typed sheds / per-model
budgets / balance, in-place live swaps with no rebuild (and the refusal
matrix), live rollback under fire with zero requests lost, the canary
controller's promote/rollback walk with journal replay parity, and the
train-to-serve publish boundary.  The model is the port's ``linear``,
its params converted from the JAX test's flax tree; the parity with the
JAX package is ``tests/test_torch_fleet_parity.py``'s."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import checkpoint, convert, fleet, gateway, \
    serving
from tensorflowonspark_torch.fleet import (CanaryController, FleetClient,
                                           FleetRouter, ModelRegistry,
                                           PublishConflict, SwapRefused)


def _linear_params(kernel, bias=None):
    """The JAX test's flax tree for y = k0*a + k1*b, as the port's
    ``state_dict``."""
    return convert.linear_params_from_flax(
        {"dense": {"kernel": np.asarray(kernel, np.float32),
                   "bias": (np.zeros((1,), np.float32) if bias is None
                            else np.asarray(bias, np.float32))}})


def _export(path, kernel, name="linear"):
    """Linear export y = k0*a + k1*b under a shared model name/signature,
    so version swaps copy same-shaped params in place (no rebuild)."""
    path = str(path)
    checkpoint.export_model(path, _linear_params(kernel), name,
                            model_config={"features": 1},
                            input_signature={"x": [None, 2]})
    return path


@pytest.fixture
def registry(tmp_path):
    reg = ModelRegistry(tmp_path / "reg", publisher="test")
    yield reg
    reg.close()


# ---------------------------------------------------------------------------
# registry: lifecycle, atomic publish, journal recovery
# ---------------------------------------------------------------------------

class TestRegistry:
    def test_publish_resolve_and_default(self, registry, tmp_path):
        e1 = _export(tmp_path / "v1", [[2.0], [3.0]])
        e2 = _export(tmp_path / "v2", [[4.0], [5.0]])
        registry.publish("lin", "1", e1, status="live")
        registry.publish("lin", "2", e2)  # staging by default
        assert registry.resolve("lin")["version"] == "1"
        assert registry.resolve("lin", "2")["status"] == "staging"
        with pytest.raises(KeyError):
            registry.resolve("nope")
        with pytest.raises(KeyError):
            registry.resolve("lin", "99")

    def test_no_live_version_is_lookup_error(self, registry, tmp_path):
        registry.publish("lin", "1", _export(tmp_path / "v1", [[1.0], [1.0]]))
        with pytest.raises(LookupError):
            registry.resolve("lin")

    def test_promote_retires_previous_live(self, registry, tmp_path):
        registry.publish("lin", "1", _export(tmp_path / "v1", [[1.0], [1.0]]),
                         status="live")
        registry.publish("lin", "2", _export(tmp_path / "v2", [[2.0], [2.0]]))
        registry.set_status("lin", "2", "live")
        assert registry.default_version("lin") == "2"
        assert registry.resolve("lin", "1")["status"] == "retired"

    def test_bad_names_and_status_rejected(self, registry, tmp_path):
        e = _export(tmp_path / "v1", [[1.0], [1.0]])
        for bad in ("", "a/b", "a@b", "a\nb"):
            with pytest.raises(ValueError):
                registry.publish(bad, "1", e)
            with pytest.raises(ValueError):
                registry.publish("m", bad, e)
        with pytest.raises(ValueError):
            registry.publish("m", "1", e, status="shiny")
        with pytest.raises(ValueError):
            registry.publish("m", "1", str(tmp_path / "not-an-export"))

    def test_concurrent_publish_single_winner(self, tmp_path):
        root = tmp_path / "reg"
        export = _export(tmp_path / "v1", [[2.0], [3.0]])
        results, barrier = [], threading.Barrier(8)

        def racer(i):
            # each racer gets its OWN registry handle, as concurrent
            # driver processes would — the O_EXCL marker arbitrates
            reg = ModelRegistry(root, publisher="p{}".format(i))
            barrier.wait()
            try:
                reg.publish("lin", "1", export)
                results.append(("won", i))
            except PublishConflict:
                results.append(("lost", i))
            finally:
                reg.close()

        threads = [threading.Thread(target=racer, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        outcomes = [r[0] for r in results]
        assert outcomes.count("won") == 1
        assert outcomes.count("lost") == 7
        # the rebuilt registry records exactly the winner
        reg = ModelRegistry(root)
        assert len(reg.versions("lin")) == 1
        winner = dict(results)["won"]
        assert reg.resolve("lin", "1")["publisher"] == "p{}".format(winner)
        reg.close()

    def test_journal_torn_tail_recovery(self, tmp_path):
        root = tmp_path / "reg"
        reg = ModelRegistry(root, publisher="test")
        reg.publish("lin", "1", _export(tmp_path / "v1", [[1.0], [1.0]]),
                    status="live")
        reg.publish("lin", "2", _export(tmp_path / "v2", [[2.0], [2.0]]))
        reg.close()
        # crash mid-append: a torn half-record, then a line that a
        # skip-and-continue reader would wrongly apply
        with open(reg.journal_path, "a") as f:
            f.write('{"kind": "status", "model": "lin", "ver')
            f.write('\n{"kind": "status", "model": "lin", "version": "1", '
                    '"status": "retired", "time": 0}\n')
        reloaded = ModelRegistry(root)
        # replay stopped at the torn line: state is intact up to it, the
        # post-tear retire was NOT trusted
        assert reloaded.default_version("lin") == "1"
        assert reloaded.resolve("lin", "1")["status"] == "live"
        assert [e["version"] for e in reloaded.versions("lin")] == ["1", "2"]
        # and the reloaded registry still journals new writes
        reloaded.set_status("lin", "2", "live")
        assert reloaded.default_version("lin") == "2"
        reloaded.close()


# ---------------------------------------------------------------------------
# router: typed sheds, budgets, balance, splits
# ---------------------------------------------------------------------------

class TestRouter:
    def test_unknown_model_shed_is_typed(self):
        router = FleetRouter()
        router.register_replica("r0", "h:1", "lin", "1")
        with pytest.raises(gateway.OverloadError) as exc:
            router.route("nope")
        assert exc.value.code == "unknown_model"
        assert router.counters()["fleet_router_shed_unknown_model"] == 1

    def test_no_capacity_when_model_drained(self):
        router = FleetRouter()
        router.register_replica("r0", "h:1", "lin", "1")
        router.set_health("r0", False)
        with pytest.raises(gateway.OverloadError) as exc:
            router.route("lin")
        assert exc.value.code == "no_capacity"

    def test_budget_isolates_hot_model(self):
        router = FleetRouter(budget_per_model=4)
        router.register_replica("hot0", "h:1", "hot", "1")
        router.register_replica("cold0", "h:2", "cold", "1")
        leases = [router.admit("hot") for _ in range(4)]
        # the hot model saturated ITS budget...
        with pytest.raises(gateway.OverloadError) as exc:
            router.admit("hot")
        assert exc.value.code == "no_capacity"
        # ...but the cold model still admits — no fleet-wide starvation
        router.admit("cold").release()
        for lease in leases:
            lease.release()
        router.admit("hot").release()
        assert router.counters()["fleet_admitted_cold"] == 1
        assert router.shed["no_capacity"] == 1

    def test_p2c_spreads_and_counts_picks(self):
        router = FleetRouter()
        router.register_replica("r0", "h:1", "lin", "1")
        router.register_replica("r1", "h:2", "lin", "1")
        for _ in range(200):
            rid, _, _ = router.route("lin")
            router.done(rid)
        assert set(router.picks) == {"r0", "r1"}
        assert min(router.picks.values()) >= 50  # no starved replica
        assert sum(router.picks.values()) == 200

    def test_split_weights_steer_versions(self):
        router = FleetRouter()
        router.register_replica("r0", "h:1", "lin", "1")
        router.register_replica("r1", "h:2", "lin", "2")
        router.set_split("lin", {"2": 1.0})
        for _ in range(20):
            rid, _, ver = router.route("lin")
            router.done(rid)
            assert (rid, ver) == ("r1", "2")
        # a split version with no healthy replica is dropped, not
        # blackholed
        router.set_split("lin", {"2": 0.1, "1": 0.9})
        router.set_health("r1", False)
        for _ in range(20):
            rid, _, ver = router.route("lin")
            router.done(rid)
            assert ver == "1"
        router.set_split("lin", None)

    def test_sync_roster_maps_meta_and_keeps_health(self):
        router = FleetRouter()
        rows = [
            {"job_name": "serving", "executor_id": "s0", "host": "h",
             "port": 1, "model": "lin", "model_version": "3"},
            {"job_name": "serving", "executor_id": "s1", "host": "h",
             "port": 2},  # pre-fleet replica: model defaults
            {"job_name": "worker", "executor_id": "w0", "host": "h",
             "port": 3},
        ]
        router.sync_roster(rows)
        table = router.replicas()
        assert set(table) == {"s0", "s1"}
        assert table["s0"]["version"] == "3"
        assert table["s1"]["model"] == "default"
        router.set_health("s0", False)
        router.sync_roster(rows)  # re-sync must not resurrect s0
        assert router.replicas()["s0"]["healthy"] is False

    def test_registry_default_drives_version_choice(self, registry,
                                                    tmp_path):
        registry.publish("lin", "1", _export(tmp_path / "v1", [[1.0], [1.0]]),
                         status="live")
        router = FleetRouter(registry=registry)
        router.register_replica("r0", "h:1", "lin", "1")
        router.register_replica("r1", "h:2", "lin", "2")
        for _ in range(10):
            rid, _, ver = router.route("lin")
            router.done(rid)
            assert ver == "1"
        # default drained mid-swap: route serves remaining healthy
        # replicas instead of shedding
        router.set_health("r0", False)
        rid, _, ver = router.route("lin")
        router.done(rid)
        assert (rid, ver) == ("r1", "2")


# ---------------------------------------------------------------------------
# live swap: zero recompiles, refusal matrix
# ---------------------------------------------------------------------------

class TestSwap:
    def test_swap_is_zero_recompile(self, tmp_path):
        e1 = _export(tmp_path / "v1", [[2.0], [3.0]])
        e2 = _export(tmp_path / "v2", [[4.0], [5.0]])
        server = serving.ModelServer(e1, batch_size=4, device="cpu")
        server.warmup()
        compiles = server.compile_count
        feed = {"x": np.asarray([[1.0, 1.0]], np.float32)}
        assert abs(float(server.predict_feed(feed, 1)["output"][0][0])
                   - 5.0) < 1e-5
        assert server.swap_export(e2, expected_version="2") == "2"
        # new weights answer immediately, from the SAME module
        assert abs(float(server.predict_feed(feed, 1)["output"][0][0])
                   - 9.0) < 1e-5
        assert server.compile_count == compiles
        assert server.swap_count == 1
        assert server.model_version == "2"

    def test_swap_refusal_matrix(self, tmp_path):
        server = serving.ModelServer(
            _export(tmp_path / "v1", [[2.0], [3.0]]), batch_size=4,
            device="cpu")
        # different model name
        other = _export(tmp_path / "other", [[1.0], [1.0]], name="notlin")
        with pytest.raises(SwapRefused, match="model"):
            server.swap_export(other)
        # different params shape (3 features would rebuild the model)
        wide = str(tmp_path / "wide")
        checkpoint.export_model(
            wide, _linear_params(np.ones((3, 1))),
            "linear", model_config={"features": 1},
            input_signature={"x": [None, 2]})
        with pytest.raises(SwapRefused, match="shapes"):
            server.swap_export(wide)
        # nonfinite weights are quarantined at the swap boundary
        poison = str(tmp_path / "poison")
        checkpoint.export_model(
            poison, _linear_params([[np.nan], [1.0]]),
            "linear", model_config={"features": 1},
            input_signature={"x": [None, 2]})
        with pytest.raises(ValueError):
            server.swap_export(poison)
        # nothing above mutated the live model
        assert server.swap_count == 0
        feed = {"x": np.asarray([[1.0, 1.0]], np.float32)}
        assert abs(float(server.predict_feed(feed, 1)["output"][0][0])
                   - 5.0) < 1e-5


# ---------------------------------------------------------------------------
# rollback under fire: zero accepted requests lost
# ---------------------------------------------------------------------------

def test_live_rollback_with_inflight_zero_loss(tmp_path):
    """Roll the default live version back (v2 -> v1) on every replica
    while concurrent clients keep predicting: every accepted request
    completes with an answer from EXACTLY one of the two versions, and
    neither swap dispatches a new rung."""
    e1 = _export(tmp_path / "v1", [[2.0], [3.0]])   # y = 2a + 3b
    e2 = _export(tmp_path / "v2", [[4.0], [5.0]])   # y = 4a + 5b
    servers = [serving.ModelServer(e1, batch_size=8, device="cpu")
               for _ in range(2)]
    gws = [gateway.GatewayServer(s, max_wait_ms=1.0, model_version="1",
                                 replica_id="r{}".format(i))
           for i, s in enumerate(servers)]
    router = FleetRouter()
    try:
        for i, g in enumerate(gws):
            host, port = g.start()
            router.register_replica("r{}".format(i),
                                    "{}:{}".format(host, port), "linear", "1")

        def push(g, version, export_dir):
            g._on_beat_reply({"knobs": {"serving_load_version": {
                "model": "linear", "version": version,
                "export_dir": export_dir,
                "token": "{}-{}".format(g.replica_id, version)}}})

        # roll the fleet forward to v2 (the "live" default under test)
        for g in gws:
            push(g, "2", e2)
        deadline = time.time() + 10
        while (any(g.model_version != "2" for g in gws)
               and time.time() < deadline):
            time.sleep(0.01)
        assert all(g.model_version == "2" for g in gws)
        compiles = [s.compile_count for s in servers]

        stop = threading.Event()
        errors, answers = [], []
        lock = threading.Lock()

        def client_loop():
            client = FleetClient(router, timeout=10.0)
            rng = np.random.RandomState(hash(threading.get_ident()) % 2**31)
            try:
                while not stop.is_set():
                    a, b = float(rng.rand()), float(rng.rand())
                    feed = {"x": np.asarray([[a, b]], np.float32)}
                    got = float(client.predict("linear", feed, 1)
                                ["output"][0][0])
                    with lock:
                        answers.append((a, b, got))
            except Exception as e:  # any loss/corruption lands here
                with lock:
                    errors.append(e)
            finally:
                client.close()

        threads = [threading.Thread(target=client_loop) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        for g in gws:           # mid-fire rollback to v1 on every replica
            push(g, "1", e1)
        deadline = time.time() + 10
        while (any(g.model_version != "1" for g in gws)
               and time.time() < deadline):
            time.sleep(0.01)
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=15)

        assert errors == []     # zero accepted requests lost
        assert len(answers) > 20
        for a, b, got in answers:
            v1 = 2 * a + 3 * b
            v2 = 4 * a + 5 * b
            assert min(abs(got - v1), abs(got - v2)) < 1e-4, \
                "answer from neither version: {} (v1={} v2={})".format(
                    got, v1, v2)
        assert all(g.model_version == "1" for g in gws)
        assert all(g.swaps_total == 2 for g in gws)
        # both swaps reused the warm rungs end to end
        assert [s.compile_count for s in servers] == compiles
    finally:
        for g in gws:
            g.stop()


# ---------------------------------------------------------------------------
# canary controller: promote / rollback walks + replay parity
# ---------------------------------------------------------------------------

class _FakeFleet(object):
    """Scripted replica fleet: push_knobs 'applies' the swap by flipping
    the node's reported version, traffic() scripts the window counters."""

    def __init__(self):
        self.nodes = {}
        self.pushes = []

    def add(self, rid, model, version):
        self.nodes[rid] = {
            "serving_model": model, "serving_model_version": version,
            "serving_requests": 0, "serving_slo_good": 0,
            "serving_slo_total": 0, "serving_nonfinite": 0}

    def metrics(self):
        return {"nodes": {rid: dict(c) for rid, c in self.nodes.items()},
                "aggregate": {}}

    def push_knobs(self, knobs, executor_id=None):
        self.pushes.append((executor_id, json.loads(json.dumps(knobs))))
        swap = knobs.get("serving_load_version")
        if swap and executor_id in self.nodes:
            self.nodes[executor_id]["serving_model_version"] = swap["version"]

    def traffic(self, rid, total, good=None, nonfinite=0):
        c = self.nodes[rid]
        c["serving_requests"] += total
        c["serving_slo_total"] += total
        c["serving_slo_good"] += total if good is None else good
        c["serving_nonfinite"] += nonfinite


@pytest.fixture
def canary_rig(tmp_path):
    clock = {"now": 1000.0}
    registry = ModelRegistry(tmp_path / "reg", publisher="test",
                             clock=lambda: clock["now"])
    registry.publish("lin", "1", _export(tmp_path / "v1", [[2.0], [3.0]]),
                     status="live")
    fake = _FakeFleet()
    fake.add("r0", "lin", "1")
    fake.add("r1", "lin", "1")
    router = FleetRouter(registry=registry)
    router.register_replica("r0", "h:1", "lin", "1")
    router.register_replica("r1", "h:2", "lin", "1")
    journal = str(tmp_path / "canary.jsonl")
    ctl = CanaryController(
        registry, router, metrics_fn=fake.metrics,
        push_knobs=fake.push_knobs, journal_path=journal,
        clock=lambda: clock["now"],
        config={"clean_windows": 3, "min_requests": 5,
                "confirm_windows": 2, "cooldown_secs": 5.0,
                "revert_cooldown_secs": 30.0})
    yield clock, registry, fake, router, ctl, journal
    ctl._journal.close()
    registry.close()


def _ticks(ctl, clock, fake, n, total=10, good=None, nonfinite=0, rid=None):
    for _ in range(n):
        clock["now"] += 1.0
        if rid is not None:
            fake.traffic(rid, total, good=good, nonfinite=nonfinite)
        ctl.tick()


class TestCanary:
    def test_clean_canary_promotes_and_replays(self, canary_rig, tmp_path):
        clock, registry, fake, router, ctl, journal = canary_rig
        registry.publish("lin", "2", _export(tmp_path / "v2", [[4.0], [5.0]]))
        ctl.tick()  # proposes: knob pushed at ONE replica
        assert len([p for p in fake.pushes]) == 1
        target = fake.pushes[0][0]
        ctl.tick()  # heartbeat confirms the flip -> canary split applied
        assert registry.resolve("lin", "2")["status"] == "canary"
        split = router.status()["split"]["lin"]
        assert split["2"] == pytest.approx(0.1)
        assert split["1"] == pytest.approx(0.9)
        _ticks(ctl, clock, fake, 3, rid=target)  # 3 clean windows
        # promoted: default flipped, split cleared, OTHER replica flipped
        assert registry.default_version("lin") == "2"
        assert registry.resolve("lin", "1")["status"] == "retired"
        assert "lin" not in router.status()["split"]
        assert {p[0] for p in fake.pushes} == {"r0", "r1"}
        assert ctl.decisions == [("kept", "lin", "2")]
        ctl.tick()  # next reconcile sees the fleet-wide flip
        assert all(row["version"] == "2"
                   for row in router.replicas("lin").values())
        # the journal re-derives the same decision stream offline
        replay = fleet.replay_journal(journal)
        assert replay["journaled"] == [("kept", "lin", "2")]
        assert replay["matches"] is True

    def test_nonfinite_canary_rolls_back_and_replays(self, canary_rig,
                                                     tmp_path):
        clock, registry, fake, router, ctl, journal = canary_rig
        registry.publish("lin", "2", _export(tmp_path / "v2",
                                             [[4.0], [5.0]]))
        ctl.tick()
        target = fake.pushes[0][0]
        ctl.tick()  # applied
        _ticks(ctl, clock, fake, 1, rid=target)             # one clean
        _ticks(ctl, clock, fake, 1, nonfinite=2, rid=target)  # poison
        # instant rollback: v2 retired, replica rolled back to v1,
        # split cleared, default untouched
        assert ctl.decisions == [("reverted", "lin", "2")]
        assert registry.resolve("lin", "2")["status"] == "retired"
        assert registry.default_version("lin") == "1"
        assert "lin" not in router.status()["split"]
        last_push = fake.pushes[-1][1]["serving_load_version"]
        assert last_push["version"] == "1"
        assert fake.nodes[target]["serving_model_version"] == "1"
        # revert cooldown: the bad version is NOT retried next tick
        pushes = len(fake.pushes)
        _ticks(ctl, clock, fake, 3)
        assert len(fake.pushes) == pushes
        replay = fleet.replay_journal(journal)
        assert replay["journaled"] == [("reverted", "lin", "2")]
        assert replay["matches"] is True

    def test_err_rate_burn_needs_confirm_streak(self, canary_rig, tmp_path):
        clock, registry, fake, router, ctl, journal = canary_rig
        registry.publish("lin", "2", _export(tmp_path / "v2",
                                             [[4.0], [5.0]]))
        ctl.tick()
        target = fake.pushes[0][0]
        ctl.tick()
        # one burning window is hysteresis, not rollback...
        _ticks(ctl, clock, fake, 1, total=10, good=5, rid=target)
        assert ctl.decisions == []
        # ...the confirming second one rolls back
        _ticks(ctl, clock, fake, 1, total=10, good=5, rid=target)
        assert ctl.decisions == [("reverted", "lin", "2")]
        assert fleet.replay_journal(journal)["matches"] is True


class TestJudgeWindow:
    CFG = {"min_requests": 5, "max_err_rate": 0.05, "confirm_windows": 2}

    def test_verdicts(self):
        base = {"serving_slo_good": 0, "serving_slo_total": 0,
                "serving_nonfinite": 0}
        clean = dict(base, serving_slo_good=20, serving_slo_total=20)
        assert fleet.judge_window(base, clean, self.CFG)["verdict"] == \
            "clean"
        thin = dict(base, serving_slo_good=2, serving_slo_total=2)
        assert fleet.judge_window(base, thin, self.CFG)["verdict"] == \
            "insufficient"
        burn = dict(base, serving_slo_good=10, serving_slo_total=20)
        v = fleet.judge_window(base, burn, self.CFG)
        assert v["verdict"] == "violation" and not v["instant"]
        poison = dict(base, serving_nonfinite=1)
        v = fleet.judge_window(base, poison, self.CFG)
        assert v["verdict"] == "violation" and v["instant"]

    def test_alerts_override_counters(self):
        base = {"serving_slo_good": 0, "serving_slo_total": 0,
                "serving_nonfinite": 0}
        clean = dict(base, serving_slo_good=20, serving_slo_total=20)
        v = fleet.judge_window(base, clean, self.CFG,
                               alerts=[{"rule": "nonfinite"}])
        assert v["verdict"] == "violation" and v["instant"]
        v = fleet.judge_window(base, clean, self.CFG,
                               alerts=[{"rule": "slo_budget_burn"}])
        assert v["verdict"] == "violation" and not v["instant"]


# ---------------------------------------------------------------------------
# train-to-serve handoff
# ---------------------------------------------------------------------------

class TestPublishTrained:
    def test_poisoned_params_never_publish(self, registry):
        with pytest.raises(ValueError, match="nonfinite"):
            fleet.publish_trained(
                {"registry": registry, "model": "lin"},
                {"w": torch.tensor([np.nan, 1.0])}, step=7)
        assert registry.models() == []

    def test_publishes_validated_export_as_staging(self, registry):
        params = _linear_params([[2.0], [3.0]])
        entry = fleet.publish_trained(
            {"registry": registry, "model": "lin",
             "model_config": {"features": 1},
             "input_signature": {"x": [None, 2]}},
            params, step=42)
        assert entry["version"] == "step-42"
        assert entry["status"] == "staging"
        assert entry["export_dir"] == os.path.join(registry.root, "lin",
                                                   "step-42")
        # the export round-trips through the serving loader
        loaded, desc = checkpoint.load_model(entry["export_dir"],
                                             validate=True)
        assert sorted(loaded) == sorted(params)
        for name, t in params.items():
            torch.testing.assert_close(loaded[name], t, rtol=0, atol=0)
        assert desc["model_name"] == "lin"
        # a registry path (not instance) also works — the CLI spec shape
        with pytest.raises(PublishConflict):
            fleet.publish_trained(
                {"registry": registry.root, "model": "lin",
                 "version": "step-42"}, params, step=42)
