"""The JAX package's autopilot tests (``tests/test_autopilot.py``),
re-pointed at the port's copy of ``autopilot``: the closed-loop
controller's decision semantics on scripted windows (hysteresis, cooldown,
revert-on-regression, dry-run), journal round-trip + offline replay, the
KNOB actuation plumbing (coordinator exactly-once semantics, node-side
duck-typed registry, live setters), the observatory surfaces, and the
2-node e2e proving a knob push changes a RUNNING port ShardedFeed's
prefetch depth mid-run.  Beside them, parity with the JAX package: the
same fake ring and clock through both ``Autopilot``s give identical action
records, and a journal the port's live cluster wrote (the ``c.train``-fed
K retune of a live port Trainer) replays to identical proposals in both
packages' ``replay_journal``.

The JAX package is imported inside the parity tests only: the executors
unpickle this module's node functions by reference."""

import json
import os
import time
import urllib.error
import urllib.request

import pytest

from tensorflowonspark_torch import autopilot
from tensorflowonspark_torch import node as node_mod
from tensorflowonspark_torch import observatory
from tensorflowonspark_torch import reservation

T0 = 1_000_000.0   # synthetic epoch: far from 0 so window math is honest


class _FakeRing(object):
    """Scripted sample ring: each tick the test sets EXACTLY the window
    content the controller should see."""

    def __init__(self):
        self._series = {}

    def set_window(self, node, samples):
        self._series[str(node)] = list(samples)

    def series(self):
        return {n: list(s) for n, s in self._series.items()}


def _starved_window(now, frac=0.8, span=4.0, events=100):
    """A window whose worst-node starved wall fraction is ``frac``."""
    return [(now - span, {"dispatch_count": 0,
                          "goodput_infeed_starved_us": 0}),
            (now, {"dispatch_count": events,
                   "goodput_infeed_starved_us": int(frac * span * 1e6)})]


def _quiet_window(now, span=4.0, events=100):
    return [(now - span, {"dispatch_count": 0,
                          "goodput_infeed_starved_us": 0}),
            (now, {"dispatch_count": events,
                   "goodput_infeed_starved_us": 0})]


def _make_pilot(ring, clock, actuator=None, journal_path=None, **cfg):
    cfg.setdefault("confirm_ticks", 2)
    cfg.setdefault("settle_ticks", 1)
    cfg.setdefault("cooldown_secs", 10.0)
    cfg.setdefault("window_secs", 15.0)
    cfg.setdefault("knobs", {"infeed_prefetch": {"initial": 2}})
    return autopilot.Autopilot(ring, actuator=actuator, config=cfg,
                               journal_path=journal_path,
                               clock=lambda: clock["now"])


class TestConfig:
    def test_unknown_config_key_raises(self):
        with pytest.raises(ValueError, match="confirm_tickz"):
            autopilot.merge_config({"confirm_tickz": 3})

    def test_unknown_knob_raises(self):
        with pytest.raises(ValueError, match="infeed_prefetchh"):
            autopilot.merge_config({"knobs": {"infeed_prefetchh": {}}})

    def test_knob_overrides_merge_keywise(self):
        cfg = autopilot.merge_config(
            {"knobs": {"infeed_prefetch": {"initial": 4}}})
        assert cfg["knobs"]["infeed_prefetch"]["initial"] == 4
        # untouched sub-keys keep their defaults
        assert cfg["knobs"]["infeed_prefetch"]["max"] == \
            autopilot.DEFAULT_KNOBS["infeed_prefetch"]["max"]


class TestHysteresis:
    def test_single_firing_window_never_turns_a_knob(self):
        ring = _FakeRing()
        clock = {"now": T0}
        applied = []
        p = _make_pilot(ring, clock, actuator=lambda k: applied.append(k),
                        confirm_ticks=2)
        ring.set_window("0", _starved_window(clock["now"]))
        assert p.tick() == []          # streak 1 < confirm_ticks
        assert applied == []

    def test_consecutive_firing_windows_propose_and_apply(self):
        ring = _FakeRing()
        clock = {"now": T0}
        applied = []
        p = _make_pilot(ring, clock, actuator=lambda k: applied.append(k))
        for _ in range(2):
            clock["now"] += 1.0
            ring.set_window("0", _starved_window(clock["now"]))
            out = p.tick()
        stages = [r["stage"] for r in out]
        assert stages == ["proposed", "applied"]
        assert out[0]["knob"] == "infeed_prefetch"
        assert out[0]["from"] == 2 and out[0]["to"] == 4   # doubling step
        assert out[0]["signal"] == "infeed_starved"
        assert applied == [{"infeed_prefetch": 4}]
        assert p.knob_values()["infeed_prefetch"] == 4

    def test_interrupted_streak_resets(self):
        ring = _FakeRing()
        clock = {"now": T0}
        applied = []
        p = _make_pilot(ring, clock, actuator=lambda k: applied.append(k),
                        confirm_ticks=2)
        clock["now"] += 1.0
        ring.set_window("0", _starved_window(clock["now"]))
        p.tick()                                      # streak 1
        clock["now"] += 1.0
        ring.set_window("0", _quiet_window(clock["now"]))
        p.tick()                                      # quiet: streak reset
        clock["now"] += 1.0
        ring.set_window("0", _starved_window(clock["now"]))
        assert p.tick() == []                         # streak 1 again
        assert applied == []


class TestCooldown:
    def test_kept_action_cools_the_knob_down(self):
        ring = _FakeRing()
        clock = {"now": T0}
        applied = []
        p = _make_pilot(ring, clock, actuator=lambda k: applied.append(k),
                        cooldown_secs=10.0, settle_ticks=1)
        records = []
        for _ in range(6):   # propose+apply, effect+kept, then cooldown
            clock["now"] += 1.0
            ring.set_window("0", _starved_window(clock["now"]))
            records.extend(p.tick())
        stages = [r["stage"] for r in records]
        assert stages[:4] == ["proposed", "applied", "effect", "kept"]
        # still starving, but the knob is cooling down: no re-fire
        assert len(applied) == 1
        assert p.status()["cooldowns"].get("infeed_prefetch", 0) > 0
        # past the cooldown the hill-climb takes the next step (4 -> 8)
        clock["now"] += 10.0
        for _ in range(2):
            clock["now"] += 1.0
            ring.set_window("0", _starved_window(clock["now"]))
            p.tick()
        assert applied[-1] == {"infeed_prefetch": 8}


class TestRevertGuardrail:
    def _run_revert(self, tmp_path):
        ring = _FakeRing()
        clock = {"now": T0}
        applied = []
        jpath = os.path.join(str(tmp_path), "journal.jsonl")
        p = _make_pilot(ring, clock, actuator=lambda k: applied.append(k),
                        settle_ticks=1, revert_margin_frac=0.25,
                        revert_cooldown_secs=60.0, journal_path=jpath)
        for _ in range(2):
            clock["now"] += 1.0
            ring.set_window("0", _starved_window(clock["now"], frac=0.5))
            p.tick()
        assert applied == [{"infeed_prefetch": 4}]
        # the settle window measures WORSE starvation: 0.9 > 0.5 * 1.25
        clock["now"] += 1.0
        ring.set_window("0", _starved_window(clock["now"], frac=0.9))
        out = p.tick()
        return p, applied, out, jpath

    def test_regressing_actuation_rolls_back_in_one_window(self, tmp_path):
        p, applied, out, jpath = self._run_revert(tmp_path)
        assert [r["stage"] for r in out] == ["effect", "reverted"]
        # the revert pushed the OLD value back through the actuator
        assert applied[-1] == {"infeed_prefetch": 2}
        assert p.knob_values()["infeed_prefetch"] == 2
        # measured before/after ride the journaled records
        rev = out[-1]
        assert rev["objective_before"] == pytest.approx(0.5, rel=0.01)
        assert rev["objective_after"] == pytest.approx(0.9, rel=0.01)
        # a reverted knob cools down LONGER than a kept one
        assert p.status()["cooldowns"]["infeed_prefetch"] > 10.0

    def test_reverted_stage_lands_in_the_journal(self, tmp_path):
        p, _, _, jpath = self._run_revert(tmp_path)
        p.stop()
        actions = [r for r in autopilot.read_journal(jpath)
                   if r.get("kind") == "action"]
        stages = [r["stage"] for r in actions]
        assert stages == ["proposed", "applied", "effect", "reverted"]
        rev = actions[-1]
        assert rev["objective_before"] is not None
        assert rev["objective_after"] is not None
        assert rev["objective_after"] > rev["objective_before"]

    def test_improvement_within_margin_is_kept(self):
        ring = _FakeRing()
        clock = {"now": T0}
        p = _make_pilot(ring, clock, actuator=lambda k: None,
                        settle_ticks=1, revert_margin_frac=0.25)
        for _ in range(2):
            clock["now"] += 1.0
            ring.set_window("0", _starved_window(clock["now"], frac=0.5))
            p.tick()
        clock["now"] += 1.0
        ring.set_window("0", _starved_window(clock["now"], frac=0.2))
        out = p.tick()
        assert [r["stage"] for r in out] == ["effect", "kept"]
        assert p.knob_values()["infeed_prefetch"] == 4


class TestDryRun:
    def test_dry_run_proposes_but_never_applies(self, tmp_path):
        ring = _FakeRing()
        clock = {"now": T0}
        applied = []
        jpath = os.path.join(str(tmp_path), "journal.jsonl")
        p = _make_pilot(ring, clock, actuator=lambda k: applied.append(k),
                        dry_run=True, journal_path=jpath)
        records = []
        for _ in range(8):
            clock["now"] += 1.0
            ring.set_window("0", _starved_window(clock["now"]))
            records.extend(p.tick())
        assert records and all(r["stage"] == "proposed" for r in records)
        assert applied == []                       # never actuated
        assert p.status()["pending"] is None       # nothing in flight
        assert p.knob_values()["infeed_prefetch"] == 2   # value untouched
        # dry-run still cools down: a decision stream, not a firehose
        assert len(records) == 1
        p.stop()
        journaled = [r for r in autopilot.read_journal(jpath)
                     if r.get("kind") == "action"]
        assert [r["stage"] for r in journaled] == ["proposed"]


class TestAlertHints:
    def test_fresh_watchtower_alert_stands_in_for_the_sensor(self):
        ring = _FakeRing()
        clock = {"now": T0}
        applied = []
        p = _make_pilot(ring, clock, actuator=lambda k: applied.append(k),
                        confirm_ticks=1)
        ring.set_window("0", _quiet_window(clock["now"]))   # sensor silent
        p.observe_alert({"rule": "infeed_starved", "time": clock["now"]})
        out = p.tick()
        assert [r["stage"] for r in out] == ["proposed", "applied"]
        assert out[0]["signal"] == "infeed_starved"
        assert applied == [{"infeed_prefetch": 4}]

    def test_stale_hint_is_ignored(self):
        ring = _FakeRing()
        clock = {"now": T0}
        applied = []
        p = _make_pilot(ring, clock, actuator=lambda k: applied.append(k),
                        confirm_ticks=1, window_secs=15.0)
        p.observe_alert({"rule": "infeed_starved", "time": clock["now"]})
        clock["now"] += 30.0                                # hint expired
        ring.set_window("0", _quiet_window(clock["now"]))
        assert p.tick() == []
        assert applied == []

    def test_unmapped_rule_is_ignored(self):
        p = _make_pilot(_FakeRing(), {"now": T0})
        p.observe_alert({"rule": "straggler_step_time", "time": T0})
        assert p._hints == {}


class TestServingSensors:
    def test_low_batch_fill_shrinks_max_wait(self):
        ring = _FakeRing()
        clock = {"now": T0}
        applied = []
        p = _make_pilot(
            ring, clock, actuator=lambda k: applied.append(k),
            confirm_ticks=1,
            knobs={"serving_max_wait_ms": {"initial": 8.0}})
        clock["now"] += 1.0
        ring.set_window("g", [
            (clock["now"] - 4, {"serving_requests": 0}),
            (clock["now"], {"serving_requests": 50,
                            "serving_batch_fill_pct_max": 20.0,
                            "serving_p99_us_max": 9000.0})])
        out = p.tick()
        assert [r["stage"] for r in out] == ["proposed", "applied"]
        assert applied == [{"serving_max_wait_ms": 4.0}]   # halved

    def test_full_batches_with_latency_headroom_raise_max_batch(self):
        ring = _FakeRing()
        clock = {"now": T0}
        applied = []
        p = _make_pilot(
            ring, clock, actuator=lambda k: applied.append(k),
            confirm_ticks=1, latency_slo_p99_us=50000.0,
            knobs={"serving_max_batch": {"initial": 8}})
        clock["now"] += 1.0
        ring.set_window("g", [
            (clock["now"] - 4, {"serving_requests": 0}),
            (clock["now"], {"serving_requests": 50,
                            "serving_batch_fill_pct_max": 97.0,
                            "serving_p99_us_max": 9000.0})])
        out = p.tick()
        assert [r["stage"] for r in out] == ["proposed", "applied"]
        assert applied == [{"serving_max_batch": 16}]      # doubled


def _gap_window(now, gap_us_per_step, steps=100, span=4.0, starved_frac=0.0):
    """A window whose per-dispatched-step host gap is ``gap_us_per_step``
    (cumulative counters, worst node), optionally also feed-starved."""
    return [(now - span, {"dispatch_count": 0, "train_steps_total": 0,
                          "dispatch_gap_us": 0,
                          "goodput_infeed_starved_us": 0}),
            (now, {"dispatch_count": steps, "train_steps_total": steps,
                   "dispatch_gap_us": int(gap_us_per_step * steps),
                   "goodput_infeed_starved_us":
                       int(starved_frac * span * 1e6)})]


class TestMegastepKnob:
    """train_steps_per_call steering: gap-per-step doubles K, group
    starvation halves it, a regressing double reverts, and K=1 never
    halves further."""

    def _k_pilot(self, applied, initial=1, **cfg):
        ring = _FakeRing()
        clock = {"now": T0}
        cfg.setdefault("knobs",
                       {"train_steps_per_call": {"initial": initial}})
        p = _make_pilot(ring, clock, actuator=lambda k: applied.append(k),
                        **cfg)
        return ring, clock, p

    def test_high_gap_per_step_doubles_k(self):
        applied = []
        ring, clock, p = self._k_pilot(applied)
        for _ in range(2):
            clock["now"] += 1.0
            # 2000 us of host gap per dispatched step >= the 1500 default
            ring.set_window("0", _gap_window(clock["now"], 2000.0))
            out = p.tick()
        assert [r["stage"] for r in out] == ["proposed", "applied"]
        assert out[0]["knob"] == "train_steps_per_call"
        assert out[0]["from"] == 1 and out[0]["to"] == 2
        assert out[0]["signal"] == "dispatch_gap_per_step"
        assert applied == [{"train_steps_per_call": 2}]

    def test_group_starved_halves_k(self):
        applied = []
        ring, clock, p = self._k_pilot(applied, initial=4)
        for _ in range(2):
            clock["now"] += 1.0
            # gap is fine (100 us/step) but the feed starves 80% of wall:
            # a K=4 group parks the device waiting for 4 batches at a time
            ring.set_window("0", _gap_window(clock["now"], 100.0,
                                             starved_frac=0.8))
            out = p.tick()
        assert [r["stage"] for r in out] == ["proposed", "applied"]
        assert out[0]["from"] == 4 and out[0]["to"] == 2
        assert out[0]["signal"] == "group_starved"
        assert applied == [{"train_steps_per_call": 2}]

    def test_starved_at_k1_never_fires(self):
        applied = []
        ring, clock, p = self._k_pilot(applied, initial=1, confirm_ticks=1)
        clock["now"] += 1.0
        ring.set_window("0", _gap_window(clock["now"], 100.0,
                                         starved_frac=0.9))
        assert p.tick() == []      # K=1 cannot halve; starvation is not
        assert applied == []       # this knob's problem any more

    def test_regressing_double_reverts_to_old_k(self):
        applied = []
        ring, clock, p = self._k_pilot(applied, initial=2, settle_ticks=1,
                                       revert_margin_frac=0.25)
        for _ in range(2):
            clock["now"] += 1.0
            ring.set_window("0", _gap_window(clock["now"], 2000.0))
            p.tick()
        assert applied == [{"train_steps_per_call": 4}]
        # the settle window measures a WORSE gap: 3000 > 2000 * 1.25
        clock["now"] += 1.0
        ring.set_window("0", _gap_window(clock["now"], 3000.0))
        out = p.tick()
        assert [r["stage"] for r in out] == ["effect", "reverted"]
        assert applied[-1] == {"train_steps_per_call": 2}
        assert p.knob_values()["train_steps_per_call"] == 2


class TestJournalRoundTrip:
    def _run_live(self, tmp_path):
        """Scripted live run over a REAL SampleRing with a snapshot_fn so
        the journal carries the series replay needs."""
        ring = observatory.SampleRing()
        latest = {}
        clock = {"now": T0}
        jpath = os.path.join(str(tmp_path), "journal.jsonl")
        p = autopilot.Autopilot(
            ring,
            actuator=lambda k: None,
            snapshot_fn=lambda: {"nodes": {n: dict(c)
                                           for n, c in latest.items()},
                                 "aggregate": {}},
            config={"confirm_ticks": 2, "settle_ticks": 30,
                    "window_secs": 15.0, "journal_snapshot_secs": 1.0,
                    "min_events": 1,
                    "knobs": {"infeed_prefetch": {"initial": 2}}},
            journal_path=jpath, clock=lambda: clock["now"])
        p._journal_meta()
        disp = starve = 0
        for _ in range(8):
            clock["now"] += 1.0
            disp += 10
            starve += 600_000      # 60% of each second starved
            c = {"dispatch_count": disp,
                 "goodput_infeed_starved_us": starve}
            ring.record("0", c, ts=clock["now"])
            latest["0"] = c
            p.tick()
        p.stop()
        return p, jpath

    def test_journal_parses_with_meta_actions_snapshots(self, tmp_path):
        p, jpath = self._run_live(tmp_path)
        records = autopilot.read_journal(jpath)
        kinds = [r["kind"] for r in records]
        assert kinds[0] == "meta"
        assert records[0]["version"] == autopilot.JOURNAL_VERSION
        assert records[0]["knobs"]["infeed_prefetch"] == 2
        assert "action" in kinds and "snapshot" in kinds
        live = [r for r in records if r.get("kind") == "action"]
        assert [r["stage"] for r in live] == ["proposed", "applied"]
        # the bounded in-memory log matches the journal
        assert [a["stage"] for a in p.actions()] == ["proposed", "applied"]
        assert p.action_counts() == {"proposed": 1, "applied": 1}

    def test_replay_rederives_the_live_proposal(self, tmp_path):
        _, jpath = self._run_live(tmp_path)
        result = autopilot.replay_journal(autopilot.read_journal(jpath))
        assert result["snapshots"] >= 6
        # replay inherits config + initial knob values from the meta record
        assert result["config"]["confirm_ticks"] == 2
        assert result["config"]["dry_run"] is True
        replayed = [(a["knob"], a["to"]) for a in result["actions"]]
        assert ("infeed_prefetch", 4) in replayed
        journaled = [(a["knob"], a["to"])
                     for a in result["journaled_actions"]
                     if a["stage"] == "proposed"]
        assert journaled == [("infeed_prefetch", 4)]

    def test_truncated_journal_still_replays(self, tmp_path):
        _, jpath = self._run_live(tmp_path)
        with open(jpath, "a") as f:
            f.write('{"kind": "snapshot", "time": 1, "snap')   # crash cut
        result = autopilot.replay_journal(autopilot.read_journal(jpath))
        assert any(a["knob"] == "infeed_prefetch"
                   for a in result["actions"])


class TestKnobCoordinator:
    def test_exactly_once_per_executor(self):
        kc = reservation.KnobCoordinator()
        kc.push({"infeed_prefetch": 4})
        assert kc.poll("0") == {"infeed_prefetch": 4}
        assert kc.poll("0") is None            # drained
        assert kc.poll("1") == {"infeed_prefetch": 4}   # independent cursor

    def test_newest_wins_merge(self):
        kc = reservation.KnobCoordinator()
        kc.push({"infeed_prefetch": 4, "wire_codec": "off"})
        kc.push({"infeed_prefetch": 8})
        assert kc.poll("0") == {"infeed_prefetch": 8, "wire_codec": "off"}

    def test_late_joiner_drains_full_history(self):
        """An elastic replacement registering AFTER the pushes still
        converges to controller intent."""
        kc = reservation.KnobCoordinator()
        kc.push({"infeed_prefetch": 4})
        kc.push({"dataservice_queue_bound": 8})
        assert kc.poll("99") == {"infeed_prefetch": 4,
                                 "dataservice_queue_bound": 8}
        assert kc.current() == {"infeed_prefetch": 4,
                                "dataservice_queue_bound": 8}

    def test_targeted_push_reaches_only_its_executor(self):
        kc = reservation.KnobCoordinator()
        kc.push({"dataservice_cache_budget": 1 << 20}, executor_id="w1")
        assert kc.poll("w0") is None
        assert kc.poll("w1") == {"dataservice_cache_budget": 1 << 20}
        # targeted pushes never leak into the broadcast view
        assert kc.current() == {}


class TestNodeRegistry:
    def test_apply_knobs_duck_types_claimed_names(self):
        class _Feed:
            def __init__(self):
                self.seen = []

            def apply_knob(self, name, value):
                self.seen.append((name, value))
                return name == "infeed_prefetch"

        feed = _Feed()
        node_mod._register_feed(feed)
        before = node_mod._knob_counters["autopilot_knobs_applied"]
        try:
            n = node_mod.apply_knobs({"infeed_prefetch": 4,
                                      "serving_max_batch": 16})
            assert n == 1                      # only the claimed knob counts
            assert ("infeed_prefetch", 4) in feed.seen
            assert node_mod._knob_counters["autopilot_knobs_applied"] == \
                before + 1
        finally:
            node_mod._feeds[:] = [r for r in node_mod._feeds
                                  if r() is not feed]

    def test_failing_setter_never_breaks_the_beat(self):
        class _Bad:
            def apply_knob(self, name, value):
                raise RuntimeError("boom")

        bad = _Bad()
        node_mod._register_feed(bad)
        try:
            assert node_mod.apply_knobs({"infeed_prefetch": 4}) == 0
        finally:
            node_mod._feeds[:] = [r for r in node_mod._feeds
                                  if r() is not bad]


class TestObservatorySurfaces:
    def _pilot_with_action(self):
        ring = _FakeRing()
        clock = {"now": T0}
        p = _make_pilot(ring, clock, actuator=lambda k: None)
        for _ in range(2):
            clock["now"] += 1.0
            ring.set_window("0", _starved_window(clock["now"]))
            p.tick()
        return p

    def _serve(self, pilot):
        srv = observatory.ObservatoryServer(
            lambda: {"nodes": {"0": {"chunks": 1}}, "aggregate": {}},
            status_fn=lambda: {"state": "running"},
            host="127.0.0.1", autopilot=pilot)
        return srv, srv.start()

    def test_autopilot_endpoint_and_counters(self):
        p = self._pilot_with_action()
        srv, (host, port) = self._serve(p)
        try:
            base = "http://%s:%d" % (host, port)
            doc = json.loads(urllib.request.urlopen(
                base + "/autopilot", timeout=5).read().decode())
            assert doc["knobs"]["infeed_prefetch"] == 4
            assert doc["action_counts"] == {"proposed": 1, "applied": 1}
            assert doc["pending"]["knob"] == "infeed_prefetch"
            assert any(a["stage"] == "applied" for a in doc["actions"])
            limited = json.loads(urllib.request.urlopen(
                base + "/autopilot?limit=1", timeout=5).read().decode())
            assert len(limited["actions"]) == 1
            status = json.loads(urllib.request.urlopen(
                base + "/status", timeout=5).read().decode())
            assert status["autopilot"]["action_counts"]["applied"] == 1
            text = urllib.request.urlopen(
                base + "/metrics", timeout=5).read().decode()
            assert 'tfos_autopilot_actions_total{stage="applied"} 1' in text
            assert "tfos_autopilot_ticks_total" in text
        finally:
            srv.stop()

    def test_autopilot_endpoint_503_without_pilot(self):
        srv, (host, port) = self._serve(None)
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(
                    "http://%s:%d/autopilot" % (host, port), timeout=5)
            assert e.value.code == 503
        finally:
            srv.stop()


def _knob_node_fn(args, ctx):
    """Build a ShardedFeed over a slow synthetic columnar source, start a
    live consumer (so the prefetch queue EXISTS), signal readiness, then
    wait for the driver's KNOB push to land."""
    import json as _json
    import os as _os
    import threading as _threading
    import time as _time

    import numpy as np

    from tensorflowonspark_torch.parallel import infeed

    class _Source:
        def next_batch_arrays(self, n):
            _time.sleep(0.02)
            return (np.ones((n, 2), np.float32),), n

        def should_stop(self):
            return False

        def interrupt(self):
            pass

    sf = infeed.ShardedFeed(_Source(), 1, prefetch=1, device="cpu")
    stop = _threading.Event()
    consumed = [0]

    def _consume():
        for _batch, _mask in sf.batches():
            consumed[0] += 1
            if stop.is_set():
                break

    t = _threading.Thread(target=_consume, daemon=True)
    t.start()
    with open(args["ready_file"] + str(ctx.executor_id), "w") as f:
        f.write("ready")
    deadline = _time.time() + 45
    while sf._prefetch_depth == 1 and _time.time() < deadline:
        _time.sleep(0.1)
    buf = sf._prefetch_buf
    with open(args["out_file"] + str(ctx.executor_id), "w") as f:
        _json.dump({"depth": sf._prefetch_depth,
                    "buf_max": buf.maxsize if buf is not None else None,
                    "consumed": consumed[0]}, f)
    stop.set()
    # hold the feed until the driver confirms the retuned gauge made it
    # back over a heartbeat
    while not _os.path.exists(args["stop_file"]) and \
            _time.time() < deadline:
        _time.sleep(0.1)


def test_e2e_knob_push_retunes_live_sharded_feed(tmp_path):
    """Tentpole e2e: a KNOB message through the heartbeat-reply channel
    changes a RUNNING ShardedFeed's prefetch depth (and its live queue
    bound) on both nodes mid-run, and the retune is observable back on
    the driver through the heartbeat gauge."""
    from tensorflowonspark_torch import backend, cluster

    ready = os.path.join(str(tmp_path), "ready-")
    out = os.path.join(str(tmp_path), "out-")
    stop_file = os.path.join(str(tmp_path), "stop")
    b = backend.LocalBackend(2)
    try:
        c = cluster.run(
            b, _knob_node_fn,
            tf_args={"ready_file": ready, "out_file": out,
                     "stop_file": stop_file},
            num_executors=2, input_mode=cluster.InputMode.FILES,
            heartbeat_interval=0.5, log_dir=str(tmp_path),
            telemetry=True, observatory=True,
            autopilot={"dry_run": True})   # coordinator up, controller passive
        assert c.autopilot is not None and c.autopilot.dry_run
        assert c.server.knob_coordinator is not None
        # the live /autopilot surface answers while the run is up
        doc = json.loads(urllib.request.urlopen(
            "http://%s:%d/autopilot" % c.observatory.addr,
            timeout=5).read().decode())
        assert doc["dry_run"] is True
        # wait until BOTH nodes hold a registered, consuming feed — a push
        # drained before the feed exists would be applied to nothing
        deadline = time.time() + 45
        while time.time() < deadline and not all(
                os.path.exists(ready + str(i)) for i in range(2)):
            time.sleep(0.1)
        c.server.knob_coordinator.push({"infeed_prefetch": 5})
        results = {}
        while time.time() < deadline and len(results) < 2:
            for i in range(2):
                if i in results or not os.path.exists(out + str(i)):
                    continue
                try:
                    with open(out + str(i)) as f:
                        results[i] = json.load(f)
                except (OSError, ValueError):
                    pass
            time.sleep(0.1)
        # the retuned depth must flow back to the driver as a gauge and
        # the application tally must ride the heartbeat counters
        agg = {}
        while time.time() < deadline:
            agg = c.metrics_snapshot().get("aggregate") or {}
            if agg.get("infeed_prefetch_depth_max") == 5 and \
                    agg.get("autopilot_knobs_applied", 0) >= 2:
                break
            time.sleep(0.2)
        with open(stop_file, "w") as f:
            f.write("done")
        c.shutdown(grace_secs=10)
        assert "error" not in c.tf_status, c.tf_status["error"]
        assert len(results) == 2, results
        for i in range(2):
            assert results[i]["depth"] == 5, results
            assert results[i]["buf_max"] == 5, results   # live queue rebound
            assert results[i]["consumed"] > 0, results   # data really flowed
        assert agg.get("infeed_prefetch_depth_max") == 5, agg
        assert agg.get("autopilot_knobs_applied", 0) >= 2, agg
        # the live run's journals replay alike in both packages
        from tensorflowonspark_tpu import autopilot as jax_autopilot
        from tensorflowonspark_tpu import watchtower as jax_watchtower
        from tensorflowonspark_torch import watchtower

        records = autopilot.read_journal(os.path.join(
            str(tmp_path), "autopilot", "journal.jsonl"))
        assert records[0]["kind"] == "meta" and records[0]["dry_run"]
        ours = autopilot.replay_journal(records)
        theirs = jax_autopilot.replay_journal(records)
        assert ours["snapshots"] and ours["actions"] == theirs["actions"]
        assert ours["journaled_actions"] == theirs["journaled_actions"]
        records = watchtower.read_journal(os.path.join(
            str(tmp_path), "watchtower", "journal.jsonl"))
        ours = watchtower.replay_journal(records)
        theirs = jax_watchtower.replay_journal(records)
        assert ours["snapshots"] and ours["alerts"] == theirs["alerts"]
    finally:
        try:
            with open(stop_file, "w") as f:
                f.write("done")
        except OSError:
            pass
        b.stop()


# -- parity with the JAX package ----------------------------------------------

def _scripted(pilot_mod, ring, windows, applied, **cfg):
    """One pilot of ``pilot_mod`` ticked over ``windows`` (``[(node,
    samples-fn of now)]`` per tick) on a fake clock; its action records."""
    clock = {"now": T0}
    cfg.setdefault("confirm_ticks", 2)
    cfg.setdefault("settle_ticks", 1)
    cfg.setdefault("cooldown_secs", 2.0)
    cfg.setdefault("revert_cooldown_secs", 3.0)
    cfg.setdefault("window_secs", 15.0)
    p = pilot_mod.Autopilot(ring, actuator=applied.append, config=cfg,
                            clock=lambda: clock["now"])
    for tick in windows:
        clock["now"] += 1.0
        for node, make in tick:
            ring.set_window(node, make(clock["now"]))
        p.tick()
    return p.actions(), p.action_counts(), p.knob_values()


def _script():
    """Starved windows (prefetch up), a regressing one (revert), gap
    windows (K doubled, then kept) and a serving window."""
    ticks = []
    for frac in (0.8, 0.8, 0.95, 0.95, 0.1, 0.1, 0.8, 0.8, 0.8):
        ticks.append([("0", lambda now, f=frac: _starved_window(now, f))])
    for gap in (2000.0, 2000.0, 900.0, 900.0, 2500.0, 2500.0, 400.0):
        ticks.append([("1", lambda now, g=gap: _gap_window(now, g))])
    return ticks


def test_autopilot_matches_jax_on_a_fake_ring():
    """The same fake ring and clock through the JAX package's
    ``Autopilot`` and the port's give identical action records, counts,
    knob values and actuator calls."""
    from tensorflowonspark_tpu import autopilot as jax_autopilot

    knobs = {"infeed_prefetch": {"initial": 2},
             "train_steps_per_call": {"initial": 1}}
    got_applied, want_applied = [], []
    got = _scripted(autopilot, _FakeRing(), _script(), got_applied,
                    knobs=knobs)
    want = _scripted(jax_autopilot, _FakeRing(), _script(), want_applied,
                     knobs=knobs)
    assert got == want
    assert got_applied == want_applied
    stages = {(a["knob"], a["stage"]) for a in got[0]}
    assert {("infeed_prefetch", "applied"),
            ("train_steps_per_call", "applied")} <= stages


def test_port_journal_replays_alike_in_both_packages(tmp_path):
    """The port's scripted live journal (TestJournalRoundTrip) replays to
    identical proposals through both packages' ``replay_journal``."""
    from tensorflowonspark_tpu import autopilot as jax_autopilot

    _, jpath = TestJournalRoundTrip()._run_live(tmp_path)
    ours = autopilot.replay_journal(autopilot.read_journal(jpath))
    theirs = jax_autopilot.replay_journal(jax_autopilot.read_journal(jpath))
    assert ours["actions"] == theirs["actions"]
    assert [(a["knob"], a["to"]) for a in ours["actions"]] == [
        ("infeed_prefetch", 4)]
