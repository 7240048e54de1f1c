"""The JAX package's remediator tests (``tests/test_remediator.py``),
re-pointed at the port's copy of ``remediator``: the topology action
plane's guardrail matrix on scripted alerts (confirm windows,
one-action-in-flight, per-family cooldown, dry-run, revert-on-regression,
budgets, replacement grace), journal round-trip + offline replay, the
node-side evict-command interception, the port Trainer's
``train_rollback`` knob claim, and the observatory surfaces
(``tfos_remediation_actions_total`` + ``/remediations``).  Beside them:
parity with the JAX package (the same fake ring and clock through both
``Remediator``s give identical action records; the journals of a live
port cluster replay alike in both packages), the port's live eviction loop
on the CPU (a two-node SPARK straggler evicted and replaced; the FILES-mode
poison rollback is ``tests/test_torch_remediator_rollback.py``'s), and
``scripts/metrics_replay_torch.py`` over its journals.

The JAX package is imported inside the tests only: the executors
unpickle this module's node functions by reference."""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

from tensorflowonspark_torch import node as node_mod
from tensorflowonspark_torch import observatory
from tensorflowonspark_torch import remediator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_000_000.0   # synthetic epoch: far from 0 so window math is honest


class _FakeRing(object):
    """Scripted sample ring: each phase the test sets EXACTLY the window
    content the settle-objective measurement should see."""

    def __init__(self):
        self._series = {}

    def set_window(self, node, samples):
        self._series[str(node)] = list(samples)

    def series(self):
        return {n: list(s) for n, s in self._series.items()}


def _sat_window(now, pct, span=4.0):
    """A window whose data-service queue saturation gauge reads ``pct``."""
    return [(now - span, {"dataservice_items": 0,
                          "dataservice_queue_sat_pct_max": pct}),
            (now, {"dataservice_items": 100,
                   "dataservice_queue_sat_pct_max": pct})]


def _alert(rule, executor, now, persists=1, severity="warn", evidence=None):
    return {"rule": rule, "executor": str(executor), "severity": severity,
            "time": now, "persists_windows": persists,
            "evidence": evidence or {}}


class _Calls(object):
    """Recording actuator set: every family armed, every call logged."""

    def __init__(self, fail=()):
        self.log = []
        self._fail = set(fail)

    def _make(self, name, needs_args):
        def fn(*args):
            if name in self._fail:
                raise RuntimeError("injected %s failure" % name)
            self.log.append((name,) + ((args[0],) if needs_args else ()))
            return {"via": name}
        return fn

    def actions(self):
        return {
            "evict": self._make("evict", True),
            "rollback": self._make("rollback", True),
            "spawn_worker": self._make("spawn_worker", False),
            "retire_worker": self._make("retire_worker", False),
            "spawn_replica": self._make("spawn_replica", False),
            "retire_replica": self._make("retire_replica", False),
        }

    def named(self, name):
        return [c for c in self.log if c[0] == name]


def _make_plane(ring, clock, calls=None, journal_path=None, **cfg):
    cfg.setdefault("settle_ticks", 2)
    cfg.setdefault("cooldown_secs", 10.0)
    cfg.setdefault("revert_cooldown_secs", 30.0)
    cfg.setdefault("window_secs", 15.0)
    cfg.setdefault("alert_ttl_secs", 300.0)
    cfg.setdefault("confirm_windows", {"evict_straggler": 2,
                                       "scale_out_workers": 2})
    calls = calls if calls is not None else _Calls()
    plane = remediator.Remediator(ring, actions=calls.actions(),
                                  config=cfg, journal_path=journal_path,
                                  clock=lambda: clock["now"])
    return plane, calls


class TestConfig:
    def test_unknown_config_key_raises(self):
        with pytest.raises(ValueError, match="cooldown_secz"):
            remediator.merge_config({"cooldown_secz": 3})

    def test_confirm_windows_merge_keywise(self):
        cfg = remediator.merge_config(
            {"confirm_windows": {"evict_straggler": 7}})
        assert cfg["confirm_windows"]["evict_straggler"] == 7
        # untouched per-action thresholds keep their defaults
        assert cfg["confirm_windows"]["rollback_poison"] == \
            remediator.DEFAULT_CONFIG["confirm_windows"]["rollback_poison"]

    def test_every_rule_maps_to_a_priority_action(self):
        for action in remediator.RULE_ACTIONS.values():
            assert action in remediator.ACTION_PRIORITY
            assert action in remediator.COOLDOWN_FAMILY


class TestGuardrails:
    def test_confirmed_straggler_evicts_and_settles_kept(self):
        clock = {"now": T0}
        plane, calls = _make_plane(_FakeRing(), clock)
        # one window of persistence: below the confirm threshold
        plane.observe_alert(_alert("straggler_step_time", 2, clock["now"]))
        assert plane.tick() == []
        assert calls.named("evict") == []
        # second consecutive window: threshold met -> proposed + applied
        clock["now"] += 5
        plane.observe_alert(_alert("straggler_step_time", 2, clock["now"],
                                   persists=2))
        recs = plane.tick()
        assert [r["stage"] for r in recs] == ["proposed", "applied"]
        assert recs[0]["action"] == "evict_straggler"
        assert recs[0]["evidence"] is not None
        assert calls.named("evict") == [("evict", "2")]
        # settle_ticks later the effect is judged; eviction is
        # irreversible so it is always kept
        clock["now"] += 5
        assert plane.tick() == []          # settling, not judged yet
        clock["now"] += 5
        stages = [r["stage"] for r in plane.tick()]
        assert stages == ["effect", "kept"]
        counts = plane.action_counts()["evict_straggler"]
        assert counts == {"proposed": 1, "applied": 1,
                          "effect": 1, "kept": 1}

    def test_one_action_in_flight_blocks_second(self):
        clock = {"now": T0}
        plane, calls = _make_plane(_FakeRing(), clock,
                                   confirm_windows={"evict_straggler": 1,
                                                    "scale_out_workers": 1})
        plane.observe_alert(_alert("straggler_step_time", 1, clock["now"],
                                   persists=3))
        assert len(plane.tick()) == 2      # proposed + applied
        # a fully-confirmed saturation alert lands while the eviction is
        # settling: nothing may actuate until the pending action is judged
        plane.observe_alert(_alert("dataservice_saturation", 0, clock["now"],
                                   persists=5))
        clock["now"] += 1
        assert plane.tick() == []
        assert calls.named("spawn_worker") == []
        assert plane.status()["pending"]["action"] == "evict_straggler"

    def test_per_family_cooldown_suppresses_flapping(self):
        clock = {"now": T0}
        plane, calls = _make_plane(
            _FakeRing(), clock, settle_ticks=1, cooldown_secs=20.0,
            confirm_windows={"scale_out_workers": 1},
            replacement_grace_secs=0.0)
        plane.observe_alert(_alert("dataservice_saturation", 0, clock["now"],
                                   persists=2))
        assert len(plane.tick()) == 2
        clock["now"] += 2
        plane.tick()                        # judged: kept, cooldown starts
        assert len(calls.named("spawn_worker")) == 1
        # fresh confirmed alerts inside the cooldown window: suppressed
        for _ in range(3):
            clock["now"] += 2
            plane.observe_alert(_alert("dataservice_saturation", 0,
                                       clock["now"], persists=4))
            assert plane.tick() == []
        assert len(calls.named("spawn_worker")) == 1
        # past the cooldown the standing alert may act again
        clock["now"] += 25
        plane.observe_alert(_alert("dataservice_saturation", 0, clock["now"],
                                   persists=4))
        assert len(plane.tick()) == 2
        assert len(calls.named("spawn_worker")) == 2

    def test_dry_run_journals_but_never_actuates(self, tmp_path):
        clock = {"now": T0}
        jp = str(tmp_path / "journal.jsonl")
        plane, calls = _make_plane(
            _FakeRing(), clock, journal_path=jp, dry_run=True,
            confirm_windows={"evict_straggler": 1})
        plane._journal_meta()
        plane.observe_alert(_alert("straggler_step_time", 3, clock["now"],
                                   persists=9))
        recs = plane.tick()
        assert [r["stage"] for r in recs] == ["proposed"]
        assert calls.log == []
        # dry-run still cools down: the journal is a decision stream,
        # not a firehose
        clock["now"] += 1
        plane.observe_alert(_alert("straggler_step_time", 3, clock["now"],
                                   persists=9))
        assert plane.tick() == []
        plane.stop()
        journaled = remediator.read_journal(jp)
        stages = [r["stage"] for r in journaled if r["kind"] == "action"]
        assert stages == ["proposed"]

    def test_revert_retires_just_spawned_worker_on_regression(self):
        clock = {"now": T0}
        ring = _FakeRing()
        plane, calls = _make_plane(
            ring, clock, settle_ticks=1,
            confirm_windows={"scale_out_workers": 1},
            revert_margin_frac=0.25)
        ring.set_window("0", _sat_window(clock["now"], 50.0))
        plane.observe_alert(_alert("dataservice_saturation", 0, clock["now"],
                                   persists=2))
        recs = plane.tick()
        assert [r["stage"] for r in recs] == ["proposed", "applied"]
        assert recs[0]["reversible"] is True
        assert plane.status()["budgets"]["workers_added"][0] == 1
        # the spawn made it WORSE: saturation gauge regressed 50 -> 80
        clock["now"] += 2
        ring.set_window("0", _sat_window(clock["now"], 80.0))
        stages = [r["stage"] for r in plane.tick()]
        assert stages == ["effect", "reverted"]
        assert len(calls.named("retire_worker")) == 1
        assert plane.status()["budgets"]["workers_added"][0] == 0

    def test_scale_out_kept_when_objective_improves(self):
        clock = {"now": T0}
        ring = _FakeRing()
        plane, calls = _make_plane(
            ring, clock, settle_ticks=1,
            confirm_windows={"scale_out_workers": 1})
        ring.set_window("0", _sat_window(clock["now"], 90.0))
        plane.observe_alert(_alert("dataservice_saturation", 0, clock["now"],
                                   persists=2))
        plane.tick()
        clock["now"] += 20                 # old gauge leaves the window
        ring.set_window("0", _sat_window(clock["now"], 40.0))
        stages = [r["stage"] for r in plane.tick()]
        assert stages == ["effect", "kept"]
        assert calls.named("retire_worker") == []

    def test_replacement_grace_shields_fresh_node(self):
        clock = {"now": T0}
        plane, calls = _make_plane(
            _FakeRing(), clock, settle_ticks=1, cooldown_secs=1.0,
            confirm_windows={"evict_straggler": 1},
            replacement_grace_secs=60.0, max_evictions=5)
        plane.observe_alert(_alert("straggler_step_time", 1, clock["now"],
                                   persists=3))
        plane.tick()
        clock["now"] += 2
        plane.tick()                        # kept; short cooldown expires
        assert len(calls.named("evict")) == 1
        # the replacement compiles cold and LOOKS slow: its straggler
        # alerts must not trigger a second eviction during the grace
        clock["now"] += 5
        plane.observe_alert(_alert("straggler_step_time", 9, clock["now"],
                                   persists=8))
        assert plane.tick() == []
        assert len(calls.named("evict")) == 1
        clock["now"] += 60                  # grace over: acts again
        plane.observe_alert(_alert("straggler_step_time", 9, clock["now"],
                                   persists=8))
        assert len(plane.tick()) == 2
        assert len(calls.named("evict")) == 2

    def test_evicted_executor_alerts_are_moot(self):
        clock = {"now": T0}
        plane, calls = _make_plane(
            _FakeRing(), clock, settle_ticks=1, cooldown_secs=0.1,
            confirm_windows={"evict_straggler": 1},
            replacement_grace_secs=0.0, max_evictions=5)
        plane.observe_alert(_alert("straggler_step_time", 4, clock["now"],
                                   persists=3))
        plane.tick()
        clock["now"] += 1
        plane.tick()
        assert len(calls.named("evict")) == 1
        # the zombie keeps straggling while it drains: ignored
        clock["now"] += 1
        plane.observe_alert(_alert("straggler_dispatch_gap", 4, clock["now"],
                                   persists=9))
        assert plane.status()["standing_alerts"] == []
        assert plane.tick() == []
        assert len(calls.named("evict")) == 1

    def test_eviction_budget_is_a_hard_cap(self):
        clock = {"now": T0}
        plane, calls = _make_plane(
            _FakeRing(), clock, settle_ticks=1, cooldown_secs=0.1,
            confirm_windows={"evict_straggler": 1},
            replacement_grace_secs=0.0, max_evictions=1)
        plane.observe_alert(_alert("straggler_step_time", 1, clock["now"],
                                   persists=3))
        plane.tick()
        clock["now"] += 1
        plane.tick()
        clock["now"] += 1
        plane.observe_alert(_alert("straggler_step_time", 2, clock["now"],
                                   persists=3))
        assert plane.tick() == []
        assert calls.named("evict") == [("evict", "1")]

    def test_actuation_failure_stays_proposed_and_cools_down(self):
        clock = {"now": T0}
        calls = _Calls(fail=("evict",))
        plane, calls = _make_plane(
            _FakeRing(), clock, calls=calls,
            confirm_windows={"evict_straggler": 1})
        plane.observe_alert(_alert("straggler_step_time", 5, clock["now"],
                                   persists=3))
        recs = plane.tick()
        assert [r["stage"] for r in recs] == ["proposed"]
        assert plane.status()["pending"] is None
        assert plane.action_counts()["evict_straggler"] == {"proposed": 1}
        # failure cooled the family down: no immediate hammering
        clock["now"] += 1
        plane.observe_alert(_alert("straggler_step_time", 5, clock["now"],
                                   persists=4))
        assert plane.tick() == []

    def test_unarmed_family_never_proposes(self):
        clock = {"now": T0}
        plane = remediator.Remediator(
            _FakeRing(), actions={"evict": lambda ex, a: None},
            config={"confirm_windows": {"scale_out_serving": 1}},
            clock=lambda: clock["now"])
        plane.observe_alert(_alert("latency_slo_burn", 0, clock["now"],
                                   persists=9, severity="crit"))
        assert plane.tick() == []
        assert plane.action_counts() == {}

    def test_idle_windows_scale_added_capacity_back_in(self):
        clock = {"now": T0}
        plane, calls = _make_plane(
            _FakeRing(), clock, settle_ticks=1, cooldown_secs=1.0,
            confirm_windows={"scale_out_workers": 1},
            scale_in_idle_windows=3)
        plane.observe_alert(_alert("dataservice_saturation", 0, clock["now"],
                                   persists=2))
        plane.tick()
        clock["now"] += 2
        plane.tick()                        # kept
        assert len(calls.named("spawn_worker")) == 1
        # quiet ticks accumulate; the countdown retires the added worker
        out = []
        for _ in range(6):
            clock["now"] += 2
            out.extend(plane.tick())
        assert [r["stage"] for r in out][:2] == ["proposed", "applied"]
        assert out[0]["action"] == "scale_in_workers"
        assert len(calls.named("retire_worker")) == 1


class TestJournalReplay:
    def test_round_trip_and_replay_rederives_proposals(self, tmp_path):
        clock = {"now": T0}
        jp = str(tmp_path / "journal.jsonl")
        plane, calls = _make_plane(
            _FakeRing(), clock, journal_path=jp,
            confirm_windows={"evict_straggler": 2})
        plane._journal_meta()
        for w in (1, 2):
            clock["now"] += 5
            plane.observe_alert(_alert("straggler_step_time", 2,
                                       clock["now"], persists=w))
            plane.tick()
        clock["now"] += 10
        plane.tick()                        # effect + kept
        plane.stop()
        records = remediator.read_journal(jp)
        kinds = {r["kind"] for r in records}
        assert {"meta", "alert", "action"} <= kinds
        meta = [r for r in records if r["kind"] == "meta"][0]
        assert "families" in meta            # metrics_replay's kind marker
        result = remediator.replay_journal(records)
        live = {(a["action"], str(a["executor"]))
                for a in result["journaled_actions"]
                if a["stage"] == "proposed"}
        rep = {(a["action"], str(a["executor"]))
               for a in result["actions"] if a["stage"] == "proposed"}
        assert live == rep == {("evict_straggler", "2")}
        # replay is dry by construction: nothing past proposed
        assert all(a["stage"] == "proposed" for a in result["actions"])

    def test_replay_honours_config_overrides(self, tmp_path):
        clock = {"now": T0}
        jp = str(tmp_path / "journal.jsonl")
        plane, _ = _make_plane(_FakeRing(), clock, journal_path=jp,
                               confirm_windows={"evict_straggler": 2})
        plane._journal_meta()
        clock["now"] += 5
        plane.observe_alert(_alert("straggler_step_time", 2, clock["now"],
                                   persists=1))
        plane.tick()
        plane.stop()
        records = remediator.read_journal(jp)
        # at the live threshold the lone one-window alert never confirmed
        assert remediator.replay_journal(records)["actions"] == []
        # "what if eviction confirmed after one window?"
        relaxed = remediator.replay_journal(
            records, config={"confirm_windows": {"evict_straggler": 1}})
        assert [a["action"] for a in relaxed["actions"]] == \
            ["evict_straggler"]


class TestNodeEvictCommand:
    def test_apply_knobs_intercepts_and_dedupes_evict(self, monkeypatch):
        fired = []
        monkeypatch.setattr(node_mod, "_evict_self",
                            lambda token: fired.append(token))
        monkeypatch.setattr(node_mod, "_evict_tokens", set())
        assert node_mod.apply_knobs({"remediator_evict": "tok-1"}) == 1
        # the heartbeat channel re-broadcasts: the same token must not
        # double-fire the drain
        assert node_mod.apply_knobs({"remediator_evict": "tok-1"}) == 0
        deadline = time.monotonic() + 5.0
        while len(fired) < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)                     # would catch a duplicate timer
        assert fired == ["tok-1"]

    def test_evict_command_never_fans_out_to_feeds(self, monkeypatch):
        monkeypatch.setattr(node_mod, "_evict_tokens", set())
        monkeypatch.setattr(node_mod, "_evict_self", lambda token: None)
        seen = []

        class Feed(object):
            def apply_knob(self, name, value):
                seen.append(name)
                return True

        feed = Feed()
        node_mod._register_feed(feed)
        try:
            node_mod.apply_knobs({"remediator_evict": "tok-2",
                                  "train_steps_per_call": 4})
            assert "remediator_evict" not in seen
            assert "train_steps_per_call" in seen
        finally:
            node_mod._feeds[:] = [r for r in node_mod._feeds
                                  if r() is not feed]


class TestTrainerRollbackKnob:
    def test_train_rollback_claimed_once_per_token(self):
        from tensorflowonspark_torch.train import Trainer
        tr = Trainer.__new__(Trainer)   # knob plumbing only: no device
        tr._rollback_req = None
        tr._rollback_tokens = set()
        tr._steps_per_call_req = None
        assert tr.apply_knob("train_rollback", "rb-1") is True
        assert tr._rollback_req == "rb-1"
        tr._rollback_req = None             # fit_feed consumed it
        # heartbeat re-broadcast of the same token: ack, but do not re-arm
        assert tr.apply_knob("train_rollback", "rb-1") is True
        assert tr._rollback_req is None
        assert tr.apply_knob("train_rollback", "rb-2") is True
        assert tr._rollback_req == "rb-2"


class TestObservatorySurfaces:
    def _plane_with_history(self):
        clock = {"now": T0}
        plane, _ = _make_plane(_FakeRing(), clock,
                               confirm_windows={"evict_straggler": 1})
        plane.observe_alert(_alert("straggler_step_time", 2, clock["now"],
                                   persists=2))
        plane.tick()
        return plane

    def test_metrics_text_has_remediation_family(self):
        plane = self._plane_with_history()
        text = observatory.render_prometheus(
            {"nodes": {}, "aggregate": {}},
            remediation_counts=plane.action_counts())
        assert ('tfos_remediation_actions_total{action="evict_straggler",'
                'stage="proposed"} 1') in text
        assert ('tfos_remediation_actions_total{action="evict_straggler",'
                'stage="applied"} 1') in text

    def test_remediations_endpoint_serves_status(self):
        plane = self._plane_with_history()
        obs = observatory.ObservatoryServer(lambda: {}, remediator=plane)
        code, body = obs._remediations_json("limit=5")
        assert code == 200
        payload = json.loads(body)
        assert payload["action_counts"]["evict_straggler"]["applied"] == 1
        assert len(payload["actions"]) == 2
        code, body = obs._remediations_json("limit=nope")
        assert code == 400

    def test_remediations_endpoint_503_when_absent(self):
        obs = observatory.ObservatoryServer(lambda: {})
        code, _body = obs._remediations_json("")
        assert code == 503


class TestFleetSpawnLabels:
    def test_spawn_substitutes_alert_labels_into_argv(self):
        pool = remediator._SubprocessPool(
            [sys.executable, "-c", "pass",
             "--model={model}", "--model-version={version}"], "serving")
        try:
            info = pool.spawn(subst={"model": "lin", "version": "7"})
            assert info["argv"][-2:] == ["--model=lin", "--model-version=7"]
            # no labels on the alert: placeholders stay verbatim rather
            # than KeyError-ing the spawn
            info = pool.spawn(subst={})
            assert info["argv"][-2:] == ["--model={model}",
                                         "--model-version={version}"]
        finally:
            pool.stop_all()

    def test_alert_labels_reach_spawn_actuator(self):
        clock = {"now": T0}
        ring = _FakeRing()
        got = []
        calls = _Calls()
        actions = calls.actions()
        actions["spawn_replica"] = lambda alert=None: got.append(alert)
        plane = remediator.Remediator(
            ring, actions=actions,
            config={"confirm_windows": {"scale_out_serving": 1},
                    "settle_ticks": 1},
            clock=lambda: clock["now"])
        ring.set_window("0", [
            (clock["now"] - 4, {"serving_requests": 0,
                                "serving_p99_us_max": 9000.0}),
            (clock["now"], {"serving_requests": 100,
                            "serving_p99_us_max": 9000.0})])
        alert = _alert("latency_slo_burn", 0, clock["now"], persists=2)
        alert.update(model="lin", version="2")
        plane.observe_alert(alert)
        plane.tick()
        # the version-labeled alert itself reached the actuator, so its
        # labels can steer the spawn argv at the burning model
        assert got and got[0]["model"] == "lin"
        assert got[0]["version"] == "2"
        assert remediator._alert_model_labels(got[0]) == {
            "model": "lin", "version": "2"}


# -- parity with the JAX package ----------------------------------------------

def _scripted_plane(rem_mod, ring):
    """A plane of ``rem_mod`` driven through a straggler eviction, a
    poison rollback, a saturation scale-out that regresses (reverted) and
    an alert on the evicted executor, on a fake clock; its records."""
    clock = {"now": T0}
    calls = _Calls()
    plane = rem_mod.Remediator(
        ring, actions=calls.actions(), clock=lambda: clock["now"],
        config={"settle_ticks": 2, "cooldown_secs": 10.0,
                "revert_cooldown_secs": 30.0, "window_secs": 15.0,
                "alert_ttl_secs": 300.0, "max_workers": 2,
                "confirm_windows": {"evict_straggler": 2,
                                    "scale_out_workers": 2,
                                    "rollback_poison": 1}})
    script = [
        [("straggler_step_time", 2, 1, "warn")],
        [("straggler_step_time", 2, 2, "warn")],
        [], [],
        [("nonfinite", 0, 1, "crit")],
        [], [],
        [("dataservice_saturation", 0, 3, "warn")],
        [], [], [("straggler_dispatch_gap", 2, 4, "warn")], [], [],
    ]
    for tick, alerts in enumerate(script):
        clock["now"] += 5
        ring.set_window("0", _sat_window(clock["now"],
                                         95.0 if tick < 9 else 99.0))
        for rule, executor, persists, severity in alerts:
            plane.observe_alert(_alert(rule, executor, clock["now"],
                                       persists=persists,
                                       severity=severity))
        plane.tick()
    return plane.actions(), plane.action_counts(), calls.log


def test_remediator_matches_jax_on_a_fake_ring():
    """The same fake ring, alerts and clock through the JAX package's
    ``Remediator`` and the port's give identical action records, counts
    and actuator calls."""
    from tensorflowonspark_tpu import remediator as jax_remediator

    got = _scripted_plane(remediator, _FakeRing())
    want = _scripted_plane(jax_remediator, _FakeRing())
    assert got == want
    families = {a["action"] for a in got[0]}
    assert {"evict_straggler", "rollback_poison",
            "scale_out_workers"} <= families


# -- the live loops on the CPU ------------------------------------------------

BASE_STEP_SECS = 0.01    # every node's feed: a batch every 10 ms
SLOW_SECS = 0.1          # the straggler's sleep a step: about 10x its peer
LOOP_SECS = 90.0         # generous deadlines: the driver runs files in
                         # parallel processes


def _xy(rng):
    import numpy as np

    x = rng.rand(8, 2).astype(np.float32)
    return {"x": x, "y": x @ np.asarray([3.14, 1.618], np.float32)}


def _linear_loss(params, batch, mask):
    pred = batch["x"] @ params["w"]
    err = (pred - batch["y"]) ** 2 * mask
    return err.sum() / mask.sum().clamp_min(1.0), {}


def _linear_trainer(log_steps):
    import functools

    import numpy as np
    import torch

    from tensorflowonspark_torch import train

    return train.Trainer(_linear_loss, {"w": np.zeros(2, np.float32)},
                         functools.partial(torch.optim.SGD, lr=0.05),
                         batch_size=8, log_steps=log_steps, device="cpu")


def _evict_node_fn(args, ctx):
    """Every node (and the replacement) trains its own linear model from a
    paced feed until the driver's stop file, with no collective; an
    evicted node ends in its SIGTERM drain."""
    import numpy as np

    rng = np.random.RandomState(1 + ctx.executor_id)
    stop = args["stop_file"]

    class _Feed(object):
        def batches(self):
            while not os.path.exists(stop):
                time.sleep(BASE_STEP_SECS)
                yield _xy(rng), np.ones(8, np.float32)

    _linear_trainer(log_steps=5).fit_feed(_Feed())


def _get(base, path):
    return json.loads(urllib.request.urlopen(base + path,
                                             timeout=10).read().decode())


def _wait(what, fn, secs=LOOP_SECS, every=0.2):
    deadline = time.monotonic() + secs
    while True:
        got = fn()
        if got:
            return got
        assert time.monotonic() < deadline, "waited %s s for %s" % (secs,
                                                                     what)
        time.sleep(every)


@pytest.fixture(scope="module")
def evict_run(tmp_path_factory):
    """A two-node SPARK cluster under the watchtower and the remediator;
    executor 1 straggles (``sleep_per_step_secs``); the run ends once the
    replacement steps.  Returns what the tests check."""
    from tensorflowonspark_torch import backend, cluster, fault

    tmp = str(tmp_path_factory.mktemp("evict"))
    stop_file = os.path.join(tmp, "stop")
    b = backend.LocalBackend(2, env_per_executor=[
        {}, {fault.FAULT_SPEC_ENV: json.dumps(
            {"sleep_per_step_secs": SLOW_SECS})}])
    out = {"log_dir": tmp}
    try:
        c = cluster.run(
            b, _evict_node_fn, tf_args={"stop_file": stop_file},
            num_executors=2, input_mode=cluster.InputMode.SPARK,
            heartbeat_interval=0.5, heartbeat_misses=20, log_dir=tmp,
            telemetry=True, observatory=True,
            watchtower={"interval_secs": 0.5, "window_secs": 8.0,
                        "cooldown_secs": 1.0, "journal_snapshot_secs": 1.0},
            remediator={"interval_secs": 0.25, "window_secs": 6.0,
                        "settle_ticks": 4, "cooldown_secs": 3.0,
                        "confirm_windows": {"evict_straggler": 2},
                        "max_evictions": 1, "max_rollbacks": 0,
                        "replacement_grace_secs": 60.0,
                        "alert_ttl_secs": 10.0,
                        "journal_snapshot_secs": 1.0})
        base = "http://%s:%d" % c.observatory.addr
        try:
            def closed():
                doc = _get(base, "/remediations?limit=100")
                got = {a["stage"] for a in doc.get("actions") or []
                       if a["action"] == "evict_straggler"}
                return got if {"proposed", "applied", "effect"} <= got \
                    else None

            out["stages"] = _wait("evict_straggler's loop", closed)
            out["applied"] = [a for a in _get(
                base, "/remediations?limit=100")["actions"]
                if a["action"] == "evict_straggler"
                and a["stage"] == "applied"]
            out["live_actions"] = [
                (a["seq"], a["stage"]) for a in _get(
                    base, "/remediations?limit=100")["actions"]]
            _wait("the replacement", lambda: c.tf_status.get("replacements"))
            out["replacement_steps"] = _wait(
                "the replacement's steps", lambda: (
                    c.metrics_snapshot().get("nodes") or {}).get(
                        "2", {}).get("dispatch_count", 0) >= 20 and (
                    c.metrics_snapshot()["nodes"]["2"]["dispatch_count"]))
            out["metrics"] = urllib.request.urlopen(
                base + "/metrics", timeout=10).read().decode()
        finally:
            with open(stop_file, "w") as f:
                f.write("done")
        c.shutdown(grace_secs=5)
        out["tf_status"] = dict(c.tf_status)
    finally:
        with open(stop_file, "w") as f:
            f.write("done")
        b.stop()
    return out


def test_e2e_straggler_evicted_and_replaced(evict_run):
    """Two SPARK nodes, one injected straggler about 10x its peer: the
    watchtower names executor 1 alone, ``evict_straggler`` reaches
    proposed -> applied -> effect, the node drains through its SIGTERM
    path (BYE ``preempted``, no death declared), and one replacement
    executor trains in its slot."""
    status = evict_run["tf_status"]
    assert "error" not in status, status.get("error")
    assert [str(a["executor"]) for a in evict_run["applied"]] == ["1"]
    assert evict_run["applied"][0]["detail"]["replaced"]
    assert status["replacements"] == ["executor 2 replaces 1 as worker:1"]
    assert status["byes"]["1"] == "preempted"
    assert not status.get("dead_nodes")
    assert "1" in status["suspects"]
    assert status["remediations"]["evict_straggler"]["applied"] == 1
    assert evict_run["replacement_steps"] >= 20
    assert ('tfos_remediation_actions_total{action="evict_straggler",'
            'stage="applied"} 1') in evict_run["metrics"]
    records = remediator.read_journal(os.path.join(
        evict_run["log_dir"], "watchtower", "journal.jsonl"))
    stragglers = {str(r["executor"]) for r in records
                  if r.get("kind") == "alert"
                  and r["rule"].startswith("straggler")}
    assert stragglers == {"1"}


def test_e2e_journals_replay_alike_in_both_packages(evict_run):
    """The live run's watchtower and remediator journals replay to
    identical alerts and proposals through the JAX package's
    ``replay_journal`` and the port's; the remediator journal accounts for
    every action ``/remediations`` served."""
    from tensorflowonspark_tpu import remediator as jax_remediator
    from tensorflowonspark_tpu import watchtower as jax_watchtower
    from tensorflowonspark_torch import watchtower

    wt = watchtower.read_journal(os.path.join(
        evict_run["log_dir"], "watchtower", "journal.jsonl"))
    ours, theirs = (watchtower.replay_journal(wt),
                    jax_watchtower.replay_journal(wt))
    assert ours["snapshots"] and ours["alerts"] == theirs["alerts"]
    rem = remediator.read_journal(os.path.join(
        evict_run["log_dir"], "remediator", "journal.jsonl"))
    ours, theirs = (remediator.replay_journal(rem),
                    jax_remediator.replay_journal(rem))
    assert ours["actions"] == theirs["actions"]
    assert ours["journaled_actions"] == theirs["journaled_actions"]
    journaled = {(r.get("seq"), r.get("stage")) for r in rem
                 if r.get("kind") == "action"}
    assert set(evict_run["live_actions"]) <= journaled


def _replay(path, *extra):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "metrics_replay_torch.py"), path,
         *extra], capture_output=True, text=True, timeout=120)


def test_metrics_replay_torch_rederives_the_live_streams(evict_run,
                                                         tmp_path):
    """``scripts/metrics_replay_torch.py --json`` autodetects the live
    run's watchtower and remediator journals and a port autopilot
    journal, and re-derives each live stream; a fleet canary journal
    replays through the port's ``fleet.replay_journal``."""
    proc = _replay(os.path.join(evict_run["log_dir"], "watchtower",
                                "journal.jsonl"), "--json")
    assert proc.returncode == 0, proc.stderr[-2000:]
    doc = json.loads(proc.stdout)
    live = {(a["rule"], str(a["executor"]))
            for a in doc["journaled_alerts"]}
    replayed = {(a["rule"], str(a["executor"]))
                for a in doc["replayed_alerts"]}
    assert ("straggler_step_time", "1") in live
    assert {p for p in live if p[0].startswith("straggler")} <= replayed
    assert doc["snapshots"] and doc["timeline"]

    proc = _replay(os.path.join(evict_run["log_dir"], "remediator",
                                "journal.jsonl"), "--json")
    assert proc.returncode == 0, proc.stderr[-2000:]
    doc = json.loads(proc.stdout)
    assert doc["kind"] == "remediator"
    assert doc["alerts"] > 0
    assert ("evict_straggler", "1") in {
        (a["action"], str(a["executor"])) for a in doc["replayed_actions"]}

    import test_torch_autopilot

    _, jpath = test_torch_autopilot.TestJournalRoundTrip()._run_live(
        tmp_path)
    proc = _replay(jpath, "--json")
    assert proc.returncode == 0, proc.stderr[-2000:]
    doc = json.loads(proc.stdout)
    assert doc["kind"] == "autopilot"
    assert [(a["knob"], a["to"]) for a in doc["replayed_actions"]] == [
        ("infeed_prefetch", 4)]

    from tensorflowonspark_torch import fleet
    from test_torch_fleet_parity import _canary_walk

    decisions, _, jpath, _ = _canary_walk(fleet, "port",
                                          str(tmp_path / "fleet"))
    for kind in ("auto", "fleet"):
        proc = _replay(jpath, "--json", "--kind", kind)
        assert proc.returncode == 0, proc.stderr[-2000:]
        doc = json.loads(proc.stdout)
        assert doc["kind"] == "fleet" and doc["matches"] is True
    assert [tuple(d) for d in doc["replayed_decisions"]] == decisions
    assert [tuple(d) for d in doc["journaled_decisions"]] == decisions
