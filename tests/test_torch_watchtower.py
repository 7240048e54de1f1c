"""The JAX package's watchtower tests (``tests/test_watchtower.py``),
re-pointed at the port's copy of ``watchtower``: rule engine verdicts on
synthetic timeseries, reset-aware windowing across node replacement, alert
plumbing (dedup, bounded log, callbacks), journal + offline-replay parity,
the observatory alert surfaces, the port Trainer's training-health tallies
on the CPU, and the flight recorder's registered sources.  Beside them,
parity with the JAX package: the same seeded series through both
``RuleEngine.evaluate`` give identical alert lists, and a journal the
port's live watchtower wrote replays to identical alerts in both
packages' ``replay_journal``.

The JAX package is imported inside the parity tests only."""

import functools
import json
import math
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import fault
from tensorflowonspark_torch import observatory
from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch import watchtower
from tensorflowonspark_torch.train import Trainer

T0 = 1_000_000.0   # synthetic epoch: far from 0 so window math is honest


def _beats(n, dt=1.0, t0=T0, step_ms=10.0, steps_per_beat=10, start=0):
    """Cumulative per-beat counters for one node running at ``step_ms``:
    the step histogram + dispatch counters the straggler signals read."""
    out = []
    for i in range(start + 1, start + n + 1):
        steps = i * steps_per_beat
        out.append((t0 + i * dt, {
            "step_ms_count": steps,
            "step_ms_sum_us": int(steps * step_ms * 1000),
            "dispatch_count": steps,
            "dispatch_gap_us": int(steps * step_ms * 1000),
            "goodput_infeed_starved_us": int(steps * step_ms * 500),
        }))
    return out


class TestRuleEngine:
    def test_straggler_names_slow_node_only(self):
        eng = watchtower.RuleEngine()
        series = {"0": _beats(8), "1": _beats(8),
                  "2": _beats(8, step_ms=90.0)}
        alerts = eng.evaluate(series, now=T0 + 8)
        stragglers = [a for a in alerts if a["rule"].startswith("straggler_")]
        assert stragglers, alerts
        assert {a["executor"] for a in stragglers} == {"2"}
        a = next(a for a in stragglers if a["rule"] == "straggler_step_time")
        assert a["z"] >= eng.config["straggler_z"]
        assert a["severity"] == "warn"
        assert "executor 2" in a["message"]

    def test_two_node_cluster_still_separates(self):
        eng = watchtower.RuleEngine()
        series = {"0": _beats(6), "1": _beats(6, step_ms=90.0)}
        alerts = eng.evaluate(series, now=T0 + 6)
        assert any(a["rule"] == "straggler_step_time"
                   and a["executor"] == "1" for a in alerts)
        assert not any(a["rule"].startswith("straggler_")
                       and a["executor"] == "0" for a in alerts)

    def test_min_events_guard_protects_healthy_peer(self):
        """Regression: a node whose window holds one mid-compile dispatch
        (zero accrued gap) must not make the active peer the outlier."""
        eng = watchtower.RuleEngine()
        stalled = [(T0 + i, {"dispatch_count": 1, "dispatch_gap_us": 0,
                             "step_ms_count": 1, "step_ms_sum_us": 0})
                   for i in range(1, 7)]
        series = {"0": stalled, "1": _beats(6)}
        alerts = eng.evaluate(series, now=T0 + 6)
        assert not any(a["rule"].startswith("straggler_") for a in alerts), \
            alerts

    def test_idle_cluster_jitter_mints_no_alerts(self):
        """Microsecond-scale differences sit under the absolute scale
        floors; an idle/uniform cluster must stay silent."""
        eng = watchtower.RuleEngine()
        series = {"0": _beats(6, step_ms=0.010),
                  "1": _beats(6, step_ms=0.013)}
        assert eng.evaluate(series, now=T0 + 6) == []

    def test_nonfinite_fires_per_growth_not_per_tick(self):
        eng = watchtower.RuleEngine()
        base = {"step_ms_count": 10, "step_ms_sum_us": 100000}
        series = {"0": [(T0 + 1, dict(base, train_nonfinite_loss=2))]}
        first = eng.evaluate(series, now=T0 + 2)
        assert [a["rule"] for a in first] == ["nonfinite"]
        assert first[0]["severity"] == "crit"
        assert first[0]["executor"] == "0"
        assert first[0]["train_nonfinite_loss"] == 2
        # same tally again: no re-fire
        assert eng.evaluate(series, now=T0 + 3) == []
        # tally grows (another corrupt window): fires again
        series["0"].append(
            (T0 + 4, dict(base, train_nonfinite_loss=2,
                          train_nonfinite_grad=1)))
        again = eng.evaluate(series, now=T0 + 5)
        assert [a["rule"] for a in again] == ["nonfinite"]
        assert again[0]["value"] == 3

    def test_crit_sorts_before_warn_within_a_tick(self):
        eng = watchtower.RuleEngine()
        series = {"0": _beats(6), "1": _beats(6, step_ms=90.0)}
        series["1"][-1][1]["train_nonfinite_loss"] = 1
        alerts = eng.evaluate(series, now=T0 + 6)
        assert len(alerts) >= 2
        assert alerts[0]["rule"] == "nonfinite"

    def test_mfu_collapse_against_run_baseline(self):
        eng = watchtower.RuleEngine()
        series = {"0": [(T0 + 1, {"train_mfu_pct_max": 40.0})]}
        assert eng.evaluate(series, now=T0 + 2) == []   # baseline arms
        series["0"].append((T0 + 3, {"train_mfu_pct_max": 10.0}))
        alerts = eng.evaluate(series, now=T0 + 4)
        assert [a["rule"] for a in alerts] == ["mfu_collapse"]
        assert alerts[0]["baseline"] == 40.0
        # a run that never achieved real MFU cannot arm the rule
        eng2 = watchtower.RuleEngine()
        weak = {"0": [(T0 + 1, {"train_mfu_pct_max": 0.4}),
                      (T0 + 2, {"train_mfu_pct_max": 0.01})]}
        assert eng2.evaluate(weak, now=T0 + 3) == []

    def test_heartbeat_miss_prefers_real_beat_ages(self):
        eng = watchtower.RuleEngine(heartbeat_interval=1.0)
        series = {"0": [(T0 - 50, {"chunks": 1})]}   # stale SAMPLES
        # fresh real beats: the stale metrics sample alone must not fire
        assert eng.evaluate(series, now=T0, beat_ages={"0": 0.2}) == []
        alerts = eng.evaluate(series, now=T0, beat_ages={"0": 3.5})
        assert [a["rule"] for a in alerts] == ["heartbeat_miss"]
        assert alerts[0]["missed_beats"] == 3.5

    def test_heartbeat_miss_dormant_without_interval(self):
        eng = watchtower.RuleEngine()
        assert "heartbeat_miss" not in eng.active_rules()
        armed = watchtower.RuleEngine(heartbeat_interval=1.0)
        assert "heartbeat_miss" in armed.active_rules()

    def test_dataservice_saturation_gauge(self):
        eng = watchtower.RuleEngine()
        series = {"0": [(T0 + 1, {"dataservice_queue_sat_pct_max": 100.0})],
                  "1": [(T0 + 1, {"dataservice_queue_sat_pct_max": 40.0})]}
        alerts = eng.evaluate(series, now=T0 + 2)
        assert [(a["rule"], a["executor"]) for a in alerts] == \
            [("dataservice_saturation", "0")]

    def test_cache_thrash_fires_on_eviction_dominated_window(self):
        """An eviction-dominated chunk-cache window (budget smaller than
        the epoch working set) names the thrashing executor and the knob
        to turn; a hit-dominated peer stays silent."""
        eng = watchtower.RuleEngine()
        thrash = [(T0 + i, {"dataservice_cache_evictions": i * 5,
                            "dataservice_cache_hit": i,
                            "dataservice_cache_spill_bytes": i * 1000})
                  for i in range(1, 7)]
        healthy = [(T0 + i, {"dataservice_cache_evictions": 0,
                             "dataservice_cache_hit": i * 10})
                   for i in range(1, 7)]
        alerts = eng.evaluate({"0": thrash, "1": healthy}, now=T0 + 6)
        assert [(a["rule"], a["executor"]) for a in alerts] == \
            [("cache_thrash", "0")]
        a = alerts[0]
        assert a["evictions"] == 25 and a["hits"] == 5
        assert a["value"] >= eng.config["cache_thrash_evict_hit_ratio"]
        assert "cache_bytes" in a["message"]
        # spill traffic in the window rides along as evidence
        assert a["spill_bytes"] == 5000 and "5000 B spilled" in a["message"]
        # a cache-less window (no counters at all) never trips the rule
        assert eng.evaluate({"0": _beats(6)}, now=T0 + 6) == []

    def test_cache_thrash_config_overrides(self):
        """The two knobs are real config keys: a raised eviction floor
        silences the same window, and typos still fail fast."""
        eng = watchtower.RuleEngine({"cache_thrash_min_evictions": 100})
        thrash = [(T0 + i, {"dataservice_cache_evictions": i * 5,
                            "dataservice_cache_hit": i})
                  for i in range(1, 7)]
        assert eng.evaluate({"0": thrash}, now=T0 + 6) == []
        with pytest.raises(ValueError, match="cache_thrash_min_evict"):
            watchtower.RuleEngine({"cache_thrash_min_evict": 8})

    def test_unknown_config_key_raises(self):
        with pytest.raises(ValueError, match="straggler_zz"):
            watchtower.RuleEngine({"straggler_zz": 4.0})


class TestResetAwareWindow:
    """Satellite: a replacement executor re-registers with zeroed counters
    under the SAME executor id (generation bump) — rate gauges and rule
    windows must restart at the reset instead of reading garbage deltas."""

    def test_effective_window_restarts_after_generation_bump(self):
        samples = _beats(4) + _beats(3, start=0, t0=T0 + 4)  # zeros again
        win = observatory.effective_window(samples)
        assert win == samples[4:]
        d = watchtower.window_deltas(samples)
        assert d is not None
        assert d["samples"] == 3
        assert all(v >= 0 for v in d["deltas"].values()), d["deltas"]

    def test_ring_rates_across_node_replacement(self):
        import time as _time

        ring = observatory.SampleRing()
        now = _time.time()
        # generation 1: 100 chunks over 10s, then the replacement restarts
        # from zero and does 30 chunks over 3s
        ring.record("n0", {"chunks": 50}, ts=now - 13)
        ring.record("n0", {"chunks": 100}, ts=now - 4)
        ring.record("n0", {"chunks": 10}, ts=now - 3)
        ring.record("n0", {"chunks": 30}, ts=now)
        rates = ring.rates(window_secs=60.0)
        # post-reset slope, not a negative/clamped cross-generation delta
        assert rates["n0"]["chunks"] == pytest.approx(20 / 3.0, rel=0.01)

    def test_straggler_judged_on_post_reset_generation(self):
        """The replacement generation is healthy: the engine must not keep
        flagging the executor id for its previous life's slowness."""
        eng = watchtower.RuleEngine()
        replaced = _beats(4, step_ms=90.0) + _beats(6, t0=T0 + 4, start=0)
        series = {"0": _beats(10), "1": _beats(10), "2": replaced}
        alerts = eng.evaluate(series, now=T0 + 10)
        assert not any(a["rule"].startswith("straggler_") for a in alerts), \
            alerts


class TestAlertPlumbing:
    def test_deduper_cooldown_is_time_based(self):
        dd = watchtower.AlertDeduper(cooldown_secs=30.0)
        a = {"rule": "straggler_step_time", "executor": "2", "time": T0}
        assert dd.admit(a)
        assert not dd.admit(dict(a, time=T0 + 29))
        assert dd.admit(dict(a, time=T0 + 61))
        # a different executor is an independent stream
        assert dd.admit(dict(a, executor="3", time=T0 + 1))

    def _make_wt(self, ring, **cfg):
        cfg.setdefault("cooldown_secs", 0.0)
        return watchtower.Watchtower(ring=ring, config=cfg,
                                     clock=lambda: T0)

    def test_alert_log_is_bounded_counts_are_not(self):
        ring = observatory.SampleRing()
        wt = self._make_wt(ring, max_alerts=3)
        base = {"step_ms_count": 10, "step_ms_sum_us": 100000}
        for i in range(1, 7):   # 6 nonfinite alerts through 6 ticks
            ring.record("0", dict(base, train_nonfinite_loss=i),
                        ts=T0 + i)
            admitted = wt.tick(now=T0 + i)
            assert [a["rule"] for a in admitted] == ["nonfinite"]
        assert len(wt.alerts()) == 3            # deque bound
        assert wt.alert_counts() == {"nonfinite": 6}   # tally keeps truth
        assert len(wt.alerts(limit=2)) == 2
        assert wt.status()["ticks"] == 6

    def test_suspect_callback_and_map(self):
        ring = observatory.SampleRing()
        seen = []
        wt = watchtower.Watchtower(
            ring=ring, config={"cooldown_secs": 0.0},
            on_suspect=lambda ex, a: seen.append((ex, a["rule"])),
            clock=lambda: T0)
        for ts, c in _beats(6):
            ring.record("0", c, ts=ts)
        for ts, c in _beats(6, step_ms=90.0):
            ring.record("1", c, ts=ts)
        wt.tick(now=T0 + 6)
        assert ("1", "straggler_step_time") in seen
        assert wt.suspects()["1"]["rule"].startswith("straggler_")
        # nonfinite is crit but NOT a suspect-node verdict
        assert all(r in watchtower.SUSPECT_RULES for _, r in seen)

    def test_callback_failure_never_breaks_the_tick(self):
        ring = observatory.SampleRing()
        wt = watchtower.Watchtower(
            ring=ring, config={"cooldown_secs": 0.0},
            on_alert=lambda a: 1 / 0, clock=lambda: T0)
        ring.record("0", {"train_nonfinite_loss": 1}, ts=T0)
        admitted = wt.tick(now=T0 + 1)
        assert [a["rule"] for a in admitted] == ["nonfinite"]


class TestJournalReplay:
    def _run_live(self, tmp_path):
        """Scripted 2-node run: node 1 turns straggler, then reports a
        nonfinite window; returns (watchtower, journal_path)."""
        ring = observatory.SampleRing()
        latest = {}

        def snapshot_fn():
            return {"nodes": {n: dict(c) for n, c in latest.items()},
                    "aggregate": {}}

        clock = {"now": T0}
        jpath = os.path.join(str(tmp_path), "journal.jsonl")
        wt = watchtower.Watchtower(
            ring=ring, snapshot_fn=snapshot_fn,
            config={"cooldown_secs": 5.0, "journal_snapshot_secs": 1.0,
                    "interval_secs": 3600.0},
            journal_path=jpath, clock=lambda: clock["now"])
        wt.start()   # writes the meta record; the thread stays idle
        fast = _beats(12)
        slow = _beats(12, step_ms=90.0)
        for i in range(12):
            clock["now"] = T0 + i + 1
            for node, beats in (("0", fast), ("1", slow)):
                ts, c = beats[i]
                if node == "1" and i >= 8:
                    c = dict(c, train_nonfinite_loss=i - 7)
                ring.record(node, c, ts=ts)
                latest[node] = c
            wt.tick(now=clock["now"])
        wt.stop()
        return wt, jpath

    def test_replay_rederives_the_live_alert_stream(self, tmp_path):
        wt, jpath = self._run_live(tmp_path)
        live = {(a["rule"], a["executor"]) for a in wt.alerts()}
        assert ("straggler_step_time", "1") in live
        assert ("nonfinite", "1") in live

        records = watchtower.read_journal(jpath)
        kinds = [r["kind"] for r in records]
        assert kinds[0] == "meta"
        assert records[0]["version"] == watchtower.JOURNAL_VERSION
        assert "snapshot" in kinds and "alert" in kinds
        result = watchtower.replay_journal(records)
        replayed = {(a["rule"], a["executor"]) for a in result["alerts"]}
        journaled = {(a["rule"], a["executor"])
                     for a in result["journaled_alerts"]}
        assert journaled == live
        assert replayed == live
        # replay inherits the run's config from the meta record
        assert result["config"]["cooldown_secs"] == 5.0

    def test_replay_config_override_changes_verdicts(self, tmp_path):
        _, jpath = self._run_live(tmp_path)
        result = watchtower.replay_journal(
            jpath, config={"straggler_z": 1e9})
        rules = {a["rule"] for a in result["alerts"]}
        assert not any(r.startswith("straggler_") for r in rules)
        assert "nonfinite" in rules

    def test_truncated_journal_still_replays(self, tmp_path):
        _, jpath = self._run_live(tmp_path)
        with open(jpath, "a") as f:
            f.write('{"kind": "snapshot", "time": 1, "snap')   # crash cut
        records = watchtower.read_journal(jpath)
        result = watchtower.replay_journal(records)
        assert any(a["rule"] == "nonfinite" for a in result["alerts"])

    def test_json_safe_strips_nonfinite_floats(self):
        safe = watchtower.json_safe(
            {"loss": float("nan"), "vals": [1.0, float("inf")], "n": 3})
        assert safe == {"loss": None, "vals": [1.0, None], "n": 3}
        json.dumps(safe)   # strict JSON


class TestObservatorySurfaces:
    def _serve(self, wt):
        srv = observatory.ObservatoryServer(
            lambda: {"nodes": {"0": {"chunks": 1}}, "aggregate": {}},
            status_fn=lambda: {"state": "running"},
            host="127.0.0.1", watchtower=wt)
        return srv, srv.start()

    def test_alerts_endpoint_serves_log_counts_suspects(self):
        ring = observatory.SampleRing()
        wt = watchtower.Watchtower(ring=ring,
                                   config={"cooldown_secs": 0.0},
                                   clock=lambda: T0)
        for ts, c in _beats(6):
            ring.record("0", c, ts=ts)
        for ts, c in _beats(6, step_ms=90.0):
            ring.record("1", c, ts=ts)
        wt.tick(now=T0 + 6)
        srv, (host, port) = self._serve(wt)
        try:
            base = "http://%s:%d" % (host, port)
            doc = json.loads(urllib.request.urlopen(
                base + "/alerts", timeout=5).read().decode())
            assert any(a["rule"].startswith("straggler_")
                       and a["executor"] == "1" for a in doc["alerts"])
            assert doc["suspects"]["1"].startswith("straggler_")
            assert doc["alert_counts"]["straggler_step_time"] >= 1
            limited = json.loads(urllib.request.urlopen(
                base + "/alerts?limit=1", timeout=5).read().decode())
            assert len(limited["alerts"]) == 1
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + "/alerts?limit=x", timeout=5)
            assert e.value.code == 400
            status = json.loads(urllib.request.urlopen(
                base + "/status", timeout=5).read().decode())
            block = status["watchtower"]
            assert "straggler_step_time" in block["active_rules"]
            assert block["alert_counts"]["straggler_step_time"] >= 1
            assert block["suspects"]["1"].startswith("straggler_")
            text = urllib.request.urlopen(
                base + "/metrics", timeout=5).read().decode()
            assert 'tfos_alerts_total{rule="straggler_step_time"}' in text
            assert "tfos_build_info{" in text
        finally:
            srv.stop()

    def test_alerts_endpoint_503_without_watchtower(self):
        srv, (host, port) = self._serve(None)
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(
                    "http://%s:%d/alerts" % (host, port), timeout=5)
            assert e.value.code == 503
        finally:
            srv.stop()

    def test_build_info_gauge_renders_without_backend_init(self):
        info = observatory.build_info()
        assert info["version"]
        text = observatory.render_prometheus(
            {"nodes": {}, "aggregate": {}},
            alert_counts={"nonfinite": 2}, info=info)
        line = next(l for l in text.splitlines()
                    if l.startswith("tfos_build_info{"))
        assert line.endswith(" 1")
        assert 'version="%s"' % info["version"] in line
        assert 'tfos_alerts_total{rule="nonfinite"} 2' in text


def _linear_trainer(log_steps=2):
    def loss_fn(params, batch, mask):
        pred = batch["x"] @ params["w"]
        err = (pred - batch["y"]) ** 2 * mask
        return err.sum() / mask.sum().clamp_min(1.0), pred

    return Trainer(loss_fn, {"w": np.zeros(2, np.float32)},
                   functools.partial(torch.optim.SGD, lr=0.05),
                   batch_size=8, log_steps=log_steps, device="cpu")


class TestTrainerHealth:
    def test_nan_batch_raises_tallies_and_alert(self):
        """The fault injector's NaN batch must surface as nonfinite
        tallies in the heartbeat counters (through the REAL eager step)
        and fire the watchtower's crit rule."""
        tr = _linear_trainer()
        inj = fault.FaultInjector({"nan_batch_at_step": 3})
        rng = np.random.RandomState(0)
        batch = {"x": rng.rand(8, 2).astype(np.float32),
                 "y": rng.rand(8).astype(np.float32)}
        for step in range(8):
            b = inj.corrupt_batch(batch, step)
            tr.step(b)
            tr._account_windows()
        snap = tr.counters_snapshot()
        assert snap["train_nonfinite_loss"] >= 1
        assert snap["train_nonfinite_grad"] >= 1
        # gauges keep the last FINITE values next to the tallies
        assert math.isfinite(snap["train_loss_max"])
        assert math.isfinite(snap["train_grad_norm_max"])

        ring = observatory.SampleRing()
        ring.record("0", snap, ts=T0)
        wt = watchtower.Watchtower(ring=ring, clock=lambda: T0)
        admitted = wt.tick(now=T0 + 1)
        assert [(a["rule"], a["executor"], a["severity"])
                for a in admitted] == [("nonfinite", "0", "crit")]

    def test_no_health_keys_before_first_window_closes(self):
        """Zero-cost-off contract: health gauges exist only once a metrics
        window has actually synced — a single un-closed window publishes
        nothing and forces no device sync."""
        tr = _linear_trainer(log_steps=5)
        batch = {"x": np.ones((8, 2), dtype=np.float32),
                 "y": np.ones(8, dtype=np.float32)}
        tr.step(batch)
        tr._account_windows()
        snap = tr.counters_snapshot()
        assert not [k for k in snap if k.startswith("train_nonfinite")]
        assert "train_loss_max" not in snap
        assert "train_health_windows" not in snap

    def test_null_injector_contract(self):
        """Telemetry off / no spec: the hot-loop hooks must be identity
        no-ops (one attribute call, no copies, no env reads per step)."""
        assert fault.from_env(environ={}) is fault.NULL
        batch = {"x": np.ones(3)}
        assert fault.NULL.corrupt_batch(batch, 7) is batch
        assert fault.NULL.on_step(7) is None
        # a spec targeted at a specific executor resolves NULL in a
        # process with no executor identity (the driver, this test)
        env = {"TFOS_FAULT_SPEC": json.dumps(
            {"executor_id": 3, "sleep_per_step_secs": 1.0})}
        assert fault.from_env(environ=env) is fault.NULL


class TestFlightSources:
    def test_registered_source_lands_in_flight_record(self, tmp_path):
        tracer = telemetry.configure(True, str(tmp_path))
        try:
            telemetry.register_flight_source(
                "sample_ring_tail", lambda: {"0": [[T0, {"chunks": 1}]]})
            telemetry.register_flight_source(
                "broken", lambda: 1 / 0)
            path = tracer.dump(reason="test")
            assert path is not None
            with open(path) as f:
                doc = json.load(f)
            extra = doc["extra"]
            assert extra["sample_ring_tail"] == {"0": [[T0, {"chunks": 1}]]}
            # a failing source degrades to a note, never kills the dump
            assert str(extra["broken"]).startswith("unavailable:")
        finally:
            telemetry.unregister_flight_source("sample_ring_tail")
            telemetry.unregister_flight_source("broken")
            telemetry.configure(False)

    def test_ring_tail_shape_is_json_ready(self):
        ring = observatory.SampleRing()
        ring.record("0", {"loss": float("nan"), "chunks": 2}, ts=T0)
        wt = watchtower.Watchtower(ring=ring, clock=lambda: T0)
        tail = wt.ring_tail(depth=4)
        json.dumps(tail)   # NaN already stripped
        assert tail["0"][0][1] == {"loss": None, "chunks": 2}


def _slo_beats(n, per_tick=100, good_frac=0.0, dt=1.0, t0=T0, start=0):
    """Cumulative serving SLO counters: ``per_tick`` requests per beat of
    which ``good_frac`` land inside the SLO."""
    out = []
    for i in range(start + 1, start + n + 1):
        total = i * per_tick
        out.append((t0 + i * dt, {
            "serving_requests": total,
            "serving_shed": 0,
            "serving_slo_good": int(total * good_frac),
            "serving_slo_total": total,
        }))
    return out


SLO_CFG = {"slo_objective": 0.999,
           "slo_fast_windows_secs": (4.0, 8.0),
           "slo_slow_windows_secs": (6.0, 12.0),
           "slo_min_requests": 10}


class TestSloBudgetBurn:
    def _drive(self, eng, series_by_node, ticks, dt=1.0):
        """Feed growing prefixes tick by tick (engine history needs the
        time axis); returns every slo alert minted along the way."""
        out = []
        for i in range(1, ticks + 1):
            window = {n: s[:i] for n, s in series_by_node.items()}
            out.extend(a for a in eng.evaluate(window, now=T0 + i * dt)
                       if a["rule"] == "slo_budget_burn")
        return out

    def test_total_burn_pages_crit(self):
        eng = watchtower.RuleEngine(SLO_CFG)
        alerts = self._drive(eng, {"r0": _slo_beats(14, good_frac=0.0),
                                   "r1": _slo_beats(14, good_frac=1.0)},
                             ticks=14)
        assert alerts, "100% err rate never paged"
        assert {a["executor"] for a in alerts} == {"r0"}
        a = alerts[-1]
        # err rate 1.0 over a 0.1% budget: 1000x burn in BOTH fast windows
        assert a["severity"] == "crit" and a["kind"] == "page"
        assert a["value"] == pytest.approx(1000.0, rel=0.01)
        assert a["threshold"] == watchtower.DEFAULT_CONFIG["slo_burn_fast"]
        assert a["evidence"]["windows"]["4s"]["err_rate"] == 1.0
        assert "page" in a["message"]

    def test_slow_leak_tickets_warn(self):
        # 1% err rate = 10x burn: over slo_burn_slow (6) but under
        # slo_burn_fast (14.4) — a ticket, never a page
        eng = watchtower.RuleEngine(SLO_CFG)
        alerts = self._drive(
            eng, {"r0": _slo_beats(14, per_tick=1000, good_frac=0.99)},
            ticks=14)
        assert alerts, "10x slow burn never ticketed"
        a = alerts[-1]
        assert a["severity"] == "warn" and a["kind"] == "ticket"
        assert a["value"] == pytest.approx(10.0, rel=0.01)
        assert a["threshold"] == watchtower.DEFAULT_CONFIG["slo_burn_slow"]

    def test_disarmed_by_default(self):
        # slo_objective defaults to 0: no objective, no budget, no rule
        eng = watchtower.RuleEngine()
        alerts = self._drive(eng, {"r0": _slo_beats(14, good_frac=0.0)},
                             ticks=14)
        assert alerts == []

    def test_min_requests_abstains(self):
        # 3 requests/tick never clears slo_min_requests=10 inside the 4s
        # fast window pair before the run ends: abstain, never vote
        eng = watchtower.RuleEngine(SLO_CFG)
        alerts = self._drive(
            eng, {"r0": _slo_beats(3, per_tick=3, good_frac=0.0)}, ticks=3)
        assert alerts == []

    def test_restart_reset_clears_history(self):
        eng = watchtower.RuleEngine(SLO_CFG)
        bad = _slo_beats(14, good_frac=0.0)
        assert self._drive(eng, {"r0": bad}, ticks=14)
        # the replica restarts: cumulative counters drop to near zero
        restarted = _slo_beats(1, per_tick=5, good_frac=1.0,
                               t0=T0 + 14.0)
        post = [a for a in eng.evaluate({"r0": restarted}, now=T0 + 15.0)
                if a["rule"] == "slo_budget_burn"]
        assert post == []          # pre-restart badness must not carry over
        assert len(eng._slo_history["r0"]) == 1

    def test_replay_rederives_slo_verdicts(self, tmp_path):
        ring = observatory.SampleRing()
        latest = {}

        def snapshot_fn():
            return {"nodes": {n: dict(c) for n, c in latest.items()},
                    "aggregate": {}}

        clock = {"now": T0}
        jpath = os.path.join(str(tmp_path), "slo_journal.jsonl")
        wt = watchtower.Watchtower(
            ring=ring, snapshot_fn=snapshot_fn,
            config=dict(SLO_CFG, cooldown_secs=5.0,
                        journal_snapshot_secs=1.0, interval_secs=3600.0,
                        slo_min_requests=5),
            journal_path=jpath, clock=lambda: clock["now"])
        wt.start()
        burning = _slo_beats(12, good_frac=0.0)
        healthy = _slo_beats(12, good_frac=1.0)
        for i in range(12):
            clock["now"] = T0 + i + 1
            for node, beats in (("r0", burning), ("r1", healthy)):
                ts, c = beats[i]
                ring.record(node, c, ts=ts)
                latest[node] = c
            wt.tick(now=clock["now"])
        wt.stop()
        live = {(a["rule"], a["executor"]) for a in wt.alerts()
                if a["rule"] == "slo_budget_burn"}
        assert live == {("slo_budget_burn", "r0")}

        result = watchtower.replay_journal(watchtower.read_journal(jpath))
        journaled = {(a["rule"], a["executor"])
                     for a in result["journaled_alerts"]
                     if a["rule"] == "slo_budget_burn"}
        replayed = {(a["rule"], a["executor"]) for a in result["alerts"]
                    if a["rule"] == "slo_budget_burn"}
        assert journaled == live
        assert replayed == live


# -- parity with the JAX package ----------------------------------------------

def _seeded_series(seed, nodes=4, ticks=24):
    """Cumulative per-beat counters of ``nodes`` nodes from one numpy
    seed: jittered step times (node 1 turns straggler half-way), dispatch
    gaps and starved time, a nonfinite tally that grows on node 2, an MFU
    gauge that collapses on node 3, and serving SLO counters on node 0."""
    rng = np.random.default_rng(seed)
    series = {}
    for n in range(nodes):
        out, steps, sum_us, gap_us, starved = [], 0, 0, 0, 0
        good = total = nonfinite = 0
        for i in range(1, ticks + 1):
            k = int(rng.integers(5, 15))
            ms = float(rng.lognormal(np.log(10.0), 0.1))
            if n == 1 and i > ticks // 2:
                ms *= 8.0
            steps += k
            sum_us += int(k * ms * 1000)
            gap_us += int(k * ms * 1000 * rng.uniform(0.05, 0.2))
            starved += int(k * ms * 1000 * rng.uniform(0.0, 0.1))
            c = {"step_ms_count": steps, "step_ms_sum_us": sum_us,
                 "dispatch_count": steps, "dispatch_gap_us": gap_us,
                 "train_steps_total": steps,
                 "goodput_infeed_starved_us": starved,
                 "train_mfu_pct_max": float(
                     40.0 * (0.2 if n == 3 and i > 18 else 1.0)
                     * rng.uniform(0.95, 1.05))}
            if n == 2 and i > 15 and rng.random() < 0.5:
                nonfinite += 1
            if nonfinite:
                c["train_nonfinite_loss"] = nonfinite
            if n == 0:
                total += 100
                good += int(100 * rng.uniform(0.5, 1.0))
                c.update(serving_slo_total=total, serving_slo_good=good)
            out.append((T0 + i + float(rng.uniform(0, 0.2)), c))
        series[str(n)] = out
    return series


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rule_engine_matches_jax_on_a_seeded_series(seed):
    """The same seeded numpy series through the JAX package's
    ``RuleEngine.evaluate`` and the port's, tick by tick, gives identical
    alert lists (each engine keeps its own run state)."""
    from tensorflowonspark_tpu import watchtower as jax_watchtower

    config = dict(SLO_CFG, window_secs=6.0, slo_min_requests=5)
    series = _seeded_series(seed)
    ours = watchtower.RuleEngine(config, heartbeat_interval=1.0)
    theirs = jax_watchtower.RuleEngine(config, heartbeat_interval=1.0)
    fired = 0
    for tick in range(1, 25):
        now = T0 + tick + 0.5
        window = {n: [(ts, c) for ts, c in s if ts <= now]
                  for n, s in series.items()}
        got = ours.evaluate(window, now=now)
        want = theirs.evaluate(window, now=now)
        assert got == want, tick
        fired += len(got)
    assert fired


def test_port_journal_replays_alike_in_both_packages(tmp_path):
    """A journal the port's live watchtower wrote (the scripted straggler
    and nonfinite run) replays to identical alerts through the JAX
    package's ``replay_journal`` and the port's, and both re-derive the
    live stream."""
    from tensorflowonspark_tpu import watchtower as jax_watchtower

    wt, jpath = TestJournalReplay()._run_live(tmp_path)
    ours = watchtower.replay_journal(jpath)
    theirs = jax_watchtower.replay_journal(jax_watchtower.read_journal(
        jpath))
    assert ours["alerts"] == theirs["alerts"]
    assert ours["journaled_alerts"] == theirs["journaled_alerts"]
    live = {(a["rule"], a["executor"]) for a in wt.alerts()}
    assert {(a["rule"], a["executor"]) for a in ours["alerts"]} == live
