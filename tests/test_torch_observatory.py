"""The port's observatory (``tensorflowonspark_torch/observatory.py``),
re-pointing ``tests/test_observatory.py``: exposition conformance,
contiguous families, the cumulative histogram, ring rates, concurrent
scrapes, a failed snapshot, the serving stage histograms with model labels,
shed reasons, SLO counters, ``tfos_up``, ``collect_slow`` and ``/slow``, on
the JAX test's own snapshots.  Beside them: the same snapshot rendered by
the JAX package's ``render_prometheus`` and the port's gives the same text
but for the ``tfos_build_info`` line; ``build_info`` and a scrape never
initialize CUDA; and the Trainer's runtime MFU gauge agrees with the
analytic FLOP count of its step within 5%."""

import functools
import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import test_observatory as ref
from tensorflowonspark_tpu import observatory as jax_observatory
from tensorflowonspark_torch import metrics as metrics_mod
from tensorflowonspark_torch import observatory, train

_parse_exposition = ref._parse_exposition
_family_of = ref._family_of
SNAPSHOT = ref.SNAPSHOT
SERVING_SNAPSHOT = ref.SERVING_SNAPSHOT


class TestPrometheusConformance:
    def test_exposition_parses_and_types_are_correct(self):
        text = observatory.render_prometheus(SNAPSHOT, scrapes=3)
        families, samples = _parse_exposition(text)
        assert families["tfos_chunks_total"] == "counter"
        assert families["tfos_events_dropped_total"] == "counter"
        assert families["tfos_depth_hwm"] == "gauge"
        assert families["tfos_dispatch_gap_us_hwm"] == "gauge"
        assert families["tfos_train_mfu_pct_max"] == "gauge"
        assert families["tfos_nodes"] == "gauge"
        assert families["tfos_scrapes_total"] == "counter"
        assert families["tfos_step_ms"] == "histogram"
        for name, mtype in families.items():
            if mtype == "counter":
                assert name.endswith("_total"), name
        assert "tfos_weird_key__total" in families
        assert "ignored_str" not in text

    def test_family_samples_are_contiguous(self):
        text = observatory.render_prometheus(SNAPSHOT, scrapes=1)
        families, samples = _parse_exposition(text)
        seen_done = set()
        current = None
        for sample_name, _ in samples:
            fam = _family_of(sample_name, families)
            assert fam in families, sample_name
            if fam != current:
                assert fam not in seen_done, "family %s interleaved" % fam
                if current is not None:
                    seen_done.add(current)
                current = fam

    def test_histogram_is_cumulative_with_inf_bucket(self):
        text = observatory.render_prometheus(SNAPSHOT)
        buckets = re.findall(
            r'tfos_step_ms_bucket\{executor="executor-0",le="([^"]+)"\} '
            r'(\d+)', text)
        assert buckets and buckets[-1][0] == "+Inf"
        counts = [int(c) for _, c in buckets]
        assert counts == sorted(counts), "buckets not cumulative"
        count = re.search(r'tfos_step_ms_count\{executor="executor-0"\} '
                          r'(\d+)', text)
        assert int(count.group(1)) == counts[-1] == 10
        assert 'tfos_step_ms_sum{executor="executor-0"} 88.0' in text

    def test_ring_rates_skip_gauges_and_clamp_resets(self):
        ring = observatory.SampleRing()
        now = time.time()
        ring.record("n0", {"chunks": 100, "depth_hwm": 9}, ts=now - 10)
        ring.record("n0", {"chunks": 40, "depth_hwm": 5}, ts=now)
        rates = ring.rates(window_secs=60.0)
        assert rates["n0"]["chunks"] == 0.0
        assert "depth_hwm" not in rates["n0"]


def _rings(records):
    """The same samples in a JAX ring and a port ring."""
    rings = jax_observatory.SampleRing(), observatory.SampleRing()
    for ring in rings:
        for node, counters, ts in records:
            ring.record(node, counters, ts=ts)
    return rings


@pytest.mark.parametrize("snapshot", [SNAPSHOT, SERVING_SNAPSHOT, {}],
                         ids=["training", "serving", "empty"])
def test_render_matches_jax_but_build_info(snapshot):
    """One snapshot, ring, scrape count, liveness and HA block rendered by
    both packages: the same exposition line for line, but for the
    ``tfos_build_info`` sample (the port reports torch, not jax)."""
    now = time.time()
    jax_ring, ring = _rings([
        ("executor-0", {"chunks": 10, "rows": 100}, now - 8),
        ("executor-0", {"chunks": 30, "rows": 400}, now - 2),
        ("replica-0", {"serving_requests": 2}, now - 4),
        ("replica-0", {"serving_requests": 9}, now - 1)])
    kwargs = {"window_secs": 60.0, "scrapes": 4,
              "beat_ages": {"executor-0": 0.3, "replica-0": 0.2},
              "coordinator": {"epoch": 2, "journal_records": 17}}
    want = jax_observatory.render_prometheus(
        snapshot, ring=jax_ring, info=jax_observatory.build_info(), **kwargs)
    got = observatory.render_prometheus(
        snapshot, ring=ring, info=observatory.build_info(), **kwargs)

    def strip(text):
        return [line for line in text.splitlines()
                if not line.startswith("tfos_build_info{")]

    assert strip(got) == strip(want)
    info_line = [line for line in got.splitlines()
                 if line.startswith("tfos_build_info{")]
    assert len(info_line) == 1 and 'torch="%s"' % torch.__version__ \
        in info_line[0]


def test_build_info_never_initializes_cuda(monkeypatch):
    """A scrape must not bring CUDA up on the driver (it forks): with
    CUDA's initialization made to raise, ``build_info`` and a ``/metrics``
    scrape still answer, name torch, and name no card."""
    def refuse(*args, **kwargs):
        raise AssertionError("CUDA initialized by a scrape")

    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    monkeypatch.setattr(torch.cuda, "init", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setattr(torch.cuda, "device_count", refuse)
    assert not torch.cuda.is_initialized()
    info = observatory.build_info()
    assert info["torch"] == torch.__version__ and "device" not in info
    srv = observatory.ObservatoryServer(lambda: SNAPSHOT, host="127.0.0.1")
    host, port = srv.start()
    try:
        text = urllib.request.urlopen(
            "http://%s:%d/metrics" % (host, port), timeout=5).read().decode()
    finally:
        srv.stop()
    _parse_exposition(text)
    assert "tfos_build_info{" in text
    assert not torch.cuda.is_initialized()


class TestScrapeDuringNodeDeath:
    def test_concurrent_scrapes_stay_consistent(self):
        full = dict(SNAPSHOT["nodes"])
        state = {"nodes": dict(full), "aggregate": {}}
        lock = threading.Lock()

        def snapshot_fn():
            with lock:
                return {"nodes": dict(state["nodes"]), "aggregate": {}}

        srv = observatory.ObservatoryServer(
            snapshot_fn, status_fn=lambda: {"state": "running"},
            host="127.0.0.1")
        host, port = srv.start()
        stop = threading.Event()

        def churn():
            flip = False
            while not stop.is_set():
                with lock:
                    state["nodes"] = ({"executor-1": full["executor-1"]}
                                      if flip else dict(full))
                flip = not flip

        churner = threading.Thread(target=churn, daemon=True)
        churner.start()
        try:
            base = "http://%s:%d" % (host, port)
            for _ in range(25):
                text = urllib.request.urlopen(
                    base + "/metrics", timeout=5).read().decode()
                _parse_exposition(text)
                n = int(re.search(r"tfos_nodes (\d+)", text).group(1))
                assert n in (1, 2)
                assert text.count("tfos_chunks_total{") == n
                status = json.loads(urllib.request.urlopen(
                    base + "/status", timeout=5).read().decode())
                assert status["tf_status"] == {"state": "running"}
                assert len(status["metrics_snapshot"]["nodes"]) in (1, 2)
        finally:
            stop.set()
            churner.join(timeout=2)
            srv.stop()
        assert not churner.is_alive()

    def test_snapshot_failure_yields_valid_exposition(self):
        def bad_snapshot():
            raise RuntimeError("node registry torn down")

        srv = observatory.ObservatoryServer(bad_snapshot, host="127.0.0.1")
        host, port = srv.start()
        try:
            text = urllib.request.urlopen(
                "http://%s:%d/metrics" % (host, port),
                timeout=5).read().decode()
        finally:
            srv.stop()
        _parse_exposition(text)
        assert "tfos_nodes 0" in text


    def test_status_while_planes_write_tf_status(self):
        """``/status`` renders the cluster's live ``tf_status`` (as
        ``cluster.run`` hands it over) while the watchtower's suspect hook
        and the roster write into it: every request is answered whole."""
        tf_status = {}
        srv = observatory.ObservatoryServer(
            lambda: SNAPSHOT, host="127.0.0.1",
            status_fn=lambda: tf_status)
        host, port = srv.start()
        stop = threading.Event()

        def write():
            n = 0
            while not stop.is_set():
                n += 1
                tf_status.setdefault("suspects", {})[str(n)] = "straggler"
                tf_status.setdefault("byes", {})[str(n)] = "preempted"
                tf_status.setdefault("replacements", []).append({"n": n})
                tf_status["key%d" % (n % 64)] = n
                if n % 500 == 0:
                    for key in ("suspects", "byes", "replacements"):
                        tf_status.pop(key, None)

        writer = threading.Thread(target=write, daemon=True)
        writer.start()
        try:
            base = "http://%s:%d" % (host, port)
            for _ in range(40):
                status = json.loads(urllib.request.urlopen(
                    base + "/status", timeout=5).read().decode())
                assert isinstance(status["tf_status"], dict)
        finally:
            stop.set()
            writer.join(timeout=2)
            srv.stop()
        assert not writer.is_alive()

    def test_a_body_that_fails_to_render_answers_500(self):
        """A status that cannot be encoded is answered 500 with the error,
        and the server goes on answering."""
        srv = observatory.ObservatoryServer(
            lambda: SNAPSHOT, host="127.0.0.1",
            status_fn=lambda: {("not", "a", "str"): 1})
        host, port = srv.start()
        try:
            base = "http://%s:%d" % (host, port)
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(base + "/status", timeout=5)
            assert err.value.code == 500
            assert "TypeError" in json.loads(err.value.read())["error"]
            text = urllib.request.urlopen(
                base + "/metrics", timeout=5).read().decode()
        finally:
            srv.stop()
        _parse_exposition(text)


def test_planes_still_to_port_answer_503():
    """``/alerts``, ``/autopilot``, ``/remediations`` and ``/fleet`` answer
    as the JAX observatory does for a plane that is not attached, and
    ``/profile`` without a coordinator says profiling is off."""
    srv = observatory.ObservatoryServer(lambda: SNAPSHOT, host="127.0.0.1")
    jax_srv = jax_observatory.ObservatoryServer(lambda: SNAPSHOT,
                                                host="127.0.0.1")
    try:
        for server in (srv, jax_srv):
            server.start()
        for path in ("/alerts", "/autopilot", "/remediations", "/fleet",
                     "/profile"):
            answers = []
            for server in (srv, jax_srv):
                with pytest.raises(urllib.error.HTTPError) as err:
                    urllib.request.urlopen("http://127.0.0.1:%d%s" % (
                        server.addr[1], path), timeout=5)
                answers.append((err.value.code, err.value.read()))
            assert answers[0] == answers[1] and answers[0][0] == 503, path
    finally:
        srv.stop()
        jax_srv.stop()


# -- the runtime MFU against the analytic FLOP count --------------------------

ROWS, WIDTH, OUT = 256, 128, 8


def _loss(params, batch, mask):
    pred = batch["x"] @ params["w"]
    err = ((pred - batch["y"]) ** 2).mean(1) * mask
    return err.sum() / mask.sum().clamp_min(1.0), {}


def test_runtime_mfu_matches_the_analytic_count_within_5pct(monkeypatch):
    """The Trainer's ``train_mfu_pct_max`` gauge, folded from its latest
    closed window, against the analytic FLOPs of the step (the matmul
    forward 2·B·D·O and the weight gradient 2·B·D·O; the input needs no
    gradient) over the same window's step time and a stated peak: within
    5%.  The CPU has no peak of its own, so the test names one."""
    peak = 1e12
    monkeypatch.setattr(metrics_mod, "peak_flops_per_device",
                        lambda device=None: peak)
    rng = np.random.RandomState(0)
    batch = {"x": rng.rand(ROWS, WIDTH).astype(np.float32),
             "y": rng.rand(ROWS, OUT).astype(np.float32)}
    mask = np.ones(ROWS, np.float32)
    tr = train.Trainer(_loss, {"w": np.zeros((WIDTH, OUT), np.float32)},
                       functools.partial(torch.optim.SGD, lr=0.01),
                       batch_size=ROWS, log_steps=5, device="cpu")
    for _ in range(3):
        tr.step(batch, mask)
    tr.reset_history()
    for _ in range(20):
        tr.step(batch, mask)
    tr._account_windows()
    snap = tr.counters_snapshot()
    analytic = 4 * ROWS * WIDTH * OUT
    assert tr.history.step_flops == pytest.approx(analytic, rel=0.05)
    (s0, t0), (s1, t1) = tr.history.timestamp_log[-2:]
    want = 100.0 * analytic / peak / ((t1 - t0) / (s1 - s0))
    assert snap["train_mfu_pct_max"] > 0
    assert snap["train_mfu_pct_max"] == pytest.approx(want, rel=0.05)
    assert snap["step_ms_count"] == s1


# -- request-plane exposition -------------------------------------------------


class TestServingExposition:
    def test_stage_histogram_with_model_version_labels(self):
        text = observatory.render_prometheus(SERVING_SNAPSHOT)
        families, _ = _parse_exposition(text)
        assert families["tfos_serving_queue_us"] == "histogram"
        assert families["tfos_serving_latency_us"] == "histogram"
        buckets = re.findall(
            r'tfos_serving_queue_us_bucket\{executor="replica-0",'
            r'model="linear",version="3",le="([^"]+)"\} (\d+)', text)
        assert buckets and buckets[-1][0] == "+Inf"
        counts = [int(c) for _, c in buckets]
        assert counts == sorted(counts) and counts[-1] == 12
        assert ('tfos_serving_queue_us_sum{executor="replica-0",'
                'model="linear",version="3"} 3100.0') in text
        assert ('tfos_serving_queue_us_count{executor="replica-0",'
                'model="linear",version="3"} 12') in text
        assert "serving_queue_us_le_50" not in families
        assert "tfos_serving_queue_us_sum_us_total" not in families

    def test_shed_reasons_become_one_labeled_family(self):
        text = observatory.render_prometheus(SERVING_SNAPSHOT)
        families, _ = _parse_exposition(text)
        assert families["tfos_serving_shed_total"] == "counter"
        for reason, val in (("overload", 1), ("deadline", 1),
                            ("shutdown", 0), ("internal", 0)):
            assert ('tfos_serving_shed_total{executor="replica-0",'
                    'reason="%s",model="linear",version="3"} %d'
                    % (reason, val)) in text
        assert re.search(
            r'tfos_serving_shed_total\{executor="replica-0"\} ', text) \
            is None

    def test_slo_counters_render(self):
        text = observatory.render_prometheus(SERVING_SNAPSHOT)
        assert 'tfos_serving_slo_good_total{executor="replica-0"} 9' in text
        assert 'tfos_serving_slo_total_total{executor="replica-0"} 12' \
            in text
        assert "serving_model" not in text

    def test_tfos_up_liveness_gauge(self):
        text = observatory.render_prometheus(
            SERVING_SNAPSHOT, beat_ages={"replica-0": 0.2})
        families, _ = _parse_exposition(text)
        assert families["tfos_up"] == "gauge"
        assert 'tfos_up{executor="replica-0"} 1' in text
        assert 'tfos_up{executor="replica-1"} 0' in text

    def test_collect_slow_flattens_and_sorts(self):
        slow = observatory.collect_slow(SERVING_SNAPSHOT)
        assert slow == jax_observatory.collect_slow(SERVING_SNAPSHOT)
        assert [r["req"] for r in slow] == ["c0-4", "c2-0", "c1-2"]
        assert [r["executor"] for r in slow] == \
            ["replica-0", "replica-1", "replica-0"]
        assert observatory.collect_slow(SERVING_SNAPSHOT, limit=1)[0][
            "req"] == "c0-4"
        assert observatory.collect_slow({}) == []


class TestSlowEndpoint:
    def test_slow_json_schema_limit_and_concurrency(self):
        srv = observatory.ObservatoryServer(
            lambda: SERVING_SNAPSHOT, host="127.0.0.1")
        host, port = srv.start()
        base = "http://%s:%d" % (host, port)
        try:
            doc = json.loads(urllib.request.urlopen(
                base + "/slow", timeout=5).read().decode())
            assert set(doc) == {"time", "count", "slow"}
            assert doc["count"] == 3
            lats = [r["latency_us"] for r in doc["slow"]]
            assert lats == sorted(lats, reverse=True)
            for key in ("req", "flow", "latency_us", "queue_us",
                        "coalesce_us", "dispatch_us", "serialize_us",
                        "rows", "batch_rows", "model", "version",
                        "executor"):
                assert key in doc["slow"][0], key
            doc = json.loads(urllib.request.urlopen(
                base + "/slow?limit=1", timeout=5).read().decode())
            assert doc["count"] == 3 and len(doc["slow"]) == 1
            assert doc["slow"][0]["req"] == "c0-4"
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(base + "/slow?limit=bogus",
                                       timeout=5)
            assert exc.value.code == 400

            errs = []

            def hammer():
                try:
                    for _ in range(10):
                        d = json.loads(urllib.request.urlopen(
                            base + "/slow", timeout=5).read().decode())
                        assert d["count"] == 3
                except Exception as e:  # pragma: no cover
                    errs.append(e)

            threads = [threading.Thread(target=hammer) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert not errs, errs
            assert not any(t.is_alive() for t in threads)
            index = urllib.request.urlopen(
                base + "/", timeout=5).read().decode()
            assert "/slow" in index
        finally:
            srv.stop()


def test_cluster_latches_serving_slow():
    """``shutdown``'s telemetry latch keeps the fleet's worst requests in
    ``tf_status["serving_slow"]``, as the JAX cluster does."""
    from tensorflowonspark_torch import cluster

    class _Server(object):
        def metrics_snapshot(self):
            return SERVING_SNAPSHOT

    c = cluster.TPUCluster(None, {}, [], cluster.InputMode.SPARK, _Server(),
                           None, {}, ("input",))
    c._latch_telemetry()
    assert c.tf_status["serving_slow"] == observatory.collect_slow(
        SERVING_SNAPSHOT)
