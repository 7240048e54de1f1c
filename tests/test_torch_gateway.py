"""The port's serving gateway: ``tests/test_gateway.py`` re-pointed to the
port (its transport cases are in ``tests/test_torch_transport.py``; the
data service's framing case is here), a JAX gateway and a port gateway held to each other on the same converted export and request
sequence, a tiny flash LM served through the port's gateway against the
JAX server, and a live weight swap under concurrent clients."""

import glob
import json
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import checkpoint as jax_checkpoint
from tensorflowonspark_tpu import gateway as jax_gateway
from tensorflowonspark_tpu import serving as jax_serving
from tensorflowonspark_tpu.models import get_model as jax_get_model
from tensorflowonspark_torch import (checkpoint, convert, gateway, serving,
                                     telemetry)
from tensorflowonspark_torch.gateway import (GatewayChannel, GatewayServer,
                                             OverloadError, ServingClient)

# fp32 linear model, sums of two products: 1e-6
TOL = 1e-6
# fp32 LM, matmul summation order differs (tests/test_torch_serving.py)
LOGIT_TOL = 1e-4


def _linear(kernel, bias=0.0):
    return {"dense": {"kernel": np.asarray(kernel, np.float32),
                      "bias": np.full((1,), bias, np.float32)}}


def _port_export(path, kernel):
    path = str(path)
    checkpoint.export_model(path, convert.linear_params_from_flax(
        _linear(kernel)), "linear", model_config={"features": 1},
        input_signature={"x": [None, 2]})
    return path


def _server(export_dir, batch_size):
    return serving.ModelServer(export_dir, batch_size=batch_size,
                               device="cpu")


# ---------------------------------------------------------------------------
# bucket ladder
# ---------------------------------------------------------------------------

def test_bucket_ladder_powers_of_two():
    assert serving.bucket_ladder(128) == (1, 2, 4, 8, 16, 32, 64, 128)
    assert serving.bucket_ladder(1) == (1,)
    assert serving.bucket_ladder(6) == (1, 2, 4, 6)
    with pytest.raises(ValueError):
        serving.bucket_ladder(0)


def test_bucket_for_rounds_up():
    ladder = serving.bucket_ladder(16)
    assert serving.bucket_for(1, ladder) == 1
    assert serving.bucket_for(3, ladder) == 4
    assert serving.bucket_for(16, ladder) == 16
    assert serving.bucket_for(33, ladder) == 33


@pytest.fixture(scope="module")
def linear_export(tmp_path_factory):
    """y = 2*x0 + 3*x1, the port's export."""
    return _port_export(tmp_path_factory.mktemp("gw") / "export",
                        [[2.0], [3.0]])


def test_predict_feed_pads_remainder_to_bucket(linear_export):
    server = _server(linear_export, 8)
    shapes = []
    real = server._apply

    def spy(inputs):
        shapes.append(inputs["x"].shape[0])
        return real(inputs)

    server._apply = spy
    feed = {"x": np.asarray([[1.0, 1.0], [2.0, 0.0], [0.0, 1.0]],
                            np.float32)}
    out = server.predict_feed(feed, 3)
    assert shapes == [4]
    np.testing.assert_allclose(out["output"][:, 0], [5.0, 4.0, 3.0],
                               rtol=1e-5)
    server.predict_feed({"x": np.zeros((4, 2), np.float32)}, 4)
    assert shapes == [4, 4]
    assert server.compile_count == 1


def test_warmup_compiles_every_bucket_once(linear_export):
    server = _server(linear_export, 8)
    assert server.warmup() == 4
    assert server.compile_count == 4
    for count in (1, 2, 3, 5, 8):
        server.predict_feed({"x": np.zeros((count, 2), np.float32)}, count)
    assert server.compile_count == 4


# ---------------------------------------------------------------------------
# continuous batcher edge cases
# ---------------------------------------------------------------------------

@pytest.fixture
def gw(linear_export):
    g = GatewayServer(_server(linear_export, 8), max_wait_ms=3.0)
    g.start()
    yield g
    g.stop()


def test_empty_flush_on_deadline(gw):
    time.sleep(0.05)
    assert gw.batches_total == 0
    assert gw.requests_total == 0


def test_single_request_under_light_load(gw):
    out = gw.submit({"x": np.asarray([[1.0, 1.0]], np.float32)}, 1)
    assert abs(float(out["output"][0][0]) - 5.0) < 1e-5
    assert gw.batches_total == 1 and gw.rows_total == 1
    m = gw.heartbeat_metrics()
    assert m["serving_p99_us_max"] > 0
    assert m["serving_batch_fill_pct_max"] == 100.0


def test_dtype_coercion_through_bucketizer(gw):
    ch = GatewayChannel((gw.host, gw.port))
    try:
        compiles_before = gw.server.compile_count
        out = ch.predict({"x": np.asarray([[1, 1], [2, 0]], np.int64)}, 2)
        np.testing.assert_allclose(out["output"][:, 0], [5.0, 4.0],
                                   rtol=1e-5)
        out = ch.predict({"x": np.asarray([[1.0, 1.0]], np.float64)}, 1)
        assert abs(float(out["output"][0][0]) - 5.0) < 1e-5
        assert gw.server.compile_count == compiles_before
    finally:
        ch.close()


def test_expired_deadline_shed_before_dispatch(gw):
    before = gw.batches_total
    with pytest.raises(OverloadError) as exc:
        gw.submit({"x": np.zeros((1, 2), np.float32)}, 1, deadline_ms=-1.0)
    assert exc.value.code == "deadline"
    assert gw.heartbeat_metrics()["serving_shed"] == 1
    assert gw.batches_total == before


def test_queue_full_sheds_with_overload(linear_export):
    g = GatewayServer(_server(linear_export, 8), max_wait_ms=1.0,
                      max_queue=2)
    for _ in range(2):
        g._enqueue({"x": np.zeros((1, 2), np.float32)}, 1, None,
                   lambda out: None, lambda code, msg: None)
    errs = []
    g._enqueue({"x": np.zeros((1, 2), np.float32)}, 1, None,
               lambda out: None, lambda code, msg: errs.append(code))
    assert errs == ["overload"]
    assert g.shed_total == 1


def test_batch_coalescing_under_concurrent_load(gw):
    outs = {}

    def hit(i):
        outs[i] = gw.submit(
            {"x": np.asarray([[float(i), 1.0]], np.float32)}, 1)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(outs) == 16
    for i, out in outs.items():
        assert abs(float(out["output"][0][0]) - (2.0 * i + 3.0)) < 1e-4
    assert gw.requests_total == 16
    assert gw.batches_total <= 16


def test_dataservice_framing_is_the_shared_transport():
    # the port's data service streams on the exact same framing objects as
    # its gateway (one protocol, not a drifted copy)
    from tensorflowonspark_torch import dataservice, transport

    assert dataservice._DHEADER is transport.DHEADER
    assert dataservice._recv_frame is transport.recv_frame
    assert dataservice._send_frame is transport.send_frame
    assert dataservice._K_COLV1 == transport.K_COLV1


# ---------------------------------------------------------------------------
# HA client failover
# ---------------------------------------------------------------------------

def test_serving_client_retries_on_survivor(linear_export):
    gws = [GatewayServer(_server(linear_export, 4), max_wait_ms=1.0)
           for _ in range(2)]
    addrs = ["{}:{}".format(*g.start()) for g in gws]
    try:
        client = ServingClient(replicas=addrs)
        feed = {"x": np.asarray([[2.0, 0.0]], np.float32)}
        assert abs(float(client.predict(feed, 1)["output"][0][0])
                   - 4.0) < 1e-5
        gws[0].stop()
        for _ in range(2):
            assert abs(float(client.predict(feed, 1)["output"][0][0])
                       - 4.0) < 1e-5
        assert client.failovers >= 1
        client.close()
    finally:
        for g in gws:
            g.stop()


def test_overload_is_not_retried_on_siblings(linear_export):
    g = GatewayServer(_server(linear_export, 4), max_wait_ms=1.0)
    addr = "{}:{}".format(*g.start())
    try:
        client = ServingClient(replicas=[addr, addr])
        with pytest.raises(OverloadError) as exc:
            client.predict({"x": np.zeros((1, 2), np.float32)}, 1,
                           deadline_ms=-1.0)
        assert exc.value.code == "deadline"
        assert client.failovers == 0
        client.close()
    finally:
        g.stop()


def test_serving_client_round_robin_balances_picks(linear_export):
    gws = [GatewayServer(_server(linear_export, 4), max_wait_ms=1.0)
           for _ in range(2)]
    addrs = ["{}:{}".format(*g.start()) for g in gws]
    try:
        client = ServingClient(replicas=addrs)
        feed = {"x": np.asarray([[1.0, 1.0]], np.float32)}
        for _ in range(8):
            client.predict(feed, 1)
        assert sorted(client.picks.values()) == [4, 4]
        assert set(client.picks) == set(addrs)
        assert gws[0].requests_total == gws[1].requests_total == 4
        client.close()
    finally:
        for g in gws:
            g.stop()


# ---------------------------------------------------------------------------
# request-plane observability
# ---------------------------------------------------------------------------

def test_stage_histograms_decompose_e2e(gw):
    for i in range(6):
        gw.submit({"x": np.asarray([[float(i), 1.0]], np.float32)}, 1)
    m = gw.heartbeat_metrics()
    stages = ("serving_queue_us", "serving_coalesce_us",
              "serving_dispatch_us", "serving_serialize_us")
    total = sum(m[s + "_sum_us"] for s in stages)
    e2e = m["serving_latency_us_sum_us"]
    assert abs(total - e2e) <= 4 * m["serving_latency_us_count"]
    for s in stages + ("serving_latency_us",):
        assert m[s + "_count"] == 6
        cum = [v for k, v in sorted(
            ((k, v) for k, v in m.items()
             if k.startswith(s + "_le_")),
            key=lambda kv: float(kv[0].rsplit("_", 1)[1]))]
        assert cum == sorted(cum)
        assert not cum or cum[-1] <= m[s + "_count"]


def test_shed_reasons_split_and_burn_budget(gw):
    with pytest.raises(OverloadError):
        gw.submit({"x": np.zeros((1, 2), np.float32)}, 1, deadline_ms=-1.0)
    m = gw.heartbeat_metrics()
    assert m["serving_shed"] == 1
    assert m["serving_shed_deadline"] == 1
    assert m["serving_shed_overload"] == 0
    assert m["serving_slo_total"] == 1
    assert m["serving_slo_good"] == 0


def test_shutdown_shed_reason(linear_export):
    g = GatewayServer(_server(linear_export, 4), max_wait_ms=1.0)
    codes = []
    for _ in range(3):
        g._enqueue({"x": np.zeros((1, 2), np.float32)}, 1, None,
                   lambda out: None, lambda code, msg: codes.append(code))
    g.stop()
    assert codes == ["shutdown"] * 3
    m = g.heartbeat_metrics()
    assert m["serving_shed_shutdown"] == 3 and m["serving_shed"] == 3


def test_overload_shed_reason(linear_export):
    g = GatewayServer(_server(linear_export, 4), max_wait_ms=1.0,
                      max_queue=1)
    g._enqueue({"x": np.zeros((1, 2), np.float32)}, 1, None,
               lambda out: None, lambda code, msg: None)
    errs = []
    g._enqueue({"x": np.zeros((1, 2), np.float32)}, 1, None,
               lambda out: None, lambda code, msg: errs.append(code))
    assert errs == ["overload"]
    assert g.heartbeat_metrics()["serving_shed_overload"] == 1


def test_slo_classification_against_threshold(linear_export):
    server = _server(linear_export, 4)
    for slo, good in ((60e6, 1), (0.001, 0)):
        g = GatewayServer(server, max_wait_ms=1.0, slo_latency_us=slo)
        g.start()
        try:
            g.submit({"x": np.zeros((1, 2), np.float32)}, 1)
            m = g.heartbeat_metrics()
            assert (m["serving_slo_good"], m["serving_slo_total"]) == \
                (good, 1)
        finally:
            g.stop()


def test_slow_ring_bounded_and_sorted(gw):
    for i in range(40):
        gw.submit({"x": np.asarray([[float(i), 1.0]], np.float32)}, 1)
    recs = gw.slow_requests()
    assert 0 < len(recs) <= 32
    lats = [r["latency_us"] for r in recs]
    assert lats == sorted(lats, reverse=True)
    for key in ("req", "flow", "time", "latency_us", "queue_us",
                "coalesce_us", "dispatch_us", "serialize_us", "rows",
                "batch_rows", "model", "version"):
        assert key in recs[0]
    assert recs[0]["req"].startswith(gw.replica_id)
    beat = gw.heartbeat_metrics()["serving_slow"]
    assert len(beat) <= 8
    assert [r["latency_us"] for r in beat] == lats[:len(beat)]
    assert gw.slow_requests(limit=3) == recs[:3]


def test_request_flow_is_one_cross_stage_track(gw, tmp_path):
    telemetry.configure(True, str(tmp_path))
    try:
        ch = GatewayChannel((gw.host, gw.port))
        try:
            ch.predict({"x": np.asarray([[1.0, 1.0]], np.float32)}, 1)
        finally:
            ch.close()
        deadline = time.monotonic() + 5.0
        while True:
            telemetry.get_tracer().flush()
            events = []
            for path in glob.glob(str(tmp_path / "trace-*.json")):
                with open(path) as f:
                    events.extend(json.load(f)["traceEvents"])
            done_stages = {e["args"].get("stage") for e in events
                           if e.get("cat") == "tfos_flow"
                           and e.get("ph") == "t"}
            if "serialize" in done_stages or time.monotonic() > deadline:
                break
            time.sleep(0.02)
    finally:
        telemetry.configure(False)
    flow = [e for e in events if e.get("cat") == "tfos_flow"
            and e.get("name") == "serving/request_flow"]
    assert flow, "no request-flow events emitted"
    assert len({e["id"] for e in flow}) == 1
    assert {e["ph"] for e in flow} == {"s", "t", "f"}
    stages = {e["args"].get("stage") for e in flow if e["ph"] == "t"}
    assert {"admit", "dispatch", "serialize"} <= stages


# ---------------------------------------------------------------------------
# the port's gateway against the JAX package's
# ---------------------------------------------------------------------------

_COUNTERS = ("serving_requests", "serving_rows", "serving_batches",
             "serving_shed", "serving_compiles") + tuple(
    "serving_shed_" + r for r in jax_gateway.SHED_REASONS)


def test_gateway_matches_jax_on_one_client_sequence(tmp_path):
    """A JAX gateway and a port gateway serve the same converted export;
    one client sends the same requests (a shed among them) to each."""
    params = _linear([[2.0], [-3.0]], bias=0.25)
    jax_dir = str(tmp_path / "jax")
    jax_checkpoint.export_model(jax_dir, params, "linear",
                                model_config={"features": 1},
                                input_signature={"x": [None, 2]})
    loaded, desc = jax_checkpoint.load_model(jax_dir)
    torch_dir = str(tmp_path / "torch")
    checkpoint.export_model(torch_dir, convert.linear_params_from_flax(
        jax.tree_util.tree_map(np.asarray, loaded)), desc["model_name"],
        model_config=desc["model_config"],
        input_signature=desc["input_signature"])
    rng = np.random.default_rng(11)
    sequence = [(n, None) for n in (1, 3, 8, 2, 5)] + [(2, -1.0), (4, None)]
    feeds = [rng.standard_normal((n, 2)).astype(np.float32)
             for n, _ in sequence]
    results = {}
    for side, gw_mod, srv in (
            ("jax", jax_gateway,
             jax_serving.ModelServer(jax_dir, batch_size=8)),
            ("port", gateway, _server(torch_dir, 8))):
        g = gw_mod.GatewayServer(srv, max_wait_ms=1.0)
        g.start()
        replies = []
        try:
            ch = gw_mod.GatewayChannel((g.host, g.port))
            try:
                for (n, deadline), x in zip(sequence, feeds):
                    try:
                        replies.append(ch.predict({"x": x}, n,
                                                  deadline_ms=deadline))
                    except gw_mod.OverloadError as e:
                        replies.append(e.code)
            finally:
                ch.close()
            metrics = g.heartbeat_metrics()
        finally:
            g.stop()
        results[side] = (replies, {k: metrics[k] for k in _COUNTERS})
    (got, got_m), (want, want_m) = results["port"], results["jax"]
    assert got_m == want_m
    assert want_m["serving_requests"] == 6 and want_m["serving_shed"] == 1
    assert len(got) == len(want) == len(sequence)
    for g_out, w_out in zip(got, want):
        if isinstance(w_out, str):
            assert g_out == w_out == "deadline"
            continue
        assert sorted(g_out) == sorted(w_out) == ["output"]
        np.testing.assert_allclose(g_out["output"], w_out["output"],
                                   rtol=0, atol=TOL)


CFG = {"vocab_size": 64, "num_layers": 2, "num_heads": 2, "head_dim": 16,
       "max_seq_len": 32, "attention": "flash", "dtype": "float32"}


def test_tiny_flash_lm_through_the_gateway_matches_jax(tmp_path):
    model = jax_get_model("transformer_lm", **CFG)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 32), jnp.int32))["params"]
    jax_dir, torch_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    signature = {"tokens": {"shape": [None, 32], "dtype": "int32"}}
    jax_checkpoint.export_model(jax_dir, jax.device_get(params),
                                "transformer_lm", model_config=CFG,
                                input_signature=signature)
    loaded, desc = jax_checkpoint.load_model(jax_dir)
    checkpoint.export_model(torch_dir, convert.transformer_params_from_flax(
        jax.tree_util.tree_map(np.asarray, loaded)), desc["model_name"],
        model_config=desc["model_config"],
        input_signature=desc["input_signature"])
    jax_server = jax_serving.ModelServer(jax_dir, batch_size=4)
    g = GatewayServer(_server(torch_dir, 4), max_wait_ms=20.0)
    g.start()
    rng = np.random.default_rng(4)
    requests = [rng.integers(0, 64, (n, 32), dtype=np.int32)
                for n in (1, 2, 3, 1)]
    replies = [None] * len(requests)

    def send(i):
        ch = GatewayChannel((g.host, g.port))
        try:
            replies[i] = ch.predict({"tokens": requests[i]},
                                    len(requests[i]))
        finally:
            ch.close()

    try:
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert g.requests_total == 4 and g.rows_total == 7
        assert g.server.compile_count == 3   # warm rungs only
    finally:
        g.stop()
    for tokens, reply in zip(requests, replies):
        want = np.asarray(jax_server.predict_feed(
            {"tokens": tokens}, len(tokens))["output"])
        got = reply["output"]
        assert got.shape == want.shape == (len(tokens), 32, 64)
        assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


def test_knob_swap_under_concurrent_clients(tmp_path):
    """The ``serving_load_version`` knob swaps v1 -> v2 while 4 clients keep
    predicting: every accepted reply comes from exactly one version, none
    is lost, later replies are v2's, and ``compile_count`` stays flat."""
    e1 = _port_export(tmp_path / "v1", [[2.0], [3.0]])   # y = 2a + 3b
    e2 = _port_export(tmp_path / "v2", [[4.0], [5.0]])   # y = 4a + 5b
    g = GatewayServer(_server(e1, 8), max_wait_ms=1.0, model_version="1",
                      replica_id="r0")
    g.start()
    compiles = g.server.compile_count
    stop = threading.Event()
    errors, answers = [], []
    lock = threading.Lock()

    def client_loop(seed):
        rng = np.random.default_rng(seed)
        ch = GatewayChannel((g.host, g.port))
        try:
            while not stop.is_set():
                a, b = rng.random(2)
                feed = {"x": np.asarray([[a, b]], np.float32)}
                sent = time.monotonic()
                got = float(ch.predict(feed, 1)["output"][0][0])
                with lock:
                    answers.append((sent, a, b, got))
        except Exception as e:
            with lock:
                errors.append(e)
        finally:
            ch.close()

    threads = [threading.Thread(target=client_loop, args=(i,))
               for i in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        g._on_beat_reply({"knobs": {"serving_load_version": {
            "model": "linear", "version": "2", "export_dir": e2,
            "token": "r0-2"}}})
        deadline = time.monotonic() + 10
        while g.model_version != "2" and time.monotonic() < deadline:
            time.sleep(0.01)
        swapped_at = time.monotonic()
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join()
    finally:
        g.stop()
    assert not errors, errors
    assert g.model_version == "2" and g.swaps_total == 1
    assert g.swap_failed_total == 0
    assert g.server.compile_count == compiles
    assert g.heartbeat_metrics()["serving_requests"] == len(answers)
    versions = []
    for t, a, b, got in answers:
        v1, v2 = 2 * a + 3 * b, 4 * a + 5 * b
        match = [abs(got - v1) < 1e-4, abs(got - v2) < 1e-4]
        assert sum(match) == 1, (a, b, got)
        versions.append(2 if match[1] else 1)
        if t > swapped_at:
            assert match[1], "a request sent after the swap got v1's answer"
    assert 1 in versions and 2 in versions
