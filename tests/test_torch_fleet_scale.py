"""The remediator's ``scale_out_serving`` spawns a fleet replica: a
``serving_spawn_argv`` of ``python -m tensorflowonspark_torch.inference_cli
--serve --registry R --model={model} ...``, its ``{model}`` filled in from
the burning alert's labels, boots a replica that resolves the model's live
version through the registry, joins the reservation roster, appears in
``FleetRouter.sync_roster`` under that model and version, and answers
through a ``FleetClient``."""

import os
import sys
import time

import numpy as np

from tensorflowonspark_torch import checkpoint, convert, fleet, \
    remediator, reservation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_000_000.0


class _Ring(object):
    def __init__(self, series):
        self._series = series

    def series(self):
        return {n: list(s) for n, s in self._series.items()}


def test_scale_out_serving_spawns_a_registry_replica(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    registry = fleet.ModelRegistry(tmp_path / "registry", publisher="test")
    export = str(tmp_path / "lin1")
    checkpoint.export_model(
        export, convert.linear_params_from_flax(
            {"dense": {"kernel": np.asarray([[2.0], [3.0]], np.float32),
                       "bias": np.zeros((1,), np.float32)}}),
        "lin", model_config={"architecture": "linear", "features": 1},
        input_signature={"x": [None, 2]})
    registry.publish("lin", "1", export, status="live")
    resv = reservation.Server(1, heartbeat_interval=0.25)
    host, port = resv.start()
    clock = {"now": T0}
    ring = _Ring({"0": [
        (T0 - 4, {"serving_requests": 0, "serving_p99_us_max": 9000.0}),
        (T0, {"serving_requests": 100, "serving_p99_us_max": 9000.0})]})
    plane = remediator.Remediator(
        ring, clock=lambda: clock["now"],
        config={"confirm_windows": {"scale_out_serving": 1},
                "settle_ticks": 1,
                "serving_spawn_argv": [
                    sys.executable, "-m",
                    "tensorflowonspark_torch.inference_cli", "--serve",
                    "--registry", registry.root, "--model={model}",
                    "--device", "cpu", "--port", "0", "--max-batch", "4",
                    "--roster", "%s:%d" % (host, port),
                    "--replica-id", "scaled-{model}", "--heartbeat",
                    "0.25"]})
    client = None
    try:
        plane.observe_alert({
            "rule": "slo_budget_burn", "executor": "0", "severity": "warn",
            "time": T0, "persists_windows": 2, "model": "lin",
            "version": "1"})
        records = plane.tick()
        assert [(r["action"], r["stage"]) for r in records] == [
            ("scale_out_serving", "proposed"),
            ("scale_out_serving", "applied")], records
        argv = records[-1]["detail"]["argv"]
        assert "--model=lin" in argv and "--replica-id" in argv
        assert argv[argv.index("--replica-id") + 1] == "scaled-lin"
        rc = reservation.Client((host, port))
        try:
            rows = rc.await_reservations(timeout=60)
        finally:
            rc.close()
        router = fleet.FleetRouter(registry=registry)
        router.sync_roster(rows)
        table = router.replicas("lin")
        assert list(table) == ["scaled-lin"], router.status()
        assert table["scaled-lin"]["version"] == "1"
        client = fleet.FleetClient(router, timeout=30.0)
        deadline = time.time() + 30
        while True:
            try:
                out = client.predict(
                    "lin", {"x": np.asarray([[1.0, 1.0]], np.float32)}, 1)
                break
            except OSError:
                assert time.time() < deadline
                router.set_health("scaled-lin", True)
                time.sleep(0.2)
        assert abs(float(out["output"][0][0]) - 5.0) < 1e-5
    finally:
        if client is not None:
            client.close()
        plane.stop()
        resv.stop()
        registry.close()
