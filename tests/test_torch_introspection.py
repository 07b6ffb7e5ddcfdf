"""The introspection server (heat_tpu_torch/telemetry/server.py), the crash
flight recorder (telemetry/flight_recorder.py), the inspect and replay CLIs
(telemetry/inspect.py, telemetry/replay.py) and the rest of
``telemetry/__init__.py``, against heat_tpu's where the reference has the
same function.

* every route the reference lists answers on an ephemeral port (the
  contracts of the reference's ``tests/test_introspection.py`` that need
  no serving layer): OpenMetrics ``/metrics``, ``/statusz`` with torch,
  CUDA and device information, ``/rooflinez`` in both forms, ``/profilez``
  POSTs with 409 on conflict, mounted routes;
* ``/canaryz`` of a process with no serving layer (ROADMAP item 17b) is
  the reference's document for a process that serves no model;
* a crashing subprocess leaves a checksum-verified bundle carrying the
  observatory and the journal, and the ``HEAT_TPU_METRICS_DUMP`` JSON with
  the observatory section; ``HEAT_TPU_HTTP_PORT`` starts the server at
  import;
* ``format_bundle`` renders a reference bundle as the reference does, and
  ``replay_report`` / ``format_replay`` of one durable journal are the
  reference's."""

import json
import os
import socket
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu as hj  # noqa: F401
import heat_tpu_torch as ht
from heat_tpu.telemetry import flight_recorder as r_flight
from heat_tpu.telemetry import inspect as r_inspect
from heat_tpu.telemetry import journal as r_journal
from heat_tpu.telemetry import replay as r_replay
from heat_tpu_torch import telemetry as p_tel
from heat_tpu_torch.core import _env
from heat_tpu_torch.telemetry import flight_recorder as p_flight
from heat_tpu_torch.telemetry import inspect as p_inspect
from heat_tpu_torch.telemetry import journal as p_journal
from heat_tpu_torch.telemetry import observatory as p_obs
from heat_tpu_torch.telemetry import replay as p_replay
from heat_tpu_torch.telemetry import server as p_server

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cpu():
    ht.use_device("cpu")


@pytest.fixture
def live():
    srv = p_server.start_server(0)
    yield srv
    p_server.stop_server()


def _get(srv, route):
    try:
        with urllib.request.urlopen(f"{srv.url}{route}", timeout=30) as r:
            return r.status, r.read().decode("utf-8"), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8"), dict(e.headers)


def _post(srv, route):
    req = urllib.request.Request(f"{srv.url}{route}", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


ROUTES = ["/metrics", "/varz", "/healthz", "/readyz", "/trace", "/tracez", "/tracez?format=json", "/sloz",
          "/sloz?format=json", "/driftz", "/driftz?format=json", "/canaryz", "/canaryz?format=json", "/rooflinez",
          "/rooflinez?format=json&limit=2", "/tenantz", "/tenantz?format=json", "/profilez", "/profilez?format=json",
          "/decisionz", "/decisionz?format=json", "/queryz", "/queryz?format=json&series=tsdb.samples&window=60",
          "/statusz", "/"]


def test_every_route_answers(live):
    x = ht.array(np.ones((64, 4), np.float32), split=0)
    for _ in range(3):
        float((x * 2.0).sum())
    for route in ROUTES:
        status, body, headers = _get(live, route)
        assert status == 200, (route, body[:300])
        if "format=json" in route or route in ("/varz", "/healthz", "/readyz", "/trace", "/statusz"):
            json.loads(body)
    status, body, headers = _get(live, "/metrics")
    assert headers["Content-Type"] == p_server.OPENMETRICS_CONTENT_TYPE and body.rstrip("\n").endswith("# EOF")
    assert "heat_tpu_observatory_ledger_size" in body
    assert _get(live, "/nowhere")[0] == 404
    index = _get(live, "/")[1]
    assert "/rooflinez" in index and "/profilez" in index and "/queryz" in index
    doc = json.loads(_get(live, "/rooflinez?format=json&limit=1")[1])
    assert len(doc["ledger"]) == 1 and doc["ledger_total"] >= 1 and doc["peaks"]["source"] == "calibrated"


def test_statusz_names_torch_cuda_and_the_device(live):
    doc = json.loads(_get(live, "/statusz")[1])
    rt = doc["runtime"]
    assert rt["torch"] and rt["backend"] in ("cpu", "cuda") and "cuda" in rt and rt["device_count"] >= 1
    assert (rt["process_index"], rt["process_count"]) == (0, 1) and rt["heat_tpu_torch"]
    assert sorted(doc["knobs"]) == sorted(_env.KNOBS)
    assert doc["dispatch"]["aot"] is not None and doc["observatory"]["enabled"] in (True, False)
    assert set(doc["elastic"]) == {"world_size", "worker_losses", "reshapes"}
    assert doc["analysis"] is None  # analysis.memory_model is ROADMAP item 18


def test_profilez_over_http(live, tmp_path, monkeypatch):
    monkeypatch.setenv("HEAT_TPU_PROFILE_DIR", str(tmp_path))
    monkeypatch.setattr(p_obs, "_PROF", dict(p_obs._PROF, base_dir=None, captures=[], seq=0))
    status, body = _post(live, "/profilez/start?duration_s=10")
    assert status == 200 and json.loads(body)["dir"]
    assert _post(live, "/profilez/start")[0] == 409
    float(ht.array(np.ones(32, np.float32)).sum())
    status, body = _post(live, "/profilez/stop")
    rec = json.loads(body)
    assert status == 200 and rec["artifacts"]
    assert _post(live, "/profilez/stop")[0] == 409
    name = rec["artifacts"][0]["name"]
    status, art, _ = _get(live, f"/profilez/artifact?name={name}")
    assert status == 200 and json.loads(art)["traceEvents"]
    assert _get(live, "/profilez/artifact?name=../../../etc/passwd")[0] == 404


def test_mounted_routes_and_readiness(live):
    p_server.register_route("/v1/probe", lambda method, path, body: (201, "text/plain", f"{method} {path} {body!r}"))
    try:
        assert _get(live, "/v1/probe/x") == (201, "GET /v1/probe/x None", _get(live, "/v1/probe/x")[2])
        assert _post(live, "/v1/probe") == (201, "POST /v1/probe b''")
        assert "/v1/probe" in p_server.registered_routes()
    finally:
        p_server.unregister_route("/v1/probe")
    assert _get(live, "/v1/probe")[0] == 404
    p_server.set_readiness(lambda: (False, {"state": "draining"}))
    try:
        status, body, _ = _get(live, "/readyz")
        assert status == 503 and json.loads(body)["state"] == "draining"
    finally:
        p_server.clear_readiness()


def test_canaryz_without_a_serving_layer_is_the_references_idle_document(live, monkeypatch):
    from heat_tpu.serving import canary as r_canary
    from heat_tpu.telemetry import metrics as r_metrics

    monkeypatch.setattr(r_canary, "_STATE", {})
    monkeypatch.setattr(r_canary, "_EVENTS", type(r_canary._EVENTS)(maxlen=r_canary._EVENTS.maxlen))
    r_metrics.reset("canary.")
    got = json.loads(_get(live, "/canaryz?format=json")[1])
    want = json.loads(json.dumps(r_canary.canaryz_report()))
    for d in (got, want):
        d.pop("timestamp")
    assert got == want
    assert _get(live, "/canaryz")[1] == r_canary.render_canaryz_html()


def test_a_bad_http_port_knob_warns_and_stays_off(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_HTTP_PORT", "eighty")
    with pytest.warns(RuntimeWarning, match="not an integer"):
        assert p_server.maybe_start_from_env() is None
    monkeypatch.setenv("HEAT_TPU_HTTP_PORT", "0")
    assert p_server.maybe_start_from_env() is None


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_CRASH = """
import numpy as np
import heat_tpu_torch as ht
from heat_tpu_torch.telemetry import journal, observatory, server
ht.use_device("cpu")
print("SERVER", server.server_running(), server.start_server().port, flush=True)
observatory.set_sync_every(2)
observatory.set_peaks(1e12, 1e10, source="spec-sheet")
x = ht.array(np.random.default_rng(0).normal(size=(300, 4)).astype(np.float32), split=0)
km = ht.cluster.KMeans(n_clusters=3, init="random", random_state=0, max_iter=6).fit(x)
print("NITER", km.n_iter_, flush=True)
journal.emit("preempt", "raise", message="probe")
observatory.watermark_tick(force=True)
raise ht.resilience.PermanentFault("boom")
"""


def test_a_crashed_subprocess_leaves_a_bundle_and_the_metrics_dump(tmp_path):
    """One subprocess: ``HEAT_TPU_HTTP_PORT`` starts the server at import,
    a fit is noted, the crash writes a bundle (checksum-verified, carrying
    the observatory and the journal) and the atexit dump carries the
    observatory section; the inspect CLI renders the bundle."""
    bundles, dump, port = tmp_path / "bundles", tmp_path / "metrics.json", _free_port()
    env = {**os.environ, "HEAT_TPU_FLIGHT_RECORDER": str(bundles), "HEAT_TPU_METRICS_DUMP": str(dump),
           "HEAT_TPU_HTTP_PORT": str(port), "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", _CRASH], env=env, capture_output=True, text=True, cwd=REPO,
                          timeout=240)
    assert proc.returncode != 0 and "PermanentFault" in proc.stderr, proc.stderr[-2000:]
    assert f"SERVER True {port}" in proc.stdout
    n_iter = int(proc.stdout.split("NITER")[1].split()[0])
    paths = sorted(bundles.glob("flight_*.json"))
    assert len(paths) == 1
    doc = p_inspect.load_bundle(str(paths[0]))
    assert doc["exception"]["type"] == "PermanentFault" and doc["runtime"]["torch"]
    rows = {r["key"].split(",")[1].strip(): r for r in doc["observatory"]["ledger"] if "(kernel, lloyd" in r["key"]}
    assert rows["lloyd_step"]["calls"] == n_iter and rows["lloyd_step"]["bound"] == "bandwidth"
    assert rows["lloyd_labels"]["calls"] == 1
    assert doc["observatory"]["peaks"]["source"] == "spec-sheet"
    assert doc["observatory"]["watermark"]["source"] in ("device", "host_rss")
    assert any(e["actor"] == "preempt" for e in doc["journal"]["events"])
    assert doc["elastic"] is not None and doc["tsdb"] is not None and doc["canary"] is None
    from heat_tpu_torch.resilience.atomic import verify_checksum

    verify_checksum(str(dump))
    dumped = json.loads(dump.read_text())
    assert dumped["observatory"]["peaks"]["source"] == "spec-sheet" and dumped["observatory"]["ledger"]
    text = p_inspect.format_bundle(doc)
    assert "observatory" in text and "spec-sheet" in text and "torch " in text
    # a torn bundle fails its checksum
    raw = bytearray(paths[0].read_bytes())
    raw[10] ^= 0xFF
    paths[0].write_bytes(bytes(raw))
    with pytest.raises(ht.resilience.ChecksumError):
        p_inspect.load_bundle(str(paths[0]))


def test_format_bundle_renders_a_reference_bundle_as_the_reference(tmp_path):
    try:
        raise ValueError("probe")
    except ValueError as e:
        doc = json.loads(json.dumps(r_flight.build_bundle(e, reason="manual"), default=str))
    for n in (5, 40):
        assert p_inspect.format_bundle(doc, n_metrics=n, n_spans=n) == r_inspect.format_bundle(doc, n_metrics=n,
                                                                                                 n_spans=n)
    # a bundle of this package loads in the reference's reader too
    path = p_flight.dump_bundle(RuntimeError("here"), directory=str(tmp_path))
    rt = r_inspect.load_bundle(path)["runtime"]
    assert rt["device_kind"] == (torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu")


def test_replay_of_one_journal_is_the_references(tmp_path):
    d = str(tmp_path / "journal")
    p_journal.set_journal_dir(d)
    try:
        a = p_journal.emit("canary", "stage", model="km", message="staged")
        p_journal.emit("canary", "promoted", model="km", cause=a["event_id"])
        p_journal.emit("preempt", "clear", message="an illegal clear")
    finally:
        p_journal.set_journal_dir(None)
        p_journal.reset_journal()
    for kw in ({}, {"check": True}):
        got, want = p_replay.replay_report(d, **kw), r_replay.replay_report(d, **kw)
        assert got == want
        assert p_replay.format_replay(got) == r_replay.format_replay(want)
    assert p_replay.replay_report(d, check=True)["check"]["violation_count"] == 1
    eid = p_replay.replay_report(d)["events"][-1]["event_id"]
    assert p_replay.replay_report(d, event_id=eid) == r_replay.replay_report(d, event_id=eid)
    assert p_replay.main([d, "--check"]) == 2 and p_replay.main([d, "--json"]) == 0
    assert p_replay.main([str(tmp_path / "empty")]) == 1
    r_journal.reset_journal()


def test_the_public_surface_is_a_superset_of_the_references():
    import heat_tpu.telemetry as r_tel

    assert set(r_tel.__all__) <= set(p_tel.__all__)
    for name in p_tel.__all__:
        assert hasattr(p_tel, name), name
    for domain in ("observatory", "alerts", "slo", "drift", "tsdb", "flight", "comm", "telemetry"):
        p_tel.reset_all(domain)
    with pytest.raises(ValueError):
        p_tel.reset_all("nowhere")
