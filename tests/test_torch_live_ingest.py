"""The live tier through the port's sweep service, after
tests/test_live_ingest.py and tests/test_live.py's service tests, on the
CPU, Titanic with 3 partners (synthetic rounds, no training):

- `POST /live/<tenant>/round` exists only with MPLC_TORCH_LIVE_INGEST=1
  and feeds the tenant's resident game exactly as an in-process
  `append_round` does (the same stamp, bit-equal answers); the wire round
  is the JAX package's encoding; tenant tokens are bound to the path;
  unknown tenant 404, malformed 400, a full game 429 with Retry-After;
- `submit_live` runs a query as a job one tier above the batch default
  with MPLC_TORCH_LIVE_QUERY_DEADLINE_SEC as its deadline, answers as the
  game does, keeps the resident engine, shows on /varz (redacted for
  other tenants); `method="auto"` plans at submit and journals the plan;
  two live queries of one tenant on two workers serialize.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from mplc_tpu.live.game import _encode_tree as jencode
from mplc_tpu.obs import export as jexport
from mplc_tpu_torch.live import residency
from mplc_tpu_torch.live.game import _encode_tree
from mplc_tpu_torch.obs import export as obs_export
from mplc_tpu_torch.obs import metrics
from mplc_tpu_torch.obs import trace as obs_trace
from mplc_tpu_torch.obs.report import format_report, sweep_report
from mplc_tpu_torch.service import ServiceAuthError, ServiceError, SweepJournal, SweepService
from test_torch_live import synth_rounds
from torch_service_helpers import clean_env, scenario


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    clean_env(monkeypatch, tmp_path, cap=None)
    residency.reset()
    metrics.reset()
    yield
    residency.reset()
    metrics.reset()


def _wire_round(game, seed=0):
    """One live_round wire document: the [[shape, dtype, values]] triples
    the WAL journals."""
    deltas, w = synth_rounds(game._init_params, game.engine.partners_count, 1, seed=seed)[0]
    return {"deltas": _encode_tree(deltas), "weights": w.tolist()}


def _post(url, doc, token=None):
    """(status, parsed JSON body or None, headers)."""
    req = urllib.request.Request(url, data=json.dumps(doc).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read() or b"null"), dict(resp.headers)
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            parsed = json.loads(body) if body else None
        except ValueError:
            parsed = None
        return e.code, parsed, dict(e.headers)


@pytest.fixture()
def live_service(monkeypatch):
    """A stopped-scheduler service with one resident game ("acme") and a
    loopback telemetry server, ingestion on."""
    monkeypatch.setenv("MPLC_TORCH_LIVE_INGEST", "1")
    svc = SweepService(start=False)
    game = svc.live_game(scenario(61), tenant="acme")
    srv = obs_export.TelemetryServer(0)
    try:
        yield svc, game, f"http://127.0.0.1:{srv.port}"
    finally:
        srv.close()
        svc.shutdown(drain=False)


def test_the_wire_round_is_the_jax_encoding(live_service):
    _, game, _ = live_service
    deltas, _ = synth_rounds(game._init_params, 3, 1, seed=5)[0]
    assert _encode_tree(deltas) == jencode(jax.tree_util.tree_map(np.asarray, deltas))


def test_ingested_round_equals_in_process_append(live_service):
    svc, game, base = live_service
    doc = _wire_round(game, seed=62)
    status, ack, _ = _post(f"{base}/live/acme/round", doc)
    assert status == 200
    assert ack == {"tenant": "acme", "stamp": game.round_stamp, "rounds_resident": 1}
    assert metrics.snapshot()["counters"]["live.rounds_ingested"] == 1
    twin = svc.live_game(scenario(61), tenant="twin")
    deltas, w = game.round_history()[0]
    stamp = svc.append_round("twin", deltas, w)
    assert stamp == game.round_stamp
    a, b = twin.query("exact"), game.query("exact")
    assert a.scores.tobytes() == b.scores.tobytes()
    assert twin._recon.values == game._recon.values


def test_route_does_not_exist_without_opt_in(live_service, monkeypatch):
    _, game, base = live_service
    monkeypatch.delenv("MPLC_TORCH_LIVE_INGEST")
    assert _post(f"{base}/live/acme/round", _wire_round(game))[0] == 404
    assert game.rounds_resident == 0


def test_unknown_tenant_404_and_malformed_400(live_service):
    _, game, base = live_service
    status, body, _ = _post(f"{base}/live/nobody/round", _wire_round(game))
    assert status == 404 and "nobody" in body["error"]
    req = urllib.request.Request(f"{base}/live/acme/round", data=b"not json", method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400
    status, body, _ = _post(f"{base}/live/acme/round", {"deltas": [[1, 2]], "weights": "x"})
    assert status == 400 and "malformed" in body["error"]
    assert game.rounds_resident == 0


def test_tenant_tokens_are_path_bound(live_service, monkeypatch):
    svc, game, base = live_service
    monkeypatch.setenv("MPLC_TORCH_METRICS_TOKEN", "master-secret")
    acme_tok = obs_export.tenant_token("master-secret", "acme")
    beta_tok = obs_export.tenant_token("master-secret", "beta")
    assert acme_tok == jexport.tenant_token("master-secret", "acme")
    doc = _wire_round(game, seed=63)
    assert _post(f"{base}/live/acme/round", doc)[0] == 401
    assert _post(f"{base}/live/acme/round", doc, token="nope")[0] == 401
    assert _post(f"{base}/live/acme/round?tenant=beta", doc, token=beta_tok)[0] == 401
    assert game.rounds_resident == 0
    status, ack, _ = _post(f"{base}/live/acme/round?tenant=acme", doc, token=acme_tok)
    assert status == 200 and ack["rounds_resident"] == 1
    status, ack, _ = _post(f"{base}/live/acme/round", doc, token="master-secret")
    assert status == 200 and ack["rounds_resident"] == 2
    # a wire credential of another tenant is refused in process too
    with pytest.raises(ServiceAuthError, match="credential"):
        svc._ingest_live_round("acme", {**doc, "credential": beta_tok})
    assert game.rounds_resident == 2


def test_full_game_429_with_retry_after(live_service):
    svc, _, base = live_service
    capped = svc.live_game(scenario(61), tenant="capped", max_rounds=1)
    doc = _wire_round(capped, seed=64)
    assert _post(f"{base}/live/capped/round", doc)[0] == 200
    status, body, headers = _post(f"{base}/live/capped/round", doc)
    assert status == 429 and "MPLC_TORCH_LIVE_MAX_ROUNDS" in body["error"]
    assert body["retry_after_sec"] == 0.0 and headers["Retry-After"] == "1"
    assert capped.rounds_resident == 1


# -- live queries as service jobs ---------------------------------------------

def test_service_live_query_job(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_LIVE_QUERY_DEADLINE_SEC", "30")
    svc = SweepService(start=False)
    with pytest.raises(ServiceError, match="no live game"):
        svc.submit_live("tenantX")
    with pytest.raises(ServiceError, match="no live game"):
        svc.append_round("tenantX", None, None)
    sc = scenario(22)
    game = svc.live_game(sc, tenant="tenantX")
    assert svc.live_game(sc, tenant="tenantX") is game
    for deltas, w in synth_rounds(game._init_params, 3, 2, seed=13):
        svc.append_round("tenantX", deltas, w)
    with pytest.raises(ValueError, match="unknown live query method"):
        svc.submit_live("tenantX", method="TMCS")
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        svc.submit_live("tenantX", prune=5.0)
    game.engine.partners_count = 17
    try:
        with pytest.raises(ValueError, match="limited to"):
            svc.submit_live("tenantX", method="exact")
    finally:
        game.engine.partners_count = 3
    with obs_trace.collect() as records:
        job = svc.submit_live("tenantX", method="exact")
        assert job.priority == svc._priority_default + 1
        assert job.deadline_sec == 30.0 and job.method == "live:exact"
        svc.run_until_idle()
    scores = job.result(timeout=5)
    direct = game.query("exact")
    assert np.asarray(scores).tobytes() == direct.scores.tobytes()
    assert job.live_result.stamp == game.round_stamp
    assert job.values == game._recon.values
    assert game.engine.stacked is not None and game.engine.progress is None
    varz = svc.varz_view()
    assert varz["live_games"]["tenantX"]["rounds_resident"] == 2
    json.dumps(varz["live_games"])
    assert varz["live_residency"] == residency.stats()
    slices = [r for r in records if r["name"] == "service.slice"]
    # one quantum: the reconstruction of the 7 coalitions, no training
    assert len(slices) == 1 and slices[0]["attrs"]["coalitions"] == 7
    assert slices[0]["attrs"]["epochs"] == slices[0]["attrs"]["samples"] == 0
    rep = sweep_report(records)
    assert rep["live"]["queries"] >= 1 and "live" in format_report(rep)
    assert metrics.snapshot()["gauges"]["live.rounds_resident{tenant=tenantX}"] == 2
    svc.shutdown(drain=False)


def test_auto_live_query_plans_at_submit_and_journals_the_plan(tmp_path):
    path = tmp_path / "wal.jsonl"
    svc = SweepService(journal_path=path, start=False)
    game = svc.live_game(scenario(23), tenant="t")
    for deltas, w in synth_rounds(game._init_params, 3, 2, seed=3):
        svc.append_round("t", deltas, w)
    job = svc.submit_live("t", method="auto")
    assert job.plan is not None and job.plan.method == "exact"
    svc.run_until_idle()
    assert job.status == "completed" and job.live_result.plan is job.plan
    subs = [r for r in SweepJournal.replay(path)[0] if r["type"] == "submit"]
    assert subs[0]["plan"]["method"] == "exact" and subs[0]["method"] == "live:exact"
    done = [r for r in SweepJournal.replay(path)[0] if r["type"] == "done"]
    assert done and done[0]["job"] == job.job_id
    svc.shutdown()


def test_varz_live_games_redacted_for_other_tenants():
    svc = SweepService(start=False)
    try:
        for tenant in ("acme", "beta"):
            svc.live_game(scenario(31), tenant=tenant)
        doc = {"live_games": svc.varz_view()["live_games"]}
        red = obs_export.redact_varz(doc, viewer="beta", key="master")
        assert red == jexport.redact_varz(doc, viewer="beta", key="master")
        assert "beta" in red["live_games"]
        others = [v for k, v in red["live_games"].items() if k != "beta"]
        assert len(others) == 1 and others[0]["redacted"] is True
        assert others[0]["resident"] is True and "acme" not in str(red)
    finally:
        svc.shutdown(drain=False)


def test_concurrent_live_queries_same_tenant_serialize():
    svc = SweepService(workers=2)
    try:
        game = svc.live_game(scenario(31), tenant="t2w")
        for deltas, w in synth_rounds(game._init_params, 3, 2, seed=15):
            svc.append_round("t2w", deltas, w)
        jobs = [svc.submit_live("t2w", method="exact") for _ in range(3)]
        results = [np.asarray(j.result(timeout=120)) for j in jobs]
        for r in results[1:]:
            np.testing.assert_array_equal(results[0], r)
        assert all(j.status == "completed" and j.values for j in jobs)
        assert game.engine.progress is None
    finally:
        svc.shutdown(drain=False)
