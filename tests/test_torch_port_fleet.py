"""PyTorch port: the fleet control plane's modules against the JAX
package on the CPU.

- ``serving/registry.py``: publish / resolve / versions / verify and
  immutability as the JAX module; a version published by either package
  verifies and resolves in the other; a truncated leaf is reported.
- ``serving/rollout.py``: ``RolloutParams`` and ``judge`` equal to the JAX
  module's over a grid of canary / incumbent documents; the state and
  request files round-trip across the packages.
- ``serving/fleet.py``: ``aggregate_health``, ``fleet_metrics`` and
  ``merge_prometheus`` equal to the JAX module's on the same documents and
  texts; the snapshot fallback ages stale heartbeats; ``ManagerFleet``
  reads signals from the same files and actuates through them.
- ``serving/autoscaler.py``: ``AutoscalerPolicy`` decides exactly what the
  JAX policy decides over the same signal sequences (the JAX package's
  decision tables and a seeded random walk); the ``Autoscaler`` runtime's
  metrics and decision log; ``EngineFleet`` over port engines.
- ``serving/lb.py``: the front door over port replica gateways routes,
  re-routes around a dead member, takes a scale-up without client change,
  passes semantic answers (404, 429 + Retry-After) through, and answers
  503 with no members.
- ``serving/incident.py``: capture, list, eviction and the rendered
  timeline equal to the JAX module's on the same spools.
"""

import base64
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.inference import weightstore as jws
from analytics_zoo_tpu.serving import autoscaler as jas
from analytics_zoo_tpu.serving import fleet as jfleet
from analytics_zoo_tpu.serving import incident as jinc
from analytics_zoo_tpu.serving import registry as jreg
from analytics_zoo_tpu.serving import rollout as jro
from analytics_zoo_tpu.serving import tracecollect as jtc
from analytics_zoo_tpu_torch.inference import weightstore as tws
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.serving import autoscaler as tas
from analytics_zoo_tpu_torch.serving import faults as tfaults
from analytics_zoo_tpu_torch.serving import fleet as tfleet
from analytics_zoo_tpu_torch.serving import incident as tinc
from analytics_zoo_tpu_torch.serving import registry as treg
from analytics_zoo_tpu_torch.serving import rollout as tro
from analytics_zoo_tpu_torch.serving import tracecollect as ttc
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.engine import (ClusterServing,
                                                    ServingParams)
from analytics_zoo_tpu_torch.serving.http import HealthServer
from analytics_zoo_tpu_torch.serving.lb import LoadBalancer
from analytics_zoo_tpu_torch.serving.queues import InProcQueue

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

DIM, NCLS = 3, 4


def _tree(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"params": {"dense": {"W": (rng.standard_normal((4, 3))
                                       * scale).astype(np.float32),
                                 "b": np.zeros(3, np.float32)}},
            "state": {}}


def _store(path, seed=0, ws=tws):
    ws.save_store(str(path), _tree(seed))
    return str(path)


# -- registry -------------------------------------------------------------------------

def test_registry_publish_resolve_versions(tmp_path):
    reg = str(tmp_path / "registry")
    assert treg.latest(reg) is None
    with pytest.raises(treg.RegistryError):
        treg.resolve(reg)
    d1 = treg.publish(reg, "v1", _store(tmp_path / "s1"), quantize=None,
                      meta={"note": "first"})
    assert d1["version"] == "v1" and treg.latest(reg) == "v1"
    time.sleep(0.01)
    treg.publish(reg, "v2", _store(tmp_path / "s2", seed=1))
    assert treg.resolve(reg) == "v2" == treg.resolve(reg, "latest")
    assert treg.resolve(reg, "v1") == "v1"
    vs = treg.versions(reg)
    assert [v["version"] for v in vs] == ["v1", "v2"]
    assert [v["latest"] for v in vs] == [False, True]
    treg.set_latest(reg, "v1")
    assert treg.latest(reg) == "v1"
    assert treg.read_meta(reg, "v1")["meta"] == {"note": "first"}
    assert treg.store_path(reg, "v1").endswith(os.path.join("v1",
                                                            "weights"))
    # the JAX module reads the same registry the same way
    assert jreg.versions(reg) == treg.versions(reg)
    assert jreg.latest(reg) == "v1"


def test_registry_immutable_and_names(tmp_path):
    reg = str(tmp_path / "registry")
    s1 = _store(tmp_path / "s1")
    doc = treg.publish(reg, "v1", s1)
    assert treg.publish(reg, "v1", s1) == doc           # idempotent
    with pytest.raises(treg.RegistryError, match="immutable"):
        treg.publish(reg, "v1", _store(tmp_path / "s2", seed=5))
    for bad in ("", "../x", "a b", ".hidden"):
        with pytest.raises(treg.RegistryError, match="invalid"):
            treg.publish(reg, bad, s1)
    with pytest.raises(treg.RegistryError, match="not a weight store"):
        treg.publish(reg, "v9", str(tmp_path))
    with pytest.raises(treg.RegistryError, match="not found"):
        treg.resolve(reg, "v7")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_registry_versions_cross_packages(tmp_path, writer):
    """A version published (over a store written) by one package verifies,
    resolves and restores in the other."""
    reg = str(tmp_path / "registry")
    w_reg, w_ws = (treg, tws) if writer == "port" else (jreg, jws)
    r_reg, r_ws = (jreg, jws) if writer == "port" else (treg, tws)
    w_reg.publish(reg, "v1", _store(tmp_path / "s1", ws=w_ws))
    assert r_reg.verify(reg, "v1") == [] == w_reg.verify(reg, "v1")
    assert r_reg.resolve(reg) == "v1"
    flat = r_ws.load_flat(r_reg.store_path(reg, "v1"))
    np.testing.assert_array_equal(flat["params/dense/W"],
                                  _tree()["params"]["dense"]["W"])


def test_registry_verify_rejects_corrupt_leaf(tmp_path):
    reg = str(tmp_path / "registry")
    treg.publish(reg, "v1", _store(tmp_path / "s1"))
    hurt = tfaults.corrupt_store_leaf(treg.store_path(reg, "v1"))
    assert os.path.getsize(hurt) == 0
    problems = treg.verify(reg, "v1")
    assert problems and any("empty" in p or "truncated" in p
                            for p in problems)
    assert jreg.verify(reg, "v1") == problems
    treg.publish(reg, "v2", _store(tmp_path / "s2", seed=9))
    assert treg.verify(reg, "v2") == []
    assert treg.verify(reg, "v3") == jreg.verify(reg, "v3")


# -- rollout ----------------------------------------------------------------------------

def test_rollout_params_from_dict_match_jax():
    for doc in (None, {}, {"canary_dwell_s": 2, "auto_rollback": False,
                           "crash_limit": 0, "error_rate_max": 0.5,
                           "unknown_knob": 1}):
        assert vars(tro.RolloutParams.from_dict(doc)) == \
            vars(jro.RolloutParams.from_dict(doc))


def _doc(served=100, dead=0, burn=0.0):
    return {"total_records": served, "dead_lettered": dead,
            "slo": {"burn_rate": burn}}


@pytest.mark.parametrize("params", [
    dict(crash_limit=2), dict(error_rate_max=0.1, min_records=8),
    dict(burn_factor=2.0, burn_min=1.0), {}])
def test_judge_matches_jax(params):
    tp, jp = tro.RolloutParams(**params), jro.RolloutParams(**params)
    cases = [(None, [], 0), (None, [], 3), (None, [_doc()], 0)]
    for served, dead in ((2, 3), (4, 4), (95, 5), (0, 0), (50, 50)):
        cases.append((_doc(served, dead), [], 0))
    for burn in (0.9, 1.5, 3.0, 4.5):
        for inc in ([_doc(burn=0.4), _doc(burn=0.6)], [_doc(burn=2.0)], []):
            cases.append((_doc(burn=burn), inc, 1))
    verdicts = [tro.judge(c, i, tp, canary_crashes=n) for c, i, n in cases]
    assert verdicts == [jro.judge(c, i, jp, canary_crashes=n)
                        for c, i, n in cases]
    assert any(verdicts) and not all(verdicts)


def test_rollout_state_and_request_cross_packages(tmp_path):
    base = str(tmp_path / "cs.pid")
    st = tro.load_state(base)
    assert st == jro.load_state(base) and st["phase"] == "idle"
    st.update(phase="canary", target="v2", base="v1", canary_index=0)
    st["assignments"] = {0: "v2", 1: "v1"}
    tro.save_state(base, st)
    back = jro.load_state(base)
    assert back["phase"] == "canary" and back["assignments"] == {0: "v2",
                                                                 1: "v1"}
    jro.save_state(base, dict(back, phase="rolling"))
    assert tro.load_state(base)["phase"] == "rolling"
    tro.write_request(base, "v2", 123.0)
    assert jro.read_request(base) == {"target": "v2", "ts": 123.0}
    with open(tro.request_path(base), "w") as f:
        f.write("not json")
    assert tro.read_request(base) is None
    assert (tro.state_path(base), tro.request_path(base)) == \
        (jro.state_path(base), jro.request_path(base))


# -- fleet aggregation ------------------------------------------------------------------

def _health_doc(rid, served, shed=0, depth=5, pending=2, p99=100.0,
                hb=0.1, running=True, knobs=None, version=None,
                burn=None):
    doc = {"running": running, "replica_id": rid, "heartbeat_age_s": hb,
           "total_records": served, "dead_lettered": 0, "shed": shed,
           "reclaimed": 1, "duplicates": 0,
           "workers": {"serving-preprocess": {"restart_count": 1}},
           "queue": {"depth": depth, "pending": pending,
                     "dead_letters": 3},
           "knobs": knobs or {"max_batch": 8, "max_batch_ceiling": 64,
                              "inflight_batches": 2, "inflight_ceiling": 8,
                              "preprocess_workers": 1},
           "stages": {"e2e": {"count": served, "p50_ms": p99 / 2,
                              "p99_ms": p99},
                      "preprocess": {"p99_ms": 5.0},
                      "predict": {"p99_ms": 50.0}},
           "warmup": {"state": "ready", "compiled": 4, "total": 4},
           "cold_start_s": 1.5,
           "resources": {"weights_bytes": 1000, "kv_state_bytes": 20},
           "process": {"rss_bytes": 10 ** 8, "threads": 9}}
    if version is not None:
        doc["model_version"] = version
    if burn is not None:
        doc["slo"] = {"burn_rate": burn}
    return doc


def _docs():
    return {0: _health_doc("replica-0", 100, depth=7, p99=120.0,
                           version="v1", burn=0.5),
            1: _health_doc("replica-1", 40, shed=3, depth=6, hb=9.0,
                           running=False, p99=300.0, version="v2",
                           burn=1.5),
            2: _health_doc("replica-2", 5, p99=80.0, version="v1")}


def test_aggregate_health_and_fleet_metrics_match_jax():
    docs = _docs()
    agg = tfleet.aggregate_health(docs)
    assert agg == jfleet.aggregate_health(docs)
    assert agg["served"] == 145 and agg["queue_depth"] == 7
    assert agg["replicas_alive"] == 2
    lb = {"snapshot": {}, "url": "http://127.0.0.1:1", "ts": 1.0}
    for kw in ({}, {"lb": lb}):
        assert tfleet.fleet_metrics(docs, **kw) == \
            jfleet.fleet_metrics(docs, **kw)
    assert tfleet.aggregate_health({}) == jfleet.aggregate_health({})


def test_replica_docs_snapshot_fallback_and_manager_fleet(tmp_path):
    pidfile = str(tmp_path / "cs.pid")
    with open(pidfile + ".replicas", "w") as f:
        f.write("2")
    old = dict(_health_doc("replica-0", 10, hb=0.05), ts=time.time() - 30)
    with open(pidfile + ".r0.health.json", "w") as f:
        json.dump(old, f)
    fresh = dict(_health_doc("replica-1", 20, hb=0.05), ts=time.time())
    with open(pidfile + ".r1.health.json", "w") as f:
        json.dump(fresh, f)
    assert tfleet.read_scale(pidfile) == 2
    docs = tfleet.replica_docs(pidfile)
    assert set(docs) == {0, 1}
    assert docs[0]["heartbeat_age_s"] >= 29.0
    assert docs[1]["heartbeat_age_s"] < 5.0
    mf = tas.ManagerFleet(pidfile)
    sig = mf.signals()
    jsig = jas.ManagerFleet(pidfile).signals()
    assert sig.served_total == jsig.served_total == 30
    assert sig.desired == 2 and sig.max_batch == 8
    assert sig.heartbeat_ages["replica-0"] >= 29.0
    mf.scale_to(5)
    assert tfleet.read_scale(pidfile) == 5
    mf.retune(max_batch=16)
    mf.retune(inflight_batches=4)
    with open(mf.knobs_path) as f:
        assert json.load(f) == {"max_batch": 16, "inflight_batches": 4}
    for name in ("autoscaler.json", "lb.json"):
        with open(f"{pidfile}.{name}", "w") as f:
            json.dump({"prom": "x 1\n", "decisions": []}, f)
    assert tfleet.autoscaler_snapshot(pidfile) == \
        jfleet.autoscaler_snapshot(pidfile)
    assert tfleet.lb_snapshot(pidfile) == jfleet.lb_snapshot(pidfile)


def _prom(records, depth, bucket, total_sum, replica, hb):
    return "\n".join([
        "# HELP serving_records_total Records served",
        "# TYPE serving_records_total counter",
        f"serving_records_total {records}",
        "# HELP serving_queue_depth Records waiting",
        "# TYPE serving_queue_depth gauge",
        f"serving_queue_depth {depth}",
        "# HELP serving_e2e_seconds e2e",
        "# TYPE serving_e2e_seconds histogram",
        f'serving_e2e_seconds_bucket{{le="0.1"}} {bucket}',
        f'serving_e2e_seconds_bucket{{le="+Inf"}} {records}',
        f"serving_e2e_seconds_sum {total_sum}",
        f"serving_e2e_seconds_count {records}",
        "# HELP serving_heartbeat_age_seconds hb",
        "# TYPE serving_heartbeat_age_seconds gauge",
        f'serving_heartbeat_age_seconds{{replica="{replica}"}} {hb}',
        "# HELP serving_dead_letters dl",
        "# TYPE serving_dead_letters gauge",
        f"serving_dead_letters {depth // 2}",
    ]) + "\n"


def test_merge_prometheus_matches_jax():
    a = _prom(100, 7, 90, 4.5, "r0", 0.2)
    b = _prom(40, 6, 35, 2.0, "r1", 0.5)
    c = _prom(3, 9, 1, 0.25, "r2", 1.5)
    for texts in ([a, b], [a, b, c], [a], []):
        assert tfleet.merge_prometheus(texts) == \
            jfleet.merge_prometheus(texts)
    merged = tfleet.merge_prometheus([a, b])
    assert "serving_records_total 140" in merged
    assert "serving_queue_depth 7" in merged
    assert 'serving_e2e_seconds_bucket{le="0.1"} 125' in merged
    assert merged.count("# TYPE serving_records_total counter") == 1


# -- autoscaler ---------------------------------------------------------------------------

def _sig(mod, **kw):
    base = dict(queue_depth=0, pending=0, replicas=2, desired=2,
                served_total=0, shed_total=0, quarantined_total=0,
                reclaimed_total=0, e2e_p99_ms=None,
                heartbeat_ages={"r0": 0.1, "r1": 0.1},
                max_batch=8, max_batch_ceiling=64,
                inflight_batches=2, inflight_ceiling=8,
                preprocess_workers=1)
    base.update(kw)
    return mod.FleetSignals(**base)


_HOT = dict(e2e_p99_ms=2000.0, queue_depth=500, max_batch=64,
            max_batch_ceiling=64, inflight_batches=8, inflight_ceiling=8)

# (params, [(signal overrides, now), ...]) — the JAX package's decision
# tables (tests/test_serving_autoscale.py) as sequences
SCENARIOS = {
    "dead_band": (dict(slo_p99_ms=1000, dwell_up_s=1.0, dwell_down_s=2.0,
                       knob_dwell_s=0.5),
                  [(dict(e2e_p99_ms=500.0, queue_depth=10), t)
                   for t in (0.0, 1.0, 2.0, 5.0, 10.0)]
                  + [(dict(e2e_p99_ms=900.0, queue_depth=200), 11.0),
                     (dict(e2e_p99_ms=500.0, queue_depth=10), 11.5),
                     (dict(e2e_p99_ms=900.0, queue_depth=200), 12.1)]),
    "scale_up": (dict(slo_p99_ms=1000, dwell_up_s=1.0, knob_dwell_s=100.0,
                      max_step=2, max_replicas=5),
                 [(_HOT, 0.0), (_HOT, 0.5), (_HOT, 1.1),
                  (dict(_HOT, replicas=4, desired=4), 1.5),
                  (dict(_HOT, replicas=4, desired=4), 2.2),
                  (dict(_HOT, replicas=5, desired=5), 3.5)]),
    "scale_down": (dict(slo_p99_ms=1000, dwell_up_s=0.5, dwell_down_s=2.0,
                        scale_down_cooldown_s=10.0, knob_dwell_s=100.0,
                        max_step=2, min_replicas=1, max_replicas=8),
                   [(_HOT, 0.0), (_HOT, 0.6)]
                   + [(dict(replicas=4, desired=4, e2e_p99_ms=50.0), t)
                      for t in (1.0, 3.5, 8.0, 10.7)]),
    "knobs": (dict(slo_p99_ms=1000, knob_dwell_s=1.0, dwell_up_s=100.0),
              [(dict(e2e_p99_ms=2000.0, queue_depth=500, max_batch=16,
                     max_batch_ceiling=32), 0.0),
               (dict(e2e_p99_ms=2000.0, queue_depth=500, max_batch=16,
                     max_batch_ceiling=32), 0.5),
               (dict(e2e_p99_ms=2000.0, queue_depth=500, max_batch=32,
                     max_batch_ceiling=32, inflight_batches=2,
                     inflight_ceiling=4), 1.5),
               (dict(e2e_p99_ms=2000.0, queue_depth=500, max_batch=32,
                     max_batch_ceiling=32, inflight_batches=4,
                     inflight_ceiling=4, preprocess_p99_ms=900.0,
                     predict_p99_ms=100.0), 3.0),
               (dict(e2e_p99_ms=10.0, max_batch=32,
                     max_batch_ceiling=32), 6.0),
               (dict(e2e_p99_ms=10.0, max_batch=16,
                     max_batch_ceiling=32), 7.5)]),
    "shed_rate": (dict(slo_p99_ms=1000, knob_dwell_s=0.1, dwell_up_s=100.0),
                  [(dict(shed_total=100), 0.0), (dict(shed_total=150), 1.0),
                   (dict(shed_total=20), 2.0)]),
    "stale": (dict(heartbeat_stale_s=5.0, replace_cooldown_s=10.0,
                   knob_dwell_s=100.0),
              [(dict(queue_depth=10, heartbeat_ages={"r0": 0.1, "r1": t2}),
                t) for t, t2 in ((0.0, 1.0), (1.0, 12.0), (5.0, 12.0),
                                 (11.5, 12.0))]
              + [(dict(queue_depth=10,
                       heartbeat_ages={"r0": 30.0, "r1": 30.0}), 30.0)]),
    "empty_fleet": (dict(slo_p99_ms=1000, knob_dwell_s=0.1,
                         dwell_up_s=100.0),
                    [(dict(replicas=0, heartbeat_ages={}, max_batch=4),
                      0.0),
                     (dict(queue_depth=10, max_batch=32), 1.0),
                     (dict(e2e_p99_ms=10.0, max_batch=32), 2.0),
                     (dict(e2e_p99_ms=2000.0, queue_depth=500,
                           max_batch=32), 3.0)]),
}


def _decisions(mod, params, steps):
    pol = mod.AutoscalerPolicy(mod.AutoscalerParams(**params))
    return [[(a.kind, a.target, a.knobs, a.reason)
             for a in pol.decide(_sig(mod, **kw), t)] for kw, t in steps]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_decisions_match_jax(name):
    params, steps = SCENARIOS[name]
    got = _decisions(tas, params, steps)
    assert got == _decisions(jas, params, steps)
    assert any(got), "the scenario never acts"


def test_policy_random_walk_matches_jax():
    """A seeded walk through load, latency, shed, backlog, topology and
    heartbeat signals: every decision equal, tick for tick."""
    g = np.random.default_rng(7)
    steps, replicas, t = [], 2, 0.0
    for _ in range(300):
        t += float(g.uniform(0.05, 1.5))
        replicas = int(np.clip(replicas + g.integers(-1, 2), 0, 8))
        steps.append((dict(
            queue_depth=int(g.integers(0, 800)),
            pending=int(g.integers(0, 50)),
            replicas=replicas, desired=replicas,
            shed_total=int(t * g.uniform(0, 20)),
            e2e_p99_ms=float(g.choice([10.0, 400.0, 900.0, 2500.0])),
            preprocess_p99_ms=float(g.uniform(1, 500)),
            predict_p99_ms=float(g.uniform(1, 500)),
            heartbeat_ages={f"r{i}": float(g.choice([0.1, 0.5, 40.0]))
                            for i in range(replicas)},
            max_batch=int(g.choice([4, 8, 16, 32, 64])),
            inflight_batches=int(g.integers(1, 8)),
            preprocess_workers=int(g.integers(1, 4))), t))
    params = dict(slo_p99_ms=1000, dwell_up_s=1.0, dwell_down_s=3.0,
                  scale_down_cooldown_s=5.0, knob_dwell_s=0.5,
                  heartbeat_stale_s=10.0, replace_cooldown_s=4.0,
                  max_replicas=6)
    got = _decisions(tas, params, steps)
    assert got == _decisions(jas, params, steps)
    kinds = {a[0] for step in got for a in step}
    assert {"scale_up", "replace_replica", "retune_up"} <= kinds


class _ScriptedFleet:
    def __init__(self, signals):
        self._signals = list(signals)
        self.calls = []
        self.desired = signals[0].desired

    def signals(self):
        return self._signals.pop(0) if len(self._signals) > 1 \
            else self._signals[0]

    def scale_to(self, n):
        self.calls.append(("scale_to", n))
        self.desired = n

    def retune(self, **knobs):
        self.calls.append(("retune", knobs))

    def replace(self, rid):
        self.calls.append(("replace", rid))


def test_autoscaler_runtime_metrics_and_decision_log():
    hot = _sig(tas, e2e_p99_ms=2000.0, queue_depth=500, max_batch=8,
               max_batch_ceiling=16, heartbeat_ages={"r0": 0.1, "r1": 99.0})
    fleet = _ScriptedFleet([hot])
    scaler = tas.Autoscaler(fleet, params=tas.AutoscalerParams(
        slo_p99_ms=1000, dwell_up_s=1.0, knob_dwell_s=0.5,
        heartbeat_stale_s=5.0, max_step=2, max_replicas=8))
    acts = scaler.tick(now=0.0)
    assert sorted(a.kind for a in acts) == ["replace_replica", "retune_up"]
    acts = scaler.tick(now=1.5)
    assert "scale_up" in [a.kind for a in acts]
    assert ("scale_to", 4) in fleet.calls
    assert ("replace", "r1") in fleet.calls
    assert ("retune", {"max_batch": 16}) in fleet.calls
    reg = scaler.registry
    dec = reg.get("autoscaler_decisions_total")
    assert dec.labels(action="scale_up").value == 1
    assert dec.labels(action="scale_down").value == 0
    assert reg.get("autoscaler_target_replicas").value == 4
    log = scaler.decisions()
    assert any(e["action"] == "scale_up" and e["target"] == 4 for e in log)
    snap = scaler.snapshot()
    assert snap["decisions"] and "autoscaler_decisions_total" in snap["prom"]


def _im():
    m = Sequential()
    m.add(tcore.Dense(NCLS, input_shape=(DIM,), activation="softmax"))
    return InferenceModel(8, 1024, device="cpu").do_load_model(m)


def _serving(queue, im=None, **params):
    defaults = dict(batch_size=4, poll_timeout_s=0.02, write_backoff_s=0.01,
                    worker_backoff_s=0.01)
    defaults.update(params)
    return ClusterServing(im or _im(), queue,
                          params=ServingParams(**defaults))


def test_engine_fleet_scale_replace_and_signals():
    q = InProcQueue()
    im = _im()
    fleet = tas.EngineFleet(lambda rid: _serving(q, im=im, replica_id=rid,
                                                 max_batch=8).start(),
                            q, initial=2, drain_s=2.0)
    try:
        sig = fleet.signals()
        assert sig.replicas == 2 and sig.desired == 2
        assert sig.max_batch == 8 and sig.max_batch_ceiling == 1024
        fleet.scale_to(3)
        assert len(fleet.engines()) == 3
        fleet.retune(max_batch=16)
        cin = InputQueue(q)
        cin.enqueue_tensor("x", np.ones(DIM, np.float32))
        assert OutputQueue(q).query("x", timeout_s=30) is not None
        victim = sorted(e.replica_id for e in fleet.engines())[0]
        fleet.replace(victim)
        new = {e.replica_id for e in fleet.engines()}
        assert victim not in new and len(new) == 3
        fleet.scale_to(1)
        assert len(fleet.engines()) == 1
        # the shared queue keeps admitting after the retirements
        cin.enqueue_tensor("y", np.ones(DIM, np.float32))
        assert not OutputQueue.is_error(OutputQueue(q).query(
            "y", timeout_s=30))
        assert q.health()["admission_open"] is True
        fleet.add_external("ext-0", lambda: 42.0,
                           lambda: {"total_records": 7})
        sig = fleet.signals()
        assert sig.heartbeat_ages["ext-0"] == 42.0 and sig.replicas == 2
        fleet.replace("ext-0")
        assert len(fleet.engines()) == 2
    finally:
        fleet.shutdown()


# -- the load balancer ---------------------------------------------------------------------

def _post_json(url, doc, timeout=10):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _record(uri):
    arr = np.ones(DIM, np.float32)
    return {"uri": uri, "b64": base64.b64encode(arr).decode(),
            "dtype": "<f4", "shape": [DIM]}


def test_lb_front_door_routes_reroutes_and_scales():
    q = InProcQueue()
    im = _im()
    engines = [_serving(q, im=im, replica_id=f"lb-{i}", http_port=0).start()
               for i in range(2)]
    members = [f"http://127.0.0.1:{e._http.port}" for e in engines]
    lb = LoadBalancer(lambda: list(members), probe_interval_s=0.1).start()
    try:
        seen = set()
        for i in range(6):
            code, doc, hdrs = _post_json(lb.url + "/v1/enqueue",
                                         _record(f"u{i}"))
            assert code == 200 and doc["uri"] == f"u{i}"
            seen.add(hdrs.get("X-Replica-Id"))
        assert seen <= {"lb-0", "lb-1"} and seen
        want = im.do_predict(np.ones((1, DIM), np.float32))[0]
        for i in range(6):
            code, doc, _ = _get(lb.url + f"/v1/result/u{i}?timeout_s=20")
            assert code == 200 and "value" in doc
        code, doc, _ = _get(lb.url + "/readyz")
        assert code == 200 and len(doc["members"]) == 2
        engines[0].shutdown()
        for i in range(6, 14):
            code, doc, _ = _post_json(lb.url + "/v1/enqueue",
                                      _record(f"u{i}"))
            assert code == 200, (i, doc)
        for i in range(6, 14):
            code, doc, _ = _get(lb.url + f"/v1/result/u{i}?timeout_s=20")
            assert code == 200 and "value" in doc
        engines.append(_serving(q, im=im, replica_id="lb-2",
                                http_port=0).start())
        members.append(f"http://127.0.0.1:{engines[-1]._http.port}")
        lb.probe_once()
        code, doc, _ = _get(lb.url + "/readyz")
        assert code == 200 and len(doc["members"]) == 2
        code, doc, _ = _post_json(lb.url + "/v1/enqueue", _record("u99"))
        assert code == 200
        code, doc, _ = _get(lb.url + "/v1/result/u99?timeout_s=20")
        assert code == 200
        top = sorted(range(NCLS), key=lambda c: -want[c])[0]
        assert doc["value"][0][0] == top
        code, snap, _ = _get(lb.url + "/metrics")
        ok = [v for v in snap["lb_requests_total"]["values"]
              if v["labels"] == {"endpoint": "enqueue", "code": "200"}]
        assert ok and ok[0]["value"] == 15
        with urllib.request.urlopen(lb.url + "/metrics?format=prom",
                                    timeout=10) as r:
            prom = r.read().decode()
        assert "lb_requests_total{" in prom and "lb_members_ready" in prom
    finally:
        lb.stop()
        for e in engines:
            e.shutdown()


def test_lb_passthrough_and_no_members():
    q = InProcQueue(max_depth=2)
    e = _serving(q, http_port=0)       # NOT started: workers off
    srv = HealthServer(e, port=0).start()
    lb = LoadBalancer(lambda: [f"http://127.0.0.1:{srv.port}"],
                      probe_interval_s=0.1).start()
    try:
        code, doc, _ = _get(lb.url + "/v1/result/missing")
        assert code == 404 and doc["ready"] is False
        codes = []
        for i in range(4):
            c, _, hdrs = _post_json(lb.url + "/v1/enqueue",
                                    _record(f"f{i}"))
            codes.append((c, hdrs.get("Retry-After")))
        assert (429, "1") in codes and codes[0][0] == 200
    finally:
        lb.stop()
        srv.stop()
    lb2 = LoadBalancer(lambda: [], probe_interval_s=0.1).start()
    try:
        code, doc, _ = _get(lb2.url + "/readyz")
        assert code == 503
        code, doc, _ = _post_json(lb2.url + "/v1/enqueue", _record("x"))
        assert code == 503 and "no replica gateway" in doc["error"]
    finally:
        lb2.stop()


def test_static_and_manager_members(tmp_path):
    from analytics_zoo_tpu.serving import lb as jlb
    from analytics_zoo_tpu_torch.serving import lb as tlb
    urls = ["http://127.0.0.1:1", "http://127.0.0.1:2"]
    assert tlb.static_members(urls)() == jlb.static_members(urls)()
    pidfile = str(tmp_path / "cs.pid")
    with open(pidfile + ".replicas", "w") as f:
        f.write("3")
    assert tlb.manager_members(pidfile, http_port=9000)() == \
        jlb.manager_members(pidfile, http_port=9000)()


# -- incident bundles -------------------------------------------------------------------------

def _fake_deployment(base, tc=ttc):
    tc.append_spans(
        tc.spool_path(base + ".r0"),
        [{"trace_id": "t1", "uri": "u1", "stage": "predict", "ts": 1.0,
          "dur_s": 0.01}], source="replica-0")
    tc.append_events(
        tc.events_path(base + ".r0"),
        [{"event": "start", "ts": 0.5},
         {"event": "quarantine", "ts": 1.1, "rid": "u9",
          "error": "poison"}], source="replica-0")
    tc.append_events(
        tc.events_path(base),
        [{"event": "replica_exit", "ts": 1.2, "index": 0}],
        source="supervisor")
    with open(base + ".r0.health.json", "w") as f:
        json.dump({"replica_id": "replica-0", "running": True,
                   "clock": {"wall": 100.0, "monotonic": 1.0}}, f)
    with open(base + ".replicas", "w") as f:
        f.write("2")
    with open(base + ".knobs.json", "w") as f:
        json.dump({"max_batch": 8}, f)


def _strip(doc):
    """A rendered bundle without the fields that name its own path."""
    return {k: v for k, v in doc.items() if k not in ("bundle", "path")}


def test_incident_capture_list_render_match_jax(tmp_path):
    base = str(tmp_path / "cs.pid")
    _fake_deployment(base)
    bundle = tinc.capture(base, "unit-test", meta={"k": 1})
    assert bundle and os.path.isdir(bundle)
    names = set(os.listdir(bundle))
    for want in ("incident.json", "cs.pid.r0.spans.jsonl",
                 "cs.pid.r0.events.jsonl", "cs.pid.events.jsonl",
                 "cs.pid.r0.health.json", "cs.pid.replicas",
                 "cs.pid.knobs.json"):
        assert want in names
    lst = tinc.list_incidents(base)
    assert len(lst) == 1 and lst[0]["reason"] == "unit-test"
    assert lst[0]["meta"] == {"k": 1}
    assert lst == jinc.list_incidents(base)
    doc = tinc.render(bundle)
    assert [e["what"] for e in doc["timeline"]] == \
        ["start", "predict", "quarantine", "replica_exit"]
    assert [e["kind"] for e in doc["timeline"]] == \
        ["event", "span", "event", "event"]
    assert doc["errors"] == ["poison"]
    assert doc == jinc.render(bundle)
    assert tinc.load_timeline(bundle) == jinc.load_timeline(bundle)
    # a bundle the JAX module captured renders the same here
    jbase = str(tmp_path / "j" / "cs.pid")
    os.makedirs(os.path.dirname(jbase))
    _fake_deployment(jbase, tc=jtc)
    jb = jinc.capture(jbase, "unit-test", meta={"k": 1})
    assert _strip(tinc.render(jb)) == _strip(jinc.render(jb))
    assert [e["what"] for e in tinc.render(jb)["timeline"]] == \
        [e["what"] for e in doc["timeline"]]


def test_incident_empty_and_eviction(tmp_path):
    base = str(tmp_path / "cs.pid")
    assert tinc.capture(base, "nothing") is None
    _fake_deployment(base)
    bundles = [tinc.capture(base, f"r{i}", max_bundles=3)
               for i in range(5)]
    assert all(bundles)
    left = tinc.list_incidents(base)
    assert [b["reason"] for b in left] == ["r2", "r3", "r4"]
    assert tinc.resolve_bundle(base) == left[-1]["path"]
    assert tinc.resolve_bundle(base, left[0]["bundle"]) == left[0]["path"]
    assert tinc.resolve_bundle(base, "nope") is None
    assert tinc.incidents_dir(base) == jinc.incidents_dir(base)
