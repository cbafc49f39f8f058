"""PyTorch port: the engine's armour against the JAX package on the CPU.

The same inputs go through both packages and every comparison is exact:

- ``serving/admission.py``: the normalizers, the pressure and shed
  policy, ``TokenBucket`` and ``AdmissionController`` decisions (with
  their ``Retry-After``) over a seeded sequence of requests under a fake
  clock, queue depth, brownout stage and fault injector;
- ``serving/brownout.py``: ``BrownoutLadder`` stages, snapshots and
  flight-recorder events for the same burn sequence;
- ``serving/metering.py``: ``UsageMeter`` drains, snapshots and the series
  it registers, metering on and off;
- the engines, over the same tiny model: the priority shed order, the
  deadline early drop, sheds and quarantines billed to their tenant,
  records and bytes by tenant, the health and metrics blocks, ``retune``
  / ``knobs`` validation, the ``admission_reject`` fault through the
  gate, and generation tokens charged per tenant with the brownout clamp.
"""

import base64
import itertools
import time

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.common.observability import \
    MetricsRegistry as JaxRegistry
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.models.textmodels import TransformerLM as JaxLM
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.models import Sequential as JaxSeq
from analytics_zoo_tpu.serving import admission as jadm
from analytics_zoo_tpu.serving import brownout as jbo
from analytics_zoo_tpu.serving import engine as jeng
from analytics_zoo_tpu.serving import faults as jfaults
from analytics_zoo_tpu.serving import metering as jmet
from analytics_zoo_tpu.serving import queues as jqueues
from analytics_zoo_tpu_torch.common.observability import MetricsRegistry
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.serving import admission as tadm
from analytics_zoo_tpu_torch.serving import brownout as tbo
from analytics_zoo_tpu_torch.serving import engine as teng
from analytics_zoo_tpu_torch.serving import faults as tfaults
from analytics_zoo_tpu_torch.serving import metering as tmet
from analytics_zoo_tpu_torch.serving import queues as tqueues
from analytics_zoo_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

DIM, NCLS = 3, 4
PKGS = ("jax", "port")
ENG = {"jax": jeng, "port": teng}
QUEUES = {"jax": jqueues, "port": tqueues}
# replica ids unique in the process: the flight recorder is the
# process's, and tests read their engine's events by replica id
_IDS = itertools.count()


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    """The JAX package at the f32 dtype policy (process-global; another
    test in the same worker may leave it at bf16)."""
    saved = dict(jdtypes._policy)
    jdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


class Recorder:
    def __init__(self):
        self.events = []

    def record(self, kind, **attrs):
        self.events.append({"event": kind, **attrs})


# -- admission policy ------------------------------------------------------------

PRIO_INPUTS = ["interactive", "Best-Effort", " BATCH ", "admin", None, 7,
               "best_effort", "batch", "INTERACTIVE", ""]
TENANT_INPUTS = ["team-a_1.x", None, "", "a b", "x" * 64, "x" * 65, 42,
                 "acme", "ünicode", "dots.ok"]


def test_normalizers_match_jax():
    for v in PRIO_INPUTS:
        assert tadm.normalize_priority(v) == jadm.normalize_priority(v), v
    for v in TENANT_INPUTS:
        assert tadm.normalize_tenant(v) == jadm.normalize_tenant(v), v
    assert tadm.PRIORITIES == jadm.PRIORITIES
    assert tadm.DEFAULT_DEPTH_FRACTIONS == jadm.DEFAULT_DEPTH_FRACTIONS


def test_pressure_shed_and_deadline_policy_match_jax():
    g = np.random.default_rng(3)
    for _ in range(500):
        sf, df = (float(x) for x in g.choice(
            [0.0, 0.3, 0.5, 0.89, 0.9, 1.0, 1.2], 2))
        stage = int(g.integers(0, 4))
        lvl = tadm.pressure_level(sf, df, stage)
        assert lvl == jadm.pressure_level(sf, df, stage)
        assert tadm.shed_classes(lvl) == jadm.shed_classes(lvl)
        rem = float(g.choice([-1.0, 0.0, 0.3, 0.7, 0.8, 1.0, 5.0]))
        backlog = int(g.integers(-1, 6))
        ewma = [None, 0.0, 0.2, 1.0][int(g.integers(0, 4))]
        assert tadm.deadline_unmeetable(rem, backlog, ewma) == \
            jadm.deadline_unmeetable(rem, backlog, ewma)


def test_token_bucket_matches_jax():
    g = np.random.default_rng(5)
    for rate, burst in ((2.0, 4.0), (0.5, 1.0), (10.0, 2.0), (1e-12, 0.3)):
        tb, jb = (m.TokenBucket(rate, burst, now=10.0) for m in (tadm, jadm))
        now = 10.0
        for _ in range(200):
            # the clock mostly advances, sometimes stands or steps back
            now += float(g.choice([0.0, 0.01, 0.2, 1.0, -0.5]))
            n = float(g.choice([1.0, 1.0, 2.0, 0.5]))
            assert tb.try_acquire(now, n) == jb.try_acquire(now, n)
            assert (tb.tokens, tb._last) == (jb.tokens, jb._last)


def _controllers(cfg, depth, stage, faults_cfg=None):
    out = {}
    for pkg, mod, fmod in (("jax", jadm, jfaults), ("port", tadm, tfaults)):
        inj = fmod.FaultInjector(faults_cfg) if faults_cfg else None
        out[pkg] = mod.AdmissionController(
            cfg, clock=FakeClock(), queue_depth_fn=lambda: depth["v"],
            max_depth=100, brownout_stage_fn=lambda: stage["v"],
            faults=inj, registry=(JaxRegistry() if pkg == "jax"
                                  else MetricsRegistry()))
    return out


@pytest.mark.parametrize("cfg", [
    {"rate": 2.0, "burst": 3.0},
    {"rate": 1.0, "burst": 1.0, "max_tenants": 2,
     "tenants": {"gold": {"rate": 100.0, "burst": 10.0},
                 "tin": {"rate": 0.5}}},
    {"rate": 5.0, "depth_fractions": {"best_effort": 0.2, "batch": 0.6,
                                      "bogus": 0.1}},
    {"enabled": False, "rate": 1e-9}])
def test_admission_decisions_and_retry_after_match_jax(cfg):
    """A seeded stream of (tenant, priority, time, queue depth, brownout
    stage) through both controllers: identical decisions, reasons,
    Retry-After values, snapshots and rejection counters."""
    depth, stage = {"v": 0}, {"v": 0}
    ctl = _controllers(cfg, depth, stage, faults_cfg={
        "admission_reject": {"version": "*", "count": 3,
                             "priority": "best_effort"}})
    g = np.random.default_rng(11)
    now = 0.0
    tenants = ["acme", "gold", "tin", None, "a b", "spray-1", "spray-2",
               "spray-3"]
    for _ in range(300):
        now += float(g.choice([0.0, 0.05, 0.3, 1.0]))
        depth["v"] = int(g.choice([0, 10, 25, 55, 65, 85, 100]))
        stage["v"] = int(g.choice([0, 0, 0, 1, 3]))
        ten = tenants[int(g.integers(0, len(tenants)))]
        prio = PRIO_INPUTS[int(g.integers(0, len(PRIO_INPUTS)))]
        dj = ctl["jax"].admit(ten, prio, now=now)
        dt = ctl["port"].admit(ten, prio, now=now)
        assert tuple(dt) == tuple(dj)
    assert ctl["port"].snapshot() == ctl["jax"].snapshot()
    if cfg.get("enabled", True):
        assert ctl["port"].snapshot()["rejected"] > 0


# -- the brownout ladder ------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    {"dwell_s": 2.0, "hold_s": 10.0},
    {"dwell_s": 0.0, "hold_s": 3.0, "enter": [3, 1, 2],
     "exit_ratio": 0.8, "batch_max_tokens": 16},
    {"dwell_s": 0.5, "hold_s": 1.0, "enter": [1, "x", 2]},
    {"enabled": False}])
def test_brownout_ladder_matches_jax(cfg):
    """The same burn sequence under the same clock: identical stages,
    policy answers, snapshots and transition events."""
    g = np.random.default_rng(7)
    burns = np.concatenate([g.uniform(0, 6, 80), np.zeros(40),
                            g.uniform(0, 1, 40), [None, "junk", -3.0]])
    clocks = {p: FakeClock() for p in PKGS}
    recs = {p: Recorder() for p in PKGS}
    lad = {"jax": jbo.BrownoutLadder(cfg, clock=clocks["jax"],
                                     recorder=recs["jax"],
                                     registry=JaxRegistry(),
                                     replica_id="r"),
           "port": tbo.BrownoutLadder(cfg, clock=clocks["port"],
                                      recorder=recs["port"],
                                      registry=MetricsRegistry(),
                                      replica_id="r")}
    for i, burn in enumerate(burns):
        for p in PKGS:
            clocks[p].t += 0.25 + 0.5 * (i % 3 == 0)
        stages = [lad[p].observe(burn) for p in PKGS]
        assert stages[0] == stages[1]
        for prio in ("interactive", "batch", "best_effort"):
            assert lad["port"].clamp_max_tokens(prio) == \
                lad["jax"].clamp_max_tokens(prio)
        assert lad["port"].suppress_partials == lad["jax"].suppress_partials
        assert lad["port"].shed_best_effort == lad["jax"].shed_best_effort
    assert lad["port"].snapshot() == lad["jax"].snapshot()
    assert recs["port"].events == recs["jax"].events


# -- the usage meter ------------------------------------------------------------------

def _charges(meter, g):
    """A seeded sequence of charges; the device-second calls apportion
    walls that are exact in binary."""
    tenants = ["acme", "zeta", None, "", "a b", "t1", "t2", "t3", "t4"]
    for _ in range(120):
        ten = tenants[int(g.integers(0, len(tenants)))]
        k = int(g.integers(0, 7))
        if k == 0:
            meter.records(ten, int(g.integers(1, 4)))
        elif k == 1:
            meter.tokens(ten, int(g.integers(0, 9)))
        elif k == 2:
            meter.sheds(ten)
        elif k == 3:
            meter.wire_bytes(ten, int(g.integers(0, 900)))
        elif k == 4:
            rows = {tenants[int(i)]: int(g.integers(0, 4))
                    for i in g.integers(0, len(tenants), 3)}
            meter.device_seconds(rows, float(g.choice([0.0, 0.25, 0.5])))
        elif k == 5:
            meter.request_seconds(ten, float(g.choice([0.01, 0.5, 2.0])))
        else:
            meter.request_seconds_many(ten, [0.01, 0.2])


def _series(reg):
    snap = reg.snapshot()
    return {name: snap[name] for name in sorted(snap)
            if name.startswith("serving_")}


@pytest.mark.parametrize("cfg", [None, {"max_tenants": 3},
                                 {"slo_objectives": {"acme": {
                                     "latency_ms": 100.0}}},
                                 {"enabled": False}])
def test_usage_meter_matches_jax(cfg):
    """The same charges on both meters: equal drains (per-interval deltas,
    timestamps aside), snapshots and registry series, metering on and
    off."""
    regs = {"jax": JaxRegistry(), "port": MetricsRegistry()}
    meters = {"jax": jmet.UsageMeter(regs["jax"], model="m1", cfg=cfg,
                                     tenants_configured=("acme", "a b"),
                                     slo_defaults={"latency_ms": 500}),
              "port": tmet.UsageMeter(regs["port"], model="m1", cfg=cfg,
                                      tenants_configured=("acme", "a b"),
                                      slo_defaults={"latency_ms": 500})}
    drains = {}
    for p in PKGS:
        g = np.random.default_rng(13)
        _charges(meters[p], g)
        first = meters[p].drain()
        _charges(meters[p], g)
        for m in (meters[p],):
            m.slo_observe("acme", 0.2, {"predict": 0.2})
            m.slo_observe("zeta", 0.9)
        drains[p] = [first, meters[p].drain(), meters[p].drain()]
    for a, b in zip(drains["port"], drains["jax"]):
        assert [dict(r, ts=0) for r in a] == [dict(r, ts=0) for r in b]
    assert meters["port"].snapshot() == meters["jax"].snapshot()
    assert _series(regs["port"]) == _series(regs["jax"])
    assert meters["port"].resolve("acme") == meters["jax"].resolve("acme")


# -- the engines ------------------------------------------------------------------------

def _dense_pair(seed=0):
    jm = JaxSeq([jcore.Dense(NCLS, input_shape=(DIM,), activation="softmax",
                             name="head")])
    params, state = jm.init(jax.random.PRNGKey(seed), (DIM,))
    params = jax.tree.map(np.asarray, params)
    tm = Sequential([tcore.Dense(NCLS, input_shape=(DIM,),
                                 activation="softmax", name="head")])
    load_jax_params(tm, params)
    return {"jax": JaxIM().do_load_model(jm, params, state),
            "port": InferenceModel(device="cpu").do_load_model(tm)}


def _engine(pkg, models, queue, **params):
    p = dict(batch_size=4, poll_timeout_s=0.02, write_backoff_s=0.01,
             worker_backoff_s=0.01, replica_id=f"r-{pkg}-{next(_IDS)}")
    p.update(params)
    return ENG[pkg].ClusterServing(models[pkg], queue,
                                   ENG[pkg].ServingParams(**p))


def _b64(vec):
    return base64.b64encode(np.asarray(vec, "<f4").tobytes()).decode()


def _serve_all(s, max_rounds=50):
    for _ in range(max_rounds):
        if not s.serve_once():
            return


def _usage(s):
    """Per-tenant usage totals without the measured seconds."""
    return {t: {k: v for k, v in d.items() if k != "device_s"}
            for t, d in s.meter.snapshot()["tenants"].items()}


@pytest.fixture(scope="module")
def dense():
    return _dense_pair()


def test_engine_priority_shed_order_matches_jax(dense):
    """Pinned at pressure level 1, both engines shed best-effort AT CLAIM,
    interactive first in the claim order, with the same markers and the
    same sheds billed to each tenant."""
    out = {}
    for pkg in PKGS:
        q = QUEUES[pkg].InProcQueue()
        s = _engine(pkg, dense, q, admission={}, brownout={})
        s._pressure_level = lambda: 1
        for i, prio in enumerate(["best_effort", "interactive", "batch",
                                  "best_effort", None]):
            q.xadd({"uri": f"p{i}", "b64": _b64([0.1 * i] * DIM),
                    "dtype": "<f4", "shape": [DIM], "priority": prio,
                    "tenant": "acme" if i % 2 else "zeta"})
        _serve_all(s)
        res = {f"p{i}": q.get_result(f"p{i}") for i in range(5)}
        out[pkg] = ({rid: r.get("error") for rid, r in res.items()},
                    {rid: [c for c, _ in r["value"]] for rid, r in
                     res.items() if "value" in r}, s.shed, _usage(s))
        s.shutdown()
    assert out["port"] == out["jax"]
    assert sum(e is not None for e in out["port"][0].values()) == 2


def test_engine_unarmoured_never_sheds_by_priority(dense):
    for pkg in PKGS:
        q = QUEUES[pkg].InProcQueue()
        s = _engine(pkg, dense, q)
        s._pressure_level = lambda: 2
        q.xadd({"uri": "legacy", "b64": _b64([0.1] * DIM), "dtype": "<f4",
                "shape": [DIM], "priority": "best_effort"})
        _serve_all(s)
        assert "value" in q.get_result("legacy"), pkg
        s.shutdown()


def test_engine_deadline_early_drop_matches_jax(dense):
    out = {}
    for pkg in PKGS:
        q = QUEUES[pkg].InProcQueue()
        s = _engine(pkg, dense, q, admission={})
        s._predict_ewma_s = 5.0
        now = time.time_ns()
        q.xadd({"uri": "doomed", "b64": _b64([0.1] * DIM), "dtype": "<f4",
                "shape": [DIM], "deadline_ns": now + int(2e9),
                "tenant": "acme"})
        q.xadd({"uri": "roomy", "b64": _b64([0.1] * DIM), "dtype": "<f4",
                "shape": [DIM], "deadline_ns": now + int(600e9)})
        _serve_all(s)
        out[pkg] = (q.get_result("doomed").get("error"),
                    "value" in q.get_result("roomy"), _usage(s))
        s.shutdown()
    assert out["port"] == out["jax"]
    assert "deadline-unmeetable" in out["port"][0]


def test_engine_bills_sheds_quarantines_and_bytes_like_jax(dense):
    """Expired, poisoned, legacy and two tenants' records: the same usage
    totals (records, tokens, bytes, sheds) by tenant, the same labelled
    series, results carrying their tenant."""
    out = {}
    for pkg in PKGS:
        q = QUEUES[pkg].InProcQueue()
        s = _engine(pkg, dense, q, serving_slo={"latency_ms": 500})
        for i in range(5):
            q.xadd({"uri": f"a{i}", "data": [0.1] * DIM, "tenant": "acme"})
        for i in range(3):
            q.xadd({"uri": f"z{i}", "b64": _b64([0.2] * DIM),
                    "dtype": "<f4", "shape": [DIM], "tenant": "zeta"})
        q.xadd({"uri": "legacy", "data": [0.3] * DIM})
        q.xadd({"uri": "doomed", "data": [0.1] * DIM, "tenant": "acme",
                "deadline_ns": 1})
        q.xadd({"uri": "bad", "b64": "!!!not-base64!!!", "dtype": "<f4",
                "tenant": "zeta"})
        _serve_all(s)
        reg = s.registry.snapshot()
        series = {name: sorted((tuple(sorted(v["labels"].items())),
                                v.get("value"), v.get("count"))
                               for v in reg[name]["values"])
                  for name in ("serving_records_total",
                               "serving_sheds_total",
                               "serving_generated_tokens_total")}
        tenants = {rid: q.get_result(rid).get("tenant")
                   for rid in ("a0", "z0", "legacy", "bad")}
        out[pkg] = (_usage(s), series, tenants, s.shed, s.dead_lettered)
        s.shutdown()
    assert out["port"] == out["jax"]
    usage = out["port"][0]
    assert usage["acme"]["records"] == 5 and usage["acme"]["sheds"] == 1
    assert usage["zeta"]["sheds"] == 1 and usage["unknown"]["records"] == 1


def test_engine_device_seconds_conserve_the_predict_walls(dense):
    """Σ tenant device seconds == the measured predict walls, in both
    packages."""
    for pkg in PKGS:
        q = QUEUES[pkg].InProcQueue()
        s = _engine(pkg, dense, q)
        for i in range(10):
            q.xadd({"uri": f"a{i}", "data": [0.1] * DIM, "tenant": "acme"})
            q.xadd({"uri": f"z{i}", "data": [0.2] * DIM, "tenant": "zeta"})
        _serve_all(s)
        usage = s.health()["usage"]["tenants"]
        busy = s.registry.histogram("serving_stage_seconds",
                                    labels=("stage",)).labels(
            stage="predict").sum
        assert sum(v["device_s"] for v in usage.values()) == \
            pytest.approx(busy, rel=1e-4, abs=1e-5), pkg
        assert usage["acme"]["device_s"] > 0 and usage["zeta"]["device_s"] > 0
        s.shutdown()


def test_engine_metering_off_matches_jax(dense):
    out = {}
    for pkg in PKGS:
        q = QUEUES[pkg].InProcQueue()
        s = _engine(pkg, dense, q, metering=False)
        for i in range(6):
            q.xadd({"uri": f"r{i}", "data": [0.1] * DIM, "tenant": "acme"})
        _serve_all(s)
        out[pkg] = (s.registry.counter("serving_records_total").value,
                    s.drain_usage(), s.health()["usage"])
        s.shutdown()
    assert out["port"] == out["jax"]
    assert out["port"][0] == 6 and out["port"][2]["enabled"] is False


def test_engine_health_and_metrics_blocks_match_jax(dense):
    docs = {}
    for pkg in PKGS:
        s = _engine(pkg, dense, QUEUES[pkg].InProcQueue(),
                    admission={"rate": 50.0, "tenants": {"acme": {}}},
                    brownout={}, serving_slo={"latency_ms": 1000.0,
                                              "window_s": 5.0,
                                              "target": 0.9})
        d = s.admit_record("acme", "interactive")
        assert d.admitted and d.tenant == "acme"
        h = s.health()
        m = s.metrics_from_health(h)
        docs[pkg] = (h["admission"], {k: v for k, v in h["brownout"].items()
                                      if k != "in_stage_s"},
                     h["usage"], {k: m[k] for k in
                                  ("admitted", "rejected", "brownout_stage")},
                     h["knobs"])
        s.shutdown()
    assert docs["port"] == docs["jax"]


@pytest.mark.parametrize("kw", [
    dict(max_batch=100, max_wait_ms=-3, preprocess_workers=500,
         inflight_batches=9),
    dict(max_batch=0, preprocess_workers=0, inflight_batches=0),
    dict(max_batch=5000, max_wait_ms=2.5),
    dict(max_batch=3)])
def test_retune_and_knobs_validation_match_jax(dense, kw):
    """``retune`` clamps to the same targets (the pow-2 ladder under the
    model's ceiling, the concurrency contract, the pool cap); ``knobs``
    shows them pending, and the batch boundary applies them with a
    ``retune`` event."""
    out = {}
    for pkg in PKGS:
        s = _engine(pkg, dense, QUEUES[pkg].InProcQueue(),
                    max_batch=16, preprocess_workers=2)
        staged = s.retune(**kw)
        pending = s.knobs()
        s._apply_pending_knobs()
        p = s.params
        ev = [e for e in s.recorder.events("retune")
              if e.get("replica") == s.replica_id][-1]
        out[pkg] = (staged, pending, s.knobs(),
                    (p.max_batch, p.max_wait_ms, p.preprocess_workers,
                     p.inflight_batches),
                    {k: v for k, v in ev.items()
                     if k not in ("ts", "replica")})
        s.shutdown()
    assert out["port"] == out["jax"]


def test_admission_fault_rejects_through_the_gate_like_jax(dense):
    """An armed ``admission_reject`` fires in the gate: the next
    best-effort requests are rejected with reason "fault", then the point
    disarms; the rejections ride the flight recorder."""
    out = {}
    for pkg in PKGS:
        s = _engine(pkg, dense, QUEUES[pkg].InProcQueue(),
                    admission={"rate": 1e6, "burst": 1e6},
                    faults={"admission_reject": {
                        "version": "*", "count": 2,
                        "priority": "best_effort"}})
        ds = [tuple(s.admit_record("t", prio)) for prio in
              ("batch", "best_effort", "best_effort", "best_effort")]
        ev = [e["reason"] for e in s.recorder.events("admission_reject")
              if e.get("replica") == s.replica_id]
        out[pkg] = (ds, ev, s.health()["admission"]["rejected_by_reason"])
        s.shutdown()
    assert out["port"] == out["jax"]
    assert [d[0] for d in out["port"][0]] == [True, False, False, True]


# -- generation: tokens by tenant, the brownout clamp ---------------------------------

GEO = dict(vocab_size=48, hidden=32, n_head=4, n_layers=2, max_len=64)
GEN = dict(paged=True, block_len=8, max_active_slots=4, max_tokens=12,
           max_prompt_len=16, stream_interval=2, decode_quantum=2)


@pytest.fixture(scope="module")
def lms():
    jlm = JaxLM(**GEO)
    params = jlm.build(jax.random.PRNGKey(2))
    tlm = TransformerLM(**GEO, device="cpu")
    load_jax_params(tlm, jax.tree.map(np.asarray, params))
    return {"jax": JaxIM().do_load_model(jlm, params, {}),
            "port": InferenceModel(device="cpu").do_load_model(tlm)}


def _gen_records(q, clamp_stage):
    recs = [("ga", [3, 9, 27, 4], "acme", "batch", 6),
            ("gz", [11, 2], "zeta", "interactive", None),
            ("gb", [7, 7, 7, 1, 2], "acme", "batch", None),
            ("gl", [5, 6], None, None, 4)]
    for rid, prompt, ten, prio, mt in recs:
        rec = {"uri": rid, "b64": _b64(prompt), "dtype": "<f4",
               "shape": [len(prompt)]}
        if ten:
            rec["tenant"] = ten
        if prio:
            rec["priority"] = prio
        if mt:
            rec["gen"] = {"max_tokens": mt}
        q.xadd(rec)
    return [r[0] for r in recs]


@pytest.mark.parametrize("stage", [0, 2])
def test_generation_tokens_by_tenant_and_clamp_match_jax(lms, stage):
    """Both engines over the same weights and records: equal tokens, the
    same tokens charged to each tenant at the decode boundaries (the
    prefill's first token outside them, in both), and at brownout stage 2
    the batch records clamped to ``batch_max_tokens`` (interactive ones
    keep their budget) with no partial written."""
    out = {}
    for pkg in PKGS:
        q = QUEUES[pkg].InProcQueue()
        s = ENG[pkg].ClusterServing(lms[pkg], q, ENG[pkg].ServingParams(
            max_batch=8, max_wait_ms=2.0, generation=GEN,
            brownout={"batch_max_tokens": 5},
            replica_id=f"g-{pkg}-{next(_IDS)}"))
        partials = []
        real = q.put_partial

        def put_partial(rid, value, real=real):
            partials.append(rid)
            return real(rid, value)

        q.put_partial = put_partial
        s._brownout.stage = stage
        rids = _gen_records(q, stage)
        _serve_all(s)
        res = {rid: q.get_result(rid) for rid in rids}
        out[pkg] = ({rid: (r["value"]["tokens"], r.get("tenant"))
                     for rid, r in res.items()}, _usage(s),
                    sorted(set(partials)))
        s.shutdown()
    assert out["port"] == out["jax"]
    toks, usage, partials = out["port"]
    lengths = {rid: len(t) for rid, (t, _) in toks.items()}
    if stage == 2:
        assert lengths == {"ga": 5, "gz": 12, "gb": 5, "gl": 4}
        assert partials == []
    else:
        assert lengths == {"ga": 6, "gz": 12, "gb": 12, "gl": 4}
        assert partials
    assert usage["acme"]["tokens"] == lengths["ga"] + lengths["gb"] - 2
    assert usage["zeta"]["tokens"] == lengths["gz"] - 1
    assert usage["unknown"]["tokens"] == lengths["gl"] - 1
