"""PyTorch port: the lifecycle manager, ``python -m
analytics_zoo_tpu_torch.serving.manager``, against the JAX package on the
CPU (``model.device: cpu``, ephemeral ports, tiny models).

- The config surface: ``load_config`` / ``serving_params`` /
  ``detect_model_type`` / ``build_queue`` as the JAX manager's; the
  bridges' model types raise naming ROADMAP item 10, sharding item 7's second part; a
  compile cache path raises and ``off`` is accepted; ``model.device``
  picks the device (none on a CPU-only host raises).
- ``serve_from_config`` over a JAX-written ``.npz`` and a port topology
  predicts what the JAX model predicts; from the weight store with a
  replica identity, a port offset and a model version.
- The actions in process: ``warmup`` exports the store (quantized first:
  an int8 store restores to the in-process int8 forward bit for bit) and
  skips it the second time; ``publish`` / ``versions`` / ``warmup
  --version``; ``metrics`` (JSON and Prometheus), ``profile``, ``health``,
  ``replay``, ``trace``, ``usage`` and ``incident``; ``rollout`` and
  ``scale`` refuse without a supervisor.
- Real processes: a ``start --foreground`` / ``status`` / ``stop`` cycle;
  a two-replica supervisor with the load balancer and the autoscaler
  that serves through the LB, respawns a SIGKILLed replica, scales up and
  down, rolls out a published v2 through its canary, and whose own
  process calls no CUDA function (the replicas fork clean); and the JAX
  package's two-replica SIGKILL test: a generation killed mid-decode by
  its armed fault resumes on the survivor or the respawn token-exactly,
  with no failed client request and the crash's incident bundle holding
  both owners' checkpoints and the resume.
"""

import base64
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.nn import Sequential as JaxSeq
from analytics_zoo_tpu.nn.layers import Dense as JaxDense
from analytics_zoo_tpu.serving import manager as jmanager
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.inference import weightstore
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
from analytics_zoo_tpu_torch.serving import manager
from analytics_zoo_tpu_torch.serving import tracecollect
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.generate import (ContinuousBatcher,
                                                      GenerationParams,
                                                      GenRequest)
from analytics_zoo_tpu_torch.serving.queues import FileQueue

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MGR = [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.manager"]
DIN, NOUT = 4, 3
LM = dict(vocab_size=48, hidden=32, n_head=4, n_layers=2, max_len=64)
GEN = {"paged": True, "block_len": 8, "max_active_slots": 4,
       "max_tokens": 24, "max_prompt_len": 16, "stream_interval": 4,
       "decode_quantum": 4, "checkpoint_interval": 4, "resume": True}
PROMPT = [5, 1, 8, 3]


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved_j, saved_t = dict(jdtypes._policy), dict(tdtypes._policy)
    jdtypes.set_policy(None)
    tdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved_j)
    tdtypes._policy.update(saved_t)


def _env():
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(cond, timeout_s, step=0.1):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def _http(url, data=None, timeout=10, method=None):
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _pid(path):
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def _alive(pid):
    if pid is None:
        return False
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def _stop(tmp_path, pidfile, proc, timeout=60):
    """``manager stop`` while this process reaps ``proc`` (the stop
    action polls the pid, and an unreaped child would linger as a zombie
    for its whole wait).  Returns the stop action's JSON."""
    stop = subprocess.Popen(MGR + ["stop", "--pidfile", pidfile],
                            cwd=str(tmp_path), env=_env(),
                            stdout=subprocess.PIPE, text=True)
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
    out, _ = stop.communicate(timeout=60)
    return json.loads(out.strip().splitlines()[-1]) if out.strip() else None


def _main(capsys, *argv):
    """One in-process CLI action: (exit code, the JSON it printed)."""
    rc = manager.main(list(argv))
    out = capsys.readouterr()
    lines = [ln for ln in (out.out or out.err).splitlines()
             if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None)


def _zoo_model(tmp_path, seed=0, name="weights.npz"):
    """A JAX-written ``.npz`` and a port topology of the same model (layer
    named ``d0``, as the JAX lifecycle test's)."""
    m = JaxSeq()
    m.add(JaxDense(NOUT, activation="softmax", input_shape=(DIN,),
                   name="d0"))
    import jax
    m.init_weights(jax.random.PRNGKey(seed))
    weights = tmp_path / name
    m.save_weights(str(weights))
    topo = tmp_path / "topology.py"
    topo.write_text(
        "from analytics_zoo_tpu_torch.nn.models import Sequential\n"
        "from analytics_zoo_tpu_torch.nn.layers.core import Dense\n"
        "def build_model():\n"
        "    m = Sequential()\n"
        "    m.add(Dense(3, activation='softmax', input_shape=(4,),"
        " name='d0'))\n"
        "    return m\n")
    return m, weights, topo


def _lm_model(tmp_path, seed=1):
    """A port ``TransformerLM`` ``.npz`` and its topology (built on the
    CPU; the config's ``model.device`` places it)."""
    lm = TransformerLM(**LM, seed=seed, device="cpu")
    weights = tmp_path / "lm.npz"
    lm.save_weights(str(weights))
    topo = tmp_path / "lm_topology.py"
    topo.write_text(
        "from analytics_zoo_tpu_torch.models.textmodels import "
        "TransformerLM\n"
        "def build_model():\n"
        f"    return TransformerLM(**{LM!r}, device='cpu')\n")
    return lm, weights, topo


def _config(tmp_path, weights, topo, params="", extra="", name="config"):
    cfg = tmp_path / f"{name}.yaml"
    cfg.write_text(
        f"model:\n  path: {weights}\n  type: zoo\n  topology: {topo}\n"
        "  device: cpu\n"
        f"data:\n  src: file:{tmp_path / 'queue'}\n"
        "params:\n  batch_size: 4\n" + params + extra)
    return str(cfg)


def _golden(lm, prompt=PROMPT):
    b = ContinuousBatcher(InferenceModel(device="cpu").do_load_model(lm),
                          GenerationParams(**GEN))
    b.submit(GenRequest("g", np.asarray(prompt, np.float32)))
    for _ in range(500):
        for ev in b.step():
            if ev.kind == "finish":
                return list(ev.tokens)
    raise AssertionError("no finish")


def _enqueue(queue, rid, tokens, tenant=None, trace_id=None):
    arr = np.ascontiguousarray(np.asarray(tokens, "<f4"))
    rec = {"uri": rid, "b64": base64.b64encode(arr).decode("ascii"),
           "dtype": "<f4", "shape": list(arr.shape)}
    if tenant is not None:
        rec["tenant"] = tenant
    if trace_id is not None:
        rec["trace_id"] = trace_id
    queue.xadd(rec)


# -- the config surface ----------------------------------------------------------------

def test_config_parsing_and_model_autodetect(tmp_path):
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(
        "model:\n  path: m.onnx\n  device: cpu\ndata:\n  src: file:/tmp/q\n"
        "params:\n  batch_size: 8\n  top_n: 3\n  filter_threshold: 0.5\n"
        "  compile_cache_dir: off\n")
    cfg = manager.load_config(str(cfg_path))
    assert cfg == jmanager.load_config(str(cfg_path))
    p = manager.serving_params(cfg)
    assert (p.batch_size, p.top_n, p.filter_threshold) == (8, 3, 0.5)
    d = tmp_path / "saved"
    d.mkdir()
    (d / "saved_model.pb").write_bytes(b"")
    for path in ("x.onnx", "x.pt", "x.pth", "w.npz", str(d)):
        assert manager.detect_model_type(path) == \
            jmanager.detect_model_type(path)
    with pytest.raises(ValueError, match="autodetect"):
        manager.detect_model_type("mystery.bin")
    with pytest.raises(ValueError, match="autodetect"):
        manager.detect_model_type(str(tmp_path))


def test_build_queue_variants(tmp_path):
    from analytics_zoo_tpu_torch.serving.queues import InProcQueue
    q = manager.build_queue({"data": {"src": f"file:{tmp_path}/q",
                                      "max_depth": 7}})
    assert isinstance(q, FileQueue)
    assert isinstance(manager.build_queue({"data": {"src": "inproc"}}),
                      InProcQueue)


def test_load_model_bridges_device_and_unported_params(tmp_path):
    for path, mtype in (("m.onnx", None), ("m.pt", None),
                        (str(tmp_path), "tensorflow")):
        cfg = {"model": {"path": path, "type": mtype, "device": "cpu"}}
        with pytest.raises(NotImplementedError, match="item 10"):
            manager.load_model(cfg)
    with pytest.raises(ValueError, match="model.path"):
        manager.load_model({"model": {}})
    with pytest.raises(ValueError, match="topology"):
        manager.load_model({"model": {"path": "w.npz", "device": "cpu"}})
    with pytest.raises(ValueError, match="unknown model type"):
        manager.load_model({"model": {"path": "w.npz", "type": "caffe",
                                      "device": "cpu"}})
    _, weights, topo = _zoo_model(tmp_path)
    cfg = {"model": {"path": str(weights), "topology": str(topo)}}
    if not torch.cuda.is_available():
        # no model.device means cuda:0, which is absent here
        with pytest.raises(RuntimeError, match="no CUDA device"):
            manager.load_model(cfg)
    cfg["model"]["device"] = "cpu"
    im = manager.load_model(cfg)
    assert im.device == torch.device("cpu") and im.load_mmap is False
    for key, val in (("sharding", "auto"), ("mesh_shape", [1, 2])):
        with pytest.raises(NotImplementedError,
                           match="item 7's second part"):
            manager.serving_params({"params": {key: val}})
    with pytest.raises(NotImplementedError, match="compile"):
        manager.serving_params({"params": {"compile_cache_dir": "/x"}})
    assert manager._resolve_cache_dir(
        manager.serving_params({"params": {"compile_cache_dir": "off"}}),
        "cs.pid") is None


def test_serve_from_config_end_to_end(tmp_path):
    jm, weights, topo = _zoo_model(tmp_path)
    cfg = _config(tmp_path, weights, topo, "  top_n: 3\n")
    serving = manager.serve_from_config(cfg)
    serving.start()
    try:
        client_q = FileQueue(str(tmp_path / "queue"))
        x = np.asarray([0.5, -1.0, 2.0, 0.25], np.float32)
        rid = InputQueue(client_q).enqueue_tensor("r0", x)
        res = OutputQueue(client_q).query(rid, timeout_s=30)
        assert res is not None and len(res["value"]) == 3
        want = np.asarray(jm.predict(x[None]))[0]
        got = dict((int(c), p) for c, p in res["value"])
        assert sorted(got) == list(range(NOUT))
        for c in range(NOUT):
            assert abs(got[c] - float(want[c])) < 1e-6
    finally:
        serving.shutdown()
    # from the deployment's weight store, with a supervisor's identity
    store = str(tmp_path / "cs.pid.weights")
    im = manager.load_model(manager.load_config(cfg))
    weightstore.save_store(store, {"params": im._params,
                                   "state": im._state})
    port = _free_port()
    cfg2 = _config(tmp_path, weights, topo, f"  http_port: {port}\n",
                   name="config2")
    serving = manager.serve_from_config(
        cfg2, replica_id="replica-3", http_port_offset=1,
        weight_store=store, model_version="v7")
    try:
        assert serving.model.load_mmap is True
        assert serving.params.http_port == port + 1
        assert serving.replica_id == "replica-3"
        h = serving.health()
        assert h["model_version"] == "v7" and h["load"]["mmap"] is True
        assert h["load"]["nvcc"] == []
    finally:
        serving.shutdown()
    with pytest.raises(NotImplementedError):
        manager.serve_from_config(cfg, cache_dir="/somewhere")


# -- the actions, in process -------------------------------------------------------------

def test_warmup_exports_store_then_skips(tmp_path, capsys):
    _, weights, topo = _zoo_model(tmp_path)
    cfg = _config(tmp_path, weights, topo, "  warmup: true\n")
    pidfile = str(tmp_path / "cs.pid")
    rc, doc = _main(capsys, "warmup", "-c", cfg, "--pidfile", pidfile)
    assert rc == 0, doc
    assert doc["store_exported"] is True and doc["cache_dir"] is None
    assert doc["load_mmap"] is False and doc["failed"] == 0
    assert doc["programs"] > 0 and doc["quantized_bits"] == 0
    assert doc["kernels_built"] == []
    assert weightstore.is_store(pidfile + ".weights")
    rc, doc = _main(capsys, "warmup", "-c", cfg, "--pidfile", pidfile)
    assert rc == 0 and doc["store_exported"] is False
    assert doc["load_mmap"] is True
    # the JAX manager's warmup document has the same keys
    assert {"cache_dir", "weight_store", "store_exported", "load_seconds",
            "load_mmap", "quantized_bits", "programs", "compiled",
            "skipped", "failed"} <= set(doc)


def test_warmup_quantized_store_restores_bitwise(tmp_path, capsys):
    _, weights, topo = _zoo_model(tmp_path)
    calib = tmp_path / "calib.npy"
    x = np.random.default_rng(0).normal(size=(16, DIN)).astype(np.float32)
    np.save(calib, x)
    cfg = _config(tmp_path, weights, topo,
                  f"  quantize:\n    bits: 8\n    calib: {calib}\n")
    pidfile = str(tmp_path / "cs.pid")
    rc, doc = _main(capsys, "warmup", "-c", cfg, "--pidfile", pidfile)
    assert rc == 0 and doc["quantized_bits"] == 8 and doc["store_exported"]
    rc, doc = _main(capsys, "warmup", "-c", cfg, "--pidfile", pidfile)
    assert rc == 0 and doc["store_exported"] is False
    assert doc["quantized_bits"] == 8 and doc["load_mmap"] is True
    # the replica's load: the store, mapped, int8 already
    conf = manager.load_config(cfg)
    im = manager.load_model(conf, weight_store=pidfile + ".weights")
    assert im.load_mmap
    # the same model quantized in process on the same calibration batch
    ref = manager.load_model(conf)
    ref.do_quantize(x, force=True, bits=8)
    probe = np.random.default_rng(1).normal(size=(9, DIN)).astype(
        np.float32)
    np.testing.assert_array_equal(im.do_predict(probe),
                                  ref.do_predict(probe))


def test_publish_versions_and_version_warmup(tmp_path, capsys):
    _, weights, topo = _zoo_model(tmp_path)
    _, weights2, _ = _zoo_model(tmp_path, seed=5, name="weights2.npz")
    cfg1 = _config(tmp_path, weights, topo, "  warmup: true\n")
    cfg2 = _config(tmp_path, weights2, topo, "  warmup: true\n",
                   name="config2")
    pidfile = str(tmp_path / "cs.pid")
    rc, doc = _main(capsys, "publish", "-c", cfg1, "--pidfile", pidfile)
    assert rc == 1 and "version name" in doc["error"]
    rc, d1 = _main(capsys, "publish", "v1", "-c", cfg1, "--pidfile", pidfile)
    assert rc == 0 and d1["published"] == "v1" and d1["latest"] == "v1"
    rc, d2 = _main(capsys, "publish", "v2", "-c", cfg2, "--pidfile", pidfile)
    assert rc == 0 and d2["fingerprint"] != d1["fingerprint"]
    rc, doc = _main(capsys, "publish", "v1", "-c", cfg2, "--pidfile", pidfile)
    assert rc == 1 and "immutable" in doc["error"]
    rc, doc = _main(capsys, "versions", "-c", cfg1, "--pidfile", pidfile)
    assert [v["version"] for v in doc["versions"]] == ["v1", "v2"]
    assert doc["latest"] == "v2"
    # the JAX manager lists the same registry
    assert jmanager.main(["versions", "-c", cfg1, "--pidfile", pidfile]) == 0
    jdoc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jdoc == doc
    rc, doc = _main(capsys, "warmup", "-c", cfg1, "--pidfile", pidfile,
                    "--version", "v1")
    assert rc == 0 and doc["version"] == "v1" and doc["load_mmap"]
    assert doc["failed"] == 0
    rc, doc = _main(capsys, "warmup", "-c", cfg1, "--pidfile", pidfile,
                    "--version", "v9")
    assert rc == 1 and "not found" in doc["error"]
    # rollout and scale need a running supervisor
    rc, doc = _main(capsys, "rollout", "v2", "-c", cfg1, "--pidfile",
                    pidfile)
    assert rc == 1 and "not running" in doc["error"]
    rc, doc = _main(capsys, "scale", "2", "--pidfile", pidfile)
    assert rc == 1 and "not running" in doc["error"]


def test_metrics_profile_health_replay_trace_usage(tmp_path, capsys):
    _, weights, topo = _zoo_model(tmp_path)
    cfg0 = _config(tmp_path, weights, topo)
    serving = manager.serve_from_config(cfg0)
    pidfile = str(tmp_path / "cs.pid")
    rc, doc = _main(capsys, "health", "--pidfile", pidfile)
    assert rc == 1 and "no health snapshot" in doc["error"]
    from analytics_zoo_tpu_torch.serving.engine import ServingParams
    serving.params = ServingParams(batch_size=4, http_port=0)
    serving.start()
    try:
        port = serving._http.port
        cfg = _config(tmp_path, weights, topo, f"  http_port: {port}\n",
                      name="probe")
        rc = manager.main(["metrics", "-c", cfg, "--prom", "--pidfile",
                           pidfile])
        out = capsys.readouterr().out
        assert rc == 0 and "serving_heartbeat_age_seconds" in out
        rc, doc = _main(capsys, "metrics", "-c", cfg, "--pidfile", pidfile)
        assert rc == 0 and "served" in doc or "records" in json.dumps(doc)
        rc, doc = _main(capsys, "profile", "0", "-c", cfg, "--pidfile",
                        pidfile, "--seconds", "0.2")
        assert rc == 0, doc
        rc, doc = _main(capsys, "profile", "x", "-c", cfg, "--pidfile",
                        pidfile)
        assert rc == 1 and "replica index" in doc["error"]
        manager._write_health(serving, manager._health_path(pidfile))
        with open(pidfile, "w") as f:
            f.write(str(os.getpid()))
        rc, doc = _main(capsys, "health", "--pidfile", pidfile)
        assert rc == 0 and doc["running"] is True
        rc, doc = _main(capsys, "status", "--pidfile", pidfile)
        assert doc["running"] is True and doc["health"]["running"] is True
    finally:
        serving.shutdown()
    os.unlink(pidfile)
    rc, doc = _main(capsys, "replay", "-c", cfg0, "--pidfile", pidfile)
    assert rc == 0 and doc["replayed"] == 0
    rc, doc = _main(capsys, "trace", "--slowest", "3", "-c", cfg0,
                    "--pidfile", pidfile)
    assert rc == 1 and "no span spools" in doc["error"]
    tracecollect.append_spans(
        tracecollect.spool_path(pidfile + ".r0"),
        [{"trace_id": "t1", "uri": "u1", "stage": "predict", "ts": 1.0,
          "dur_s": 0.01}], source="replica-0")
    rc, doc = _main(capsys, "trace", "t1", "-c", cfg0, "--pidfile", pidfile)
    assert rc == 0 and doc["found"] is True
    rc, doc = _main(capsys, "usage", "--json", "--pidfile", pidfile)
    assert rc == 1 and "no usage journals" in doc["error"]


def test_incident_actions(tmp_path, capsys):
    base = str(tmp_path / "cs.pid")
    rc, doc = _main(capsys, "incident", "--pidfile", base)
    assert rc == 1 and "nothing to capture" in doc["error"]
    tracecollect.append_events(
        tracecollect.events_path(base + ".r0"),
        [{"event": "start", "ts": 0.5},
         {"event": "quarantine", "ts": 1.1, "rid": "u9",
          "error": "poison"}], source="replica-0")
    tracecollect.append_events(
        tracecollect.events_path(base),
        [{"event": "replica_exit", "ts": 1.2, "index": 0}],
        source="supervisor")
    rc, doc = _main(capsys, "incident", "--pidfile", base)
    assert rc == 0 and doc["captured"] is True
    rc, doc = _main(capsys, "incident", "--list", "--pidfile", base)
    assert [b["reason"] for b in doc["incidents"]] == ["operator"]
    rc, doc = _main(capsys, "incident", "--show", "--pidfile", base)
    assert rc == 0 and doc["reason"] == "operator"
    assert [e["what"] for e in doc["timeline"]] == \
        ["start", "quarantine", "replica_exit"]
    rc, doc = _main(capsys, "incident", "--show", "nope", "--pidfile",
                    base)
    assert rc == 1


# -- real processes ----------------------------------------------------------------------

def test_cli_start_stop_cycle(tmp_path):
    _, weights, topo = _zoo_model(tmp_path)
    cfg = _config(tmp_path, weights, topo)
    pidfile = str(tmp_path / "cs.pid")
    proc = subprocess.Popen(MGR + ["start", "-c", cfg, "--pidfile", pidfile,
                                   "--foreground"],
                            cwd=str(tmp_path), env=_env())
    try:
        assert _wait(lambda: os.path.exists(pidfile + ".health.json"), 60)
        r = subprocess.run(MGR + ["status", "--pidfile", pidfile],
                           cwd=str(tmp_path), env=_env(),
                           capture_output=True, text=True)
        doc = json.loads(r.stdout)
        assert doc["running"] is True and doc["health"]["running"] is True
        client_q = FileQueue(str(tmp_path / "queue"))
        rid = InputQueue(client_q).enqueue_tensor("r0",
                                                  np.ones(4, np.float32))
        res = OutputQueue(client_q).query(rid, timeout_s=30)
        assert res is not None and not OutputQueue.is_error(res)
        assert _stop(tmp_path, pidfile, proc) == {"stopped": True}
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    assert not os.path.exists(pidfile)
    assert not os.path.exists(pidfile + ".health.json")


# records every CUDA entry point a process calls (pid and name), and the
# supervisor's torch.cuda.is_initialized() as it exits
_CUDA_PROBE = """
import atexit, json, os, sys
import torch
log = sys.argv[1]
for name in ("is_available", "device_count", "init", "_lazy_init",
             "current_device", "synchronize", "set_device"):
    orig = getattr(torch.cuda, name)
    def wrapped(*a, _orig=orig, _name=name, **k):
        with open(log, "a") as f:
            f.write(f"{os.getpid()} {_name}\\n")
        return _orig(*a, **k)
    setattr(torch.cuda, name, wrapped)
me = os.getpid()
def report():
    if os.getpid() == me:
        with open(log + ".exit", "w") as f:
            json.dump({"pid": me,
                       "initialized": torch.cuda.is_initialized()}, f)
atexit.register(report)
from analytics_zoo_tpu_torch.serving import manager
sys.exit(manager.main(sys.argv[2:]))
"""


def test_supervisor_lb_respawn_scale_rollout_cuda_free(tmp_path, capsys):
    _, weights, topo = _zoo_model(tmp_path)
    _, weights2, _ = _zoo_model(tmp_path, seed=5, name="weights2.npz")
    port, lb_port = _free_port(), _free_port()
    params = (f"  http_port: {port}\n  drain_s: 1\n  lease_s: 1\n"
              "  reclaim_interval_s: 0.2\n")
    extra = ("rollout:\n  canary_dwell_s: 0.5\n  ready_timeout_s: 60\n"
             "autoscaler:\n  min_replicas: 1\n  max_replicas: 3\n"
             "  dwell_up_s: 600\n  dwell_down_s: 600\n"
             "  heartbeat_stale_s: 600\n")
    cfg = _config(tmp_path, weights, topo, params, extra)
    cfg2 = _config(tmp_path, weights2, topo, params, extra, name="config2")
    pidfile = str(tmp_path / "cs.pid")
    # two published versions; the fleet starts at the latest but one
    assert _main(capsys, "publish", "v1", "-c", cfg, "--pidfile",
                 pidfile)[0] == 0
    assert _main(capsys, "publish", "v2", "-c", cfg2, "--pidfile",
                 pidfile)[0] == 0
    from analytics_zoo_tpu_torch.serving import registry
    registry.set_latest(pidfile + ".registry", "v1")
    probe = tmp_path / "cuda_probe.py"
    probe.write_text(_CUDA_PROBE)
    log = str(tmp_path / "cuda_calls.log")
    sup_log = open(tmp_path / "supervisor.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(probe), log, "start", "-c", cfg, "--pidfile",
         pidfile, "--replicas", "2", "--lb-port", str(lb_port),
         "--autoscale", "--foreground"],
        cwd=str(tmp_path), env=_env(), stdout=sup_log,
        stderr=subprocess.STDOUT)

    def status():
        r = subprocess.run(MGR + ["status", "--pidfile", pidfile],
                           cwd=str(tmp_path), env=_env(),
                           capture_output=True, text=True)
        return json.loads(r.stdout)

    def ready(i):
        try:
            return _http(f"http://127.0.0.1:{port + i}/readyz",
                         timeout=2)[0] == 200
        except OSError:
            return False

    def log_tail():
        with open(tmp_path / "supervisor.log") as f:
            return f.read()[-3000:]

    def served(uri):
        x = np.ones(4, np.float32)
        code, doc, hdrs = _http(
            f"http://127.0.0.1:{lb_port}/v1/enqueue",
            data=json.dumps({"uri": uri, "b64": base64.b64encode(
                x).decode(), "dtype": "<f4", "shape": [4]}).encode())
        assert code == 200, doc
        code, doc, hdrs = _http(
            f"http://127.0.0.1:{lb_port}/v1/result/{uri}?timeout_s=20",
            timeout=30)
        assert code == 200 and "value" in doc, doc
        return doc

    try:
        assert _wait(lambda: ready(0) and ready(1), 90, 0.2), log_tail()
        assert served("a0")["model_version"] == "v1"
        st = status()
        assert st["replicas"]["desired"] == 2
        members = st["replicas"]["members"]
        assert all(m["alive"] and m["model_version"] == "v1"
                   for m in members.values())
        # SIGKILL replica 0: respawned, the LB routes around it meanwhile
        old = _pid(pidfile + ".r0")
        os.kill(old, signal.SIGKILL)
        served("a1")
        assert _wait(lambda: _alive(_pid(pidfile + ".r0"))
                     and _pid(pidfile + ".r0") != old and ready(0), 60,
                     0.2), log_tail()
        # scale up to 3 and back to 2: the retiring replica drains with
        # the shared admission open
        r = subprocess.run(MGR + ["scale", "3", "--pidfile", pidfile],
                           cwd=str(tmp_path), env=_env(),
                           capture_output=True, text=True)
        assert json.loads(r.stdout) == {"replicas": 3}
        assert _wait(lambda: ready(2), 60, 0.2), log_tail()
        pid2 = _pid(pidfile + ".r2")
        subprocess.run(MGR + ["scale", "2", "--pidfile", pidfile],
                       cwd=str(tmp_path), env=_env(), capture_output=True)
        for i in range(4):
            served(f"b{i}")
        assert _wait(lambda: not _alive(pid2), 30, 0.2)
        served("b9")
        # a rollout to v2 through the canary
        r = subprocess.run(MGR + ["rollout", "v2", "-c", cfg, "--pidfile",
                                  pidfile], cwd=str(tmp_path), env=_env(),
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr

        def promoted():
            st = status()
            ro = st.get("rollout") or {}
            return ro.get("phase") == "idle" and ro.get("base") == "v2" \
                and all(m.get("model_version") == "v2" and m.get("ready")
                        for m in st["replicas"]["members"].values())
        assert _wait(promoted, 90, 0.3), log_tail()
        assert served("c0")["model_version"] == "v2"
        # the fleet view sums the replicas
        r = subprocess.run(MGR + ["metrics", "--all-replicas", "-c", cfg,
                                  "--pidfile", pidfile], cwd=str(tmp_path),
                           env=_env(), capture_output=True, text=True)
        fm = json.loads(r.stdout)
        assert set(fm["per_replica"]) == {"replica-0", "replica-1"}
        r = subprocess.run(MGR + ["incident", "--list", "--pidfile",
                                  pidfile], cwd=str(tmp_path), env=_env(),
                           capture_output=True, text=True)
        reasons = [b["reason"] for b in json.loads(r.stdout)["incidents"]]
        assert "replica-0-crash" in reasons
    finally:
        _stop(tmp_path, pidfile, proc)
        sup_log.close()
    assert not os.path.exists(pidfile)
    for i in range(3):
        assert not _alive(_pid(pidfile + f".r{i}"))
    # the supervisor's process never touched CUDA; its replicas forked
    # from a process in which CUDA was never initialised
    with open(log + ".exit") as f:
        exit_doc = json.load(f)
    assert exit_doc["initialized"] is False
    calls = open(log).read().split("\n") if os.path.exists(log) else []
    assert not [c for c in calls if c.startswith(f"{exit_doc['pid']} ")]


def test_two_replica_lb_sigkill_mid_decode_resumes_token_exact(tmp_path):
    """The JAX package's two-replica SIGKILL test against the port: one
    generation in flight behind the LB, its owner killed MID-DECODE by the
    armed decode_crash fault (once, marker-gated); the survivor or the
    respawn reclaims the lease and finishes it token-exactly, the client's
    single long poll never fails, and the crash's incident bundle and the
    spools hold both owners' checkpoints and the resume."""
    lm, weights, topo = _lm_model(tmp_path)
    golden = _golden(lm)
    port, lb_port = _free_port(), _free_port()
    marker = tmp_path / "crash.marker"
    gen = "".join(f"    {k}: {str(v).lower()}\n" for k, v in GEN.items())
    cfg = _config(
        tmp_path, weights, topo,
        f"  http_port: {port}\n  drain_s: 2\n  lease_s: 2\n"
        "  reclaim_interval_s: 0.5\n  compile_cache_dir: off\n"
        "  generation:\n" + gen +
        "  faults:\n    decode_crash_after_n_tokens:\n"
        f"      version: '*'\n      n: 10\n      once: {marker}\n")
    pidfile = str(tmp_path / "cs.pid")
    log = open(tmp_path / "supervisor.log", "w")
    proc = subprocess.Popen(
        MGR + ["start", "-c", cfg, "--pidfile", pidfile, "--replicas", "2",
               "--lb-port", str(lb_port), "--foreground", "--no-prewarm"],
        cwd=str(tmp_path), env=_env(), stdout=log, stderr=subprocess.STDOUT)
    try:
        def ready():
            ok = 0
            for i in range(2):
                try:
                    ok += _http(f"http://127.0.0.1:{port + i}/readyz",
                                timeout=2)[0] == 200
                except OSError:
                    pass
            return ok == 2
        assert _wait(ready, 90, 0.2), open(tmp_path / "supervisor.log").read()
        _enqueue(FileQueue(str(tmp_path / "queue")), "gen-0", PROMPT,
                 tenant="acme", trace_id="trace-chaos-1")
        code, res, _ = _http(
            f"http://127.0.0.1:{lb_port}/v1/result/gen-0?timeout_s=60",
            timeout=90)
        assert code == 200 and "error" not in res, res
        assert res["value"]["tokens"] == golden
        assert os.path.exists(marker)          # the fault fired
        time.sleep(1.5)                        # one drain past the result
    finally:
        _stop(tmp_path, pidfile, proc)
        log.close()
    snaps = [s for s in tracecollect.load_snapshots(
        tracecollect.find_snapshot_spools(pidfile)) if s.get("rid") == "gen-0"]
    assert snaps and all(s.get("trace_id") == "trace-chaos-1" for s in snaps)
    # one generation epoch hop: epoch 0 from the victim, epoch 1 from the
    # process that resumed it (the survivor, or the victim's respawn,
    # which carries the same replica id)
    assert {s.get("epoch") for s in snaps} == {0, 1}
    merged = tracecollect.merge_spools(
        tracecollect.find_spools(pidfile)
        + tracecollect.find_event_spools(pidfile))
    resumes = [e for e in merged if e.get("event") == "gen_resume"
               and e.get("rid") == "gen-0"]
    assert resumes
    r = subprocess.run(MGR + ["incident", "--list", "--pidfile", pidfile],
                       cwd=str(tmp_path), env=_env(), capture_output=True,
                       text=True)
    reasons = [b["reason"] for b in json.loads(r.stdout)["incidents"]]
    assert any(x.endswith("-crash") for x in reasons), reasons
