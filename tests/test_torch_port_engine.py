"""PyTorch port: ``ClusterServing`` in generation mode, end to end on the CPU.

Records go in through the client over ``InProcQueue``; the engine's
workers read, decode and hand them to the paged batcher; terminal results,
streamed partials, a quarantined poison record and a shed late record come
back under the queue's contracts (the shape of the JAX package's
``test_engine_generation_e2e_streaming``).  The served tokens must equal a
direct run of the port's batcher over the same prompts.
"""

import time

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
from analytics_zoo_tpu_torch.serving import generate as tgen
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.engine import (ClusterServing,
                                                    ServingParams)
from analytics_zoo_tpu_torch.serving.queues import InProcQueue

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(120)

GEO = dict(vocab_size=48, hidden=32, n_head=4, n_layers=2, max_len=64)
GEN = dict(paged=True, block_len=8, max_active_slots=4, max_tokens=12,
           max_prompt_len=16, stream_interval=2, decode_quantum=2,
           kv_quant="off")


class _PartialLog(InProcQueue):
    """InProcQueue that remembers every streamed partial."""

    def __init__(self):
        super().__init__()
        self.partials = {}

    def put_partial(self, rid, value):
        self.partials.setdefault(rid, []).append(list(value["tokens"]))
        return super().put_partial(rid, value)


def _im():
    return InferenceModel(device="cpu").do_load_model(
        TransformerLM(**GEO, seed=3, device="cpu"))


PROMPTS = {"a": [3, 9, 27, 4, 12],
           "b": list(range(1, 17)),
           "c": [40, 41]}


def test_engine_generation_e2e_streaming_and_quarantine():
    im = _im()
    q = _PartialLog()
    serving = ClusterServing(im, q, ServingParams(
        max_batch=8, max_wait_ms=2.0, generation=GEN))
    iq, oq = InputQueue(q), OutputQueue(q)
    serving.start()
    try:
        for rid, p in PROMPTS.items():
            iq.enqueue_tensor(rid, np.asarray(p, np.float32))
        iq.enqueue_tensor("poison", np.asarray([1, 10_000], np.float32))
        q.xadd({"uri": "late", "data": [1.0, 2.0],
                "deadline_ns": time.time_ns() - int(1e9)})
        res = oq.query_many(list(PROMPTS) + ["poison", "late"],
                            timeout_s=60.0)
        # the engine keeps serving after the quarantine
        iq.enqueue_tensor("after", np.asarray([7, 8, 9], np.float32))
        after = oq.query("after", timeout_s=60.0)
        snap = serving.registry.snapshot()
        h = serving.health()
    finally:
        serving.shutdown(drain_s=2.0)

    ref = tgen.ContinuousBatcher(im, tgen.GenerationParams(**GEN))
    for rid, p in list(PROMPTS.items()) + [("after", [7, 8, 9])]:
        ref.submit(tgen.GenRequest(rid, np.asarray(p, np.float32)))
    want = {}
    while not ref.idle:
        for ev in ref.step():
            if ev.kind == "finish":
                want[ev.rid] = ev.tokens
    res["after"] = after
    for rid in list(PROMPTS) + ["after"]:
        r = res[rid]
        assert not OutputQueue.is_partial(r) and "value" in r, r
        assert r["value"]["tokens"] == want[rid]
        assert r["value"]["length"] == GEN["max_tokens"]
        assert r["value"]["finish_reason"] == "length"
        # partials streamed every 2 tokens, each a prefix of the final
        parts = q.partials[rid]
        assert [len(p) for p in parts] == list(
            range(2, GEN["max_tokens"], 2))
        for p in parts:
            assert p == want[rid][:len(p)]
    assert OutputQueue.is_error(res["poison"])
    assert "out of range" in res["poison"]["error"]
    assert OutputQueue.is_deadline_exceeded(res["late"])
    assert "poison" in {e["uri"] for e in q.dead_letters()}
    assert serving.dead_lettered == 1 and serving.shed == 1
    assert serving.total_records == 4
    n_tok = 4 * GEN["max_tokens"]
    assert snap["serving_generated_tokens_total"]["values"][0][
        "value"] == n_tok
    assert snap["serving_decode_steps_total"]["values"][0]["value"] > 0
    assert snap["serving_time_to_first_token_seconds"]["values"][0][
        "count"] == 4
    gen = h["generation"]
    assert gen["finished"] == 4 and gen["quarantined"] == 1
    assert gen["slots_total"] == GEN["max_active_slots"]
    assert h["device"] == "cpu"


def test_engine_serve_once_synchronous_drive():
    im = _im()
    q = InProcQueue()
    serving = ClusterServing(im, q, ServingParams(generation=dict(
        GEN, kv_quant="int8")))
    iq = InputQueue(q)
    for rid, p in PROMPTS.items():
        iq.enqueue_tensor(rid, np.asarray(p, np.float32))
    assert serving.serve_once() == len(PROMPTS)
    res = q.get_results(list(PROMPTS))
    assert all(r["value"]["length"] == GEN["max_tokens"]
               for r in res.values())
    assert serving._batcher.stats()["pool"]["kv_quant"] == "int8"
    serving.shutdown()


@pytest.mark.parametrize("opt", [dict(warmup=True),
                                 dict(http_port=8080, generation=GEN),
                                 dict(admission={"rate": 1.0},
                                      generation=GEN),
                                 dict(sharding="auto"),
                                 dict(brownout={"enabled": True},
                                      generation=GEN)])
def test_engine_unported_options_raise(opt):
    with pytest.raises(NotImplementedError):
        ClusterServing(_im(), InProcQueue(), ServingParams(**opt))


def test_engine_predict_plane_options_are_served():
    """The predict plane and its options (top_n, filter_threshold,
    inflight_batches, quantize) construct; a generation engine accepts
    them too, as the JAX engine does."""
    for opt in (dict(generation=None, top_n=3, inflight_batches=4),
                dict(top_n=3, filter_threshold=0.5, generation=GEN)):
        serving = ClusterServing(_im(), InProcQueue(), ServingParams(**opt))
        assert (serving._batcher is None) == (opt["generation"] is None)
        serving.shutdown()


def test_engine_params_take_the_reference_defaults():
    """A config written for the JAX engine, with its predict-plane and
    gateway options left at their defaults, is accepted; an unknown option
    is an error."""
    p = ServingParams.from_dict({"top_n": 5, "inflight_batches": 2,
                                 "gateway": True, "sharding": "off",
                                 "generation": GEN})
    assert p.generation == GEN
    with pytest.raises(TypeError):
        ServingParams(no_such_option=1)
