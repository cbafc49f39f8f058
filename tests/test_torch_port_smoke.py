"""PyTorch port: the host-side logic of ``chip_smoke.py`` on the CPU.

The script itself needs a CUDA card; its request mix, its bound
arithmetic, its cross-check (token sequences against the plain-attention
batcher, divergence accepted only at a near tie) and its predict-path
checks (every record answered, top-5 log-probabilities against the plain
path, launches = forwards x blocks) are plain Python and run here at a
tiny width.
"""

import copy

import numpy as np
import pytest
import torch

import chip_smoke as cs
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM

torch.set_num_threads(1)

VOCAB = 256


def test_request_mix_shape():
    waves = cs.make_requests(0, VOCAB)
    assert [len(w) for w in waves] == [8, 8]
    reqs = [r for w in waves for r in w]
    assert len({rid for rid, _ in reqs}) == cs.N_REQUESTS
    lens = [len(p) for _, p in reqs]
    assert min(lens) >= 16 and max(lens) <= cs.GENERATION["max_prompt_len"]
    prefix = reqs[0][1][:cs.PREFIX_LEN]
    sharers = [(rid, p) for rid, p in reqs
               if np.array_equal(p[:cs.PREFIX_LEN], prefix)]
    assert len(sharers) == cs.N_REQUESTS // 2
    # wave 1 registers the prefix (one sharer of exactly 40 tokens), wave 2
    # hits it
    first = [p for rid, p in waves[0] if any(rid == s for s, _ in sharers)]
    assert [len(p) for p in first] == [40]


def test_paged_bound_counts_needed_bytes():
    case = cs.paged_case(0, [1, 16, 17, 256, 100, 33, 255, 64],
                         device="cpu")
    b = cs.paged_bound(case)
    lens = np.array([1, 16, 17, 256, 100, 33, 255, 64])
    entries = int(np.sum(-(-lens // 16)))
    kv = int(lens.sum()) * 12 * 64
    assert b["bytes"] == 2 * kv * 4 + 2 * 8 * 12 * 64 * 4 + entries * 4 + 32
    assert b["flops"] == 4 * kv and b["bound_by"] == "bytes"
    q = cs.paged_bound(cs.quantize_case(case))
    assert q["bytes"] == b["bytes"] - 2 * kv * 3 + 2 * entries * 12 * 4


@pytest.fixture(scope="module")
def tiny():
    lm = TransformerLM(vocab_size=VOCAB, hidden=32, n_head=2, n_layers=1,
                       max_len=cs.LANE, seed=0, device="cpu")
    return InferenceModel(device="cpu").do_load_model(lm)


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_cross_check_accepts_equal_and_rejects_real_divergence(
        tiny, kv_quant):
    waves = cs.make_requests(0, VOCAB)
    plain = cs.batcher_tokens(tiny, waves, kv_quant, "torch")
    assert sorted(plain) == sorted(r for w in waves for r, _ in w)
    cs.cross_check(tiny, waves, plain, kv_quant)
    rid, prompt = waves[1][2]
    toks = plain[rid]
    margin, top = cs.replay_margin(tiny._model, prompt, toks, 5, kv_quant)
    assert top == toks[5] and margin > cs.TIE_MARGIN
    forged = dict(plain)
    forged[rid] = toks[:5] + [(toks[5] + 1) % VOCAB] + toks[6:]
    with pytest.raises(cs.SmokeFailure, match="not a near tie"):
        cs.cross_check(tiny, waves, forged, kv_quant)


def test_predict_path_bounds():
    """Flash: 4·D flop per (query, key) pair kept, q/k/v read and the
    output written once.  w8a8 / w4a16: bytes of the weight, its scales,
    the activations and the output."""
    f = cs.flash_bound(8, 12, 1024, 64, True)
    assert f["ops"] == 4 * 8 * 12 * (1024 * 1025 // 2) * 64
    assert f["bytes"] == 8 * 12 * 1024 * 64 * 16
    assert f["bound_by"] == "operations"
    assert cs.flash_bound(1, 1, 8, 32, False)["ops"] == 4 * 64 * 32
    w8 = cs.w8a8_bound(8, 768, 50257)
    assert w8["bytes"] == 8 * 768 + 768 * 50257 + 4 * 50257 + 4 * 8 * 50257
    assert w8["bound_by"] == "bytes"
    w4 = cs.w4a16_bound(8, 768, 50257, 12)
    assert w4["bytes"] == 8 * 768 * 4 + 384 * 50257 + 4 * 12 * 50257 \
        + 4 * 8 * 50257
    assert w4["ops"] == 2 * 8 * 768 * 50257 + 768 * 50257


@pytest.fixture
def tiny_predict(monkeypatch):
    monkeypatch.setattr(cs, "PREDICT", dict(vocab=40, hidden_size=32,
                                            n_block=2, n_head=2, seq_len=16))
    monkeypatch.setattr(cs, "PREDICT_BATCH", 4)
    model = cs.build_predict_model(0)
    return model, cs.predict_records(0, 10)


@pytest.mark.parametrize("spec,quant", [(None, None), ("int8", "w8a8"),
                                        ("int4", "w4a16")])
def test_predict_checks_accept_the_served_path_and_reject_faults(
        tiny_predict, tmp_path, spec, quant):
    model, X = tiny_predict
    if spec == "int8":
        np.save(tmp_path / "calib.npy", cs.predict_records(1, 4))
        spec = {"bits": 8, "calib": str(tmp_path / "calib.npy")}
    im = InferenceModel(device="cpu").do_load_model(copy.deepcopy(model))
    run = cs.serve_predict(im, X, cs.ServingParams(
        batch_size=4, max_wait_ms=2.0, quantize=spec))
    assert len(run["results"]) == len(X) and run["forwards"] >= 3
    # CPU tensors take the plain versions: no launches to count here
    assert run["flash"] == run["w8a8"] == run["w4a16"] == 0
    ref, x_plain = cs.head_inputs(im, X, "torch")
    _, x_kernel = cs.head_inputs(im, X, None)
    tol = cs.logp_tolerance(im, x_kernel, x_plain)
    assert tol.shape == (len(X),) and (tol >= cs.LOGP_TOL).all()
    run["flash"] = run["forwards"] * cs.PREDICT["n_block"]
    if quant:
        run[quant] = run["forwards"]
    out = cs.check_predict(str(spec), run, ref, tol, quant)
    assert len(out["top1"]) == len(X)
    bad = dict(run, flash=run["flash"] - 1)
    with pytest.raises(cs.SmokeFailure, match="flash launches"):
        cs.check_predict("bad", bad, ref, tol, quant)
    rid = run["rids"][3]
    top = [list(p) for p in run["results"][rid]["value"]]
    top[0][1] *= 1 + 2 * cs.LOGP_TOL
    forged = dict(run, results=dict(run["results"], **{rid: {"value": top}}))
    with pytest.raises(cs.SmokeFailure, match="log-prob error"):
        cs.check_predict("forged", forged, ref, tol, quant)
