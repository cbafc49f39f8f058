"""PyTorch port: the host-side logic of ``chip_smoke.py`` on the CPU.

The script itself needs a CUDA card; its request mix, its bound
arithmetic, its cross-check (token sequences against the plain-attention
batcher, divergence accepted only at a near tie) and its predict-path
checks (every record answered, top-5 log-probabilities against the plain
path, launches = forwards x blocks), its training checks, its ResNet
phase's (fused_bn bounds, path shapes, parity checks and planted faults;
``Estimator.fit`` of a ResNet-50 through both routes) and its image phase's
(ResNet-50's conv inventory and launch arithmetic, the conv bound, parity
and planted faults on the plain version, image records served in f32,
int8 and int4 and checked against the plain route, ``predict_image_set``)
and its recommendation phase's (the models' Dense shapes, the Census
surrogate against the example's own generator, NeuralCF trained, ranked
and served in f32 / int8 / int4, WideAndDeep trained and served, and the
checks' rejection of faults), its recurrent phase's and its text
phase's (the classifier's width and one-row conv geometries, the NER
surrogate's tags and the span F1, TextClassifier / NER / the taggers /
KNRM trained and served) and its forecast phase's (the series' length
and cadence, the naive forecasts, the grid and trial checks, AutoTS, the
forecasters, the population trainer and the served routes) and its
front door phase's (the queue-fed and HTTP rounds, admission's 429s,
the profile, the documents, the ledger and usage checks, the brownout
and int8-predict steps) and its fleet phase's helpers (the median of the
fleet's merged TTFT buckets, the summed series, the topology files it
writes) and its multi-GPU phase (4 ranks over gloo, here on the CPU) are
plain Python and run here at a tiny width.
"""

import copy
import sys
import time

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
        batch_size=4, max_wait_ms=2.0, quantize=spec,
        warmup={"max_batch": 4, "scales": "off"}))
    assert len(run["results"]) == len(X) and run["forwards"] >= 3
    assert run["warm"]["total"] == 3 and run["warm"]["failed"] == 0
    # CPU tensors take the plain versions: no launches to count here
    assert set(run["card"].values()) == set(run["wrapper"].values()) == {0}
    assert run["warm_hits"] == run["forwards"]
    ref, x_plain = cs.head_inputs(im, X, "torch")
    _, x_kernel = cs.head_inputs(im, X, None)
    tol = cs.logp_tolerance(im, x_kernel, x_plain)
    assert tol.shape == (len(X),) and (tol >= cs.LOGP_TOL).all()
    # what the card reads: 2 flash launches and 1 of the quantized head a
    # forward, on the card and by the wrappers alike
    fw = run["forwards"]
    card = dict(run["card"], flash_fwd=fw * cs.PREDICT["n_block"])
    if quant:
        card[quant] = fw
    run = dict(run, card=card, wrapper=dict(card))
    out = cs.check_predict(str(spec), run, ref, tol, quant)
    assert len(out["top1"]) == len(X)
    bad = dict(run, card=dict(card, flash_fwd=card["flash_fwd"] - 1))
    with pytest.raises(cs.SmokeFailure, match="flash_fwd launches on the"):
        cs.check_predict("bad", bad, ref, tol, quant)
    uncounted = dict(run, wrapper=dict(card, flash_fwd=0))
    with pytest.raises(cs.SmokeFailure, match="flash_fwd launches on the"):
        cs.check_predict("uncounted", uncounted, ref, tol, quant)
    cold = dict(run, warm_hits=fw - 1)
    with pytest.raises(cs.SmokeFailure, match="found their bucket warm"):
        cs.check_predict("cold", cold, ref, tol, quant)
    rid = run["rids"][3]
    top = [list(p) for p in run["results"][rid]["value"]]
    top[0][1] *= 1 + 2 * cs.LOGP_TOL
    forged = dict(run, results=dict(run["results"], **{rid: {"value": top}}))
    with pytest.raises(cs.SmokeFailure, match="log-prob error"):
        cs.check_predict("forged", forged, ref, tol, quant)



def test_predict_graph_probe_needs_a_card():
    import predict_graph_probe as pgp
    if torch.cuda.is_available():
        pytest.skip("the probe runs on the card here")
    assert pgp.main([]) == 1
    assert set(pgp.ROUTES) == {"eager", "graph"}


def test_flash_backward_bounds():
    """10·D flop per kept pair for the whole backward (0.195 ms at the path
    shape: 32.2 GFLOP of f32-accurate products at 3xTF32's 165 TFLOP/s),
    6·D for dq's function, 8·D for dk/dv's; q, k, v, O, dO read and dq,
    dk, dv written once."""
    pairs = 8 * 12 * 1024 * 1025 // 2
    b = cs.flash_bwd_bound(8, 12, 1024, 64, True)
    assert b["ops"] == 10 * 64 * pairs == 32_243_712_000
    assert b["bytes"] == 8 * 12 * 1024 * (64 * 4 * 8 + 4)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(0.19542, abs=1e-5)
    assert cs.flash_bwd_bound(8, 12, 1024, 64, True, "dq")["ops"] \
        + cs.flash_bwd_bound(8, 12, 1024, 64, True, "dkv")["ops"] \
        == 14 * 64 * pairs
    assert cs.flash_bwd_bound(1, 1, 8, 32, False)["ops"] == 10 * 32 * 64


@pytest.fixture
def tiny_train(monkeypatch):
    monkeypatch.setattr(cs, "TRAIN", dict(vocab=97, hidden_size=32,
                                          n_block=2, n_head=2, seq_len=32))
    monkeypatch.setattr(cs, "TRAIN_SEQS", 16)
    monkeypatch.setattr(cs, "TRAIN_BATCH", 4)
    monkeypatch.setattr(cs, "TRAIN_SUBVOCAB", 20)
    monkeypatch.setattr(cs, "TRAIN_LR", 3e-3)
    return cs.build_train_model(0), cs.train_data(0)


def test_train_data_is_motifs_from_a_sub_vocabulary(tiny_train):
    _, (x, y) = tiny_train
    assert x.shape == y.shape == (16, 32)
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
    assert len(np.unique(np.concatenate([x, y]))) <= cs.TRAIN_SUBVOCAB


def test_train_checks_accept_the_path_and_reject_faults(tiny_train):
    """The training phase's host logic at a tiny width: the kernel-route
    and plain runs from one set of weights (on the CPU both take the plain
    versions, so launches stay 0 and the losses are equal); the checks
    pass once the launch counts the card would give are filled in, and
    reject a missing launch, a loss that does not fall and a wrong step
    count."""
    model, (x, y) = tiny_train
    runs = {}
    for tag, impl in (("kernel", None), ("plain", "torch")):
        m = copy.deepcopy(model)
        cs.set_impl(m, impl)
        runs[tag] = cs.train_run(m, x, y, 0)
        assert runs[tag]["flash"] == runs[tag]["dq"] == runs[tag]["dkv"] == 0
    assert runs["kernel"]["losses"] == runs["plain"]["losses"]
    cs.check_train("plain", runs["plain"], kernels=False)
    run = dict(runs["kernel"], flash=8, dq=8, dkv=8)
    cs.check_train("kernel", run, kernels=True)
    with pytest.raises(cs.SmokeFailure, match="dkv launches"):
        cs.check_train("bad", dict(run, dkv=7), kernels=True)
    with pytest.raises(cs.SmokeFailure, match="did not fall"):
        cs.check_train("bad", dict(run, losses=run["losses"][::-1]),
                       kernels=True)
    summary = dict(run["summary"], steps=3)
    with pytest.raises(cs.SmokeFailure, match="fit_summary"):
        cs.check_train("bad", dict(run, summary=summary), kernels=True)


def test_planted_backward_faults_spoil_what_they_name(monkeypatch):
    """``planted`` wraps a backward kernel's wrapper only while its block
    runs, also when the block raises; each planted train fault spoils
    exactly what its tag says, on outputs laid out as the wrappers lay
    them out ((B, H, T, D) views of (B, T, H, D) memory)."""
    g = torch.Generator().manual_seed(0)

    def grads():
        return [torch.randn(2, 80, 3, 8, generator=g).transpose(1, 2)
                for _ in range(2)]

    monkeypatch.setattr(cs.fa, "flash_bwd_dq", lambda *a: grads()[0])
    monkeypatch.setattr(cs.fa, "flash_bwd_dkv", lambda *a: tuple(grads()))
    wrappers = {n: getattr(cs.fa, n) for n in ("flash_bwd_dq",
                                               "flash_bwd_dkv")}
    (dq_tag, _, _, dq_reject), (dk_tag, _, _, dk_reject) = cs.TRAIN_FAULTS
    assert not dq_reject and dk_reject and "dq" in dq_tag and "dk" in dk_tag
    for tag, name, spoil, _ in cs.TRAIN_FAULTS:
        g.manual_seed(1)
        clean = wrappers[name]()
        g.manual_seed(1)
        with cs.planted(name, spoil):
            assert getattr(cs.fa, name) is not wrappers[name]
            bad = getattr(cs.fa, name)()
        assert getattr(cs.fa, name) is wrappers[name]
        if name == "flash_bwd_dq":
            torch.testing.assert_close(bad, clean * (1 + cs.PLANTED_SCALE_ERR),
                                       rtol=0, atol=0)
        else:
            dk, dv = clean
            want = dk.clone()
            want[0, 0, :64] = 0
            torch.testing.assert_close(bad[0], want, rtol=0, atol=0)
            torch.testing.assert_close(bad[1], dv, rtol=0, atol=0)
            assert bool((bad[0][0, 0, 64:] != 0).all())
    with pytest.raises(KeyError):
        with cs.planted("flash_bwd_dq", lambda out: None):
            raise KeyError("inside")
    assert cs.fa.flash_bwd_dq is wrappers["flash_bwd_dq"]


def test_loss_gap_is_the_largest_step_difference():
    assert cs.loss_gap({"losses": [10.0, 9.5, 9.0]},
                       {"losses": [10.0, 9.25, 9.125]}) == 0.25


# -- phase 6: ResNet-50 and fused_bn ---------------------------------------------

def test_fused_bn_bounds():
    """At the probe shape: f32 is bytes-bound (411.0 MB of x, 102.8 MB of
    y, 0.1534 ms; its 13.15 GFLOP of products at 3xTF32's 165 TFLOP/s plus
    the sums' 3 flop an output take 0.081 ms); bf16 is bytes-bound too
    (205.5 MB of x, 51.4 MB of y, 0.0767 ms)."""
    m, k, n = cs.PROBE_SHAPE
    b = cs.fused_bn_bound(m, k, n, torch.float32)
    assert b["bound_by"] == "bytes"
    assert b["ops"] == 2 * m * k * n + 3 * m * n
    assert b["bytes"] == 4 * (m * k + k * n + m * n) + 8 * n
    assert b["bound_ms"] == pytest.approx(0.15339, abs=1e-5)
    b = cs.fused_bn_bound(m, k, n, torch.bfloat16)
    assert b["bound_by"] == "bytes"
    assert b["bytes"] == 2 * (m * k + k * n + m * n) + 8 * n
    assert b["bound_ms"] == pytest.approx(0.07670, abs=1e-5)


def test_fused_bn_path_shapes_of_resnet50():
    """The fusion plan of ResNet-50 at batch 128: 33 pairs over 12 distinct
    (M, K, N), M from 6272 to 401408, the probe's shape twice (stage 0
    blocks 1 and 2)."""
    from analytics_zoo_tpu_torch.models.imageclassification import resnet
    shapes = cs.fused_bn_shapes(resnet(50), 128)
    assert sum(shapes.values()) == 33 and len(shapes) == 12
    assert shapes[cs.PROBE_SHAPE] == 2
    assert {m for m, _, _ in shapes} == {401408, 100352, 25088, 6272}


def test_fused_bn_checks_accept_the_plain_result_and_reject_faults():
    """The parity check passes the plain version against itself and
    rejects y x 1.001 and a lost 128-row tile of the sums."""
    g = np.random.default_rng(0)
    x, w = cs.fused_bn_case(g, 1000, 33, 10, torch.float32, 3, device="cpu")
    assert x.stride() == (36, 1)
    ref = cs.fb.fused_bn(x, w, impl="torch")
    assert cs.check_fused_bn("ok", ref, ref) == (0.0, 0.0)
    with pytest.raises(cs.SmokeFailure, match="bad y"):
        cs.check_fused_bn("bad", (ref[0] * 1.001, ref[1]), ref)
    y = ref[0][128:256]
    lost = ref[1] - torch.stack([y.sum(0), (y * y).sum(0)])
    with pytest.raises(cs.SmokeFailure, match="bad sum"):
        cs.check_fused_bn("bad", (ref[0], lost), ref)


def test_planted_partials_spoil_their_sites(monkeypatch):
    """``planted_partials`` wraps ``fb._launch_partials`` only while its
    block runs (also when the block raises) and hands each launch's site
    (launch index modulo the plan's length) to the fault: the lost-tile
    fault zeroes tile 0 at the last site only; the accumulator fault
    scales y and Σ by 1.001 and Σ² by its square everywhere."""
    def fake(x, w):
        return torch.ones(4, 3), torch.ones(2, 2, 3)
    monkeypatch.setattr(cs.fb, "_launch_partials", fake)
    (acc_tag, acc, acc_reject), (tile_tag, tile, tile_reject) = \
        cs.RESNET_FAULTS
    assert tile_reject and not acc_reject
    with cs.planted_partials(tile, 3):
        outs = [cs.fb._launch_partials(None, None) for _ in range(6)]
    assert cs.fb._launch_partials is fake
    for i, (y, part) in enumerate(outs):
        want = torch.ones(2, 2, 3)
        if i % 3 == 2:
            want[0] = 0
        assert torch.equal(part, want) and torch.equal(y, torch.ones(4, 3))
    with cs.planted_partials(acc, 3):
        y, part = cs.fb._launch_partials(None, None)
    scale = 1 + cs.PLANTED_SCALE_ERR
    torch.testing.assert_close(y, torch.full((4, 3), scale))
    torch.testing.assert_close(part[:, 0], torch.full((2, 3), scale))
    torch.testing.assert_close(part[:, 1], torch.full((2, 3), scale ** 2))
    with pytest.raises(KeyError):
        with cs.planted_partials(tile, 3):
            raise KeyError("inside")
    assert cs.fb._launch_partials is fake


@pytest.fixture
def tiny_resnet(monkeypatch):
    # the CIFAR stem keeps 4x4 in the last stage at 32x32, so its BNs see
    # enough values a channel for finite eval-mode statistics
    monkeypatch.setattr(cs, "RESNET", dict(model_name="resnet50",
                                           num_classes=20, stem="cifar",
                                           input_shape=(32, 32, 3)))
    monkeypatch.setattr(cs, "RESNET_BATCH", 4)
    monkeypatch.setattr(cs, "RESNET_STEPS", 2)
    monkeypatch.setattr(cs, "RESNET_CLASSES", 3)
    model = cs.ImageClassifier(**cs.RESNET, device="cpu").model
    return model.init_weights(0), cs.resnet_data(0)


def test_resnet_data_is_offset_classes(tiny_resnet):
    _, (x, y, xe, ye) = tiny_resnet
    assert x.shape == (8, 32, 32, 3) and xe.shape == (4, 32, 32, 3)
    assert x.dtype == np.float32 and y.dtype == np.int64
    assert len(np.unique(np.concatenate([y, ye]))) <= cs.RESNET_CLASSES
    assert int(max(y.max(), ye.max())) < 20


def test_resnet_checks_accept_the_path_and_reject_faults(tiny_resnet):
    """The ResNet phase's host logic at a tiny size: the kernel-route and
    plain runs from one set of weights (on the CPU both take the plain
    version, so launches stay 0 and the losses are equal); the checks pass
    once the launch count the card would give is filled in, and reject a
    missing launch and a loss that does not fall."""
    model, (x, y, xe, ye) = tiny_resnet
    runs = {}
    for tag, impl in (("kernel", None), ("plain", "torch")):
        m = copy.deepcopy(model)
        cs.set_impl(m, impl)
        runs[tag] = cs.resnet_run(m, x, y, xe, ye, 0)
        assert runs[tag]["fused"] == 0
        assert len(runs[tag]["losses"]) == 3
        assert set(runs[tag]["eval"]) == {"loss", "accuracy"}
    assert runs["kernel"]["losses"] == runs["plain"]["losses"]
    assert cs.loss_gap(runs["kernel"], runs["plain"]) == 0.0
    falling = [3.0, 2.5, 2.0]
    cs.check_resnet("plain", dict(runs["plain"], losses=falling), 33,
                    kernels=False)
    run = dict(runs["kernel"], losses=falling, fused=99)
    cs.check_resnet("kernel", run, 33, kernels=True)
    with pytest.raises(cs.SmokeFailure, match="launches"):
        cs.check_resnet("bad", dict(run, fused=98), 33, kernels=True)
    with pytest.raises(cs.SmokeFailure, match="did not fall"):
        cs.check_resnet("bad", dict(run, losses=[2.0, 2.5, 3.0]), 33,
                        kernels=True)


def test_resnet_profile_families():
    for name, fam in (("void fused_bn_kernel<float>(float const*)",
                       "fused_bn"),
                      ("sm90_xmma_fprop_implicit_gemm_f32f32", "cuDNN conv"),
                      ("cutlass_80_simt_sgemm_128x64", "GEMM (fused_bn "
                                                       "backward, fc)"),
                      ("void at::native::multi_tensor_apply_kernel<>",
                       "SGD (foreach)"),
                      ("void at::native::vectorized_elementwise_kernel<4>",
                       "BN and other elementwise / reductions")):
        assert cs.kernel_family(name) == fam


def test_sass_check_holds_kernels_of_their_sources():
    """Every kernel that ``sass_check`` holds to a tensor-core instruction
    is defined in its source, and each rule names one of the four: TF32
    and BF16 HMMA, s8 IMMA (``w8a8``, and ``w8a8_conv2d`` where it builds
    its A tiles byte by byte: the s8 m16n8k32 mma of the shared header
    through ``mma_s8``), s8 IGMMA (``w8a8_conv2d`` where it copies its A
    tiles: wgmma m64nNk32 at its tiles' 64 and 128 channels)."""
    wg = tuple(cs.SASS_S8_WG.values())
    for name, rules in cs.SASS_KERNELS.items():
        src = (cs._build.CSRC / f"{name}.cu").read_text()
        for key, op in rules:
            assert key.split("I")[0] + "(" in src, key
            assert op in (cs.SASS_TF32, cs.SASS_BF16, cs.SASS_S8) + wg
    header = (cs._build.CSRC / "mma_tf32.cuh").read_text()
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in header
    for name, kernel in ((cs.qm.KERNEL, "w8a8_kernel"),
                         (cs.qm.KERNEL_CONV, "w8a8_conv2d_kernel")):
        rules = [op for key, op in cs.SASS_KERNELS[name] if kernel in key]
        assert cs.SASS_S8 == "IMMA.16832.S8.S8" and cs.SASS_S8 in rules
        src = (cs._build.CSRC / f"{name}.cu").read_text()
        assert '#include "mma_tf32.cuh"' in src and "mma_s8(" in src
    conv = dict(cs.SASS_KERNELS[cs.qm.KERNEL_CONV])
    assert len(conv) == 6 and wg == ("IGMMA.64x64x32.S8.S8",
                                     "IGMMA.64x128x32.S8.S8")
    for bn in cs.qm.CONV_BNS:
        assert conv[f"w8a8_conv2d_kernelILi{bn}ELi0E"] == cs.SASS_S8_WG[bn]
        for route in (1, 2):
            assert conv[f"w8a8_conv2d_kernelILi{bn}ELi{route}E"] == \
                cs.SASS_S8
        assert f"wgmma.mma_async.sync.aligned.m64n{bn}k32.s32.s8.s8" in \
            (cs._build.CSRC / f"{cs.qm.KERNEL_CONV}.cu").read_text()


@pytest.mark.parametrize("nbytes", [1, 1_300_000, 5_200_000, 21_700_000,
                                    38_900_000, 44_000_000, 150_000_000])
def test_timings_cycle_more_than_twice_l2(nbytes):
    """A timing cycles through the fewest input sets whose bytes exceed
    L2_FLUSH_BYTES (100 MB, twice the H100's L2)."""
    n = cs.n_sets(nbytes)
    assert n * nbytes > cs.L2_FLUSH_BYTES >= (n - 1) * nbytes
    assert cs.L2_FLUSH_BYTES >= 2 * 50e6


def test_paged_timing_shapes_and_long_cache_bound():
    """The main path's lengths (17-192, drawn as before) over 16-entry
    tables, and GPT-2's full context (769-1024) over 64-entry ones, whose
    bytes bound is ~0.013 ms f32 and ~0.0033 ms int8."""
    t = cs.paged_timing_lengths(0)
    main, n_main = t["main"]
    long, n_long = t["long"]
    assert (n_main, n_long) == (16, 64)
    assert np.array_equal(main, np.random.default_rng(1).integers(17, 193,
                                                                  8))
    assert main.min() >= 17 and main.max() <= 192
    assert long.min() >= 769 and long.max() <= 1024
    case = cs.paged_case(0, long, n_table=64, device="cpu")
    f32 = cs.paged_bound(case)
    i8 = cs.paged_bound(cs.quantize_case(case))
    assert f32["bound_by"] == i8["bound_by"] == "bytes"
    assert 0.011 < f32["bound_ms"] < 0.0135
    assert 0.0028 < i8["bound_ms"] < 0.0035
    assert cs.n_sets(f32["bytes"]) == 3


def test_w4a16_parity_cases_cover_the_kernels_edges():
    """The card's w4a16 cases: both x types, one and four m-tiles, groups
    straddling a 16-row chunk and the two halves, odd K, several x
    segments (K > 768), a weight not on 16 bytes."""
    cases = cs.W4_CASES
    assert {c[4] for c in cases} == {torch.float32, torch.bfloat16}
    assert {1, 8} <= {c[0] for c in cases} and max(c[0] for c in cases) > 8

    def group_size(k, group):        # the quantizer's effective size
        return -(-k // -(-k // group))

    def straddles_halves(k, group):  # one group holds k = kh - 1 and kh
        kh, gs = (k + 1) // 2, group_size(k, group)
        return (kh - 1) // gs == kh // gs

    assert any(straddles_halves(c[1], c[3]) for c in cases)
    assert any(group_size(c[1], c[3]) % 16 for c in cases)
    assert any(c[1] % 2 for c in cases)
    assert any((c[1] + 1) // 2 > 384 for c in cases)
    assert any(c[5] % 16 for c in cases)


def test_w8a8_parity_cases_cover_the_kernels_edges():
    """The card's bitwise w8a8 cases: one m-tile a block, several, the
    most (8, ``w8a8_matmul`` takes ceil(M / 8)) and more rows than one
    block holds, the head at every timed M; K below one k-step of 32,
    ragged, odd and past one x segment of 768; N = 1, below one mma tile
    of 16, odd; a weight base off 16 bytes; all -128 / 127."""
    cases = cs.W8_CASES
    assert {1, 8, 9, 33, 64} <= {c[0] for c in cases}
    assert {20, 100, 768, 777} <= {c[1] for c in cases}
    assert {1, 15, 61, 50257} <= {c[2] for c in cases}
    assert {1, 2, 3, 5, 8} <= {min(-(-c[0] // 8), 8) for c in cases}
    assert any(c[0] > 64 for c in cases)
    assert {(m, 768, 50257) for m in cs.W8_TIMED_M} <= {c[:3] for c in cases}
    assert cs.W8_TIMED_M == (1, 8, 33)
    assert any(c[1] < 32 for c in cases) and any(c[1] % 2 for c in cases)
    assert any(c[1] > 768 and c[1] % 64 for c in cases)
    assert any(c[2] < 16 for c in cases) and any(c[2] % 2 for c in cases)
    assert any(c[3] % 16 for c in cases)
    assert any(c[4] for c in cases)
    assert any(c[3] % 16 and c[2] == 50257 for c in cases)


# -- the continuity phase -------------------------------------------------------

def test_resume_victim_arguments():
    args = cs.parse_args(["--resume-victim", "spool-dir", "--seed", "3"])
    assert (args.resume_victim, args.seed) == ("spool-dir", 3)
    args = cs.parse_args([])
    assert args.resume_victim is None and args.seed == 0
    assert not args.profile and not args.kernel_timing


def test_params_checksum_names_the_weights():
    geo = dict(vocab_size=VOCAB, hidden=32, n_head=2, n_layers=1,
               max_len=cs.LANE, device="cpu")
    a = cs.params_checksum(TransformerLM(**geo, seed=4))
    assert a == cs.params_checksum(TransformerLM(**geo, seed=4))
    assert a != cs.params_checksum(TransformerLM(**geo, seed=5))
    lm = TransformerLM(**geo, seed=4)
    with torch.no_grad():
        lm.embed.view(-1)[17] += 1e-7
    assert cs.params_checksum(lm) != a


def test_victim_readings_parse_its_output():
    log = "\n".join(["victim: params checksum 0123abcd",
                     '{"ckpt_s": 0.002, "snapshots": 8}',
                     "victim: warm (121 entries, 1 capture(s)), serving",
                     '{"ckpt_s": 0.001, "snapshots": 3}'])
    assert cs.victim_readings(log) == {"checksum": "0123abcd",
                                       "ckpt_s": [0.002, 0.001],
                                       "snapshots": 11}


def test_expected_resume_from_a_crafted_queue_and_spool(tmp_path):
    """The survivor's expected resumes and waste, worked out from a queue
    and a spool crafted as a dead owner leaves them: a record done by the
    owner, resumes whose partial runs past (waste) or stops at their
    checkpoint, and restarts for a missing, corrupt, other-epoch or
    unannotated checkpoint, each wasting its whole partial."""
    from analytics_zoo_tpu_torch.serving.queues import FileQueue
    from analytics_zoo_tpu_torch.serving import tracecollect as tc

    q = FileQueue(str(tmp_path / "q"))
    spool = str(tmp_path / "dead.gensnap.jsonl")
    rids = ["done", "ahead", "even", "nosnap", "corrupt", "epoch", "noann"]
    partial = {"ahead": 17, "even": 9, "nosnap": 5, "corrupt": 13,
               "epoch": 4, "noann": 3}
    q.put_result("done", {"value": {"tokens": [1, 2]}})
    for rid, n in partial.items():
        assert q.put_partial(rid, {"partial": True, "tokens": [1] * n,
                                   "n": n})

    def snap(rid, n, epoch=0, bad=False):
        s = {"rid": rid, "epoch": epoch, "prompt": [3, 4],
             "tokens": list(range(n)), "n": n, "ts": time.monotonic()}
        s["crc"] = tc.snapshot_checksum(s) ^ (1 if bad else 0)
        return s

    tc.append_snapshots(spool, [snap("ahead", 1), snap("ahead", 9),
                                snap("even", 9), snap("corrupt", 9,
                                                      bad=True),
                                snap("epoch", 2, epoch=1),
                                snap("noann", 2)])
    for rid in ("ahead", "even", "nosnap", "corrupt", "epoch"):
        q.annotate(rid, {"spool": spool, "epoch": 0, "replica": "dead"})
    want = cs.expected_resume(q, rids, spool)
    assert want == {"done": ["done"], "resumed": {"ahead": 9, "even": 9},
                    "restarted": ["nosnap", "corrupt", "epoch", "noann"],
                    "waste": 8 + 5 + 13 + 4 + 3}


def test_resume_depth_checks_accept_the_path_and_reject_faults(tiny):
    """Resumes of served requests at every depth through the batcher (the
    plain attention on the CPU, so no launch): accepted; a partial that
    re-streams the past, a resume that parts from its uninterrupted
    tokens at a real margin, or launches that do not match are
    rejected."""
    waves = cs.make_requests(0, VOCAB)
    golden = cs.batcher_tokens(tiny, waves, "off", "torch")
    run = cs.resume_run(tiny, waves, golden, cs.resume_gen(cs.GENERATION))
    assert len(run["subs"]) == len(cs.RESUME_PICKS) * len(cs.RESUME_DEPTHS)
    assert max(k for _, _, k in run["subs"]) \
        == cs.GENERATION["max_tokens"] - 1
    cs.check_resume_run(tiny, run, golden, "off", "off", 0)
    with pytest.raises(cs.SmokeFailure, match="paged launches"):
        cs.check_resume_run(tiny, dict(run, launches=1), golden, "off",
                            "off", 0)
    stale = copy.copy(run["events"][0])
    stale.kind, stale.rid, stale.tokens = "partial", "req-00@17", [1] * 17
    with pytest.raises(cs.SmokeFailure, match="partial"):
        cs.check_resume_run(tiny, dict(run, events=run["events"] + [stale]),
                            golden, "off", "off", 0)
    forged = dict(golden)
    toks = golden["req-01"]
    forged["req-01"] = toks[:40] + [(toks[40] + 1) % VOCAB] + toks[41:]
    with pytest.raises(cs.SmokeFailure, match="not a near tie"):
        cs.check_resume_run(tiny, run, forged, "off", "off", 0)


# -- phase 7: image classification ---------------------------------------------

def test_image_conv_inventory_of_resnet50():
    """ResNet-50 at 224 x 224 and batch 16: 20 spatial convolutions (the
    w8a8_conv2d kernel's launches a forward) at 11 shapes, 33 pointwise
    ones and the head (34 matmul launches) at 13 (M, K, N); every strided
    conv pads SAME's (0, 1) at even sizes, the stem (2, 3)."""
    from analytics_zoo_tpu_torch.models.imageclassification import \
        ImageClassifier
    ic = ImageClassifier(**cs.IMAGE, device="cpu")
    inv = cs.conv_inventory(ic.model, cs.IMAGE_BATCH)
    spatial, matmuls = inv["spatial"], inv["matmuls"]
    assert len(spatial) == cs.IMAGE_SPATIAL == 20
    assert len(cs.distinct(spatial)) == cs.IMAGE_SPATIAL_SHAPES == 11
    assert len(matmuls) == cs.IMAGE_MATMULS == 34
    assert len(cs.distinct(matmuls)) == 13
    stem = spatial[0]
    assert stem[:4] == ((16, 224, 224, 3), (7, 7, 3, 64), (2, 2),
                        ((2, 3), (2, 3)))
    for x, k, strides, pads, _, _ in spatial[1:]:
        if strides == (2, 2) and k[0] == 3:
            assert pads == ((0, 1), (0, 1))
    assert sum(n for g, n in cs.distinct(spatial)
               if g[1][:2] == (1, 1)) == 3          # strided projections
    assert matmuls[-1] == (16, 2048, 1000)
    assert matmuls[0] == (16 * 56 * 56, 64, 64)
    # the forward's launches by precision
    assert cs.IMAGE_LAUNCHES["int8"] == {"w8a8_conv": 20, "w8a8": 34}
    assert cs.IMAGE_LAUNCHES["int4"] == {"w4a16": 34}
    assert cs.IMAGE_LAUNCHES["f32"] == {}


def test_image_conv_bound_is_bytes_then_operations():
    """The stem's bound is its bytes (2.4 MB read, 51.4 MB of f32 output
    written, ~16 us); stage 4's 3x3 convs are bound by operations."""
    stem = ((16, 224, 224, 3), (7, 7, 3, 64), (2, 2), ((2, 3), (2, 3)),
            (1, 1), 1)
    b = cs.conv_bound(stem)
    m = 16 * 112 * 112
    assert b["bytes"] == 16 * 224 * 224 * 3 + 147 * 64 + 4 * 64 + 4 * m * 64
    assert b["ops"] == 2 * m * 64 * 147 and b["bound_by"] == "bytes"
    assert 0.015 < b["bound_ms"] < 0.017
    deep = ((16, 7, 7, 512), (3, 3, 512, 512), (1, 1), ((1, 1), (1, 1)),
            (1, 1), 1)
    assert cs.conv_bound(deep)["bound_by"] == "operations"


def test_image_conv_parity_and_planted_faults_on_cpu():
    """The parity and planted-fault helpers on the plain version: every
    case equal, the three planted faults (a dropped k piece, shifted pads,
    a split's merge without one block's partial) rejected by the bitwise
    check."""
    shapes = [((2, 11, 9, 3), (7, 7, 3, 8), (2, 2), ((2, 3), (3, 3)),
               (1, 1), 1),
              ((1, 8, 8, 16), (3, 3, 16, 16), (2, 2), ((0, 1), (0, 1)),
               (1, 1), 1)]
    assert cs.conv_parity(0, shapes, device="cpu") == \
        len(shapes) + len(cs.CONV_RAGGED)
    out = cs.conv_planted(0, shapes[1], device="cpu")
    assert len(out) == 3 and all("rejected" in o for o in out)
    assert "without the next block's partial" in out[2]


def test_conv_planted_merge_fault_is_a_build_of_the_kernel():
    """The planted lost partial is the kernel's own source built with
    CV_MERGE_SKIP, which only the merge reads (0, the default, skips
    none); the smem query takes the entry point's geometry."""
    src = (cs._build.CSRC / f"{cs.qm.KERNEL_CONV}.cu").read_text()
    assert "#ifndef CV_MERGE_SKIP\n#define CV_MERGE_SKIP 0\n" in src
    assert src.count("CV_MERGE_SKIP") == 4
    assert "q < split && q != CV_MERGE_SKIP" in src
    assert cs.CONV_MERGE_SKIP == ("-DCV_MERGE_SKIP=1",)
    assert cs._build.library_path(cs.CONV_SOURCE, cs.CONV_MERGE_SKIP) != \
        cs._build.library_path(cs.CONV_SOURCE)
    for _, geom in cs.CONV_SMEM_SHAPES:
        args = cs.conv_args(geom)
        assert len(args) == 16
        x = torch.zeros(geom[0], dtype=torch.int8)
        _, _, (ho, wo) = cs.qm._conv_geometry(x, geom[1], *geom[2:])
        assert args[7:9] == (ho, wo)
        assert args[0] * ho * wo == cs.conv_mnk(geom)[0]


@pytest.fixture
def tiny_image(monkeypatch):
    """The image phase at ResNet-50 32 x 32 with 10 classes: 8 records of
    40 x 36 pixels, batch 4, the kernels' launch counts 0 (no card)."""
    from analytics_zoo_tpu_torch.common import context
    monkeypatch.setattr(cs, "IMAGE", dict(model_name="resnet50",
                                          num_classes=10,
                                          input_shape=(32, 32, 3)))
    monkeypatch.setattr(cs, "IMAGE_SOURCE", (40, 36, 3))
    monkeypatch.setattr(cs, "IMAGE_BATCH", 4)
    monkeypatch.setattr(cs, "IMAGE_RECORDS", 8)
    monkeypatch.setattr(cs, "IMAGE_WARMUP", {"max_batch": 4,
                                             "scales": "both",
                                             "scale_dtypes": ["|u1"]})
    monkeypatch.setattr(cs, "IMAGE_LAUNCHES", {"f32": {}, "int8": {},
                                               "int4": {}})
    monkeypatch.setattr(context, "_global_ctx",
                        context.ZooContext(context.ZooConf(device="cpu")))
    from analytics_zoo_tpu_torch.models.imageclassification import \
        ImageClassifier
    ic = ImageClassifier(**cs.IMAGE, device="cpu")
    recs = cs.image_records(0)
    X = cs.decoded_inputs(recs)
    params, state = cs.image_params(0, ic.model, X[:4])
    return recs, X, params, state


def test_image_records_and_params(tiny_image):
    """Half the records on the float path, half on the u8 path, decoded
    as the engine decodes them (pixel values, resized); the head scaled so
    its logits have IMAGE_LOGIT_STD over the calibration batch."""
    recs, X, params, state = tiny_image
    assert [u8 for _, _, u8 in recs] == [False] * 4 + [True] * 4
    assert X.shape == (8, 32, 32, 3) and X.dtype == np.float32
    assert 0.0 <= X.min() and X.max() <= 255.0
    from analytics_zoo_tpu_torch.models.imageclassification import \
        ImageClassifier
    model = ImageClassifier(**cs.IMAGE, device="cpu").model
    model.set_weights(params, state)
    seen = []
    model.graph_layers[-1].register_forward_pre_hook(
        lambda _m, a: seen.append(a[0]))
    with torch.inference_mode():
        model.eval()(torch.from_numpy(X[:4]))
    logits = seen[0].double() @ model.graph_layers[-1].W.detach().double()
    assert abs(float(logits.std()) - cs.IMAGE_LOGIT_STD) < 1e-3


def test_image_serving_checks_on_cpu(tiny_image):
    """Served over image records in f32, int8 and int4 on the CPU (every
    wrapper takes its plain version there): each run passes its check
    against the plain route; a one-ulp change of one int8 probability, a
    launch count off by one and a record missing are rejected."""
    recs, X, params, state = tiny_image
    from analytics_zoo_tpu_torch.models.imageclassification import \
        ImageClassifier
    runs = {}
    for tag, spec in (("f32", None), ("int4", "int4")):
        model = ImageClassifier(**cs.IMAGE, device="cpu").model
        im = InferenceModel(device="cpu").do_load_model(model, params, state)
        run = cs.serve_images(im, recs, cs.ServingParams(
            batch_size=4, max_wait_ms=2.0, quantize=spec,
            warmup=cs.IMAGE_WARMUP))
        ref = cs.plain_probs(im, X, "torch")
        cs.check_image(tag, run, ref, cs.IMAGE_LOGP_TOL[tag])
        runs[tag] = (run, ref)
        assert set(run["programs"]) <= {"b4x32x32x3/<f4",
                                         "b4x32x32x3/|u1+scales"}
    run, ref = runs["f32"]
    cs.check_image("int8", run, ref, None)      # bitwise: same route
    bad = copy.deepcopy(run)
    top = bad["results"]["img-03"]["value"]
    top[0][1] = float(np.nextafter(np.float32(top[0][1]), np.float32(1)))
    with pytest.raises(cs.SmokeFailure, match="img-03"):
        cs.check_image("int8", bad, ref, None)
    bad = copy.deepcopy(run)
    bad["card"]["w8a8"] = 1
    with pytest.raises(cs.SmokeFailure, match="w8a8 launches"):
        cs.check_image("f32", bad, ref, cs.IMAGE_LOGP_TOL["f32"])
    bad = copy.deepcopy(run)
    del bad["results"]["img-05"]
    with pytest.raises(cs.SmokeFailure, match="img-05"):
        cs.check_image("f32", bad, ref, cs.IMAGE_LOGP_TOL["f32"])


def test_predict_image_set_check_on_cpu(tiny_image, monkeypatch):
    """The predict_image_set check through a 32 x 32 preprocessing chain
    registered for the model's name."""
    from analytics_zoo_tpu_torch.feature import image as timage
    from analytics_zoo_tpu_torch.models.imageclassification import (
        ImageClassificationConfig, ImageClassifier)
    _, _, params, state = tiny_image
    monkeypatch.setitem(ImageClassificationConfig._REGISTRY, "resnet50",
                        timage.ImageResize(36, 36)
                        >> timage.ImageCenterCrop(32, 32))
    model = ImageClassifier(**cs.IMAGE, device="cpu").model
    im = InferenceModel(device="cpu").do_load_model(model, params, state)
    cs.predict_image_set_check(params, state, torch.device("cpu"), im)


def test_ptxas_summary_names_every_template_argument():
    """Each entry point by its kernel name and full template argument list
    (two bool arguments, a type and an int), its registers and spills."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__53266352_"
        "13_quant_conv_cu_b63f88ab18w8a8_conv2d_kernelILb0ELb1EEEvPKaS2_PKfP"
        "fNS_8ConvGeomE' for 'sm_90a'",
        "ptxas info    : Used 117 registers",
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__73ee249f_"
        "15_quant_matmul_cu_ad31fd2012w4a16_kernelI13__nv_bfloat16Li4EEEvPKT"
        "_PKhPKfPfiiii' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    24 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads",
        "ptxas info    : Used 187 registers, 4224 bytes smem"])
    assert cs.ptxas_summary(log) == (
        "w8a8_conv2d_kernel<Lb0ELb1>: 117 regs; "
        "w4a16_kernel<13__nv_bfloat16Li4>: 24 bytes stack frame, 24 bytes "
        "spill stores, 24 bytes spill loads; "
        "w4a16_kernel<13__nv_bfloat16Li4>: 187 regs, 4224 B static smem")


# -- phase 8: the recommendation zoo --------------------------------------------

def test_reco_dense_shapes_are_the_full_width_models():
    """RECO_DENSE is what the models at full width hold, in graph order:
    NeuralCF at MovieLens-1M width (1,274,786 parameters) and WideAndDeep
    at the Census columns (wide_dim 173, deep input 34)."""
    from analytics_zoo_tpu_torch.models.recommendation import (NeuralCF,
                                                               WideAndDeep)
    ncf = NeuralCF(cs.NCF_DATA["n_users"], cs.NCF_DATA["n_items"], 2,
                   **cs.NCF, device="cpu")
    assert ncf.model.param_count() == cs.NCF_PARAMS
    assert cs.dense_shapes(ncf.model) == cs.RECO_DENSE["ncf"]
    info = cs.census_info()
    assert (info.wide_dim, info.indicator_dim) == (173, 16)
    wad = WideAndDeep(2, info, "wide_n_deep", hidden_layers=cs.WAD_HIDDEN,
                      device="cpu")
    assert cs.dense_shapes(wad.model) == cs.RECO_DENSE["wad"]
    assert len(cs.reco_shapes()) == 8 and (64, 32) in cs.reco_shapes()


def _census_example():
    import importlib.util
    import pathlib
    path = pathlib.Path(cs.__file__).parent / "examples" / \
        "wide_deep_census.py"
    spec = importlib.util.spec_from_file_location("wide_deep_census", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_census_columns_are_the_examples_surrogate():
    """The numpy generator draws what the example's ``synth_census``
    draws (pandas, same seed) and engineers its columns as the example's
    transformers do: the same labels, buckets, category codes and
    normalised values."""
    import pandas as pd
    ex = _census_example()
    n, seed = 3000, 11
    df = ex.synth_census(n, seed)
    cols, y = cs.census_columns(n, seed)
    np.testing.assert_array_equal(y, df["label"].to_numpy())
    np.testing.assert_array_equal(cols["age_bucket"], pd.cut(
        df["age"], bins=[0, 25, 35, 45, 55, 65, 200], labels=False))
    np.testing.assert_array_equal(cols["hours_bucket"], pd.cut(
        df["hours_per_week"], bins=[0, 25, 39, 41, 50, 200], labels=False))
    np.testing.assert_array_equal(cols["gain_flag"],
                                  (df["capital_gain"] > 0).astype(int))
    for col in ("workclass", "education", "occupation", "relationship",
                "gender"):
        codes = {v: i for i, v in enumerate(sorted(df[col].unique()))}
        np.testing.assert_array_equal(cols[f"{col}_id"],
                                      df[col].map(codes).to_numpy())
    np.testing.assert_allclose(cols["age_norm"], (df["age"] - 38.0) / 13.0)
    np.testing.assert_allclose(cols["hours_norm"],
                               (df["hours_per_week"] - 40.0) / 12.0)
    assert 0.25 < y.mean() < 0.5


@pytest.fixture
def tiny_reco(monkeypatch):
    """Phase 8 at a tiny width on the CPU: NeuralCF over 40 users x 30
    items (embeds 8, hidden (16, 8)), WideAndDeep hidden (8, 4) over 2000
    Census rows, small batches, the kernels' launch counts 0 (no card),
    and the HR gap widened to 0.1 (one of 40 users is 0.025)."""
    from analytics_zoo_tpu_torch.common import context
    monkeypatch.setattr(cs, "NCF", dict(user_embed=8, item_embed=8,
                                        hidden_layers=(16, 8), mf_embed=8))
    monkeypatch.setattr(cs, "NCF_DATA", dict(n_users=40, n_items=30))
    monkeypatch.setattr(cs, "NCF_BATCH", 128)
    monkeypatch.setattr(cs, "NCF_LR", 1e-2)
    monkeypatch.setattr(cs, "NCF_EVAL", dict(num_neg=20, k=10, seed=123))
    monkeypatch.setattr(cs, "RECO_BATCH", 256)
    monkeypatch.setattr(cs, "RECO_HR_GAP", 0.1)
    monkeypatch.setattr(cs, "RECO_DENSE", {
        "ncf": ((16, 16), (16, 8), (16, 2)),
        "wad": ((173, 2), (34, 8), (8, 4), (4, 2))})
    monkeypatch.setattr(cs, "RECO_LAUNCHES", {"f32": {}, "int8": {},
                                              "int4": {}})
    monkeypatch.setattr(cs, "CENSUS_ROWS", 2000)
    monkeypatch.setattr(cs, "CENSUS_TRAIN", 1600)
    monkeypatch.setattr(cs, "WAD_HIDDEN", (8, 4))
    monkeypatch.setattr(cs, "WAD_BATCH", 64)
    monkeypatch.setattr(cs, "WAD_LR", 1e-2)
    monkeypatch.setattr(cs, "WAD_PREDICT_BATCH", 128)
    monkeypatch.setattr(context, "_global_ctx",
                        context.ZooContext(context.ZooConf(device="cpu")))


def _sync_ratings(monkeypatch):
    """synthetic_ml1m at 30 items with 12 interactions a user."""
    real = cs.synthetic_ml1m
    monkeypatch.setattr(cs, "synthetic_ml1m",
                        lambda **kw: real(ratings_per_user=12, **kw))


def test_reco_ncf_phase_on_cpu(tiny_reco, monkeypatch):
    """Trained (the loss falls), ranked and served in f32, int8 and int4
    on the CPU (every wrapper takes its plain version there, so each
    route's check against the plain route passes), recommend_for_user
    included; then a one-ulp change of one int8 probability, a launch
    count off by one, a rising loss and an HR below its floor are
    rejected."""
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    _sync_ratings(monkeypatch)
    data = cs.ncf_data(0)
    assert (data["n_users"], data["n_items"]) == (40, 30)
    ncf = NeuralCF(40, 30, 2, **cs.NCF, device="cpu")
    ncf.init_weights(0)
    assert cs.dense_shapes(ncf.model) == cs.RECO_DENSE["ncf"]
    epochs = cs.ncf_train(ncf, data, 0)
    cs.check_ncf_train(epochs, hr_min=0.2)
    params = cs.numpy_tree(cs.export_params(ncf.model))
    served = cs.ncf_serve(ncf, params, data, torch.device("cpu"))
    run = served["int8"]
    assert run["probs"].shape == (40 * 21, 2) and run["forwards"] == 4
    assert run["x"][0].shape == (40 * 21, 1)
    bad = run["probs"].copy()
    bad[3, 1] = np.nextafter(bad[3, 1], np.float32(1))
    with pytest.raises(cs.SmokeFailure, match="bitwise"):
        cs.check_route("ncf[int8]", bad, run["probs"], 8)
    with pytest.raises(cs.SmokeFailure, match="plain route"):
        cs.check_route("ncf[int4]", run["probs"] + 1e-3, run["probs"], 4)
    monkeypatch.setattr(cs, "RECO_LAUNCHES", {"int8": {"w8a8": 1}})
    good = dict(run, card={"w8a8": 12, "w4a16": 0},
                wrapper={"w8a8": 12, "w4a16": 0})
    cs.check_launches("ncf[int8]", good, 3)
    for bad_counts in ({"w8a8": 11, "w4a16": 0}, {"w8a8": 12, "w4a16": 1}):
        with pytest.raises(cs.SmokeFailure, match="launches"):
            cs.check_launches("ncf[int8]", dict(good, card=bad_counts), 3)
    rising = [dict(e) for e in epochs]
    rising[-1]["loss"] = rising[0]["loss"] + 1.0
    with pytest.raises(cs.SmokeFailure, match="did not fall"):
        cs.check_ncf_train(rising, hr_min=0.0)
    with pytest.raises(cs.SmokeFailure, match="HR@10"):
        cs.check_ncf_train(epochs, hr_min=1.01)


def test_reco_wide_and_deep_phase_on_cpu(tiny_reco):
    """Trained above the majority class and served in int8 and int4 on
    the CPU, each against the plain route."""
    out = cs.wad_phase(0, torch.device("cpu"))
    assert out["accuracy"] > 0.6
    assert out["int8"]["forwards"] == out["int4"]["forwards"] == 4


# -- phase 9: the recurrent zoo -----------------------------------------------

def test_recurrent_dense_shapes_are_the_full_width_models():
    """The phase's (K, N) table is the Dense inventory of the models at
    their smoke configurations (built on the meta-free CPU at full
    width), and the session model's parameter count is the constant the
    phase checks."""
    from analytics_zoo_tpu_torch.models.anomalydetection import \
        AnomalyDetector
    from analytics_zoo_tpu_torch.models.recommendation import \
        SessionRecommender
    sr = SessionRecommender(**cs.SESSION, device="cpu")
    assert cs.dense_shapes(sr.model) == cs.RECURRENT_DENSE["session"]
    assert sr.model.param_count() == cs.SESSION_PARAMS
    ad = AnomalyDetector(**cs.ANOMALY, device="cpu")
    assert cs.dense_shapes(ad.model) == cs.RECURRENT_DENSE["anomaly"]
    assert cs.recurrent_shapes() == [(20, 37484), (100, 40), (40, 20),
                                     (15, 1)]
    b = cs.w8a8_bound(1024, 20, 37484)
    assert b["bound_by"] == "bytes" and b["bytes"] > 153e6
    reqs = cs.seq2seq_requests(0)
    assert len(reqs) == cs.SEQ2SEQ_REQUESTS == 64
    assert all(4 <= len(p) <= 24 for _, p, _ in reqs)
    assert [b for _, _, b in reqs[:8]] == list(cs.SEQ2SEQ_BUDGETS)


def test_session_data_is_predictable_from_the_session():
    """Each session, its label and its history lie in one cluster; the
    popularity baseline is far below what the cluster tells."""
    data = cs.session_data(0)
    assert data["x_train"][0].shape == (cs.SESSION_TRAIN,
                                        cs.SESSION["session_length"])
    assert data["x_test"][1].shape == (cs.SESSION_TEST,
                                       cs.SESSION["history_length"])
    assert data["y_train"].min() >= 1
    assert data["y_train"].max() <= cs.SESSION["item_count"]
    again = cs.session_data(0)
    assert np.array_equal(again["y_test"], data["y_test"])
    base = cs.popularity_baseline(data)
    assert base["recall"] < 0.25
    probs = np.zeros((3, 6), np.float32)
    probs[:, 2] = 0.5
    probs[0, 4] = 0.6
    r, m = cs.rank_metrics(probs, np.array([2, 2, 4]), k=2)
    assert (r, m) == (3.0, 0.5 + 1.0 + 0.5)


@pytest.fixture
def tiny_recurrent(monkeypatch):
    """Phase 9 at a tiny width on the CPU: 1000 items in 16 clusters, embed
    8, GRU (8, 4), MLP (8, 4), 4096 training sessions at batch 256; an
    AnomalyDetector (4, 6, 3) over 600 points; the kernels' launch counts
    0 (no card); a Seq2seq of vocab 64 serving 12 requests."""
    from analytics_zoo_tpu_torch.common import context
    monkeypatch.setattr(cs, "SESSION", dict(
        item_count=1000, item_embed=8, rnn_hidden_layers=(8, 4),
        session_length=5, include_history=True, mlp_hidden_layers=(8, 4),
        history_length=3))
    monkeypatch.setattr(cs, "SESSION_PARAMS", 2 * 1001 * 8 + 408 + 156
                        + 2 * (4 * 1001 + 1001) + 72 + 36)
    monkeypatch.setattr(cs, "SESSION_TRAIN", 4096)
    monkeypatch.setattr(cs, "SESSION_TEST", 512)
    monkeypatch.setattr(cs, "SESSION_BATCH", 256)
    monkeypatch.setattr(cs, "SESSION_LR", 2e-2)
    monkeypatch.setattr(cs, "SESSION_CLUSTERS", 16)
    monkeypatch.setattr(cs, "SESSION_RECALL_GAP", 0.05)
    monkeypatch.setattr(cs, "ANOMALY", dict(
        feature_shape=(24, 1), hidden_layers=(4, 6, 3),
        dropouts=(0.2, 0.2, 0.2)))
    monkeypatch.setattr(cs, "ANOMALY_POINTS", 600)
    monkeypatch.setattr(cs, "ANOMALY_PLANTED", 4)
    monkeypatch.setattr(cs, "ANOMALY_TOP", 4)
    monkeypatch.setattr(cs, "RECURRENT_DENSE", {
        "session": ((4, 1001), (8, 8), (8, 4), (4, 1001)),
        "anomaly": ((3, 1),)})
    monkeypatch.setattr(cs, "RECO_LAUNCHES", {"f32": {}, "int8": {},
                                              "int4": {}})
    monkeypatch.setattr(cs, "SEQ2SEQ", dict(vocab_size=64, embed_dim=8,
                                            hidden_sizes=(16,),
                                            bridge="dense"))
    monkeypatch.setattr(cs, "SEQ2SEQ_REQUESTS", 12)
    monkeypatch.setattr(cs, "SEQ2SEQ_BUDGETS", (4, 6, 8, 20))
    monkeypatch.setattr(cs, "SEQ2SEQ_GEN", dict(
        cs.SEQ2SEQ_GEN, max_active_slots=4, decode_quantum=3,
        max_tokens=20))
    monkeypatch.setattr(cs, "RESUME_LEASE_S", 0.3)
    monkeypatch.setattr(context, "_global_ctx",
                        context.ZooContext(context.ZooConf(device="cpu")))


def test_recurrent_session_phase_on_cpu(tiny_recurrent):
    """Trained (the loss falls, Recall@20 above the popularity
    baseline's), served in f32, int8 and int4 on the CPU (every wrapper
    takes its plain version there, so each route's check against the
    plain route passes), recommend_for_session included; a rising loss,
    a recall below its floor and a launch count off by one are
    rejected."""
    out = cs.session_phase(0, torch.device("cpu"))
    epochs = out["epochs"]
    base = cs.popularity_baseline(cs.session_data(0))
    assert epochs[-1]["recall"] > base["recall"] + 0.05
    for tag in ("f32", "int8", "int4"):
        assert out["served"][tag]["forwards"] == 2
    rising = [dict(e) for e in epochs]
    rising[-1]["loss"] = rising[0]["loss"] + 1.0
    with pytest.raises(cs.SmokeFailure, match="did not fall"):
        cs.check_session_train(rising, base, recall_min=0.0)
    with pytest.raises(cs.SmokeFailure, match="Recall@20"):
        cs.check_session_train(epochs, base, recall_min=1.01)
    run = {"forwards": 2, "card": {"w8a8": 8, "w4a16": 0},
           "wrapper": {"w8a8": 8, "w4a16": 0}}
    cs.RECO_LAUNCHES["int8"] = {"w8a8": 1}
    cs.check_launches("session[int8]", run, 4)
    with pytest.raises(cs.SmokeFailure, match="launches"):
        cs.check_launches("session[int8]",
                                 dict(run, card={"w8a8": 7, "w4a16": 0}), 4)


def test_recurrent_anomaly_phase_on_cpu(tiny_recurrent):
    """Trained (the loss falls), planted anomalies flagged, served in
    int8 and int4 against the plain route; the example's series copied
    exactly."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "anomaly_example", cs.__file__.replace(
            "chip_smoke.py", "examples/anomaly_detection.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    for args in ((), (10320, 12, 3)):
        got, want = cs.synth_series(*args), ex.synth_series(*args)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    out = cs.anomaly_phase(0, torch.device("cpu"))
    assert out["int8"]["forwards"] == out["int4"]["forwards"] == 3
    assert out["recalled"] >= 1


def test_recurrent_seq2seq_pieces_on_cpu(tiny_recurrent, tmp_path):
    """The engine serves every request its budget of tokens, each equal to
    its own ``Seq2seq.infer``; the two bare batchers agree; a reclaimed
    record with a snapshot is restarted from 0 with the downgrade event;
    a changed token that is not a near tie is rejected."""
    from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq
    model = Seq2seq(**cs.SEQ2SEQ, device="cpu")
    model.init_weights(0)
    im = InferenceModel(device="cpu").do_load_model(model)
    reqs = cs.seq2seq_requests(0)
    run = cs.seq2seq_serve(im, reqs)
    got = {rid: run["results"][rid]["value"]["tokens"] for rid, _, _ in reqs}
    cs.seq2seq_check_infer(model, reqs, got, "seq2seq[cpu]")
    eager = cs.seq2seq_batcher(im, reqs, warm=False)
    warm = cs.seq2seq_batcher(im, reqs, warm=True)
    assert eager["tokens"] == warm["tokens"] == got
    assert warm["doc"]["failed"] == 0
    rec = cs.seq2seq_reclaim(im, reqs[1], str(tmp_path))
    fails = rec["events"]["gen_resume_failed"]
    assert [e["reason"] for e in fails] == [
        "bare-state model cannot replay decode state"]
    assert len(rec["events"]["gen_resume"]) == 1
    assert rec["tokens"] == got[reqs[1][0]]
    rid, prompt, budget = reqs[0]
    bad = dict(got)
    bad[rid] = list(got[rid])
    bad[rid][1] = (bad[rid][1] + 1) % cs.SEQ2SEQ["vocab_size"]
    with pytest.raises(cs.SmokeFailure, match="near tie"):
        cs.seq2seq_check_infer(model, reqs[:1], bad, "seq2seq[bad]")
# -- phase 10: the text zoo -------------------------------------------------

# -- phase 10: the text zoo -----------------------------------------------------

def test_text_classifier_width_and_heads_are_news20s():
    """TEXT_CLS builds the 1,291,932-parameter classifier whose Dense
    shapes are TEXT_DENSE's; KNRM's head is (21, 1)."""
    from analytics_zoo_tpu_torch.models import KNRM, TextClassifier
    tc = TextClassifier(**cs.TEXT_CLS, device="cpu")
    assert tc.model.param_count() == cs.TEXT_CLS_PARAMS
    assert cs.dense_shapes(tc.model) == cs.TEXT_DENSE["classifier"]
    kn = KNRM(**cs.KNRM_GEO, device="cpu")
    assert cs.dense_shapes(kn.model) == cs.TEXT_DENSE["knrm"]


def test_text_conv_cases_are_the_layers_geometries():
    """Each one-row case is what a ``Convolution1D`` of its kernel,
    dilation and border mode hands ``w8a8_conv2d``: pads (0, 0) on the
    row axis and the 1-D layer's pads on T (an even kernel pads the end
    more); the classifier's is (M, N, K) = (63488, 256, 1000)."""
    from analytics_zoo_tpu_torch.nn.layers import AtrousConvolution1D
    cs.text_conv_bound_check(cs.TEXT_CONV)
    for (b, one, t, c), (kh, k, cg, cout), st, pads, dil, g in \
            cs.TEXT_CONV_CASES:
        assert one == kh == 1 and st == (1, 1) and g == 1 and cg == c
        assert pads[0] == (0, 0) and dil[0] == 1
        mode = "valid" if pads[1] == (0, 0) else "same"
        layer = AtrousConvolution1D(cout, k, atrous_rate=dil[1],
                                    border_mode=mode, input_shape=(t, c))
        assert layer._pads((t,)) == [pads[1]]
    with pytest.raises(cs.SmokeFailure, match="text conv"):
        cs.text_conv_bound_check(cs.TEXT_CONV_CASES[1])


def test_ner_data_tags_follow_the_words():
    """A word's tag is decided by its entity list and its place in a
    span; spellings are fixed a word; padding is word 0, tag O."""
    d = cs.ner_data(0, 256)
    w, chars = d["x"][0].astype(int), d["x"][1].astype(int)
    y = d["y"].astype(int)
    n_ent = cs.NER_ENTITY_WORDS
    ent = (w > 0) & (w <= 4 * n_ent)
    assert ((y > 0) == ent).all()
    kind = (w - 1) // n_ent
    assert (((y[ent] - 1) // 2) == kind[ent]).all()
    # an I- tag continues a span of its type
    inside = (y > 0) & (y % 2 == 0)
    prev = np.roll(y, 1, axis=1)
    assert (((prev[inside] - 1) // 2) == ((y[inside] - 1) // 2)).all()
    assert (chars[w == 0] == 0).all()
    first = {}
    for word, spell in zip(w.reshape(-1), chars.reshape(-1, chars.shape[-1])):
        assert np.array_equal(first.setdefault(int(word), spell), spell)
    assert (d["lengths"] >= 8).all() and (d["lengths"] <= cs.NER_LEN).all()


def test_ner_scores_spans_and_f1():
    spans = cs.entity_spans(np.array([1, 2, 0, 3, 4, 4, 2, 8, 0]), 9)
    assert spans == {(0, 2, 0), (3, 6, 1), (6, 7, 0), (7, 8, 3)}
    data = {"y": np.array([[1, 2, 0, 3, 0, 0]], np.float32),
            "lengths": np.array([5])}
    s = cs.ner_scores(np.array([[1, 2, 0, 5, 0, 7]]), data)
    assert s["accuracy"] == 0.8
    assert s["precision"] == s["recall"] == s["f1"] == 0.5


@pytest.fixture
def tiny_text(monkeypatch):
    """Phase 10 at a tiny width on the CPU: a 4-topic corpus of 512 + 64
    documents of 24 ids, embedding 8, encoder 8; NER / taggers with 2000
    words, sentences of 12; KNRM of 4 / 10 tokens, embedding 8; the
    kernels' launch counts 0 (no card)."""
    from analytics_zoo_tpu_torch.common import context
    monkeypatch.setattr(cs, "TEXT_CLS", dict(
        class_num=4, vocab_size=201, embedding_dim=8, sequence_length=24,
        encoder_output_dim=8))
    monkeypatch.setattr(cs, "TEXT_CLS_PARAMS",
                        201 * 8 + 5 * 8 * 8 + 8 + 8 * 128 + 128 + 128 * 4
                        + 4)
    monkeypatch.setattr(cs, "TEXT_DENSE", {"classifier": ((8, 128),
                                                          (128, 4)),
                                           "knrm": ((21, 1),)})
    monkeypatch.setattr(cs, "TEXT_MAX_WORDS", 200)
    monkeypatch.setattr(cs, "TEXT_WORDS", 400)
    monkeypatch.setattr(cs, "TEXT_TOPIC_WORDS", 10)
    monkeypatch.setattr(cs, "TEXT_TOPIC_SHARE", 0.5)
    monkeypatch.setattr(cs, "TEXT_DOC_LEN", (10, 30))
    monkeypatch.setattr(cs, "TEXT_TRAIN", 512)
    monkeypatch.setattr(cs, "TEXT_TEST", 64)
    monkeypatch.setattr(cs, "TEXT_BATCH", 32)
    monkeypatch.setattr(cs, "TEXT_LR", 1e-2)
    monkeypatch.setattr(cs, "TEXT_RNN_STEPS", 2)
    monkeypatch.setattr(cs, "TEXT_ACC_MIN", 0.5)
    monkeypatch.setattr(cs, "TEXT_ACC_GAP", 0.1)
    monkeypatch.setattr(cs, "TEXT_RECORDS", 8)
    monkeypatch.setattr(cs, "TEXT_SERVE_BATCH", 4)
    monkeypatch.setattr(cs, "TEXT_LAUNCHES", {
        k: {"f32": {}, "int8": {}, "int4": {}}
        for k in ("cnn", "lstm", "gru", "knrm")})
    monkeypatch.setattr(cs, "NER_GEO", dict(
        num_entities=9, word_vocab_size=2000, char_vocab_size=20,
        word_length=6, word_emb_dim=8, char_emb_dim=4, tagger_lstm_dim=8,
        dropout=0.5))
    monkeypatch.setattr(cs, "NER_LEN", 12)
    monkeypatch.setattr(cs, "NER_TRAIN", 512)
    monkeypatch.setattr(cs, "NER_TEST", 64)
    monkeypatch.setattr(cs, "NER_ENTITY_WORDS", 20)
    monkeypatch.setattr(cs, "TAGGER_ROWS", 64)
    monkeypatch.setattr(cs, "KNRM_GEO", dict(
        text1_length=4, text2_length=10, vocab_size=300, embed_size=8,
        kernel_num=21, sigma=0.1, exact_sigma=0.001))
    monkeypatch.setattr(cs, "KNRM_TRAIN", 512)
    monkeypatch.setattr(cs, "KNRM_BATCH", 64)
    monkeypatch.setattr(cs, "KNRM_LR", 1e-2)
    monkeypatch.setattr(cs, "KNRM_GROUPS", 8)
    monkeypatch.setattr(cs, "KNRM_CANDIDATES", 5)
    monkeypatch.setattr(cs, "KNRM_GAP", 0.2)
    monkeypatch.setattr(context, "_global_ctx",
                        context.ZooContext(context.ZooConf(device="cpu")))


def test_text_classifier_phase_on_cpu(tiny_text):
    """cnn trained (the loss falls, accuracy above its floor), lstm and
    gru stepped, each served in f32 / int8 / int4 against the plain route
    (on the CPU every wrapper takes its plain version), the cnn one also
    over ClusterServing records; a rising loss and an accuracy below its
    floor are rejected."""
    out = cs.classifier_phase(0, torch.device("cpu"))
    assert set(out) == {"cnn", "lstm", "gru"}
    for enc, run in out.items():
        for tag in ("f32", "int8", "int4"):
            assert run["served"][tag]["forwards"] == 2
    recs = out["cnn"]["records"]
    assert all(recs[t]["forwards"] >= 2 for t in recs)
    bad = dict(out["cnn"], losses=[1.0, 2.0])
    with pytest.raises(cs.SmokeFailure, match="did not fall"):
        cs.check_text_train("cnn", bad, 0.0)
    with pytest.raises(cs.SmokeFailure, match="accuracy"):
        cs.check_text_train("cnn", out["cnn"], 1.01)
    run = {"forwards": 2, "card": {"w8a8": 4, "w4a16": 0, "w8a8_conv": 2},
           "wrapper": {"w8a8": 4, "w4a16": 0, "w8a8_conv": 2}}
    cs.check_text_launches("text[cnn/int8]", run,
                           {"w8a8_conv": 1, "w8a8": 2})
    with pytest.raises(cs.SmokeFailure, match="w8a8_conv launches"):
        cs.check_text_launches("text[cnn/int8]", dict(
            run, card={"w8a8": 4, "w4a16": 0, "w8a8_conv": 1}),
            {"w8a8_conv": 1, "w8a8": 2})


def test_text_ner_and_taggers_on_cpu(tiny_text):
    """NER trained for 2 epochs (the loss falls) and its Viterbi paths
    scored; SequenceTagger and IntentEntity stepped, their loss falling;
    an F1 below its floor is rejected."""
    out = cs.ner_phase(0, torch.device("cpu"), f1_min=0.0)
    assert 0.0 <= out["f1"] <= 1.0 and out["accuracy"] > 0.5
    with pytest.raises(cs.SmokeFailure, match="F1"):
        cs.ner_phase(0, torch.device("cpu"), f1_min=1.01)
    tg = cs.taggers_phase(0, torch.device("cpu"))
    assert all(v["after"] < v["before"] for v in tg.values())


def test_text_knrm_phase_on_cpu(tiny_text):
    """KNRM trained (the loss falls), every group's candidates scored in
    f32 / int8 / int4 in batches, against the plain route, and ranked by
    ``evaluate_ndcg`` / ``evaluate_map``; NDCG@3 / MAP below their floors
    rejected, and a ranking call out of the groups' order too."""
    out = cs.knrm_phase(0, torch.device("cpu"), ndcg_min=0.0, map_min=0.0)
    for tag in ("f32", "int8", "int4"):
        assert out[tag]["forwards"] == -(-cs.KNRM_GROUPS
                                         * cs.KNRM_CANDIDATES
                                         // cs.KNRM_BATCH)
        assert 0.0 <= out[tag]["ndcg"] <= 1.0
    with pytest.raises(cs.SmokeFailure, match="NDCG"):
        cs.knrm_phase(0, torch.device("cpu"), ndcg_min=1.01)
    groups = cs.knrm_groups(0)
    ranker = cs.GroupScores(groups, np.zeros(len(groups) * 5))
    with pytest.raises(cs.SmokeFailure, match="not group 0"):
        ranker.predict(cs.knrm_candidates(groups[1:2]))


# -- phase 11: zouwu's forecasters and automl ---------------------------------

def test_forecast_series_is_nyc_taxi_length_and_cadence():
    df = cs.forecast_series(0)
    assert len(df) == cs.FORECAST_POINTS == 10320
    dt = df["datetime"]
    assert str(dt.iloc[0]) == "2014-07-01 00:00:00"
    assert set(np.diff(dt.to_numpy()).astype("timedelta64[m]").astype(
        int)) == {30}
    assert df["value"].equals(cs.forecast_series(0)["value"])
    assert not df["value"].equals(cs.forecast_series(1)["value"])
    v = df["value"].to_numpy()
    day = np.corrcoef(v[:-48], v[48:])[0, 1]
    half = np.corrcoef(v[:-24], v[24:])[0, 1]
    assert day > 0.5 > half            # daily seasonality
    train, val, test = cs.forecast_split(df)
    assert (len(train), len(val), len(test)) == (8256, 1032, 1032)
    assert train.index[-1] + 1 == val.index[0] and \
        val.index[-1] + 1 == test.index[0]


def test_naive_forecasts_and_the_forecast_check():
    """Persistence and seasonal-naive MSE / sMAPE by hand on a crafted
    series; the check accepts a pipeline under the limit and rejects one
    above it (a planted fault: the MSE of the better naive forecast)."""
    import pandas as pd
    v = np.arange(200, dtype=np.float64) ** 1.5 + 100
    df = pd.DataFrame({"value": v})
    out = cs.naive_forecasts(df, 120, 8)
    y = v[128:]
    for name, lag in (("persistence", 1), ("seasonal_naive", 48)):
        p = v[128 - lag:200 - lag]
        assert out[name]["mse"] == pytest.approx(np.mean((y - p) ** 2))
        assert out[name]["smape"] == pytest.approx(
            100 * np.mean(2 * np.abs(p - y) / (np.abs(p) + np.abs(y))))
    best = out["persistence"]["mse"]
    assert cs.check_forecast("t", {"mse": 0.5 * best, "smape": 1.0},
                             out) == pytest.approx(0.5)
    with pytest.raises(cs.SmokeFailure, match="above"):
        cs.check_forecast("t", {"mse": best, "smape": 1.0}, out)
    with pytest.raises(cs.SmokeFailure, match="metrics"):
        cs.check_forecast("t", {"mse": float("nan"), "smape": 1.0}, out)


def test_forecast_grid_and_trial_checks():
    trials = [{"config": {"lstm_units": u, "batch_size": b,
                          "lstm_1_units": 32}, "mse": 0.1 * i}
              for i, (u, b) in enumerate((u, b) for u in (16, 32, 64)
                                         for b in (32, 64))]
    cs.check_grid(trials)
    cs.check_same_trials(trials, copy.deepcopy(trials))
    cs.check_same_trials(trials, copy.deepcopy(trials[:2]))
    with pytest.raises(cs.SmokeFailure, match="grid"):
        cs.check_grid(trials[:5])
    off = copy.deepcopy(trials)
    off[3]["mse"] = np.nextafter(off[3]["mse"], 1.0)
    with pytest.raises(cs.SmokeFailure, match="parallelism 2"):
        cs.check_same_trials(trials, off)


@pytest.fixture
def tiny_forecast(monkeypatch):
    from analytics_zoo_tpu_torch.common import context
    monkeypatch.setattr(cs, "FORECAST_POINTS", 900)
    monkeypatch.setattr(cs, "FORECAST_RECIPE", dict(epochs=1,
                                                    lstm_1_units=(16,)))
    monkeypatch.setattr(cs, "FORECAST_RATIO_MAX", 1e3)
    monkeypatch.setattr(cs, "MTNET", dict(lookback=8, long_num=1,
                                          cnn_filters=4, cnn_kernel=3,
                                          uni_size=4, ar_window=2))
    monkeypatch.setattr(cs, "MTNET_SMOKE_POINTS", 200)
    monkeypatch.setattr(cs, "SEQ2SEQ_FORECAST_STEPS", 2)
    monkeypatch.setattr(cs, "POP_K", 3)
    monkeypatch.setattr(cs, "FORECAST_BATCH", 128)
    monkeypatch.setattr(cs, "FORECAST_RECORDS", 8)
    monkeypatch.setattr(cs, "FORECAST_SERVE_BATCH", 4)
    monkeypatch.setattr(cs, "RECO_LAUNCHES", {"f32": {}, "int8": {},
                                              "int4": {}})
    monkeypatch.setattr(context, "_global_ctx",
                        context.ZooContext(context.ZooConf(device="cpu")))


def test_forecast_phase_on_cpu(tiny_forecast, tmp_path):
    """AutoTS at parallelism 2 and its first configs again at 1 (identical
    trials, no retrain), the save / load
    round trip, MTNet, the MTNet smoke recipe, Seq2Seq and the population
    trainer, then every model served in f32, int8 and int4 on the CPU
    (every wrapper takes its plain version there, so each route's check
    against the plain route passes; MTNet quantizes nothing) and the
    int8 pipeline model through ClusterServing; a quantized route off the
    plain one by a planted error is rejected."""
    dev = torch.device("cpu")
    data = cs.forecast_data(0, str(tmp_path))
    assert len(data["df"]) == 900
    auto = cs.autots_phase(0, dev, data)
    assert len(auto["trials"]) == cs.FORECAST_TRIALS
    fc = cs.forecasters_phase(0, dev, data)
    served = cs.forecast_serve_phase(dev, data, auto, fc)
    for model in ("pipeline", "lstm_forecaster", "mtnet"):
        for tag in ("f32", "int8", "int4"):
            assert served[model][tag]["forwards"] >= 1
    assert served["records"]["forwards"] >= 2
    y = served["pipeline"]["int8"]["y"]
    cs.check_route("t[int8]", y, y.copy(), 8)
    bad = y.copy()
    bad[0, 0] = np.nextafter(bad[0, 0], np.float32(1e9))
    with pytest.raises(cs.SmokeFailure, match="bitwise"):
        cs.check_route("t[int8]", bad, y, 8)


# -- phase 12: the front door ---------------------------------------------------

def test_gateway_generation_steps_on_cpu(tiny):
    """Phase 12's generation steps at a tiny width on the CPU: the
    queue-fed rounds, the HTTP rounds (clients in another process and on
    threads) with a retune under traffic, admission's computed 429s, a
    profile (202, then 409), the documents and the ledger, and usage
    conserved, each check passing as on the card."""
    waves = cs.make_requests(0, VOCAB)
    ref = cs.batcher_tokens(tiny, waves, "off", "torch")
    out = cs.gateway_generation(tiny, waves, ref, card=False)
    assert out["http"]["tok_s"] > 0 and out["http"]["ext_tok_s"] > 0
    use = out["usage"]
    assert set(use["tenants"]) == {"acme", "slowco", "unknown"}
    assert abs(use["device_s"] - use["wall_s"]) < 1e-5
    assert set(out["gateway_p50_s"]) == {"enqueue", "result"}


def test_gateway_brownout_step_on_cpu(tiny):
    """The brownout engine's objective is missed by every record: the
    ladder reaches stage 2, batch records end at ``batch_max_tokens`` and
    no partial is written once the ladder suppresses them."""
    bo = cs.brownout_step(tiny, cs.make_requests(0, VOCAB))
    assert bo["stage"] >= 2 and bo["partials_before"] > 0
    assert [t["to"] for t in bo["transitions"]][:2] == [1, 2]


def test_gateway_predict_step_on_cpu(tiny_predict, monkeypatch, tmp_path):
    """JSON records through the gateway into the int8 predict engine: every
    top-5 equal to ``InferenceModel.predict`` on the batch the engine
    formed (the plain versions here, so no launch is counted)."""
    monkeypatch.setattr(cs, "PREDICT_WARMUP", {"max_batch": 4,
                                               "scales": "off"})
    monkeypatch.setattr(cs, "N_RECORDS", 8)
    pr = cs.predict_http_step(0, torch.device("cpu"), str(tmp_path),
                              launches=False)
    assert pr["forwards"] >= 2 and pr["records_s"] > 0
    assert pr["card"] == {"flash_fwd": 0, "w8a8": 0}


class _Drained:
    def __init__(self, records):
        self.records = records

    def drain_usage(self):
        return list(self.records)


def test_gateway_usage_check_rejects_faults():
    """The usage check holds the drained device seconds to the charged
    walls and each tenant's records and tokens to what was delivered (less
    each request's prefill token); a fault in any of them is rejected."""
    rec = {"tenant": "acme", "model": "default", "records": 2,
           "tokens": 10, "device_s": 0.75, "bytes": 40, "sheds": 0}
    good = _Drained([rec])
    cs.usage_step(good, [0.25, 0.5], {"acme": [6, 6]})
    with pytest.raises(cs.SmokeFailure, match="device seconds"):
        cs.usage_step(good, [0.25, 0.51], {"acme": [6, 6]})
    with pytest.raises(cs.SmokeFailure, match="tokens"):
        cs.usage_step(good, [0.75], {"acme": [6, 7]})
    with pytest.raises(cs.SmokeFailure, match="records"):
        cs.usage_step(good, [0.75], {"acme": [6, 6, 1]})
    with pytest.raises(cs.SmokeFailure, match="tenants"):
        cs.usage_step(_Drained([rec, dict(rec, tenant="zeta")]), [1.5],
                      {"acme": [6, 6]})


def test_gateway_items_split_tenants_within_the_slow_burst():
    """Step 1's posts: slowco's share fits its burst, priorities
    alternate, and the rids carry the round's tag."""
    items = cs.gateway_items(cs.make_requests(0, VOCAB), "t")
    slow = [i for i in items if i[2] == "slowco"]
    assert len(items) == cs.N_REQUESTS
    assert len(slow) == cs.GATEWAY_ADMISSION["tenants"]["slowco"]["burst"]
    assert {i[3] for i in items} == {"interactive", "batch"}
    assert all(rid.startswith("t-req-") for rid, *_ in items)
    assert cs.untagged({rid: [1] for rid, *_ in items}, "t").keys() == {
        rid for w in cs.make_requests(0, VOCAB) for rid, _ in w}


# -- phase 13: the fleet's host-side helpers ------------------------------------

def _prom(counts, total, sum_s, name="serving_time_to_first_token_seconds",
          labels=""):
    lines = [f"# TYPE {name} histogram"]
    for le, c in counts:
        lines.append(f'{name}_bucket{{{labels}le="{le}"}} {c}')
    lines += [f'{name}_bucket{{{labels}le="+Inf"}} {total}',
              f"{name}_sum {sum_s}", f"{name}_count {total}"]
    return "\n".join(lines) + "\n"


def test_fleet_histogram_p50_interpolates_merged_buckets():
    """``histogram_quantile(0.5)`` over the buckets of a merged text, an
    earlier reading subtracted, linear within the bucket as Prometheus
    interpolates; label sets summed; none without samples."""
    name = "serving_time_to_first_token_seconds"
    before = cs.prom_buckets(_prom([(0.05, 2), (0.1, 2)], 2, 0.05), name)
    after = cs.prom_buckets(
        _prom([(0.05, 2), (0.1, 8), (0.25, 12)], 12, 1.0)
        + _prom([(0.05, 0), (0.1, 0), (0.25, 0)], 0, 0.0,
                labels='model="m",'), name)
    assert after[0.1] == 8 and after[float("inf")] == 12
    # 10 new samples: 0 below 0.05, 6 in (0.05, 0.1], 4 in (0.1, 0.25]
    p50 = cs.histogram_p50(after, before)
    assert p50 == pytest.approx(0.05 + 0.05 * 5 / 6)
    assert cs.histogram_p50(before, before) is None
    # a median past the last finite bucket reads that bucket's edge
    tail = cs.prom_buckets(_prom([(0.05, 0)], 4, 9.0), name)
    assert cs.histogram_p50(tail, {}) == 0.05


def test_fleet_prom_value_sums_series_and_last_json():
    text = ("# TYPE serving_decode_steps_total counter\n"
            "serving_decode_steps_total 120\n"
            'serving_decode_steps_total{replica="r1"} 84\n'
            "serving_decode_steps_total_other 5\n")
    assert cs.prom_value(text, "serving_decode_steps_total") == 204.0
    assert cs.last_json("noise\n{\"a\": 1}\nmore\n{\"b\": 2}\n") == {"b": 2}
    assert cs.last_json("no json here") is None


def test_fleet_topologies_build_the_phase_models(tmp_path):
    """The topology files the phase writes build, in a fresh namespace,
    the models whose keys its ``.npz`` files hold."""
    from analytics_zoo_tpu_torch.utils.convert import export_params
    from analytics_zoo_tpu_torch.utils.serialization import _flatten_with_paths
    saved = (cs.GPT2_SMALL, cs.PREDICT)
    cs.GPT2_SMALL = dict(vocab_size=97, hidden=16, n_head=2, n_layers=1,
                         max_len=32)
    cs.PREDICT = dict(vocab=11, hidden_size=8, n_block=1, n_head=2,
                      seq_len=4)
    try:
        for text, want in ((cs.predict_topology(),
                            cs.fleet_predict_model(0)),
                           (cs.lm_topology(), TransformerLM(
                               **cs.GPT2_SMALL, device="cpu"))):
            scope = {}
            exec(compile(text, "topology.py", "exec"), scope)
            got = scope["build_model"]()
            assert [k for k, _ in _flatten_with_paths(export_params(got))] \
                == [k for k, _ in _flatten_with_paths(export_params(want))]
    finally:
        cs.GPT2_SMALL, cs.PREDICT = saved


# -- phase 14: the Estimator's leftovers, rehearsed on the CPU -------------------

@pytest.fixture
def tiny_estimator(tiny_train, monkeypatch):
    """``tiny_train``'s model with one-group epochs of 4 x 4 sequences."""
    monkeypatch.setattr(cs, "RESUME_SEQS", cs.K_STEPS * cs.TRAIN_BATCH)
    monkeypatch.setattr(cs, "K_SEQS", 10 * cs.TRAIN_BATCH)
    return tiny_train[0]


def test_estimator_graph_vs_eager_on_cpu(tiny_estimator):
    """On the CPU both routes are eager steps: losses and weights equal,
    the loss falls over 20 steps of groups 4, 4, 2."""
    x, _ = cs.k_data(0)
    assert x.shape[0] == cs.K_SEQS
    out = cs.graph_vs_eager(tiny_estimator, 0, torch.device("cpu"),
                            card=False)
    assert out["loss_gap"] == 0.0 and out["weight_gap"] == 0.0


def test_estimator_retry_tensorboard_and_preemption_on_cpu(tiny_estimator,
                                                          tmp_path):
    """The reference run, the retried run (ends on the reference's
    weights), the NativeFeatureSet-fed run with TensorBoard files and a
    profile, and a victim process (this script's ``fit_victim`` on the
    tiny model, slowed so SIGTERM lands mid-run) that exits 143 and
    resumes to the reference's losses."""
    cpu = torch.device("cpu")
    ref = cs.resume_reference(tiny_estimator, 0, cpu)
    assert sorted(ref["losses"]) == list(range(1, cs.RESUME_STEPS + 1))
    assert cs.retry_step(tiny_estimator, 0, cpu, ref,
                         str(tmp_path))["weight_gap"] == 0.0
    tb = cs.tensorboard_step(tiny_estimator, 0, cpu, ref, str(tmp_path),
                             card=False)
    assert tb["kernels"] == {k: 0 for k in cs.K_KERNELS}
    code = (
        "import sys, time, torch, chip_smoke as cs\n"
        f"cs.TRAIN = {cs.TRAIN!r}\n"
        f"cs.TRAIN_SEQS, cs.TRAIN_BATCH = {cs.TRAIN_SEQS}, {cs.TRAIN_BATCH}\n"
        f"cs.TRAIN_SUBVOCAB, cs.TRAIN_LR = {cs.TRAIN_SUBVOCAB}, "
        f"{cs.TRAIN_LR}\n"
        f"cs.RESUME_SEQS = {cs.RESUME_SEQS}\n"
        "torch.set_num_threads(1)\n"
        "say = cs.say\n"
        "cs.say = lambda *a: (say(*a), time.sleep(0.1))\n"
        "sys.exit(cs.fit_victim(sys.argv[1], 0, '--resume' in sys.argv, "
        "torch.device('cpu')))\n")
    vdir = tmp_path / "victim"
    vdir.mkdir()
    procs = cs.start_fit_victims(0, str(vdir), victim_cmd=[
        sys.executable, "-c", code, str(vdir)])
    try:
        out = cs.preemption_step(0, ref, str(vdir), procs, timeout_s=120)
    finally:
        cs.stop_fit_victims(procs)
    assert 1 <= out["snapshot_step"] < cs.RESUME_STEPS
    assert out["gap"] == 0.0


# -- phase 17: multi-GPU training, rehearsed on the CPU ---------------------------

_TINY_PARALLEL = dict(
    TRAIN=dict(vocab=66, hidden_size=32, n_block=4, n_head=4, seq_len=32),
    TRAIN_SUBVOCAB=16, PAR_RING=(2, 4, 64, 16),
    PAR_MOE=dict(num_experts=4, hidden_dim=16), PAR_MOE_TOKENS=(2, 8))


@pytest.fixture
def tiny_parallel(monkeypatch):
    for k, v in _TINY_PARALLEL.items():
        monkeypatch.setattr(cs, k, v)


def test_parallel_phase_on_cpu(tiny_parallel, tmp_path):
    """Phase 17 at a tiny width: 4 ranks (this script's
    ``parallel_worker`` in processes of their own, on the CPU over gloo)
    run the ring, the 5 layouts' fits and the MoE against the references
    and a gloo world of one made here (every wrapper takes its plain
    version, so no launch is counted); the checks accept them and reject
    a doctored report."""
    sets = "; ".join(f"cs.{k} = {v!r}" for k, v in _TINY_PARALLEL.items())

    def cmd(rank, port):
        return [sys.executable, "-c",
                "import sys, torch; import chip_smoke as cs; "
                f"{sets}; sys.exit(cs.parallel_worker({str(tmp_path)!r}, "
                f"{rank}, {port}, 0, device=torch.device('cpu')))"]

    workers = cs.start_parallel_workers(0, str(tmp_path), cmd=cmd)
    try:
        out = cs.parallel_phase(0, {}, workers, cs.build_train_model(0),
                                dev=torch.device("cpu"), backend="gloo")
    finally:
        cs.stop_parallel_workers(workers)
    reports = out["reports"]
    assert sorted(r["rank"] for r in reports) == [0, 1, 2, 3]
    assert [r["seq_index"] for r in reports] == [0, 1, 2, 3]
    fits = reports[0]["fits"]
    assert [fits[t]["rows"] for t, *_ in cs.PAR_LAYOUTS] == [8, 32, 32, 16,
                                                            32]
    assert all(r["moe"]["experts_held"] == 1 for r in reports)
    bad = copy.deepcopy(reports)
    bad[2]["fits"]["seq 4"]["loss_rgap"] = 2 * cs.PAR_LOSS_RTOL
    with pytest.raises(cs.SmokeFailure, match="fit seq 4"):
        cs.check_parallel(bad, out["refs"], card=False)
    bad = copy.deepcopy(reports)
    bad[1]["ring"]["causal"]["card"]["flash_fwd"] = 1
    with pytest.raises(cs.SmokeFailure, match="ring"):
        cs.check_parallel(bad, out["refs"], card=False)
    assert cs.par_expected_launches("seq 4", {"seq": 2}) == \
        cs.TRAIN["n_block"] * cs.PAR_STEPS * 3
    assert cs.par_expected_launches("pipe 4", {"pipe": 1}) == \
        cs.TRAIN["n_block"] // 4 * (cs.PAR_MICRO + 3) * cs.PAR_STEPS
