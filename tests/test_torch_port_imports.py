"""PyTorch port: import and device rules.

- Every module of ``analytics_zoo_tpu_torch`` imports in a fresh
  interpreter in which ``jax`` cannot be imported, and pulls in nothing of
  ``analytics_zoo_tpu``.
- No file of the package names ``jax`` or ``analytics_zoo_tpu`` in an
  import statement.
- Entry points run on ``cuda:0`` unless told otherwise: with no device
  given and no CUDA present they raise instead of carrying on on the CPU.
- The package-level import surface: every name a JAX package
  ``__init__.py`` exports imports from the same place in the port, with
  ``jax`` blocked, unless ``NOT_PORTED`` lists it, and then it must be
  absent (so a later port moves it off the list); a JAX package whose
  ``__init__.py`` the port has not got at all is in
  ``PACKAGES_NOT_PORTED``.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import analytics_zoo_tpu_torch
from analytics_zoo_tpu_torch.common import context
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM

torch.set_num_threads(1)

PKG = pathlib.Path(analytics_zoo_tpu_torch.__file__).parent
REPO = PKG.parent

_PROBE = """
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
import analytics_zoo_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
for n in names:
    importlib.import_module(n)
print(json.dumps({"modules": names, "foreign": sorted(
    k for k, m in sys.modules.items() if m is not None
    and k.split(".")[0] in ("jax", "jaxlib", "analytics_zoo_tpu"))}))
"""


def test_every_module_imports_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["foreign"] == []
    for mod in ("serving.engine", "serving.generate", "serving.faults",
                "serving.tracecollect", "ops.paged_attention",
                "models.textmodels", "utils.convert", "estimator.estimator",
                "nn.objectives", "nn.metrics", "nn.optimizers",
                "common.triggers", "feature.dataset", "feature.common",
                "feature.image", "ops.quant_matmul", "nn.layers.conv",
                "inference.quantize", "models.imageclassification",
                "models.recommendation", "models.recommendation.neuralcf",
                "models.recommendation.wide_and_deep",
                "models.recommendation.recommender",
                "models.recommendation.movielens", "nn.layers.core",
                "nn.layers.recurrent", "models.seq2seq",
                "models.anomalydetection",
                "models.recommendation.session_recommender",
                "nn.layers.crf", "nn.layers.pooling", "feature.text",
                "models.textclassification", "models.textmatching",
                "automl", "automl.search", "automl.feature",
                "automl.regression", "automl.population", "zouwu",
                "zouwu.forecast", "utils.serialization", "interop",
                "interop.keras_import", "serving.admission",
                "serving.brownout", "serving.metering", "serving.http",
                "inference.resources"):
        assert f"analytics_zoo_tpu_torch.{mod}" in doc["modules"]


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_or_reference_package_imports(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "analytics_zoo_tpu"), \
            f"{path.relative_to(REPO)} imports {name}"


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("ZOO_TPU_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        context.init_context()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceModel()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(vocab_size=8, hidden=8, n_head=2, n_layers=1,
                      max_len=8)


def test_explicit_cpu_device_and_context(monkeypatch):
    monkeypatch.delenv("ZOO_TPU_DEVICE", raising=False)
    ctx = context.init_context(device="cpu", seed=7)
    assert ctx.device == torch.device("cpu")
    assert context.get_context() is ctx and ctx.conf.seed == 7
    a, b = ctx.next_seed(), ctx.next_seed()
    ctx.set_seed(7)
    assert ctx.next_seed() == a and a != b
    assert context.resolve_device("cuda") == torch.device("cuda", 0)
    monkeypatch.setenv("ZOO_TPU_DEVICE", "cpu")
    assert context.ZooConf.from_env().device == "cpu"


def test_tf32_off_for_f32_products():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_seeded_weights_are_reproducible():
    geo = dict(vocab_size=16, hidden=8, n_head=2, n_layers=1, max_len=8)
    a = TransformerLM(**geo, seed=5, device="cpu")
    b = TransformerLM(**geo, seed=5, device="cpu")
    c = TransformerLM(**geo, seed=6, device="cpu")
    assert torch.equal(a.blocks[0].qkv.W, b.blocks[0].qkv.W)
    assert not torch.equal(a.embed, c.embed)


def test_recurrent_entry_points_follow_the_device_rule(monkeypatch):
    """``Seq2seq`` and the recurrent zoo models resolve ``cuda:0`` with no
    device given, so with no CUDA they raise; ``device="cpu"`` builds on
    the CPU."""
    from analytics_zoo_tpu_torch.models.anomalydetection import \
        AnomalyDetector
    from analytics_zoo_tpu_torch.models.recommendation import \
        SessionRecommender
    from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builds = (lambda **kw: Seq2seq(8, embed_dim=4, hidden_sizes=(4,), **kw),
              lambda **kw: SessionRecommender(9, item_embed=4,
                                              rnn_hidden_layers=(3,),
                                              session_length=3, **kw),
              lambda **kw: AnomalyDetector((4, 1), (3,), (0.1,), **kw))
    for build in builds:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        m = build(device="cpu")
        model = getattr(m, "model", m)
        assert {p.device for p in model.parameters()} == {
            torch.device("cpu")}


def test_text_entry_points_follow_the_device_rule(monkeypatch):
    """``TextClassifier``, ``KNRM`` and the taggers resolve ``cuda:0`` with
    no device given, so with no CUDA they raise; ``device="cpu"`` builds
    on the CPU."""
    from analytics_zoo_tpu_torch.models import KNRM, TextClassifier
    from analytics_zoo_tpu_torch.models.textmodels import (
        NER, IntentEntity, SequenceTagger)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    geo = dict(word_vocab_size=9, char_vocab_size=5, word_length=3,
               word_emb_dim=4, char_emb_dim=2, tagger_lstm_dim=3)
    builds = (lambda **kw: TextClassifier(3, 9, embedding_dim=4,
                                          sequence_length=6,
                                          encoder_output_dim=3, **kw),
              lambda **kw: KNRM(3, 5, 9, embed_size=4, **kw),
              lambda **kw: NER(4, **geo, **kw),
              lambda **kw: SequenceTagger(4, 3, **geo, **kw),
              lambda **kw: IntentEntity(2, 4, **geo, **kw))
    for build in builds:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        model = build(device="cpu").model
        assert {p.device for p in model.parameters()} == {
            torch.device("cpu")}

# -- the package-level import surface ---------------------------------------

JAX_PKG = REPO / "analytics_zoo_tpu"

# names a JAX package __init__.py exports that the port has not ported
# yet, by the package that exports them
NOT_PORTED = {
    "": {"init_nncontext", "mesh"},
    "nn.layers": {
        # conv.py
        "AtrousConvolution2D", "Convolution3D", "Cropping1D", "Cropping2D",
        "Cropping3D", "Deconvolution2D", "DepthwiseConvolution2D",
        "LocallyConnected1D", "LocallyConnected2D", "LRN2D",
        "ResizeBilinear", "SeparableConvolution2D", "ShareConvolution2D",
        "UpSampling1D", "UpSampling2D", "UpSampling3D", "ZeroPadding1D",
        "ZeroPadding3D",
        # pooling.py
        "AveragePooling3D", "GlobalAveragePooling3D", "GlobalMaxPooling3D",
        "MaxPooling3D",
        # math.py
        "AddConstant", "BinaryThreshold", "CAdd", "CMul", "Exp", "Expand",
        "GaussianSampler", "GetShape", "HardShrink", "HardTanh",
        "Identity", "Log", "Max", "Mul", "MulConstant", "Negative",
        "Power", "RReLU", "Scale", "SelectTable", "Softmax", "SoftShrink",
        "SplitTensor", "Sqrt", "Square", "Threshold",
        # embedding.py
        "SparseDense", "SparseEmbedding", "WordEmbedding",
        # moe.py
        "MixtureOfExperts",
        # advanced.py
        "ELU", "LeakyReLU", "MaxoutDense", "PReLU", "SReLU",
        "SpatialDropout1D", "SpatialDropout2D", "ThresholdedReLU",
        "WithinChannelLRN2D"},
}
# JAX packages whose __init__.py exports names and whose port does not
# exist yet
PACKAGES_NOT_PORTED = ("nnframes", "xshard")


def _jax_exports():
    """{dotted package (relative, "" for the root): [exported names]} from
    the JAX package's ``__init__.py`` files (read, not imported)."""
    out = {}
    for init in sorted(JAX_PKG.rglob("__init__.py")):
        tree = ast.parse(init.read_text(), filename=str(init))
        names = [a.asname or a.name for node in tree.body
                 if isinstance(node, ast.ImportFrom)
                 for a in node.names]
        if names:
            rel = init.parent.relative_to(JAX_PKG)
            out[".".join(rel.parts)] = names
    return out


EXPORTS = _jax_exports()

_SURFACE_PROBE = """
import importlib, json, sys
sys.modules["jax"] = None
found = {}
for pkg, names in json.loads(sys.argv[1]).items():
    mod = "analytics_zoo_tpu_torch" + ("." + pkg if pkg else "")
    try:
        m = importlib.import_module(mod)
    except ModuleNotFoundError:
        found[pkg] = None
        continue
    found[pkg] = [n for n in names if hasattr(m, n)]
print(json.dumps(found))
"""


@pytest.fixture(scope="module")
def port_surface():
    out = subprocess.run(
        [sys.executable, "-c", _SURFACE_PROBE, json.dumps(EXPORTS)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_jax_exports_are_read():
    assert set(EXPORTS) == {"", "nn", "nn.layers", "models",
                            "models.recommendation", "automl",
                            "zouwu"} | set(PACKAGES_NOT_PORTED)
    assert {"ZooConf", "init_context", "dtypes"} <= set(EXPORTS[""])
    assert {"Dense", "Convolution1D", "CRF", "MixtureOfExperts"} <= set(
        EXPORTS["nn.layers"])


@pytest.mark.parametrize("pkg", sorted(set(EXPORTS) - set(
    PACKAGES_NOT_PORTED)))
def test_port_exports_the_jax_names(pkg, port_surface):
    names = EXPORTS[pkg]
    todo = NOT_PORTED.get(pkg, set())
    assert todo <= set(names), sorted(todo - set(names))
    got = port_surface[pkg]
    assert got is not None, f"the port has no package {pkg!r}"
    missing = sorted(n for n in names if n not in todo and n not in got)
    assert not missing, f"analytics_zoo_tpu_torch.{pkg} lacks {missing}"
    ported = sorted(n for n in todo if n in got)
    assert not ported, f"{ported} are ported now: take them off NOT_PORTED"


@pytest.mark.parametrize("pkg", PACKAGES_NOT_PORTED)
def test_packages_not_ported_are_absent(pkg, port_surface):
    assert port_surface[pkg] is None, \
        f"analytics_zoo_tpu_torch.{pkg} exists: check its exports here"


def test_text_zoo_names_import_from_the_surface():
    code = ("import sys; sys.modules['jax'] = None\n"
            "from analytics_zoo_tpu_torch.nn.layers import Dense, "
            "Convolution1D, CRF\n"
            "from analytics_zoo_tpu_torch.models import TextClassifier, KNRM\n"
            "from analytics_zoo_tpu_torch.nn import Sequential, Model\n"
            "from analytics_zoo_tpu_torch import init_context, ZooConf\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
