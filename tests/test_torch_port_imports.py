"""PyTorch port: import and device rules.

- Every module of ``analytics_zoo_tpu_torch`` imports in a fresh
  interpreter in which ``jax`` cannot be imported, and pulls in nothing of
  ``analytics_zoo_tpu``.
- No file of the package names ``jax`` or ``analytics_zoo_tpu`` in an
  import statement.
- Entry points run on ``cuda:0`` unless told otherwise: with no device
  given and no CUDA present they raise instead of carrying on on the CPU.
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
                "models.recommendation.session_recommender"):
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
