"""PyTorch port: the mmap weight store and ``InferenceModel.do_load`` /
``do_load_store`` against the JAX package on the CPU.

- The on-disk format is the JAX one: the same tree saved by either
  package gives the same manifest (fingerprint, leaf files, shapes,
  dtypes, total bytes) and byte-identical leaf files, for float, int8 and
  int4 trees (0-d scale leaves included); each package loads the other's
  store with every leaf bitwise.
- ``load_store`` restores by key, by position when the template's names
  differ (natural order, dense_9 < dense_10), and raises ``KeyError`` on
  a shape mismatch, as the JAX module does; ``load_store_nested`` and
  ``graft_containers`` as the JAX module.
- ``do_load`` routes a directory to ``do_load_store`` (``load_mmap``
  true) and a ``.npz`` (either package's) through ``load_weights``;
  both predict what ``do_load_model`` predicts with the same weights,
  exactly.  A ``TransformerLM`` exports the JAX param layout, so its store
  loads in the JAX package too.
- Quantized stores: a port int8 / int4 store restores to a model whose
  quantized forward equals the exported one's bit for bit; a JAX-written
  one restores to the JAX leaves bitwise, predicting what the port
  predicts given those leaves directly; a float store that matches
  nothing keeps failing loudly.
- A restored parameter is a private copy on the CPU: writing through it
  leaves the store's bytes alone.
- ``load_flat``: a reader racing a writer that rewrites the store in a
  loop never sees an error (the JAX reader's single retry can lose that
  race; this one reads through one directory handle and starts over).
"""

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.inference import weightstore as jws
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.models.textmodels import TransformerLM as JaxLM
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.models import Sequential as JaxSeq
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.inference import weightstore as tws
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.utils.convert import export_params

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

DIN, HID, NOUT = 12, 16, 6
LM = dict(vocab_size=48, hidden=32, n_head=4, n_layers=2, max_len=64)


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved_j, saved_t = dict(jdtypes._policy), dict(tdtypes._policy)
    jdtypes.set_policy(None)
    tdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved_j)
    tdtypes._policy.update(saved_t)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    """{path: numpy leaf} of a nested dict / list of arrays or tensors."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            out.update(_leaves(v, path))
        else:
            out[path] = v.detach().numpy() if hasattr(v, "detach") \
                else np.asarray(v)
    return out


def _jax_seq(names=("ws_a", "ws_b")):
    m = JaxSeq()
    m.add(jcore.Dense(HID, activation="relu", input_shape=(DIN,),
                      name=names[0]))
    m.add(jcore.Dense(NOUT, activation="softmax", name=names[1]))
    m.init_weights()
    return m


def _port_topology(names=("ws_a", "ws_b")):
    def build():
        m = Sequential()
        m.add(tcore.Dense(HID, activation="relu", input_shape=(DIN,),
                          name=names[0]))
        m.add(tcore.Dense(NOUT, activation="softmax", name=names[1]))
        return m
    return build


def _x(seed, n=7):
    return np.random.default_rng(seed).normal(size=(n, DIN)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_trees():
    """``{"float" | "int8" | "int4": {"params", "state"}}``: one JAX
    model's weights, then quantized by the JAX ``do_quantize``."""
    out = {}
    for kind, bits in (("float", 0), ("int8", 8), ("int4", 4)):
        m = _jax_seq()
        im = JaxIM(2, 8).do_load_model(m, m._params, m._state)
        if bits:
            im.do_quantize(_x(1, 16), force=True, bits=bits, group_size=4)
        out[kind] = {"params": _np(im._params), "state": _np(im._state)}
    return out


# -- the format -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
def test_same_tree_same_store_in_both_packages(tmp_path, jax_trees, kind):
    tree = jax_trees[kind]
    jm = jws.save_store(str(tmp_path / "j"), tree)
    tm = tws.save_store(str(tmp_path / "t"), tree)
    assert tm == jm
    assert tm["fingerprint"] == jws._fingerprint(
        jws._flatten(tree)) == tws._fingerprint(tws._flatten(tree))
    for meta in tm["leaves"].values():
        with open(tmp_path / "j" / meta["file"], "rb") as f:
            want = f.read()
        with open(tmp_path / "t" / meta["file"], "rb") as f:
            assert f.read() == want
    if kind == "int8":
        assert any(m["shape"] == [] for m in tm["leaves"].values())
    # idempotent either way: each package skips the other's store
    assert tws.save_store(str(tmp_path / "j"), tree)["skipped"] is True
    assert jws.save_store(str(tmp_path / "t"), tree)["skipped"] is True


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
def test_each_package_loads_the_others_store(tmp_path, jax_trees, kind):
    tree = jax_trees[kind]
    want = _leaves(tree)
    jws.save_store(str(tmp_path / "j"), tree)
    tws.save_store(str(tmp_path / "t"), tree)
    for got in (tws.load_flat(str(tmp_path / "j")),
                jws.load_flat(str(tmp_path / "t"))):
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert isinstance(v, np.memmap)
            assert v.dtype == want[k].dtype and v.shape == want[k].shape
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    flat = tws.load_flat(str(tmp_path / "j"), mmap=False)
    assert not any(isinstance(v, np.memmap) for v in flat.values())
    assert tws.read_manifest(str(tmp_path / "j")) == \
        jws.read_manifest(str(tmp_path / "j"))
    assert tws.is_store(str(tmp_path / "j"))
    assert not tws.is_store(str(tmp_path / "nothing"))


def test_save_store_idempotent_and_rewrites_on_change(tmp_path, jax_trees):
    store = str(tmp_path / "s")
    tree = jax_trees["float"]
    first = tws.save_store(store, tree)
    assert not first.get("skipped")
    assert tws.save_store(store, tree)["skipped"] is True
    # a change mid-array (not only at the ends) forces the re-export
    changed = jax.tree.map(np.copy, tree)
    w = changed["params"]["ws_a"]["W"]
    w[DIN // 2, HID // 2] += 1.0
    again = tws.save_store(store, changed)
    assert not again.get("skipped")
    assert again["fingerprint"] != first["fingerprint"]
    assert not os.path.exists(store + ".old")
    np.testing.assert_array_equal(
        tws.load_flat(store)["params/ws_a/W"], w)


# -- template restores ----------------------------------------------------------------

def _template(build):
    m = build()
    return {"params": export_params(m), "state": {}}


def test_load_store_by_key_and_by_position(tmp_path, jax_trees):
    store = str(tmp_path / "s")
    tws.save_store(store, jax_trees["float"])
    want = _leaves(jax_trees["float"])
    by_key = tws.load_store(store, like=_template(_port_topology()))
    assert _leaves(by_key).keys() == want.keys()
    # names that sort differently as strings than as numbers: the natural
    # order maps ws_a -> layer_9 and ws_b -> layer_10
    moved = tws.load_store(
        store, like=_template(_port_topology(("layer_9", "layer_10"))))
    got = _leaves(moved)
    for src, dst in (("ws_a", "layer_9"), ("ws_b", "layer_10")):
        for leaf in ("W", "b"):
            np.testing.assert_array_equal(
                got[f"params/{dst}/{leaf}"], want[f"params/{src}/{leaf}"])
    # the JAX module's positional restore agrees
    jmoved = jws.load_store(store, like={"params": _np(
        _jax_seq(("layer_9", "layer_10"))._params), "state": {}})
    for k, v in _leaves(jmoved).items():
        np.testing.assert_array_equal(got[k], v)


def test_load_store_shape_mismatch_raises_keyerror(tmp_path, jax_trees):
    store = str(tmp_path / "s")
    tws.save_store(store, jax_trees["float"])

    def wide():
        m = Sequential()
        m.add(tcore.Dense(HID + 1, input_shape=(DIN,), name="other_a"))
        m.add(tcore.Dense(NOUT, name="other_b"))
        return m
    with pytest.raises(KeyError):
        tws.load_store(store, like=_template(wide))
    with pytest.raises(KeyError):
        jws.load_store(store, like={"params": _np(JaxSeq(
            [jcore.Dense(HID + 1, input_shape=(DIN,), name="jw_a"),
             jcore.Dense(NOUT, name="jw_b")]).init_weights()),
            "state": {}})
    with pytest.raises(KeyError, match="leaves"):
        def short():
            m = Sequential()
            m.add(tcore.Dense(NOUT, input_shape=(DIN,), name="short_a"))
            return m
        tws.load_store(store, like=_template(short))


def test_load_store_nested_and_graft_match_jax(tmp_path, jax_trees):
    store = str(tmp_path / "s")
    tws.save_store(store, jax_trees["int8"])
    like_t = _template(_port_topology(("q_9", "q_10")))
    like_j = {"params": _np(_jax_seq(("q_9", "q_10"))._params), "state": {}}
    got = _leaves(tws.load_store_nested(store, like=like_t))
    want = _leaves(jws.load_store_nested(store, like=like_j))
    assert got.keys() == want.keys()
    assert "params/q_10/W_q" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    skeleton = {"a": {"W": 1, "b": 2}, "empty": {}, "c": {"d": {}}}
    restored = {"a": {"W_q": 3, "b": 4}}
    assert tws.graft_containers(skeleton, restored, require_leaves=False) \
        == jws.graft_containers(skeleton, restored, require_leaves=False)
    with pytest.raises(KeyError):
        tws.graft_containers(skeleton, restored)
    with pytest.raises(KeyError):
        tws.load_store_nested(store, like={"params": {"x": {"W": np.zeros(
            (DIN, HID), np.float32)}, "y": {"W": np.zeros(1)},
            "z": {"W": np.zeros(1)}}})
    assert [tws._natural(p) for p in ("d/dense_9", "d/dense_10")] == \
        [jws._natural(p) for p in ("d/dense_9", "d/dense_10")]
    assert sorted(["dense_10", "dense_9"], key=tws._natural) == \
        ["dense_9", "dense_10"]


# -- InferenceModel.do_load / do_load_store ------------------------------------------

def test_do_load_store_and_npz_predict_as_do_load_model(tmp_path, jax_trees):
    tree = jax_trees["float"]
    x = _x(5)
    build = _port_topology()
    ref = InferenceModel(2, 8, device="cpu").do_load_model(
        build(), params=tree["params"])
    store = str(tmp_path / "store")
    jws.save_store(store, tree)                      # the JAX package wrote it
    im = InferenceModel(2, 8, device="cpu").do_load(build, store)
    assert im.load_mmap is True and im.load_seconds > 0
    np.testing.assert_array_equal(im.do_predict(x), ref.do_predict(x))
    # a .npz from the JAX package goes through init_weights + load_weights
    jm = _jax_seq()
    jm.set_weights(tree["params"], tree["state"])
    npz = str(tmp_path / "w.npz")
    jm.save_weights(npz)
    im2 = InferenceModel(2, 8, device="cpu").do_load(build, npz)
    assert im2.load_mmap is False and im2.load_seconds > 0
    np.testing.assert_array_equal(im2.do_predict(x), ref.do_predict(x))
    # and the JAX InferenceModel restores the port's export of it
    tws.save_store(str(tmp_path / "port"), {"params": im2._params,
                                            "state": im2._state})
    jim = JaxIM(2, 8).do_load(lambda: _jax_seq(), str(tmp_path / "port"))
    assert jim.load_mmap
    np.testing.assert_allclose(jim.do_predict(x), ref.do_predict(x),
                               atol=1e-6)


def test_restored_parameters_are_private_copies(tmp_path, jax_trees):
    store = str(tmp_path / "store")
    tws.save_store(store, jax_trees["float"])
    im = InferenceModel(device="cpu").do_load(_port_topology(), store)
    with torch.no_grad():
        for p in im._model.parameters():
            assert p.is_contiguous()
            p.add_(1.0)
    for k, v in tws.load_flat(store).items():
        np.testing.assert_array_equal(v, _leaves(jax_trees["float"])[k])


def test_transformer_lm_exports_the_jax_layout(tmp_path):
    jlm = JaxLM(**LM)
    params = _np(jlm.build(jax.random.PRNGKey(3)))
    tws.save_store(str(tmp_path / "j"), {"params": params, "state": {}})

    def build():
        return TransformerLM(**LM, seed=11, device="cpu")
    im = InferenceModel(device="cpu").do_load(build, str(tmp_path / "j"))
    got = _leaves(im._params)
    want = _leaves(params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's export is the JAX file: same store, loadable by JAX
    man = tws.save_store(str(tmp_path / "t"), {"params": im._params,
                                               "state": im._state})
    assert man["fingerprint"] == jws.read_manifest(
        str(tmp_path / "j"))["fingerprint"]
    back = jws.load_store(str(tmp_path / "t"),
                          like={"params": params, "state": {}})
    for k, v in _leaves(back).items():
        np.testing.assert_array_equal(v, _leaves({"params": params,
                                                  "state": {}})[k])
    # a .npz the port writes loads through the JAX package's serializer
    npz = str(tmp_path / "lm.npz")
    im._model.save_weights(npz)
    from analytics_zoo_tpu.utils.serialization import load_pytree
    tree = load_pytree(npz, like={"params": params, "state": {}})
    for k, v in _leaves(tree["params"]).items():
        np.testing.assert_array_equal(v, want[k])
    im2 = InferenceModel(device="cpu").do_load(build, npz)
    ids = np.random.default_rng(0).integers(0, LM["vocab_size"], (2, 9))
    with torch.no_grad():
        np.testing.assert_array_equal(
            im2._model(torch.tensor(ids)).numpy(),
            im._model(torch.tensor(ids)).numpy())


@pytest.mark.parametrize("bits", [8, 4])
def test_port_quantized_store_restores_bitwise(tmp_path, bits):
    build = _port_topology(("pq_a", "pq_b"))
    im = InferenceModel(2, 8, device="cpu").do_load_model(build())
    im.do_quantize(_x(1, 16), force=True, bits=bits, group_size=4)
    store = str(tmp_path / "store")
    tws.save_store(store, {"params": im._params, "state": im._state})
    # a fresh float model (another process would build it so) maps the
    # quantized leaves, its containers remapped from other auto-names
    back = InferenceModel(2, 8, device="cpu").do_load(
        _port_topology(("pq_c", "pq_d")), store)
    assert back.load_mmap
    from analytics_zoo_tpu_torch.inference.quantize import quantized_bits
    assert quantized_bits(back._params) == bits
    x = _x(9, 11)
    np.testing.assert_array_equal(back.do_predict(x), im.do_predict(x))
    got, want = _leaves(back._params), _leaves(im._params)
    assert [k.split("/", 1)[1] for k in sorted(got)] == \
        [k.split("/", 1)[1] for k in sorted(want)]
    for (kg, vg), (kw, vw) in zip(sorted(got.items()), sorted(want.items())):
        np.testing.assert_array_equal(vg, vw, err_msg=kw)
    # the JAX InferenceModel restores the port's quantized store too
    jim = JaxIM(2, 8).do_load(lambda: _jax_seq(("jq_a", "jq_b")), store)
    jl = _leaves(_np(jim._params))
    for (kj, vj), (kw, vw) in zip(sorted(jl.items()), sorted(want.items())):
        np.testing.assert_array_equal(vj, vw, err_msg=kw)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_jax_quantized_store_restores_to_its_leaves(tmp_path, jax_trees,
                                                    kind):
    tree = jax_trees[kind]
    store = str(tmp_path / "store")
    jws.save_store(store, tree)
    im = InferenceModel(2, 8, device="cpu").do_load(_port_topology(), store)
    want = _leaves(tree["params"])
    got = _leaves(im._params)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    direct = InferenceModel(2, 8, device="cpu").do_load_model(
        _port_topology()(), params=tree["params"])
    x = _x(4, 9)
    np.testing.assert_array_equal(im.do_predict(x), direct.do_predict(x))


def test_float_store_of_another_topology_fails_loudly(tmp_path, jax_trees):
    store = str(tmp_path / "store")
    tws.save_store(store, jax_trees["float"])

    def other():
        m = Sequential()
        m.add(tcore.Dense(NOUT, input_shape=(DIN + 3,), name="ot_a"))
        m.add(tcore.Dense(NOUT, name="ot_b"))
        return m
    with pytest.raises(KeyError):
        InferenceModel(device="cpu").do_load(other, store)


# -- the reader against a rewriting writer --------------------------------------------

def _tree(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"params": {"dense": {"W": (rng.standard_normal((4, 3))
                                       * scale).astype(np.float32),
                                 "b": np.zeros(3, np.float32)}},
            "state": {}}


def test_load_flat_retries_on_transient_error(monkeypatch, tmp_path):
    """A transient ENOENT is absorbed; a persistent mismatch escapes."""
    calls = {"n": 0}
    real = tws._load_flat_once

    def flaky(store_dir, mmap):
        calls["n"] += 1
        if calls["n"] == 1:
            raise FileNotFoundError("transient: store mid-swap")
        return real(store_dir, mmap)

    store = str(tmp_path / "s")
    tws.save_store(store, _tree())
    monkeypatch.setattr(tws, "_load_flat_once", flaky)
    flat = tws.load_flat(store)
    assert calls["n"] == 2 and "params/dense/W" in flat
    monkeypatch.setattr(
        tws, "_load_flat_once",
        lambda s, m: (_ for _ in ()).throw(ValueError("corrupt")))
    with pytest.raises(ValueError, match="corrupt"):
        tws.load_flat(store)


def test_load_flat_missing_store_fails(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(FileNotFoundError):
        tws.load_flat(str(tmp_path / "absent"))
    assert time.monotonic() - t0 < tws._RETRY_S + 1.0


def test_load_flat_rejects_a_leaf_that_disagrees_with_its_manifest(tmp_path):
    store = str(tmp_path / "s")
    tws.save_store(store, _tree())
    man = tws.read_manifest(store)
    leaf = man["leaves"]["params/dense/W"]["file"]
    np.save(os.path.join(store, leaf), np.zeros((4, 3), np.float64))
    with pytest.raises(ValueError, match="manifest records"):
        tws.load_flat(store)


@pytest.mark.parametrize("mmap", [False, True])
def test_load_flat_survives_concurrent_rewrites(tmp_path, mmap):
    """The JAX test of the same name, against the port's reader: a writer
    alternating two trees (each a full dir-swap rewrite) while readers
    loop ``load_flat`` never surfaces an error to the reader, and every
    load is one whole version of the store."""
    store = str(tmp_path / "s")
    trees = [_tree(0, scale=2.0), _tree(1, scale=2.0)]
    tws.save_store(store, _tree(0))
    versions = [tws._flatten(t)["params/dense/W"]
                for t in trees + [_tree(0)]]
    stop = threading.Event()
    errors = []

    def writer():
        i = 0
        while not stop.is_set():
            try:
                tws.save_store(store, trees[i % 2])
            except Exception as e:  # noqa: BLE001
                errors.append(f"writer: {e!r}")
                return
            i += 1

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    deadline = time.monotonic() + 3.0
    loads = 0
    try:
        while time.monotonic() < deadline:
            try:
                flat = tws.load_flat(store, mmap=mmap)
                w = np.array(flat["params/dense/W"])
                if not any(np.array_equal(w, v) for v in versions):
                    errors.append("reader: a mixed or torn leaf")
                    break
                loads += 1
            except Exception as e:  # noqa: BLE001
                errors.append(f"reader: {e!r}")
                break
    finally:
        stop.set()
        t.join(timeout=10)
    assert not errors, errors
    assert loads > 10
