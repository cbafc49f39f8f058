"""PyTorch port: the native sample store and ``NativeFeatureSet`` against
the JAX package, on the CPU.

Both packages build the repository's ``csrc/sample_store.cpp``, each into
its own library.  Compared exactly: gathered samples, the mmap tier's
file, the bad-index error, ``NativeFeatureSet``'s batches (against the
JAX ``NativeFeatureSet`` and the port's ``ArrayFeatureSet`` for the same
shuffle generator), and a fit fed from it.  The build: a hashed library
name, a temporary file published with ``os.replace`` (concurrent builds
leave one whole library and no temporary), a compiler failure raised with
its output.
"""

import os
import threading

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.feature import dataset as jdataset
from analytics_zoo_tpu.utils import native as jnative
from analytics_zoo_tpu_torch.common.context import ZooConf, ZooContext
from analytics_zoo_tpu_torch.common.observability import MetricsRegistry
from analytics_zoo_tpu_torch.estimator.estimator import Estimator
from analytics_zoo_tpu_torch.feature import dataset as tdataset
from analytics_zoo_tpu_torch.nn.layers.core import Dense
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.utils import native as tnative

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

NATIVE = {"jax": jnative, "port": tnative}


def _data(n=130):
    g = np.random.default_rng(0)
    return (g.normal(size=(n, 6)).astype(np.float32),
            g.integers(0, 5, (n, 2)).astype(np.int32),
            g.normal(size=(n, 1)).astype(np.float32))


def test_store_gathers_match_jax():
    data = np.arange(100 * 32, dtype=np.float32).reshape(100, 8, 4)
    idx = np.asarray([0, 99, 50, 50, 7])
    got = {}
    for pkg, mod in NATIVE.items():
        st = mod.NativeSampleStore(100, (8, 4), np.float32, n_threads=3)
        st.write_bulk(0, data)
        got[pkg] = st.gather(idx)
        assert len(st) == 100
        st.close()
    np.testing.assert_array_equal(got["port"], got["jax"])
    np.testing.assert_array_equal(got["port"], data[idx])


def test_store_mmap_tier_matches_jax(tmp_path):
    for pkg, mod in NATIVE.items():
        p = str(tmp_path / f"{pkg}.bin")
        st = mod.NativeSampleStore(64, (16,), np.float32, path=p)
        st.write_bulk(0, np.full((64, 16), 7.0, np.float32))
        assert st.gather(np.asarray([63]))[0].sum() == 7.0 * 16
        st.close()
    with open(tmp_path / "jax.bin", "rb") as f, \
            open(tmp_path / "port.bin", "rb") as g:
        assert f.read() == g.read()
    assert os.path.getsize(tmp_path / "port.bin") == 64 * 16 * 4


@pytest.mark.parametrize("pkg", sorted(NATIVE))
def test_store_bad_index_and_write_raise(pkg):
    st = NATIVE[pkg].NativeSampleStore(10, (4,), np.float32)
    st.write_bulk(0, np.zeros((10, 4), np.float32))
    for bad in ([11], [-1], [10]):
        with pytest.raises(IndexError):
            st.gather(np.asarray(bad))
    with pytest.raises(IndexError):
        st.write_bulk(8, np.zeros((3, 4), np.float32))
    st.close()


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("multi", [False, True])
def test_native_featureset_batches_match_jax_and_arrays(shuffle, multi,
                                                        tmp_path):
    x0, x1, y = _data()
    x = [x0, x1] if multi else x0
    sets = {"jax": jdataset.NativeFeatureSet(x, y),
            "port": tdataset.NativeFeatureSet(
                x, y, path_prefix=str(tmp_path / "arena")),
            "array": tdataset.ArrayFeatureSet(x, y)}
    got = {k: list(fs.batches(64, shuffle=shuffle,
                              rng=np.random.default_rng(1)))
           for k, fs in sets.items()}
    assert sets["port"].size() == 130 and len(got["port"]) == 3
    for other in ("jax", "array"):
        for a, b in zip(got["port"], got[other]):
            for u, v in zip(a[0] if multi else [a[0]],
                            b[0] if multi else [b[0]]):
                np.testing.assert_array_equal(u, v)
                assert u.dtype == v.dtype
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])
    assert got["port"][-1][2].sum() == 130 - 128
    assert os.path.getsize(str(tmp_path / "arena.x0")) == x0.nbytes
    for fs in (sets["jax"], sets["port"]):
        fs.close()


def test_fit_from_native_featureset_equals_arrays():
    x, _, y = _data(96)

    def fit(data):
        m = Sequential([Dense(4, activation="tanh", input_shape=(6,)),
                        Dense(1)]).init_weights(2)
        est = Estimator(m, optimizer="adam", loss="mse",
                        registry=MetricsRegistry(),
                        ctx=ZooContext(ZooConf(seed=3, device="cpu")))
        losses = []
        est._listeners.append(lambda s, l: losses.append(float(l)))
        est.fit(data, batch_size=32, epochs=2, verbose=False)
        return losses, [p.detach().clone() for p in m.parameters()]

    native = tdataset.NativeFeatureSet(x, y)
    a, wa = fit(native)
    b, wb = fit(tdataset.ArrayFeatureSet(x, y))
    native.close()
    assert a == b and len(a) == 6
    assert all(torch.equal(u, v) for u, v in zip(wa, wb))


def test_library_is_built_apart_from_the_jax_one():
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR
    assert path.name.startswith("libsamplestore-") and path.suffix == ".so"
    assert tnative.SOURCE.name == "sample_store.cpp"
    assert str(path) != os.path.join(jnative._BUILD, "libsamplestore.so")
    assert tnative.build_library() == path and path.exists()


def test_concurrent_builds_publish_one_whole_library(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    out, errs = [], []

    def build():
        try:
            out.append(tnative.build_library())
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    ts = [threading.Thread(target=build) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in ts) and errs == []
    assert len(set(out)) == 1 and out[0].exists()
    assert os.listdir(tmp_path / "build") == [out[0].name]
    import ctypes
    assert ctypes.CDLL(str(out[0])).ss_create is not None


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "sample_store.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="sample_store.cpp") as e:
        tnative.build_library()
    assert "error" in str(e.value)
    assert os.listdir(tmp_path / "build") == []
