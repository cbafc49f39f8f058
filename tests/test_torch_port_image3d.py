"""PyTorch port: ``feature/image3d`` against the JAX package, on the CPU.

The port keeps its own copy of the JAX package's 3-D (medical) volume
transforms, on its own ``feature/common.Preprocessing``: host scipy code,
so every output is held to JAX's bit for bit, over seeded (D, H, W)
volumes of odd and even sizes, f32 and f64.
"""

import numpy as np
import pytest

from analytics_zoo_tpu.feature import image3d as j3
from analytics_zoo_tpu_torch.feature import image3d as t3
from analytics_zoo_tpu_torch.feature.common import (ChainedPreprocessing,
                                                    Preprocessing)

SHAPES = [(9, 12, 10), (8, 8, 16)]


def _vol(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_crops_match_jax(shape):
    vol = _vol(0, shape)
    _same(t3.Crop3D((1, 2, 3), (4, 5, 6)).transform(vol),
          j3.Crop3D((1, 2, 3), (4, 5, 6)).transform(vol))
    _same(t3.CenterCrop3D((5, 6, 7)).transform(vol),
          j3.CenterCrop3D((5, 6, 7)).transform(vol))
    a, b = t3.RandomCrop3D((4, 4, 4), seed=3), j3.RandomCrop3D((4, 4, 4),
                                                               seed=3)
    for _ in range(5):                 # the same draws, call after call
        _same(a.transform(vol), b.transform(vol))
    # a patch larger than the volume on an axis: JAX clamps its start to 0
    _same(t3.RandomCrop3D((20, 2, 2), seed=4).transform(vol),
          j3.RandomCrop3D((20, 2, 2), seed=4).transform(vol))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("order", [0, 1, 3])
def test_rotate_matches_jax(shape, order):
    vol = _vol(1, shape, np.float64)
    for angles in ((30.0, 0.0, 0.0), (0.0, -15.0, 40.0), (10.0, 20.0, 5.0),
                   (0.0, 0.0, 0.0)):
        _same(t3.Rotate3D(*angles, order=order).transform(vol),
              j3.Rotate3D(*angles, order=order).transform(vol))


@pytest.mark.parametrize("shape", SHAPES)
def test_affine_matches_jax(shape):
    vol = _vol(2, shape)
    g = np.random.default_rng(2)
    m = np.eye(3) + g.normal(0, 0.1, (3, 3))
    for order, t in ((1, (0.0, 0.0, 0.0)), (0, (1.5, -2.0, 0.5)),
                     (3, (0.2, 0.3, -0.4))):
        _same(t3.AffineTransform3D(m, t, order=order).transform(vol),
              j3.AffineTransform3D(m, t, order=order).transform(vol))


@pytest.mark.parametrize("shape", SHAPES)
def test_warp_matches_jax(shape):
    vol = _vol(3, shape)
    flow = np.random.default_rng(3).normal(0, 1.5, (3,) + shape)
    for order in (0, 1):
        _same(t3.Warp3D(flow, order=order).transform(vol),
              j3.Warp3D(flow, order=order).transform(vol))
    with pytest.raises(ValueError, match=r"flow must be \(3, D, H, W\)"):
        t3.Warp3D(flow[:2])
    with pytest.raises(ValueError, match="does not match volume"):
        t3.Warp3D(flow).transform(vol[1:])


def test_chains_on_the_ports_preprocessing():
    """Each transform is the port's ``Preprocessing``: ``>>`` chains and
    a list maps, as in JAX."""
    vols = [_vol(4 + i, SHAPES[0]) for i in range(3)]
    flow = np.random.default_rng(4).normal(0, 0.5, (3, 5, 6, 7))
    tc = t3.Rotate3D(20.0) >> t3.CenterCrop3D((5, 6, 7)) >> t3.Warp3D(flow)
    jc = j3.Rotate3D(20.0) >> j3.CenterCrop3D((5, 6, 7)) >> j3.Warp3D(flow)
    assert isinstance(tc, ChainedPreprocessing)
    assert all(isinstance(s, Preprocessing) for s in tc.stages)
    for a, b in zip(tc(vols), jc(vols)):
        _same(a, b)
