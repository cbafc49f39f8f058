"""PyTorch port: ``ops/fused_bn.py`` (the fused 1×1-conv + BN-statistics
op) against the JAX package, on the CPU.

- the probe oracle: the plain version against the probe's own Pallas
  kernel ``tools/fused_bn_probe.py::_fused_kernel``, wrapped here in a
  ``pl.pallas_call(..., interpret=True)`` with the probe's block specs at a
  small M (bf16 x and w, f32 sums);
- the plain version at ragged f32 shapes against a float64 product;
- the gradient: the autograd backward (``dY = gy + gΣ + 2·y·gΣ²``, then
  ``dY @ wᵀ`` and ``xᵀ @ dY``) against autograd through the plain
  version, and a fused 1×1 conv → BatchNormalization in training against
  ``jax.grad`` of the JAX ``Convolution2D`` → ``BatchNormalization``;
- the wrapper's contract: operands checked before anything is built, the
  kernel source shipped and its build deferred, no launch counted on the
  CPU, ``impl="cuda"`` refused for CPU tensors.

The kernel itself is held to the plain version on the card
(``tests/test_torch_port_card.py``, ``chip_smoke.py``).
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.nn.layers import conv as jconv
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.nn.graph import Input
from analytics_zoo_tpu_torch.nn.layers.conv import Convolution2D
from analytics_zoo_tpu_torch.nn.layers.core import BatchNormalization
from analytics_zoo_tpu_torch.nn.models import Model
from analytics_zoo_tpu_torch.ops import fused_bn as tfb
from analytics_zoo_tpu_torch.utils.convert import (export_state,
                                                   load_jax_params,
                                                   load_jax_state)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    """Both packages at the f32 dtype policy the tolerances here assume."""
    saved_j, saved_t = dict(jdtypes._policy), dict(tdtypes._policy)
    jdtypes.set_policy(None)
    tdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved_j)
    tdtypes._policy.update(saved_t)


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "fused_bn_probe", REPO / "tools" / "fused_bn_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe_call(probe, x, w, block_m):
    """The probe's ``_fused_kernel`` under the probe's grid and block specs
    (``make_pallas_fused``), at this M, in interpret mode."""
    m, k = x.shape
    n = w.shape[1]
    return pl.pallas_call(
        functools.partial(probe._fused_kernel, block_m=block_m),
        out_shape=[jax.ShapeDtypeStruct((m, n), x.dtype),
                   jax.ShapeDtypeStruct((2, n), "float32")],
        grid=(m // block_m,),
        in_specs=[pl.BlockSpec((block_m, k), lambda i: (i, 0)),
                  pl.BlockSpec((k, n), lambda i: (0, 0))],
        out_specs=[pl.BlockSpec((block_m, n), lambda i: (i, 0)),
                   pl.BlockSpec((2, n), lambda i: (0, 0))],
        interpret=True)(x, w)


def _bf16_operands(seed, m, k, n):
    g = np.random.default_rng(seed)
    x = jnp.asarray(g.normal(size=(m, k)), jnp.bfloat16)
    w = jnp.asarray(g.normal(size=(k, n)), jnp.bfloat16)
    as_t = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
            for a in (x, w)]
    return x, w, as_t


@pytest.mark.parametrize("m,k,n,block_m", [(256, 32, 16, 64),
                                           (192, 24, 8, 64),
                                           (256, 64, 32, 128)])
def test_plain_matches_probe_kernel_in_interpret_mode(probe, m, k, n,
                                                      block_m):
    """bf16 products with f32 sums on both sides.  y: the same f32 sums
    rounded once to bf16, so at most one bf16 step apart (rtol 2**-7; read
    0).  Σ and Σ² of the f32 accumulator over 192-256 rows in another
    order: rtol 1e-5, atol 1e-3 for Σ near 0 (a sum of ~±6 values; read
    3.9e-3 on Σ² up to 2.3e4, relative 1.7e-7)."""
    x, w, (tx, tw) = _bf16_operands(m + k + n, m, k, n)
    y, stats = _probe_call(probe, x, w, block_m)
    ty, tstats = tfb.fused_bn(tx, tw)
    assert ty.dtype == torch.bfloat16 and tstats.dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(y.astype(jnp.float32)),
                               rtol=2 ** -7, atol=0)
    np.testing.assert_allclose(tstats.numpy(), np.asarray(stats),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("m,k,n", [(300, 33, 10), (129, 1, 7), (1, 70, 65)])
def test_plain_f32_matches_float64(m, k, n):
    """Ragged f32 shapes (M not a multiple of any tile, odd K, N = 10)
    against numpy in float64: f32 rounding of sums of <= 70 products and
    of <= 300 rows (atol 1e-4 on Σ² up to ~2e4, rtol 1e-5)."""
    g = np.random.default_rng(m * k + n)
    x = g.normal(size=(m, k)).astype(np.float32)
    w = g.normal(size=(k, n)).astype(np.float32)
    y, stats = tfb.fused_bn(torch.from_numpy(x), torch.from_numpy(w))
    y64 = x.astype(np.float64) @ w.astype(np.float64)
    np.testing.assert_allclose(y.numpy(), y64, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        stats.numpy(), np.stack([y64.sum(0), (y64 * y64).sum(0)]),
        rtol=1e-5, atol=1e-4)


def test_plain_reads_a_row_strided_view():
    """x as a (rows, channels) view with a row stride larger than K, as a
    channel slice of a wider tensor gives it."""
    g = np.random.default_rng(3)
    wide = torch.from_numpy(g.normal(size=(50, 12)).astype(np.float32))
    w = torch.from_numpy(g.normal(size=(8, 5)).astype(np.float32))
    x = wide[:, 2:10]
    assert x.stride() == (12, 1)
    y, stats = tfb.fused_bn(x, w)
    y2, stats2 = tfb.fused_bn(x.contiguous(), w)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(stats, stats2, rtol=0, atol=0)


@pytest.mark.parametrize("use_stats", ["both", "y_only", "stats_only"])
def test_backward_matches_autograd_through_the_plain_version(use_stats):
    """The Function's backward formula against autograd through
    ``fused_bn_torch`` itself (same f32 math, other association order:
    atol 1e-4 on gradients up to ~1e3, rtol 1e-5)."""
    g = np.random.default_rng(4)
    x0 = g.normal(size=(40, 6)).astype(np.float32)
    w0 = g.normal(size=(6, 5)).astype(np.float32)
    ry = torch.from_numpy(g.normal(size=(40, 5)).astype(np.float32))
    rs = torch.from_numpy(g.normal(size=(2, 5)).astype(np.float32))

    def loss(fn):
        x = torch.from_numpy(x0).requires_grad_()
        w = torch.from_numpy(w0).requires_grad_()
        y, stats = fn(x, w)
        terms = {"both": (y * ry).sum() + (stats * rs).sum(),
                 "y_only": (y * ry).sum(),
                 "stats_only": (stats * rs).sum()}[use_stats]
        terms.backward()
        return x.grad, w.grad

    got = loss(tfb.fused_bn)
    want = loss(tfb.fused_bn_torch)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


def _conv_bn_pair(seed, cin, cout):
    g = np.random.default_rng(seed)
    params = {
        "c": {"W": g.normal(0, 0.3, (1, 1, cin, cout)).astype(np.float32)},
        "bn": {"gamma": g.uniform(0.5, 1.5, cout).astype(np.float32),
               "beta": g.normal(0, 0.1, cout).astype(np.float32)}}
    state = {"c": {},
             "bn": {"mean": g.normal(0, 0.1, cout).astype(np.float32),
                    "var": g.uniform(0.5, 2, cout).astype(np.float32)}}
    inp = Input(shape=(6, 5, cin))
    y = Convolution2D(cout, 1, bias=False, name="c")(inp)
    y = BatchNormalization(momentum=0.9, name="bn")(y)
    model = Model(input=inp, output=y)
    load_jax_params(model, params)
    load_jax_state(model, state)
    return model, params, state


def test_fused_conv_bn_gradient_matches_jax_grad():
    """A 1×1 conv → BatchNormalization in training, fused in the port (the
    plan holds the pair), against ``jax.grad`` of the JAX layers: the loss
    ``Σ out · r`` differentiated by x, W, gamma and beta (f32 noise through
    the batch statistics: atol 1e-4 on gradients up to 36, read 1.7e-5),
    the output (1e-5, read 1.2e-6) and the new moving statistics (1e-6,
    read 1.2e-7)."""
    model, params, state = _conv_bn_pair(5, 8, 12)
    assert len(model.fusion_plan) == 1
    g = np.random.default_rng(6)
    x = g.normal(1.0, 2.0, (4, 6, 5, 8)).astype(np.float32)
    r = g.normal(size=(4, 6, 5, 12)).astype(np.float32)
    jc = jconv.Convolution2D(12, 1, bias=False, name="c")
    jb = jcore.BatchNormalization(momentum=0.9, name="bn")

    def jloss(x, W, gamma, beta):
        y = jc.call({"W": W}, x)
        out, new = jb.apply({"gamma": gamma, "beta": beta}, state["bn"], y,
                            training=True)
        return (out * r).sum(), (out, new)
    (_, (jout, jnew)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        x, params["c"]["W"], params["bn"]["gamma"], params["bn"]["beta"])
    tx = torch.from_numpy(x).requires_grad_()
    model.train()
    out = model(tx)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    conv, bn = model.graph_layers
    for got, want in zip((tx.grad, conv.W.grad, bn.gamma.grad, bn.beta.grad),
                         jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(export_state(model)["bn"][k].numpy(),
                                   np.asarray(jnew[k]), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("bad", ["rank", "inner", "dtype", "mixed_dtype"])
def test_wrapper_rejects_what_the_op_cannot_take(bad):
    x, w = torch.zeros(8, 4), torch.zeros(4, 3)
    if bad == "rank":
        x = torch.zeros(2, 8, 4)
    elif bad == "inner":
        w = torch.zeros(5, 3)
    elif bad == "dtype":
        x, w = x.double(), w.double()
    else:
        w = w.bfloat16()
    with pytest.raises((ValueError, TypeError)):
        tfb.fused_bn(x, w)


def test_kernel_route_checks_layouts_before_building():
    """The CUDA route's layout checks run before anything is compiled: a
    column-strided x is refused (``_fns`` stays unset); a zero-size
    product needs no launch and gives exact zeros."""
    x = torch.zeros(4, 8)[:, ::2]
    with pytest.raises(ValueError, match="contiguous last axis"):
        tfb._fused_bn_cuda(x, torch.zeros(4, 3))
    y, stats = tfb._fused_bn_cuda(torch.zeros(0, 4), torch.zeros(4, 3))
    assert y.shape == (0, 3) and stats.shape == (2, 3)
    assert not bool(stats.any())
    assert tfb._fns is None and tfb.launches == 0


def test_source_ships_build_deferred_and_cpu_counts_nothing():
    """The CUDA source ships in the package, nothing is compiled at
    import, a CPU call takes the plain version and counts no launch, and
    ``impl="cuda"`` is refused for CPU tensors."""
    assert (tfb._build.CSRC / f"{tfb.KERNEL}.cu").exists()
    assert tfb._build.library_path(tfb.KERNEL).name.startswith(
        "libfused_bn-")
    n0 = tfb.launches
    tfb.fused_bn(torch.ones(3, 2), torch.ones(2, 2))
    assert tfb.launches == n0 and tfb._fns is None
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfb.fused_bn(torch.ones(3, 2), torch.ones(2, 2), impl="cuda")
