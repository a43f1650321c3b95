"""The port's Conv2D, Pool2D and Flat held against the JAX ops.

The same seeded numpy input, parameters and output cotangent go through
the ``flexflow_tpu`` op (``jax.vjp``) and its ``flexflow_torch``
counterpart (autograd) on the CPU.  Bars, each against the largest
magnitude of the tensor compared (``scale``):

- f32: the output and every gradient within ``1e-5 * scale``;
- bf16: the output within ``2^-6 * scale`` and every gradient within
  ``2^-5 * scale``.  Both sides round the convolution, the bias add and
  the pool to bf16, but in other places (the JAX op adds the bias to
  the rounded convolution, cuDNN and oneDNN add it before rounding) and
  a weight gradient sums ``N * Ho * Wo`` bf16 products in another order.

The max pool sends each window's gradient to its FIRST maximum in both
packages: with planted ties (small integers, ReLU zeros) the gradients
agree exactly, in f32 and in bf16.  ``Flat`` flattens NHWC in (h, w, c)
order; a flatten of the NCHW view, in (c, h, w) order, is shown to
differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu.ops as jops
from flexflow_tpu.ops.base import TensorSpec as JSpec
import flexflow_torch.ops as tops
from flexflow_torch.graph import FFModel
from flexflow_torch.ops.base import TensorSpec as TSpec

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -6, 2.0 ** -5)}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _specs(shape, dtype):
    axes = ("n", "h", "w", "c")
    return (JSpec("x", tuple(shape), _JDT[dtype], axes),
            TSpec("x", tuple(shape), _TDT[dtype], axes))


def _draw(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _both(jop, top, x, params, seed, dtype):
    """Forward and backward of both ops on ``x`` and ``params`` (f32
    numpy, rounded to ``dtype`` on each side), with one seeded output
    cotangent.  Returns ``(jax, torch)``, each ``(y, dx, dparams)`` as
    f32 numpy."""
    jdt, tdt = _JDT[dtype], _TDT[dtype]
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    jx = jnp.asarray(x, jdt)

    def f(p, xx):
        return jop.forward(p, [xx], {}, True)[0][0]

    jy, vjp = jax.vjp(f, jp, jx)
    g = _draw(seed, jy.shape)
    jdp, jdx = vjp(jnp.asarray(g, jdt))

    tp = {k: torch.from_numpy(v).to(tdt).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ty = top.forward(tp, [tx], {}, True)[0][0]
    assert tuple(ty.shape) == tuple(jy.shape) == top.outputs[0].shape
    ty.backward(torch.from_numpy(g).to(tdt))

    def npf(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    return ((npf(jy), npf(jdx), {k: npf(v) for k, v in jdp.items()}),
            (ty.detach().float().numpy(), tx.grad.float().numpy(),
             {k: v.grad.float().numpy() for k, v in tp.items()}))


def _assert_close(got, want, rtol, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def _hold(jres, tres, dtype):
    (jy, jdx, jdp), (ty, tdx, tdp) = jres, tres
    ytol, gtol = TOL[dtype]
    _assert_close(ty, jy, ytol, "y")
    _assert_close(tdx, jdx, gtol, "dx")
    assert sorted(tdp) == sorted(jdp)
    for k in jdp:
        _assert_close(tdp[k], jdp[k], gtol, f"d{k}")


#: (input NHWC, out channels, kernel, stride, padding, bias, activation):
#: AlexNet's conv1 (11 x 11 / 4, pad 2, Cin 3) and conv2/conv3 shapes at
#: small sizes, no bias, and a non-square kernel, stride and padding.
CONV_CASES = [
    ((2, 35, 35, 3), 8, (11, 11), (4, 4), (2, 2), True, "relu"),
    ((2, 9, 9, 6), 12, (5, 5), (1, 1), (2, 2), True, "relu"),
    ((3, 7, 7, 8), 5, (3, 3), (1, 1), (1, 1), False, None),
    ((2, 10, 9, 4), 6, (3, 2), (2, 1), (0, 1), True, "tanh"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_conv2d_matches_jax(case, dtype):
    shape, cout, k, s, p, bias, act = CONV_CASES[case]
    js, ts = _specs(shape, dtype)
    args = (cout, k[0], k[1], s[0], s[1], p[0], p[1])
    jop = jops.Conv2D("conv", js, *args, activation=act, use_bias=bias)
    top = tops.Conv2D("conv", ts, *args, activation=act, use_bias=bias)
    specs = top.param_specs()
    assert {n: tuple(v.shape) for n, v in specs.items()} == \
        {n: tuple(v.shape) for n, v in jop.param_specs().items()}
    assert specs["kernel"].shape == (k[0], k[1], shape[3], cout)  # HWIO
    params = {n: _draw(10 + i, v.shape, 0.3)
              for i, (n, v) in enumerate(sorted(specs.items()))}
    _hold(*_both(jop, top, _draw(case, shape), params, 99, dtype), dtype)


def test_conv2d_glorot_fans_are_hwio():
    """GlorotUniform with the JAX op's explicit fans: ``kh kw cin`` in,
    ``kh kw cout`` out, so the bound is ``sqrt(6 / (kh kw (cin + cout)))``
    (an (out, in)-major default would read 11 and 11 as the fans)."""
    _, ts = _specs((1, 35, 35, 3), "float32")
    op = tops.Conv2D("conv1", ts, 64, 11, 11, 4, 4, 2, 2)
    spec = op.param_specs()["kernel"]
    w = spec.initializer(torch.Generator().manual_seed(0), spec.shape,
                         spec.dtype)
    bound = np.sqrt(6.0 / (11 * 11 * (3 + 64)))
    assert float(w.abs().max()) <= bound
    assert float(w.abs().max()) > 0.95 * bound


#: (input NHWC, kernel, stride, padding, pool type): AlexNet's 3 x 3 / 2
#: max pool, padded max and average pools (the average counting the
#: padding), and a padding of 2 on a 3-wide window, more than PyTorch's
#: pools take themselves.
POOL_CASES = [
    ((2, 13, 13, 5), (3, 3), (2, 2), (0, 0), "max"),
    ((2, 8, 9, 3), (3, 3), (1, 2), (1, 1), "max"),
    ((2, 7, 7, 4), (3, 3), (2, 2), (2, 2), "max"),
    ((2, 13, 13, 5), (3, 3), (2, 2), (0, 0), "avg"),
    ((2, 7, 7, 4), (3, 3), (2, 2), (2, 2), "avg"),
]


def _pool_pair(shape, k, s, p, kind, dtype):
    js, ts = _specs(shape, dtype)
    args = (k[0], k[1], s[0], s[1], p[0], p[1])
    return (jops.Pool2D("pool", js, *args, pool_type=kind),
            tops.Pool2D("pool", ts, *args, pool_type=kind))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_pool2d_matches_jax(case, dtype):
    shape, k, s, p, kind = POOL_CASES[case]
    jop, top = _pool_pair(shape, k, s, p, kind, dtype)
    _hold(*_both(jop, top, _draw(case, shape), {}, 7, dtype), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_ties_go_to_the_first_maximum(dtype):
    """Inputs of a few integers, half of them ReLU zeros: most windows
    hold their maximum more than once.  Each window's gradient must land
    on the same element in both packages, so the gradients (sums of
    cotangents, exact in f32 and in bf16 at these sizes) are equal."""
    shape = (2, 13, 13, 6)
    x = np.maximum(np.random.default_rng(3).integers(-3, 3, shape), 0)
    x = x.astype(np.float32)
    jop, top = _pool_pair(shape, (3, 3), (2, 2), (0, 0), "max", dtype)
    (jy, jdx, _), (ty, tdx, _) = _both(jop, top, x, {}, 5, dtype)
    # Ties are the common case here, not a corner.
    windows = np.lib.stride_tricks.sliding_window_view(x, (3, 3), (1, 2))
    windows = windows[:, ::2, ::2].reshape(*jy.shape, 9)
    assert ((windows == jy[..., None]).sum(-1) > 1).mean() > 0.5
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tdx, jdx)
    # Not any maximum: the first one.  The same pool over the input
    # flipped in h and w (the windows map onto each other at this shape)
    # sends each gradient to the last maximum, and that differs.
    tx = torch.from_numpy(x[:, ::-1, ::-1].copy()).to(_TDT[dtype])
    tx.requires_grad_(True)
    g = torch.from_numpy(_draw(5, jy.shape)[:, ::-1, ::-1].copy())
    top.forward({}, [tx], {}, True)[0][0].backward(g.to(_TDT[dtype]))
    last = tx.grad.float().numpy()[:, ::-1, ::-1]
    assert not np.array_equal(last, jdx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_is_hwc_order(dtype):
    shape = (2, 3, 4, 5)
    js, ts = _specs(shape, dtype)
    jop, top = jops.Flat("flat", js), tops.Flat("flat", ts)
    x = _draw(1, shape)
    (jy, jdx, _), (ty, tdx, _) = _both(jop, top, x, {}, 2, dtype)
    assert ty.shape == (2, 60) and top.outputs[0].shape == (2, 60)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tdx, jdx)
    chw = torch.from_numpy(x).to(_TDT[dtype]).permute(0, 3, 1, 2)
    assert not np.array_equal(chw.reshape(2, -1).float().numpy(), jy)


def test_flat_feeds_linear_in_hwc_order():
    """Conv -> Flat -> Linear with the JAX weights: the linear's weight
    columns meet the features in the order JAX flattened them."""
    shape = (2, 6, 6, 4)
    js, ts = _specs(shape, "float32")
    jconv = jops.Conv2D("c", js, 3, 3, 3, 1, 1, 1, 1, activation="relu")
    tconv = tops.Conv2D("c", ts, 3, 3, 3, 1, 1, 1, 1, activation="relu")
    jflat = jops.Flat("f", jconv.outputs[0])
    tflat = tops.Flat("f", tconv.outputs[0])
    jlin = jops.Linear("l", jflat.outputs[0], 7)
    tlin = tops.Linear("l", tflat.outputs[0], 7)
    pc = {"kernel": _draw(1, (3, 3, 4, 3), 0.3), "bias": _draw(2, (3,), 0.3)}
    pl = {"kernel": _draw(3, (7, 108), 0.3), "bias": _draw(4, (7,), 0.3)}
    x = _draw(5, shape)

    def run(ops, params, arr):
        for op, p in zip(ops, params):
            arr = op.forward(p, [arr], {}, False)[0][0]
        return arr

    jy = run((jconv, jflat, jlin),
             [{k: jnp.asarray(v) for k, v in p.items()} for p in (pc, {}, pl)],
             jnp.asarray(x))
    ty = run((tconv, tflat, tlin),
             [{k: torch.from_numpy(v) for k, v in p.items()}
              for p in (pc, {}, pl)], torch.from_numpy(x))
    _assert_close(ty.numpy(), np.asarray(jy), 1e-5, "y")


def test_graph_builders_name_and_shape_like_jax():
    from flexflow_tpu.graph import FFModel as JModel

    def build(ff):
        x = ff.create_tensor((2, 35, 35, 3), name="image")
        t = ff.conv2d(x, 8, 11, 11, 4, 4, 2, 2, activation="relu")
        t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
        t = ff.pool2d(t, 2, 2, 1, 1, 1, 1, pool_type="avg")
        return ff.flat(t)

    jff, tff = JModel(), FFModel()
    build(jff), build(tff)
    assert [(op.name, op.outputs[0].shape, op.outputs[0].dim_axes)
            for op in tff.layers] == \
        [(op.name, op.outputs[0].shape, op.outputs[0].dim_axes)
         for op in jff.layers]
    assert [op.name for op in tff.layers] == ["conv2d0", "pool2d0", "pool2d1",
                                              "flat0"]


@pytest.mark.parametrize("bad", [
    lambda ts: tops.Pool2D("p", ts, 3, 3, 2, 2, 0, 0, pool_type="min"),
    lambda ts: tops.Conv2D("c", ts, 4, 3, 3, 1, 1, 0, 0, activation="swish"),
    lambda ts: tops.Flat("f", TSpec("x", (2, 9), torch.float32, ("n", None))),
])
def test_bad_ops_are_refused_at_build(bad):
    _, ts = _specs((1, 8, 8, 3), "float32")
    with pytest.raises(ValueError):
        bad(ts)
