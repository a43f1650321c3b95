"""Each op of the port held against its JAX op.

The same numpy inputs and parameters go through the ``flexflow_tpu``
op and its ``flexflow_torch`` counterpart on the CPU; outputs (and KV
caches, for the cached attention protocol) agree in f32 within 1e-5,
and the gradients of every op on the training path agree with
``jax.vjp`` within 1e-5 relative to their largest magnitude.
Where the JAX op reaches a Pallas kernel (dense attention at t >= 16,
cached decode) it runs in interpret mode, as the JAX package's own
tests run it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu.ops as jops
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.transformer import build_transformer_lm as jbuild
from flexflow_tpu.ops import attention as jattn
from flexflow_tpu.ops.activations import apply_activation as japply
from flexflow_tpu.ops.base import TensorSpec as JSpec
import flexflow_torch.ops as tops
from flexflow_torch.ops import attention as tattn
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.models.transformer import build_transformer_lm as tbuild
from flexflow_torch.ops.activations import apply_activation as tapply
from flexflow_torch.ops.base import TensorSpec as TSpec

TOL = 1e-5


def _specs(name, shape, dtype="float32", axes=None):
    axes = axes or ("n",) + (None,) * (len(shape) - 1)
    jdt = jnp.int32 if dtype == "int32" else jnp.float32
    tdt = torch.int32 if dtype == "int32" else torch.float32
    return JSpec(name, tuple(shape), jdt, axes), TSpec(name, tuple(shape), tdt, axes)


def _params(jop, top, seed):
    """Random params for both ops from one numpy draw; the two ops must
    declare the same keys and shapes."""
    jspecs, tspecs = jop.param_specs(), top.param_specs()
    assert sorted(jspecs) == sorted(tspecs)
    r = np.random.default_rng(seed)
    arrays = {}
    for k in sorted(jspecs):
        assert tuple(jspecs[k].shape) == tuple(tspecs[k].shape), k
        arrays[k] = (0.3 * r.standard_normal(jspecs[k].shape)).astype(np.float32)
    return ({k: jnp.asarray(a) for k, a in arrays.items()},
            {k: torch.from_numpy(a) for k, a in arrays.items()})


def _run(jop, top, jp, tp, xs, jstate=None, tstate=None):
    jys, jst = jop.forward(jp, [jnp.asarray(x) for x in xs], jstate or {}, False)
    tys, tst = top.forward(tp, [torch.from_numpy(np.asarray(x)) for x in xs],
                           tstate or {}, False)
    assert len(jys) == len(tys)
    for jy, ty in zip(jys, tys):
        assert tuple(ty.shape) == tuple(jy.shape)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=0)
    return jst, tst


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("act", [None, "none", "relu", "sigmoid", "tanh", "gelu"])
def test_activations(act):
    x = 3 * _x(0, (4, 33))
    want = np.asarray(japply(jnp.asarray(x), act))
    got = tapply(torch.from_numpy(x), act).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_unknown_activation_refused():
    with pytest.raises(ValueError):
        tops.check_activation("swish")


@pytest.mark.parametrize("act", [None, "gelu"])
def test_linear(act):
    js, ts = _specs("x", (3, 5, 16))
    jop = jops.Linear("d", js, 24, activation=act)
    top = tops.Linear("d", ts, 24, activation=act)
    assert tuple(top.param_specs()["kernel"].shape) == (24, 16)  # (out, in)
    jp, tp = _params(jop, top, 1)
    _run(jop, top, jp, tp, [_x(2, (3, 5, 16))])


def test_add():
    js, ts = _specs("a", (2, 7, 8))
    jop, top = jops.Add("add", js, js), tops.Add("add", ts, ts)
    _run(jop, top, {}, {}, [_x(3, (2, 7, 8)), _x(4, (2, 7, 8))])


def test_word_embedding():
    js, ts = _specs("tok", (2, 9), "int32", ("n", "s"))
    jop = jops.WordEmbedding("embed", js, 50, 12)
    top = tops.WordEmbedding("embed", ts, 50, 12)
    jp, tp = _params(jop, top, 5)
    ids = np.random.default_rng(6).integers(0, 50, (2, 9)).astype(np.int32)
    _run(jop, top, jp, tp, [ids])


def test_layer_norm():
    js, ts = _specs("x", (2, 6, 20))
    jop, top = jops.LayerNorm("ln", js), tops.LayerNorm("ln", ts)
    jp, tp = _params(jop, top, 7)
    _run(jop, top, jp, tp, [5 + 2 * _x(8, (2, 6, 20))])


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_position_embedding(mode):
    js, ts = _specs("x", (2, 10, 8), axes=("n", "s", None))
    jop, top = jops.PositionEmbedding("pos", js), tops.PositionEmbedding("pos", ts)
    jp, tp = _params(jop, top, 9)
    t = {"train": 10, "prefill": 6, "decode": 1}[mode]
    jst, tst = {}, {}
    if mode != "train":
        pos = np.array([3, 7] if mode == "decode" else [0, 0], np.int32)
        jst, tst = {"pos": jnp.asarray(pos)}, {"pos": torch.from_numpy(pos)}
    _run(jop, top, jp, tp, [_x(10, (2, t, 8))], jst, tst)


def _mha(causal=True):
    js, ts = _specs("x", (2, 16, 32), axes=("n", "s", None))
    jop = jops.MultiHeadAttention("attn", js, 2, causal=causal)
    top = tops.MultiHeadAttention("attn", ts, 2, causal=causal)
    jp, tp = _params(jop, top, 11)
    return jop, top, jp, tp


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [16, 8])
def test_attention_dense(t, causal):
    """t = 16 reaches the Pallas flash kernel on the JAX side, t = 8 its
    einsum fallback; the port runs its flash wrapper for both."""
    jop, top, jp, tp = _mha(causal)
    _run(jop, top, jp, tp, [_x(12, (2, t, 32))])


def _caches(seed, B=2, S=16, h=2, hd=16):
    ck, cv = _x(seed, (B, S, h, hd)), _x(seed + 1, (B, S, h, hd))
    return ({"cache_k": jnp.asarray(ck), "cache_v": jnp.asarray(cv)},
            {"cache_k": torch.from_numpy(ck.copy()),
             "cache_v": torch.from_numpy(cv.copy())})


@pytest.mark.parametrize("decode_kernel", [None, False])
def test_attention_cached_decode(decode_kernel):
    """t == 1: K/V written at ``pos`` first, then keys ``<= pos``
    attended — flash decode (Pallas / the port's wrapper) or the einsum
    reference, with the caches updated identically."""
    jop, top, jp, tp = _mha()
    jop.decode_kernel = top.decode_kernel = decode_kernel
    jst, tst = _caches(13)
    pos = np.array([3, 15], np.int32)
    jst["pos"], tst["pos"] = jnp.asarray(pos), torch.from_numpy(pos)
    jout, tout = _run(jop, top, jp, tp, [_x(14, (2, 1, 32))], jst, tst)
    for key in ("cache_k", "cache_v"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("t", [8, 16])
def test_attention_cached_prefill(t):
    jop, top, jp, tp = _mha()
    jst, tst = _caches(15, B=1)
    jst["pos"] = jnp.zeros((1,), jnp.int32)
    tst["pos"] = torch.zeros((1,), dtype=torch.int32)
    jout, tout = _run(jop, top, jp, tp, [_x(16, (1, t, 32))], jst, tst)
    for key in ("cache_k", "cache_v"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offset,t", [(4, 12), (8, 8), (12, 4)])
def test_attention_offset_prefill_matches_jax_attend_chunk(offset, t, causal):
    """``chunk``: t queries at rows [offset, offset + t) over a cache
    whose rows [0, offset) hold a prefix.  JAX attends through its jnp
    ``_attend_chunk``; the port through ``_attend_offset`` (the queries
    placed in a zero query over the span, on a fresh prefill's route).
    Outputs and caches agree."""
    jop, top, jp, tp = _mha(causal)
    jst, tst = _caches(17, B=1)
    jst["chunk"], tst["chunk"] = offset, offset
    jout, tout = _run(jop, top, jp, tp, [_x(18, (1, t, 32))], jst, tst)
    for key in ("cache_k", "cache_v"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_einsum_attention_reference(causal):
    q, k, v = (_x(s, (2, 2, 12, 16)) for s in (20, 21, 22))
    want = jattn._einsum_attention(*(jnp.asarray(a) for a in (q, k, v)), causal)
    got = tattn._einsum_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_einsum_decode_reference():
    q, ck, cv = _x(23, (3, 2, 16)), _x(24, (3, 10, 2, 16)), _x(25, (3, 10, 2, 16))
    pos = np.array([0, 4, 9], np.int32)
    want = jattn._einsum_decode(jnp.asarray(q), jnp.asarray(ck),
                                jnp.asarray(cv), jnp.asarray(pos))
    got = tattn._einsum_decode(torch.from_numpy(q), torch.from_numpy(ck),
                               torch.from_numpy(cv), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_softmax_forward_refuses():
    """The loss forward runs K3: on a device that is neither the CPU nor
    CUDA (meta tensors stand in) it refuses instead of computing a plain
    cross-entropy."""
    _, lg = _specs("lg", (2, 4, 10))
    _, lb = _specs("lb", (2, 4), "int32")
    top = tops.SoftmaxCrossEntropy("softmax", lg, lb)
    assert top.is_loss
    logits = torch.empty((2, 4, 10), device="meta")
    labels = torch.empty((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        top.forward({}, [logits, labels], {}, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_graph_matches(dtype):
    """The two build functions give the same ops, tensor names, parameter keys,
    shapes and dtypes — what lets params cross over untransposed."""
    kw = dict(batch_size=2, seq_len=16, vocab_size=64, d_model=32,
              num_heads=2, num_layers=2)
    jff = jbuild(config=JConfig(batch_size=2, compute_dtype=dtype), **kw)
    tff = tbuild(config=TConfig(batch_size=2, compute_dtype=dtype), **kw)
    assert [op.name for op in jff.layers] == [op.name for op in tff.layers]
    assert [t.name for t in jff.input_tensors] == [t.name for t in tff.input_tensors]
    for jop, top in zip(jff.layers, tff.layers):
        assert type(jop).__name__ == type(top).__name__
        assert [t.name for t in jop.outputs] == [t.name for t in top.outputs]
        assert [t.shape for t in jop.outputs] == [t.shape for t in top.outputs]
        jsp, tsp = jop.param_specs(), top.param_specs()
        assert sorted(jsp) == sorted(tsp)
        for k in jsp:
            assert tuple(jsp[k].shape) == tuple(tsp[k].shape)
            assert np.dtype(jsp[k].dtype).name == str(tsp[k].dtype).split(".")[1]


# ---------------------------------------------------------------------------
# backward of each op, against jax.vjp
# ---------------------------------------------------------------------------


def _grads_match(jop, top, jp, tp, xs, tol=TOL, float_inputs=(0,)):
    """Gradients of ``sum(y * g)`` w.r.t. the params and the float inputs
    agree with ``jax.vjp`` of the JAX op within ``tol`` times the
    larger of 1 and the gradient's largest magnitude (f32 sums in another
    order; attention's input gradients reach ~20 here)."""
    import jax

    jxs = [jnp.asarray(x) for x in xs]
    txs = [torch.from_numpy(np.asarray(x)) for x in xs]

    def jf(params, fl):
        ins = list(jxs)
        for i, x in zip(float_inputs, fl):
            ins[i] = x
        return jop.forward(params, ins, {}, True)[0][0]

    jy, vjp = jax.vjp(jf, jp, [jxs[i] for i in float_inputs])
    g = np.random.default_rng(99).standard_normal(jy.shape).astype(np.float32)
    jgp, jgx = vjp(jnp.asarray(g, jy.dtype))
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    for i in float_inputs:
        txs[i] = txs[i].clone().requires_grad_(True)
    ty = top.forward(tp, txs, {}, True)[0][0]
    leaves = list(tp.values()) + [txs[i] for i in float_inputs]
    got = torch.autograd.grad((ty.float() * torch.from_numpy(g)).sum(), leaves)
    want = [jgp[k] for k in tp] + list(jgx)
    for name, a, b in zip(list(tp) + ["x"] * len(float_inputs), got, want):
        assert a.dtype == torch.float32 or str(a.dtype).endswith(
            np.dtype(b.dtype).name), name
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b,
                                   atol=tol * max(1.0, float(np.abs(b).max())),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("act", [None, "gelu", "relu"])
def test_linear_backward(act):
    js, ts = _specs("x", (3, 5, 16))
    jop = jops.Linear("d", js, 24, activation=act)
    top = tops.Linear("d", ts, 24, activation=act)
    jp, tp = _params(jop, top, 30)
    _grads_match(jop, top, jp, tp, [_x(31, (3, 5, 16))])


def test_layer_norm_backward():
    js, ts = _specs("x", (2, 6, 20))
    jop, top = jops.LayerNorm("ln", js), tops.LayerNorm("ln", ts)
    jp, tp = _params(jop, top, 32)
    _grads_match(jop, top, jp, tp, [5 + 2 * _x(33, (2, 6, 20))])


def test_position_embedding_and_add_backward():
    js, ts = _specs("x", (2, 10, 8), axes=("n", "s", None))
    jop, top = jops.PositionEmbedding("pos", js), tops.PositionEmbedding("pos", ts)
    jp, tp = _params(jop, top, 34)
    _grads_match(jop, top, jp, tp, [_x(35, (2, 10, 8))])
    jadd, tadd = jops.Add("add", js, js), tops.Add("add", ts, ts)
    _grads_match(jadd, tadd, {}, {}, [_x(36, (2, 10, 8)), _x(37, (2, 10, 8))],
                 float_inputs=(0, 1))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_backward(causal):
    """t = 16: the JAX op differentiates through its Pallas flash VJP
    (interpret mode), the port through K1b's plain backward."""
    jop, top, jp, tp = _mha(causal)
    _grads_match(jop, top, jp, tp, [_x(38, (2, 16, 32))])


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_word_embedding_backward(out_dtype):
    """The table stays f32 when the output is bf16 (the graph's rule
    under sparse embedding updates), so its gradient is f32: the bf16
    cotangent is widened and scatter-added in f32, as JAX's cast VJP
    and gather transpose do.  Repeated ids sum."""
    import jax

    js, ts = _specs("tok", (2, 9), "int32", ("n", "s"))
    jdt = jnp.bfloat16 if out_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if out_dtype == "bfloat16" else torch.float32
    jop = jops.WordEmbedding("embed", js, 50, 12, out_dtype=jdt)
    top = tops.WordEmbedding("embed", ts, 50, 12, out_dtype=tdt)
    jp, tp = _params(jop, top, 39)
    ids = np.random.default_rng(40).integers(0, 8, (2, 9)).astype(np.int32)
    g = _x(41, (2, 9, 12))
    _, vjp = jax.vjp(lambda p: jop.forward(p, [jnp.asarray(ids)], {}, True)[0][0],
                     jp)
    (jg,) = vjp(jnp.asarray(g, jdt))
    table = tp["table"].clone().requires_grad_(True)
    y = top.forward({"table": table}, [torch.from_numpy(ids)], {}, True)[0][0]
    assert y.dtype == tdt and table.dtype == torch.float32
    (tg,) = torch.autograd.grad(y, table, torch.from_numpy(g).to(tdt))
    assert tg.dtype == torch.float32
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg["table"]), atol=1e-6,
                               rtol=0)
