"""The PyTorch port's TransformerLM forward and its parallel modules
(`mxtpu_torch/parallel/`) against the JAX package's
(`mxtpu/parallel/`).

Weights are drawn by `mxtpu.parallel.transformer.init_params` on a
1-device mesh and carried over with `params_from_jax`, so both packages
compute one function; tokens come from numpy.  The float32 bound is the
one `tests/test_parallel.py` holds the sharded forward to.  The JAX
forward is run both on its plain route and with the Pallas flash kernel
in interpreter mode.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mxtpu.parallel import blockwise_attention as jax_blockwise
from mxtpu.parallel import transformer as jtf
from mxtpu.parallel.mesh import (AXIS_DP, AXIS_EP, AXIS_PP, AXIS_SP,
                                 AXIS_TP, create_mesh, get_shard_map)
from mxtpu_torch.base import MXNetError
from mxtpu_torch.parallel import mesh as tmesh
from mxtpu_torch.parallel import transformer as ttf

# the module: the package's `ring_attention` is the function, as in mxtpu
tra = importlib.import_module("mxtpu_torch.parallel.ring_attention")

torch.set_num_threads(1)

B, T = 2, 64
SMALL = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_len=T)


def _mesh():
    return create_mesh({AXIS_DP: 1, AXIS_PP: 1, AXIS_TP: 1, AXIS_SP: 1,
                        AXIS_EP: 1}, devices=jax.devices()[:1])


def _both_forwards(dtype, seed=3):
    """JAX logits and the port's logits (float32 numpy) for one config,
    the same weights and the same tokens."""
    mesh = _mesh()
    jcfg = jtf.TransformerConfig(dtype=dtype, **SMALL)
    tcfg = ttf.TransformerConfig(dtype=dtype, **SMALL)
    jparams = jtf.init_params(jcfg, mesh, seed=seed)
    tokens = np.random.RandomState(seed).randint(
        0, jcfg.vocab, (B, T)).astype(np.int32)
    jout = jtf.make_forward(jcfg, mesh)(jparams, tokens)
    jout = np.asarray(jout.astype(jnp.float32))
    tparams = ttf.params_from_jax({k: np.asarray(v)
                                   for k, v in jparams.items()},
                                  tcfg, "cpu")
    tout = ttf.make_forward(tcfg, "cpu")(tparams, tokens)
    assert tout.shape == (B, T, jcfg.vocab) and tout.dtype == tcfg.torch_dtype
    return jout, tout.float().numpy()


@pytest.mark.parametrize("pallas_interpret", [False, True])
def test_forward_matches_jax_float32(pallas_interpret, monkeypatch):
    if pallas_interpret:
        monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    jout, tout = _both_forwards("float32")
    np.testing.assert_allclose(tout, jout, rtol=2e-4, atol=2e-4)


def test_forward_matches_jax_bfloat16():
    """bf16 weights carried over by their bits; every op rounds to bf16
    in both packages, but XLA and PyTorch round sums at other places, so
    the bound is bf16's: logits of unit scale agree to 0.05 (a few bf16
    ulps) and their relative L2 error stays under 2% (0.7% measured)."""
    jout, tout = _both_forwards("bfloat16")
    np.testing.assert_allclose(tout, jout, rtol=0.05, atol=0.05)
    assert np.linalg.norm(tout - jout) <= 0.02 * np.linalg.norm(jout)


def test_params_from_jax_is_exact_for_bfloat16():
    mesh = _mesh()
    jcfg = jtf.TransformerConfig(dtype="bfloat16", **SMALL)
    jparams = {k: np.asarray(v) for k, v in
               jtf.init_params(jcfg, mesh, seed=1).items()}
    tparams = ttf.params_from_jax(jparams, ttf.TransformerConfig(
        dtype="bfloat16", **SMALL), "cpu")
    for name, arr in jparams.items():
        assert tparams[name].dtype == torch.bfloat16
        assert tparams[name].shape == arr.shape
        np.testing.assert_array_equal(tparams[name].float().numpy(),
                                      arr.astype(np.float32))
    with pytest.raises(MXNetError, match="names"):
        ttf.params_from_jax({"embed": jparams["embed"]},
                            ttf.TransformerConfig(dtype="bfloat16", **SMALL),
                            "cpu")


def test_init_params_shapes_dtypes_and_seed():
    cfg = ttf.TransformerConfig(dtype="bfloat16", **SMALL)
    a = ttf.init_params(cfg, "cpu", seed=0)
    b = ttf.init_params(cfg, "cpu", seed=0)
    c = ttf.init_params(cfg, "cpu", seed=1)
    jshapes = jtf.param_shapes(jtf.TransformerConfig(**SMALL), 1)
    assert ttf.param_shapes(cfg) == jshapes
    for name, shape in jshapes.items():
        assert tuple(a[name].shape) == shape
        assert a[name].dtype == torch.bfloat16
        assert torch.equal(a[name], b[name])
    assert not torch.equal(a["wq"], c["wq"])
    assert torch.all(a["ln1"] == 1)
    # std 1/sqrt(fan_in): w2's fan-in is d_ff
    assert abs(a["w2"].float().std().item() - SMALL["d_ff"] ** -0.5) < 0.01


def test_config_validation():
    with pytest.raises(MXNetError, match="remat"):
        ttf.TransformerConfig(remat="bogus")
    ttf.TransformerConfig(remat="dots")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttf.TransformerConfig(n_experts=4)
    with pytest.raises(MXNetError, match="dtype"):
        ttf.TransformerConfig(dtype="float16")


# -- numerics traps ----------------------------------------------------------

def test_matmul_numerics_are_f32_reductions():
    """The forward, not its caller, pins cuBLAS to f32 reductions for
    bf16 GEMMs and to no TF32 for f32 ones (torch lets both slip)."""
    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction
    try:
        mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = True
        ttf._set_matmul_numerics()
        assert not mm.allow_tf32
        assert not mm.allow_bf16_reduced_precision_reduction
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = saved


def test_dense_ffn_gelu_is_the_tanh_approximation():
    """`jax.nn.gelu` defaults to the tanh approximation; torch's default
    is exact erf.  The port's FFN matches JAX's `_dense_ffn` at f32
    precision, and the erf variant would miss that bound."""
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1.5, (2, 8, 16)).astype(np.float32)
    w1 = rng.normal(0, 0.5, (16, 32)).astype(np.float32)
    w2 = rng.normal(0, 0.3, (32, 16)).astype(np.float32)
    mesh = _mesh()
    jffn = jax.jit(get_shard_map()(jtf._dense_ffn, mesh=mesh,
                                   in_specs=(P(), P(), P()), out_specs=P()))
    ref = np.asarray(jffn(x, w1, w2))
    tx, tw1, tw2 = (torch.from_numpy(a) for a in (x, w1, w2))
    got = ttf._dense_ffn(tx, tw1, tw2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    erf = (torch.nn.functional.gelu(tx @ tw1) @ tw2).numpy()
    assert np.abs(erf - ref).max() > 1e-4


def test_rms_norm_casts_before_the_scale():
    """In bf16 the JAX order is: normalize in f32, cast to bf16, THEN
    multiply by the scale in bf16.  The port matches JAX nearly bitwise;
    scaling in f32 before the single cast would round differently on
    many elements."""
    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.normal(0, 2, (4, 64, 128)), jnp.bfloat16)
    scale = jnp.asarray(rng.uniform(0.5, 2.0, (128,)), jnp.bfloat16)
    ref = np.asarray(jtf._rms_norm(x, scale).astype(jnp.float32))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    ts = torch.from_numpy(np.array(scale.astype(jnp.float32))).bfloat16()
    got = ttf._rms_norm(tx, ts)
    assert got.dtype == torch.bfloat16
    n = ref.size
    mism = int((got.float().numpy() != ref).sum())
    x32 = tx.float()
    wrong = (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
             * ts.float()).to(torch.bfloat16)
    mism_wrong = int((wrong.float().numpy() != ref).sum())
    assert mism <= 0.01 * n, mism
    assert mism_wrong > 0.05 * n, mism_wrong


def test_embedding_sums_in_param_dtype_and_masks_out_of_range_tokens():
    cfg = ttf.TransformerConfig(dtype="float32", **SMALL)
    p = ttf.init_params(cfg, "cpu", seed=2)
    fwd = ttf.make_forward(cfg, "cpu")
    toks = np.random.RandomState(2).randint(0, cfg.vocab, (1, 16))
    bad = toks.copy()
    bad[0, 3] = cfg.vocab + 5   # outside the vocab: embeds as zeros
    zero_row = dict(p, embed=p["embed"].clone())
    out_bad = fwd(p, bad)
    zero_row["embed"][toks[0, 3]] = 0
    out_zero = fwd(zero_row, toks)
    torch.testing.assert_close(out_bad, out_zero)
    with pytest.raises(MXNetError, match="max_len"):
        fwd(p, np.zeros((1, T + 1), np.int64))


# -- ring / blockwise attention and the mesh ----------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_plain_loop_matches_jax(causal):
    """The blocked online softmax (no kernel), square and decode-shaped
    (Tq < Tk: queries are the LAST Tq positions)."""
    rng = np.random.RandomState(6)
    for tq, tk in ((96, 96), (40, 96)):
        q = rng.normal(0, 1, (2, 3, tq, 16)).astype(np.float32)
        k = rng.normal(0, 1, (2, 3, tk, 16)).astype(np.float32)
        v = rng.normal(0, 1, (2, 3, tk, 16)).astype(np.float32)
        ref = np.asarray(jax_blockwise(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), block_size=32,
                                       causal=causal, use_pallas=False))
        got = tra._blockwise_loop(
            *(torch.from_numpy(a) for a in (q, k, v)), block_size=32,
            causal=causal, scale=16 ** -0.5)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-5)
        # the public route: square to flash_attention, decode to the loop
        got = tra.blockwise_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), block_size=32,
            causal=causal)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-5)


def test_ring_attention_sp1_routes_to_flash_and_sp2_raises():
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 2, 64, 32))
                                .astype(np.float32)) for _ in range(3))
    ref = jax_blockwise(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                        causal=True, use_pallas=False)
    got = tra.ring_attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)
    # a ring over sp = 2 takes the group's two shards as lists
    with pytest.raises(MXNetError, match="as lists"):
        tra.ring_attention(q, k, v, causal=True, axis_size=2)


def test_ring_self_attention_matches_transformer_attention():
    cfg = ttf.TransformerConfig(dtype="float32", **SMALL)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 64, generator=g)
    ws = [torch.randn(64, 64, generator=g) * 0.125 for _ in range(4)]
    mesh = tmesh.create_mesh(devices=["cpu"])
    torch.testing.assert_close(
        tra.ring_self_attention(x, *ws, n_heads=cfg.n_heads),
        ttf._attention(cfg, mesh, [x], *([w] for w in ws))[0])


def test_mesh_is_one_device():
    m = tmesh.create_mesh({tmesh.AXIS_DP: 1, tmesh.AXIS_TP: 1},
                          devices=["cpu"])
    assert m.shape == {a: 1 for a in ("dp", "pp", "tp", "sp", "ep")}
    assert m.device == torch.device("cpu")
    # one device holds no tp = 2 mesh; two (repeated) devices do
    with pytest.raises(MXNetError, match="needs 2 devices, have 1"):
        tmesh.create_mesh({tmesh.AXIS_TP: 2}, devices=["cpu"])
    assert tmesh.create_mesh({tmesh.AXIS_TP: 2},
                             devices=["cpu", "cpu"]).shape[tmesh.AXIS_TP] == 2
