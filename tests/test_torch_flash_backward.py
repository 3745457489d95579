"""The PyTorch port's flash-attention backward
(`mxtpu_torch/ops/flash_attention.py`: `_flash_bwd_reference`, the
`_FlashAttention` autograd Function) against the JAX package's
(`mxtpu/ops/pallas_attention.py`: `_flash_backward_pallas` and
`jax.grad` of `flash_attention`).

The same numpy inputs go through the Pallas backward kernels in
interpreter mode (as `tests/test_pallas_attention.py` runs them on the
CPU) or JAX's jnp sweeps, and through the port on the CPU, which takes
the plain backward.  The CUDA kernels themselves run only on the card:
`chip_smoke.py` holds them against the plain backward there, at the
bounds used here for bf16.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxtpu.ops import pallas_attention as jfa
from mxtpu_torch.base import MXNetError
from mxtpu_torch.ops import flash_attention as tfa

F32_TOL = dict(rtol=2e-4, atol=2e-5)       # test_pallas_attention's sweeps
MULTIBLOCK_TOL = dict(rtol=2e-3, atol=2e-4)  # its multiblock gradients


def _arrays(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _to_jax(t):
    """A port tensor as a JAX array of the same dtype and values."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _scales(q, k, v, g, out, lse, sm_scale, causal):
    """|dS||K|, |dS|^T|Q| and P^T|G|: the sums behind dq, dk and dv
    before they cancel (chip_smoke.py's `bwd_error_scales`)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool)
                          .triu(1), float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", g.float(), v.float())
    ds = (p * (dp - tfa._delta(out, g)[..., None]) * sm_scale).abs()
    return (ds @ k.float().abs(), ds.transpose(1, 2) @ q.float().abs(),
            p.transpose(1, 2) @ g.float().abs())


def _within_bf16_bound(got, ref, scales):
    """chip_smoke.py's bf16 bound on each gradient: |d| <= 2e-3 +
    2^-6 * scale elementwise, and a relative L2 error of at most 1e-2."""
    for a, b, s in zip(got, ref, scales):
        d = a.float() - b.float()
        if not (bool(torch.all(d.abs() <= 2e-3 + 2 ** -6 * s)) and
                (d.norm() / b.float().norm()).item() <= 1e-2):
            return False
    return True


# -- the plain backward against the Pallas kernels -----------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,block", [((2, 128, 64), 64),
                                         ((3, 256, 32), 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_pallas_kernels(dtype, shape, block, causal,
                                               monkeypatch):
    """`_flash_bwd_reference` against `_flash_backward_pallas` in
    interpret mode, one block and several, on the same q, k, v, g, O
    and LSE.  f32 at the bound of `test_pallas_backward_kernels_match_
    jnp_sweeps`; bf16 at chip_smoke.py's bound for the CUDA kernels
    (both sides round P and dS to bf16, so only the f32 sums' order and
    the rounding of values that order moves differ: 0.13 of the bound
    and relative L2 1.4e-4 measured)."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    q, k, v, g = (torch.from_numpy(a) for a in _arrays([shape] * 4, 0))
    if dtype == "bfloat16":
        q, k, v, g = (t.to(torch.bfloat16) for t in (q, k, v, g))
    scale = shape[-1] ** -0.5
    out, lse = tfa._reference_attention_lse(q, k, v, scale, causal)
    ref = tfa._flash_bwd_reference(q, k, v, g, out, lse, scale, causal)
    jgrads = jfa._flash_backward_pallas(
        *(_to_jax(t) for t in (q, k, v, g, out, lse)), scale, causal, block,
        block)
    for a, b in zip(ref, jgrads):
        assert a.dtype == q.dtype
    if dtype == "float32":
        for a, b in zip(ref, jgrads):
            np.testing.assert_allclose(a.numpy(), _np(b), **F32_TOL)
    else:
        jref = [torch.from_numpy(_np(b)) for b in jgrads]
        assert _within_bf16_bound(ref, jref, _scales(q, k, v, g, out, lse,
                                                     scale, causal))


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_cast_down_rule(causal):
    """In bf16 the plain backward rounds P to bf16 before dv = P^T G, as
    `_dot_f32` does in the JAX kernels: its dv equals an explicit
    P_bf16^T G (computed here in float64 and rounded once) on all but a
    few elements, where a variant that keeps P in f32 differs on
    ~40% (measured) -- the rule is visible and the check sees it."""
    q, k, v, g = (_bf16(a) for a in _arrays([(2, 256, 64)] * 4, 3))
    scale = 64 ** -0.5
    out, lse = tfa._reference_attention_lse(q, k, v, scale, causal)
    dv = tfa._flash_bwd_reference(q, k, v, g, out, lse, scale, causal)[2]
    s = (np.einsum("bqd,bkd->bqk", q.double().numpy(), k.double().numpy())
         .astype(np.float32) * np.float32(scale))
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s,
                     np.float32(-1e30))
    p = np.exp(s - lse.numpy()[..., None])

    def dv_with(p_operand):
        return torch.from_numpy(np.einsum(
            "bqk,bqd->bkd", p_operand, g.double().numpy())).to(torch.bfloat16)

    p_bf16 = torch.from_numpy(p).to(torch.bfloat16).double().numpy()
    mism = (dv != dv_with(p_bf16)).float().mean().item()
    mism_f32 = (dv != dv_with(p.astype(np.float64))).float().mean().item()
    assert mism <= 0.01, mism
    assert mism_f32 >= 0.2, mism_f32


# -- gradients of the public function against jax.grad ------------------------

def _port_grads(q, k, v, g, **kw):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*ts, **kw)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return [t.grad.numpy() for t in ts]


def _jax_grads(q, k, v, g, **kw):
    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, **kw)
                       .astype(jnp.float32) * g)
    return [np.asarray(a) for a in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_grad_3d_multiblock(causal, monkeypatch):
    """(bh, T, d) with 2 x 2 blocks on the JAX side (its Pallas forward
    and backward kernels in interpret mode), at the multiblock gradient
    bound of `test_pallas_attention.py`."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    q, k, v, g = _arrays([(2, 256, 64)] * 4, 1)
    ref = _jax_grads(q, k, v, g, causal=causal, block_q=128, block_k=128)
    for a, b in zip(_port_grads(q, k, v, g, causal=causal), ref):
        np.testing.assert_allclose(a, b, **MULTIBLOCK_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_grad_4d_strided_heads(causal, monkeypatch):
    """(batch, heads, T, d) with heads split by a transpose (a strided
    view, as the transformer makes them): the gradients come back in the
    layout of the inputs."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    x, gx = _arrays([(2, 128, 3 * 32), (2, 3, 128, 32)], 2)
    q = np.ascontiguousarray(x.reshape(2, 128, 3, 32).transpose(0, 2, 1, 3))
    ref = _jax_grads(q, q * 0.5, q * -0.7, gx, causal=causal, block_q=64,
                     block_k=64)
    base = torch.from_numpy(x).requires_grad_(True)
    heads = base.reshape(2, 128, 3, 32).transpose(1, 2)   # strided
    assert not heads.is_contiguous()
    ks, vs = (heads * 0.5).detach().requires_grad_(True), \
        (heads * -0.7).detach().requires_grad_(True)
    out = tfa.flash_attention(heads, ks, vs, causal=causal)
    assert out.shape == (2, 3, 128, 32)
    (out * torch.from_numpy(gx)).sum().backward()
    dq = base.grad.reshape(2, 128, 3, 32).transpose(1, 2).numpy()
    for a, b in zip((dq, ks.grad.numpy(), vs.grad.numpy()), ref):
        np.testing.assert_allclose(a, b, **MULTIBLOCK_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_gradients_match_jax_f32_sweeps(causal):
    """Tq 100 x Tk 90: JAX's backward takes its f32 jnp sweeps
    (`_flash_bwd`), which the port's plain backward equals in f32."""
    q, g = _arrays([(2, 100, 32)] * 2, 4)
    k, v = _arrays([(2, 90, 32)] * 2, 5)
    ref = _jax_grads(q, k, v, g, causal=causal)
    for a, b in zip(_port_grads(q, k, v, g, causal=causal), ref):
        np.testing.assert_allclose(a, b, **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_bf16_gradients_against_jax_f32_sweeps(causal):
    """The JAX package has no bf16 kernel result at ragged lengths: it
    routes them to its f32 sweeps, which keep P and dS in f32.  The
    port keeps the kernels' cast-down rule at every length, so it is
    held to the sweeps at a bf16 bound: chip_smoke.py's elementwise
    bound on the sums before they cancel and a relative L2 error of at
    most 1e-2 (measured: 0.39 of the bound, relative L2 2.8e-3).
    Looser than the f32 bound because P and dS lose 8 bits on the
    port's side only."""
    q, g = (_bf16(a) for a in _arrays([(2, 100, 32)] * 2, 6))
    k, v = (_bf16(a) for a in _arrays([(2, 90, 32)] * 2, 7))
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tfa.flash_attention(*ts, causal=causal)
    out.backward(g)
    got = [t.grad for t in ts]

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=causal)
                       .astype(jnp.float32) * _to_jax(g).astype(jnp.float32))
    ref = [torch.from_numpy(_np(a)) for a in jax.grad(
        loss, argnums=(0, 1, 2))(*(_to_jax(t) for t in (q, k, v)))]
    _, lse = tfa._reference_attention_lse(q, k, v, 32 ** -0.5, causal)
    assert all(a.dtype == torch.bfloat16 for a in got)
    assert _within_bf16_bound(got, ref, _scales(q, k, v, g, out.detach(),
                                                lse, 32 ** -0.5, causal))


# -- the autograd Function's routing ------------------------------------------

def test_forward_asks_for_the_lse_only_when_a_gradient_is_needed(monkeypatch):
    seen = []
    impl = tfa._flash_impl

    def spy(q, k, v, sm_scale, causal, want_lse):
        seen.append(want_lse)
        return impl(q, k, v, sm_scale, causal, want_lse)

    monkeypatch.setattr(tfa, "_flash_impl", spy)
    q = torch.randn(2, 64, 32, requires_grad=True)
    with torch.no_grad():
        tfa.flash_attention(q, q, q, causal=True)
    with torch.inference_mode():
        tfa.flash_attention(q, q, q, causal=True)
    tfa.flash_attention(q.detach(), q.detach(), q.detach(), causal=True)
    assert seen == [False, False, False]
    out = tfa.flash_attention(q, q, q, causal=True)
    assert seen == [False, False, False, True] and out.requires_grad


def test_backward_takes_the_plain_version_on_the_cpu(monkeypatch):
    """A CPU tensor's backward runs `_flash_bwd_reference` once with
    the saved O and LSE and a contiguous cotangent in O's dtype; the
    CUDA launcher refuses CPU tensors."""
    calls = []
    ref = tfa._flash_bwd_reference

    def spy(q, k, v, g, out, lse, sm_scale, causal):
        calls.append((g.dtype, g.is_contiguous(), lse.shape, sm_scale,
                      causal))
        return ref(q, k, v, g, out, lse, sm_scale, causal)

    monkeypatch.setattr(tfa, "_flash_bwd_reference", spy)
    q = torch.randn(3, 64, 16, requires_grad=True)
    out = tfa.flash_attention(q, q, q, sm_scale=0.3, causal=True)
    # the cotangent reaches the Function as a transposed (strided) view
    (out.transpose(1, 2) * torch.randn(3, 16, 64)).sum().backward()
    assert calls == [(torch.float32, True, (3, 64), 0.3, True)]
    assert q.grad is not None and q.grad.shape == q.shape
    with pytest.raises(MXNetError, match="CUDA"):
        tfa._flash_backward_cuda(q.detach(), q.detach(), q.detach(),
                                 q.detach(), out.detach(),
                                 torch.zeros(3, 64), 0.3, True)


def test_square_ring_attention_differentiates_through_the_function(
        monkeypatch):
    """The transformer's route, `ring_attention` at sp = 1 with square
    q/k, reaches the autograd Function: its backward runs the plain
    backward once on the CPU (the kernels on the card), and the
    gradients equal autograd through the plain forward."""
    from mxtpu_torch.parallel import ring_attention as tra

    calls = []
    ref = tfa._flash_bwd_reference
    monkeypatch.setattr(tfa, "_flash_bwd_reference",
                        lambda *a: calls.append(1) or ref(*a))
    x = torch.randn(2, 3, 64, 16, requires_grad=True)
    g = torch.randn(2, 3, 64, 16)
    tra.ring_attention(x, x * 0.5, x * 2.0, causal=True).backward(g)
    assert calls == [1]
    y = x.detach().requires_grad_(True)
    q, k, v = (t.reshape(6, 64, 16) for t in (y, y * 0.5, y * 2.0))
    out, _ = tfa._reference_attention_lse(q, k, v, 0.25, True)
    out.backward(g.reshape(6, 64, 16))
    torch.testing.assert_close(x.grad, y.grad, rtol=2e-4, atol=2e-5)
