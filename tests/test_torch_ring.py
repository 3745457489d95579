"""The PyTorch port's ring attention at sp > 1
(`mxtpu_torch/parallel/ring_attention.py`: `_RingAttention`, the plain
ring and the kernels' route) against the JAX package's custom-VJP ring
(`mxtpu/parallel/ring_attention.py`) under shard_map on the conftest's
CPU devices.

The port takes one sp group's shards as lists ([cpu] * sp here).  On
the CPU it runs the plain ring; the kernels' route (a forward launch
with the LSE per kept block, merged in f32; a dq and a dk/dv launch per
kept pair with the global LSE and delta) is run here with the launches
replaced by the kernels' plain versions, which counts them.  The bound
is the one `tests/test_parallel.py` holds the JAX ring's gradients to,
f32 rtol 2e-4 / atol 2e-5.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

import mxtpu.parallel as jpar
from mxtpu.parallel.mesh import get_shard_map
from mxtpu_torch.base import MXNetError
from mxtpu_torch.ops import flash_attention as tfa

tra = importlib.import_module("mxtpu_torch.parallel.ring_attention")

torch.set_num_threads(1)

SHAPE = (2, 2, 32, 16)         # B, H, T (global), D: a kernel head dim
TOL = dict(rtol=2e-4, atol=2e-5)
CASES = [(sp, causal) for sp in (2, 4) for causal in (True, False)]


def _inputs(seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_ring(sp, causal):
    """mxtpu's ring under shard_map over sp devices: the output and the
    gradients of sum(sin(o) * o), a non-uniform cotangent."""
    mesh = jpar.create_mesh({"sp": sp}, devices=jax.devices()[:sp])

    def both(q, k, v):
        def loss(q, k, v):
            o = jpar.ring_attention(q, k, v, axis_name="sp", causal=causal)
            return (jnp.sin(o) * o).sum(), o

        (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
        return o, grads

    spec = PartitionSpec(None, None, "sp", None)
    fn = jax.jit(get_shard_map()(both, mesh=mesh, in_specs=(spec,) * 3,
                                 out_specs=(spec, (spec,) * 3)))
    o, grads = fn(*_inputs())
    return np.asarray(o), [np.asarray(g) for g in grads]


def _port_ring(sp, causal):
    """The port's ring over [cpu] * sp shards: the output and the
    gradients of the same loss, reassembled."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _inputs())
    qs, ks, vs = (list(t.chunk(sp, 2)) for t in (q, k, v))
    outs = tra.ring_attention(qs, ks, vs, causal=causal, axis_size=sp)
    assert isinstance(outs, list) and len(outs) == sp
    o = torch.cat(outs, 2)
    grads = torch.autograd.grad((torch.sin(o) * o).sum(), (q, k, v))
    return o.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("sp,causal", CASES)
def test_ring_matches_jax_ring(sp, causal):
    jo, jg = _jax_ring(sp, causal)
    to, tg = _port_ring(sp, causal)
    np.testing.assert_allclose(to, jo, **TOL)
    for a, b, name in zip(tg, jg, "qkv"):
        np.testing.assert_allclose(a, b, err_msg="d" + name, **TOL)


@pytest.mark.parametrize("sp,causal", CASES)
def test_the_kernel_route_matches_jax_and_counts_its_launches(
        sp, causal, monkeypatch):
    """The kernels' route of `_RingAttention`, with each launch made by
    the kernel's plain version: the causal ring launches the forward
    and each backward kernel sp(sp+1)/2 times (the blocks on and below
    the diagonal), the other ring sp^2 times."""
    calls = {"fwd": [], "bwd": []}

    def fwd(q, k, v, scale, causal, want_lse):
        assert want_lse and q.is_contiguous() and q.dim() == 3
        calls["fwd"].append(causal)
        return tfa._reference_attention_lse(q, k, v, scale, causal)

    def pair_bwd(q, k, v, g, o, lse, delta, scale, causal):
        tfa._check_bwd_args(q, k, v, g, o, lse)
        torch.testing.assert_close(delta, tfa._delta(o, g))
        calls["bwd"].append(causal)
        return tfa._flash_bwd_reference(q, k, v, g, o, lse, scale, causal)

    monkeypatch.setattr(tfa, "_flash_forward_cuda", fwd)
    monkeypatch.setattr(tra, "_pair_backward_cuda", pair_bwd)
    monkeypatch.setattr(tra, "_ring_forward_plain", tra._ring_forward_cuda)
    monkeypatch.setattr(tra, "_ring_backward_plain", tra._ring_backward_cuda)
    jo, jg = _jax_ring(sp, causal)
    to, tg = _port_ring(sp, causal)
    np.testing.assert_allclose(to, jo, **TOL)
    for a, b, name in zip(tg, jg, "qkv"):
        np.testing.assert_allclose(a, b, err_msg="d" + name, **TOL)
    want = sp * (sp + 1) // 2 if causal else sp * sp
    assert len(calls["fwd"]) == len(calls["bwd"]) == want
    # only the diagonal blocks are masked
    assert sum(calls["fwd"]) == sum(calls["bwd"]) == (sp if causal else 0)


def test_the_kernel_route_raises_off_the_card():
    """A CPU shard handed to the kernels' route raises; nothing falls
    back to the plain ring."""
    q, k, v = (list(torch.randn(1, 2, 8, 16).chunk(2, 2)) for _ in range(3))
    with pytest.raises(MXNetError, match="CUDA device"):
        tra._ring_forward_cuda(q, k, v, True, 0.25)
    t = torch.randn(2, 4, 16)
    lse = torch.zeros(2, 4)
    with pytest.raises(MXNetError, match="CUDA device"):
        tra._pair_backward_cuda(t, t, t, t, t, lse, lse, 0.25, True)


def test_ring_arguments_and_the_degenerate_ring():
    q = torch.randn(1, 2, 16, 8)
    with pytest.raises(MXNetError, match="shards"):
        tra.ring_attention([q, q], [q], [q, q])
    with pytest.raises(MXNetError, match="axis_size 3"):
        tra.ring_attention([q, q], [q, q], [q, q], axis_size=3)
    # a list of one is the sp = 1 route: flash attention
    one = tra.ring_attention([q], [q], [q], causal=True)
    torch.testing.assert_close(one[0], tra.ring_attention(q, q, q,
                                                          causal=True))


def test_ring_self_attention_over_shards_equals_the_whole():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, 16, generator=g)
    ws = [torch.randn(16, 16, generator=g) * 0.25 for _ in range(4)]
    whole = tra.ring_self_attention(x, *ws, n_heads=2)
    parts = tra.ring_self_attention(list(x.chunk(4, 1)), *ws, n_heads=2)
    torch.testing.assert_close(torch.cat(parts, 1), whole, **TOL)
