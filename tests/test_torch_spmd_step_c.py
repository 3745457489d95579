"""The PyTorch port's sharded TransformerLM against the JAX package's on
{sp 4}, {dp 8} and {dp 2, tp 2, ep 2}; the Adam moments carried over
from `mxtpu` mid-run (`opt_state_from_jax`); the kernels' ring route
inside the sharded step (launches counted); and the bfloat16 sharded
step against the one-device step.  Helpers and bounds:
`tests/test_torch_spmd_step.py`.
"""
import importlib

import numpy as np
import pytest
import torch

import jax

from mxtpu.parallel import transformer as jtf
from mxtpu_torch.base import MXNetError
from mxtpu_torch.ops import flash_attention as tfa
from mxtpu_torch.parallel import spmd
from mxtpu_torch.parallel import transformer as ttf
from test_torch_spmd_step import (LR, check_adam, check_moment_memory,
                                  check_sgd, cfg_kw, data, meshes, run_both)

tra = importlib.import_module("mxtpu_torch.parallel.ring_attention")

torch.set_num_threads(1)


def test_sgd_step_matches_jax_sp4():
    runs, _, _ = run_both(dict(sp=4), "sgd", steps=2)
    check_sgd(runs)


def test_zero1_adam_step_matches_jax_dp8():
    """dp = 8: every moment big enough is split eight ways."""
    runs, jstate, tstate = run_both(dict(dp=8), "adam")
    check_adam(runs)
    check_moment_memory(jstate, tstate, ttf.TransformerConfig(**cfg_kw()))


def test_zero1_adam_step_matches_jax_dp2_tp2_ep2():
    """ep = 2 with the dense FFN: the ep replicas compute equal copies."""
    runs, jstate, tstate = run_both(dict(dp=2, tp=2, ep=2), "adam")
    check_adam(runs)
    check_moment_memory(jstate, tstate, ttf.TransformerConfig(**cfg_kw()))


def test_adam_state_carried_over_from_jax_mid_run():
    """`params_from_jax` and `opt_state_from_jax` take the JAX package's
    state after one step; a second step from it agrees."""
    jm, tm = meshes(dp=2, tp=2, sp=2)
    jcfg = jtf.TransformerConfig(**cfg_kw())
    tcfg = ttf.TransformerConfig(**cfg_kw())
    jstep, sh = jtf.make_train_step(jcfg, jm, lr=LR, optimizer="adam")
    tstep, _ = ttf.make_train_step(tcfg, tm, lr=LR, optimizer="adam")
    tok, lab = data(seed=5)
    jt, jl = (jax.device_put(a, sh["data"]) for a in (tok, lab))
    jp, jo, _ = jstep(jtf.init_params(jcfg, jm, seed=5),
                      jtf.init_opt_state(jcfg, jm), jt, jl)
    tp = ttf.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             tcfg, tm)
    to = ttf.opt_state_from_jax(
        {"m": {k: np.asarray(v) for k, v in jo["m"].items()},
         "v": {k: np.asarray(v) for k, v in jo["v"].items()},
         "t": np.asarray(jo["t"])}, tcfg, tm)
    assert to["t"].shards[0].item() == 1.0
    assert to["m"]["wq"].spec == ttf._opt_state_specs(tcfg, tm)["wq"]
    jp, jo, jloss = jstep(jp, jo, jt, jl)
    tp, to, tloss = tstep(tp, to, tok, lab)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=2e-4)
    for k in jp:
        np.testing.assert_allclose(spmd.gather(tp[k]).numpy(),
                                   np.asarray(jp[k]), atol=2 * LR)
    for m in "mv":
        for k in jo[m]:
            want = np.asarray(jo[m][k])
            np.testing.assert_allclose(spmd.gather(to[m][k]).numpy(), want,
                                       rtol=2e-4,
                                       atol=2e-5 * np.abs(want).max())


def test_init_params_do_not_depend_on_the_mesh():
    _, tm = meshes(dp=2, pp=2, tp=2)
    cfg = ttf.TransformerConfig(**cfg_kw(pp=2))
    one = ttf.init_params(cfg, "cpu", seed=7)
    many = ttf.init_params(cfg, tm, seed=7)
    shapes = ttf.param_shapes(cfg, 2)
    for n, t in one.items():
        assert many[n].shape == shapes[n]
        assert torch.equal(spmd.gather(many[n]).reshape(t.shape), t)
    # a step refuses parameters laid out on another mesh
    _, other = meshes(dp=8)
    step, _ = ttf.make_train_step(ttf.TransformerConfig(**cfg_kw()), other)
    with pytest.raises(MXNetError, match="not laid out"):
        step(ttf.init_params(ttf.TransformerConfig(**cfg_kw()), tm), *data())


@pytest.mark.parametrize("remat,fwd_per_block", [("none", 1), ("dots", 2)])
def test_the_sharded_step_launches_the_ring_kernels(remat, fwd_per_block,
                                                    monkeypatch):
    """The sharded step with the ring on its kernels' route (each launch
    made by the kernel's plain version): the loss and parameters of the
    plain route, and per step, for each microbatch, layer and (dp, tp,
    ep) group, sp(sp+1)/2 launches of each backward kernel and of the
    forward (twice under "dots": the recompute reruns it)."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, scale, causal, want_lse):
        calls["fwd"] += 1
        return tfa._reference_attention_lse(q, k, v, scale, causal)

    def pair_bwd(q, k, v, g, o, lse, delta, scale, causal):
        calls["bwd"] += 1
        return tfa._flash_bwd_reference(q, k, v, g, o, lse, scale, causal)

    axes = dict(dp=2, pp=2, tp=2, sp=2)
    _, tm = meshes(**{a: n for a, n in axes.items() if a != "dp"})
    cfg = ttf.TransformerConfig(**cfg_kw(pp=2, remat=remat))
    tok, lab = data(seed=6, shape=(4, 32))

    def one_step():
        step, _ = ttf.make_train_step(cfg, tm, n_micro=2, lr=LR)
        params, loss = step(ttf.init_params(cfg, tm, seed=6), tok, lab)
        return loss, {n: spmd.gather(p) for n, p in params.items()}

    plain_loss, plain = one_step()
    monkeypatch.setattr(tfa, "_flash_forward_cuda", fwd)
    monkeypatch.setattr(tra, "_pair_backward_cuda", pair_bwd)
    monkeypatch.setattr(tra, "_ring_forward_plain", tra._ring_forward_cuda)
    monkeypatch.setattr(tra, "_ring_backward_plain", tra._ring_backward_cuda)
    loss, params = one_step()
    np.testing.assert_allclose(loss.item(), plain_loss.item(), rtol=2e-5)
    for n in params:
        np.testing.assert_allclose(params[n].numpy(), plain[n].numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=n)
    sp, groups = tm.shape["sp"], tm.size // tm.shape["sp"] // tm.shape["pp"]
    per_ring = sp * (sp + 1) // 2
    blocks = 2 * cfg.n_layers * groups * per_ring   # n_micro = 2
    assert calls == {"fwd": fwd_per_block * blocks, "bwd": blocks}


def test_bfloat16_sharded_step_against_the_one_device_step():
    """bf16, remat "dots", ZeRO-1 Adam: one step on {pp 2, tp 2, sp 2}
    against the one-device step from the same weights.  The tp partial
    products are rounded to bf16 before their sum, so the loss agrees to
    bf16's 0.01 (measured 6.3e-4), the first moments (0.1 * the
    gradient, f32) to a relative L2 error of 0.03 (the card check's
    gradient bound; measured 0.015 at most), and the parameters, where
    Adam's step is lr * sign(g), to 2 * lr and a bf16 ulp of each side,
    at most 5% of them more than the ulps apart (measured 0.9%)."""
    _, tm = meshes(pp=2, tp=2, sp=2)
    cfg = ttf.TransformerConfig(**cfg_kw(pp=2, dtype="bfloat16",
                                         remat="dots"))
    tok, lab = data(seed=8)
    p1 = ttf.init_params(cfg, "cpu", seed=8)
    o1 = ttf.init_opt_state(cfg, "cpu")
    step1, _ = ttf.make_train_step(cfg, "cpu", n_micro=2, lr=LR,
                                   optimizer="adam")
    p2 = ttf.shard_params(p1, cfg, tm)
    step2, _ = ttf.make_train_step(cfg, tm, n_micro=2, lr=LR,
                                   optimizer="adam")
    p2, o2, l2 = step2(p2, ttf.init_opt_state(cfg, tm), tok, lab)
    p1, o1, l1 = step1(p1, o1, tok, lab)
    assert abs(l1.item() - l2.item()) <= 0.01
    for n, t in p1.items():
        a = spmd.gather(p2[n]).reshape(t.shape).float()
        m1, m2 = o1["m"][n], spmd.gather(o2["m"][n]).reshape(t.shape)
        assert ((m2 - m1).norm() / m1.norm()).item() <= 0.03, n
        diff = (a - t.float()).abs()
        ulp = (a.abs() + t.float().abs()) * 2 ** -7 + 1e-6
        assert bool((diff <= 2 * LR + ulp).all()), n
        assert (diff > ulp).float().mean().item() <= 0.05, n
