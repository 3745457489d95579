"""The PyTorch port's TransformerLM training (`mxtpu_torch/parallel/
transformer.py`: the loss, `make_train_step`, `make_fused_train_steps`,
`init_opt_state`; `mxtpu_torch/executor.py`: remat) against the JAX
package's (`mxtpu/parallel/transformer.py`, `mxtpu/executor.py`) on a
1-device mesh.

Weights are drawn by the JAX package and carried over with
`params_from_jax`; tokens and labels come from numpy.  On the CPU the
port's attention takes the plain forward and backward, and JAX's takes
its reference forward and jnp sweeps, or its Pallas kernels in
interpreter mode where a test says so.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mxtpu.ops import pallas_attention as jfa
from mxtpu.parallel import transformer as jtf
from mxtpu.parallel.mesh import (AXIS_DP, AXIS_EP, AXIS_PP, AXIS_SP,
                                 AXIS_TP, create_mesh, get_shard_map)
from mxtpu_torch import executor as tex
from mxtpu_torch.base import MXNetError
from mxtpu_torch.ops import flash_attention as tfa
from mxtpu_torch.parallel import transformer as ttf

B, T = 2, 64
SMALL = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_len=T)
F32_TOL = dict(rtol=2e-4, atol=2e-5)
LR = 1e-2


def _mesh():
    return create_mesh({AXIS_DP: 1, AXIS_PP: 1, AXIS_TP: 1, AXIS_SP: 1,
                        AXIS_EP: 1}, devices=jax.devices()[:1])


def _data(seed=0, shape=(B, T)):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, SMALL["vocab"], shape).astype(np.int32),
            rng.randint(0, SMALL["vocab"], shape).astype(np.int32))


def _setup(dtype="float32", remat="none", seed=0):
    """(JAX config, port config, JAX params, port params): one set of
    weights in both packages."""
    jcfg = jtf.TransformerConfig(dtype=dtype, remat=remat, **SMALL)
    tcfg = ttf.TransformerConfig(dtype=dtype, remat=remat, **SMALL)
    jparams = jtf.init_params(jcfg, _mesh(), seed=seed)
    tparams = ttf.params_from_jax({k: np.asarray(v)
                                   for k, v in jparams.items()},
                                  tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _run_both(optimizer, dtype="float32", steps=3, remat="none"):
    """Both packages' make_train_step for `steps` steps on one batch;
    returns (JAX losses, port losses, JAX params, port params) after
    each step."""
    jcfg, tcfg, jp, tp = _setup(dtype, remat)
    tok, lab = _data()
    mesh = _mesh()
    jstep, sh = jtf.make_train_step(jcfg, mesh, lr=LR, optimizer=optimizer)
    tstep, info = ttf.make_train_step(tcfg, device="cpu", lr=LR,
                                      optimizer=optimizer)
    assert info["device"] == torch.device("cpu")
    jtok, jlab = (jax.device_put(a, sh["data"]) for a in (tok, lab))
    if optimizer == "adam":
        jo, to = jtf.init_opt_state(jcfg, mesh), \
            ttf.init_opt_state(tcfg, device="cpu")
    out = []
    for _ in range(steps):
        if optimizer == "sgd":
            jp, jl = jstep(jp, jtok, jlab)
            tp, tl = tstep(tp, tok, lab)
        else:
            jp, jo, jl = jstep(jp, jo, jtok, jlab)
            tp, to, tl = tstep(tp, to, tok, lab)
        out.append((float(jl), tl.item(), {k: _np(v) for k, v in jp.items()},
                    {k: v.float().numpy().copy() for k, v in tp.items()}))
    return out


def test_sgd_steps_match_jax():
    """Three SGD steps: the losses and every parameter after each step
    at f32 rtol 2e-4 / atol 2e-5 (measured: parameters within 3e-8)."""
    for jl, tl, jp, tp in _run_both("sgd"):
        np.testing.assert_allclose(tl, jl, **F32_TOL)
        for name in jp:
            np.testing.assert_allclose(tp[name], jp[name], **F32_TOL)


def test_adam_steps_match_jax():
    """Three Adam steps: the losses at rtol 2e-4.  Adam's first update is
    lr * sign(g) where |g| is tiny, so a gradient that rounds to the
    other sign in one package moves that weight 2 * lr apart; the
    parameters are held to atol 2 * lr, and at most 0.1% of their
    elements may differ by more than 1e-4 (measured: 3e-4 at most, one
    element of 78,144 above 1e-4)."""
    runs = _run_both("adam")
    np.testing.assert_allclose([r[1] for r in runs], [r[0] for r in runs],
                               rtol=2e-4)
    _, _, jp, tp = runs[-1]
    diff = np.concatenate([np.abs(tp[k] - jp[k]).ravel() for k in jp])
    assert diff.max() <= 2 * LR
    assert (diff > 1e-4).mean() <= 1e-3


def test_first_step_gradients_match_jax():
    """The loss and every parameter's gradient: the port's
    `_loss_and_grads` against `jax.value_and_grad` of the JAX loss in a
    1-device shard_map (measured: within 1e-6 of each gradient's
    largest element)."""
    jcfg, tcfg, jp, tp = _setup()
    tok, lab = _data()
    mesh = _mesh()
    specs = jtf.param_specs(jcfg)
    data = P(AXIS_DP, AXIS_SP)
    vg = jax.jit(get_shard_map()(
        jax.value_and_grad(jtf._build_loss_fn(jcfg, mesh, 1)), mesh=mesh,
        in_specs=(specs, data, data), out_specs=(P(), specs)))
    jl, jg = vg(jp, tok, lab)
    tl, tg = ttf._loss_and_grads(tcfg, 1)(tp, torch.from_numpy(tok).long(),
                                         torch.from_numpy(lab).long())
    np.testing.assert_allclose(tl.item(), float(jl), rtol=2e-5)
    assert set(tg) == set(jg)
    for name, g in tg.items():
        ref = _np(jg[name])
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-4,
                                   atol=2e-5 * np.abs(ref).max())


def test_jax_pallas_route_runs_its_backward_kernels(monkeypatch):
    """The JAX side with its Pallas kernels in interpreter mode: a spy
    sees `_flash_backward_pallas` traced (once: the layers run under
    `lax.scan`), and the SGD step still matches the port's."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    calls = []
    pallas_bwd = jfa._flash_backward_pallas

    def spy(*args):
        calls.append(args[0].shape)
        return pallas_bwd(*args)

    monkeypatch.setattr(jfa, "_flash_backward_pallas", spy)
    (jl, tl, jp, tp), = _run_both("sgd", steps=1)
    assert calls == [(B * SMALL["n_heads"], T,
                      SMALL["d_model"] // SMALL["n_heads"])]
    np.testing.assert_allclose(tl, jl, **F32_TOL)
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], **F32_TOL)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_bfloat16_loss_trajectory_matches_jax(optimizer):
    """bf16 weights carried over by their bits; both packages round to
    bf16 at the same ops but XLA and PyTorch order sums differently, and
    the port rounds P and dS to bf16 as the JAX kernels do while JAX's
    CPU route (its jnp sweeps) keeps them in f32.  Five steps agree to
    1% (measured: 2e-4 for SGD, 2.6e-3 for Adam, whose sign-like updates
    amplify the differences)."""
    runs = _run_both(optimizer, dtype="bfloat16", steps=5)
    np.testing.assert_allclose([r[1] for r in runs], [r[0] for r in runs],
                               rtol=1e-2)


def test_fused_steps_equal_single_steps_and_match_jax():
    """`make_fused_train_steps(K=3)` is three `make_train_step` calls:
    exactly equal losses and parameters on the CPU.  Its losses match
    JAX's fused steps."""
    K = 3
    jcfg, tcfg, jp, tp = _setup()
    toks, labs = _data(1, (K, B, T))
    single, _ = ttf.make_train_step(tcfg, device="cpu", lr=LR,
                                    optimizer="adam")
    fused, info = ttf.make_fused_train_steps(tcfg, K, device="cpu", lr=LR)
    assert info["k_steps"] == K and info["optimizer"] == "adam"
    tp2 = {k: v.clone() for k, v in tp.items()}
    to, to2 = ttf.init_opt_state(tcfg, "cpu"), ttf.init_opt_state(tcfg, "cpu")
    seq = []
    for i in range(K):
        tp, to, loss = single(tp, to, toks[i], labs[i])
        seq.append(loss)
    tp2, to2, losses = fused(tp2, to2, toks, labs)
    assert losses.shape == (K,)
    assert torch.equal(losses, torch.stack(seq))
    for name in tp:
        assert torch.equal(tp2[name], tp[name])
        assert torch.equal(to2["m"][name], to["m"][name])
    assert to2["t"].item() == K
    mesh = _mesh()
    jfused, sh = jtf.make_fused_train_steps(jcfg, mesh, K, lr=LR,
                                            optimizer="adam")
    _, _, jlosses = jfused(jp, jtf.init_opt_state(jcfg, mesh),
                           jax.device_put(toks, sh["data"]),
                           jax.device_put(labs, sh["data"]))
    np.testing.assert_allclose(losses.numpy(), _np(jlosses), rtol=2e-4)


def test_fused_sgd_and_argument_errors():
    _, tcfg, _, tp = _setup()
    toks, labs = _data(2, (2, B, T))
    fused, _ = ttf.make_fused_train_steps(tcfg, 2, device="cpu",
                                          optimizer="sgd")
    tp, losses = fused(tp, toks, labs)
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    for bad in (lambda: ttf.make_fused_train_steps(tcfg, 0, device="cpu"),
                lambda: ttf.make_train_step(tcfg, device="cpu",
                                            optimizer="rmsprop"),
                lambda: ttf.make_fused_train_steps(tcfg, 2, device="cpu",
                                                   optimizer="rmsprop")):
        with pytest.raises(MXNetError):
            bad()


def test_n_micro_splits_the_batch_into_equal_loss():
    """Microbatches run through the stack in turn: the loss and the
    update equal one microbatch's up to f32 summation order; an n_micro
    that does not divide the batch raises."""
    _, tcfg, _, tp = _setup()
    tok, lab = _data()
    results = []
    for n_micro in (1, 2):
        step, _ = ttf.make_train_step(tcfg, device="cpu", n_micro=n_micro,
                                      lr=LR)
        params, loss = step({k: v.clone() for k, v in tp.items()}, tok, lab)
        results.append((loss.item(), params))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-6)
    for name in tp:
        torch.testing.assert_close(results[1][1][name], results[0][1][name],
                                   rtol=1e-5, atol=1e-7)
    step, _ = ttf.make_train_step(tcfg, device="cpu", n_micro=3)
    with pytest.raises(MXNetError, match="n_micro"):
        step(tp, tok, lab)


def _grads_recording(remat, monkeypatch):
    """The loss and gradients of one step under `remat`, with the
    selective-checkpoint policy's decisions (op, saved?) in the first
    forward, and the number of attention forwards run."""
    decisions, forwards = [], []
    policy = tex._policy

    def recording(saveable):
        inner = policy(saveable)

        def rec(ctx, op, *args, **kwargs):
            out = inner(ctx, op, *args, **kwargs)
            if not ctx.is_recompute:
                decisions.append(
                    (op, out == torch.utils.checkpoint.CheckpointPolicy
                     .MUST_SAVE))
            return out
        return rec

    impl = tfa._flash_impl

    def counting(*args, **kwargs):
        forwards.append(1)
        return impl(*args, **kwargs)

    monkeypatch.setattr(tex, "_policy", recording)
    monkeypatch.setattr(tfa, "_flash_impl", counting)
    _, tcfg, _, tp = _setup(remat=remat)
    tok, lab = _data()
    loss, grads = ttf._loss_and_grads(tcfg, 1)(
        tp, torch.from_numpy(tok).long(), torch.from_numpy(lab).long())
    return loss, grads, decisions, len(forwards)


def test_remat_policies_keep_values_and_save_what_they_say(monkeypatch):
    """`none`, `dots`, `dots_no_batch` and `full` give equal losses and
    gradients.  Under `dots` the policy saves the products' outputs and
    nothing else, under `dots_no_batch` no batched product, under
    `full` nothing; under each remat policy the attention forward runs
    again in the backward (2 layers: 2 forwards, then 4)."""
    base_loss, base_grads, decisions, n_fwd = _grads_recording(
        "none", monkeypatch)
    assert decisions == [] and n_fwd == 2
    aten = torch.ops.aten
    products = {aten.mm.default, aten.bmm.default, aten.addmm.default,
                aten.mm.dtype}
    for remat in ("dots", "dots_no_batch", "full"):
        loss, grads, decisions, n_fwd = _grads_recording(remat, monkeypatch)
        assert loss.item() == base_loss.item()
        for name, g in grads.items():
            torch.testing.assert_close(g, base_grads[name], rtol=1e-6,
                                       atol=1e-7)
        assert n_fwd == 4
        saved = {op for op, keep in decisions if keep}
        assert decisions and all(
            keep == (op in tex._REMAT_POLICIES[remat])
            for op, keep in decisions)
        if remat == "dots":
            # x @ w and the attention plain version's einsums
            assert saved == {aten.mm.default, aten.bmm.default}
        elif remat == "dots_no_batch":
            assert saved == {aten.mm.default}
        else:
            assert saved == set()
        assert saved <= products
    with pytest.raises(MXNetError, match="remat"):
        tex.apply_remat(lambda x: x, "mirror")


@pytest.mark.parametrize("label_at", ["zero", "last", "outside"])
def test_xent_matches_jax_sharded_xent(label_at):
    """`_xent` against `_sharded_xent` at tp = 1 in a 1-device
    shard_map, with labels at 0, at vocab - 1, and outside the vocab
    (picks no logit), in value and in gradient."""
    rng = np.random.RandomState(8)
    V = 32
    logits = rng.normal(0, 3, (16, V)).astype(np.float32)
    labels = rng.randint(0, V, 16).astype(np.int32)
    labels[::3] = {"zero": 0, "last": V - 1, "outside": V + 2}[label_at]
    mesh = _mesh()

    def jloss(lg, lab):
        return jtf._sharded_xent(lg, lab, V)

    jx = jax.jit(get_shard_map()(jloss, mesh=mesh, in_specs=(P(), P()),
                                 out_specs=P()))
    jgrad = jax.jit(get_shard_map()(
        jax.grad(lambda lg, lab: jloss(lg, lab).sum()), mesh=mesh,
        in_specs=(P(), P()), out_specs=P()))
    lg = torch.from_numpy(logits).requires_grad_(True)
    nll = ttf._xent(lg, torch.from_numpy(labels).long())
    nll.sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(),
                               np.asarray(jx(logits, labels)), **F32_TOL)
    np.testing.assert_allclose(lg.grad.numpy(),
                               np.asarray(jgrad(logits, labels)), **F32_TOL)


def test_embedding_is_shared_by_the_forward_and_the_loss():
    """`make_forward`'s logits are the loss's: one `_embed` and one
    `_logits` for both (and an out-of-vocab token embeds as zeros in
    both)."""
    _, tcfg, _, tp = _setup()
    tok, lab = _data()
    tok[0, 5] = SMALL["vocab"] + 3
    logits = ttf.make_forward(tcfg, device="cpu")(tp, tok)
    ref = ttf._xent(logits.reshape(B * T, -1).float(),
                    torch.from_numpy(lab).long().reshape(-1)).mean()
    loss, _ = ttf._loss_and_grads(tcfg, 1)(tp, torch.from_numpy(tok).long(),
                                          torch.from_numpy(lab).long())
    assert loss.item() == pytest.approx(ref.item(), rel=1e-6)


def test_opt_state_layout():
    cfg = ttf.TransformerConfig(dtype="bfloat16", **SMALL)
    opt = ttf.init_opt_state(cfg, device="cpu")
    shapes = ttf.param_shapes(cfg)
    assert set(opt) == {"m", "v", "t"}
    for key in ("m", "v"):
        assert {k: tuple(v.shape) for k, v in opt[key].items()} == shapes
        assert all(v.dtype == torch.float32 and not v.any()
                   for v in opt[key].values())
    assert opt["t"].shape == () and opt["t"].item() == 0
    # the JAX package's state has the same names and shapes
    jopt = jtf.init_opt_state(jtf.TransformerConfig(**SMALL), _mesh())
    assert {k: v.shape for k, v in jopt["m"].items()} == shapes
    assert dataclasses.replace(cfg, remat="dots").remat == "dots"
