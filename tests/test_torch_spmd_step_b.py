"""The PyTorch port's sharded TransformerLM against the JAX package's on
a pipeline mesh: {dp 2, pp 2, tp 2} with two microbatches (SGD and
ZeRO-1 Adam), the sharded forward's logits, and the remat policies on a
mesh.  Helpers and bounds: `tests/test_torch_spmd_step.py`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mxtpu.parallel import transformer as jtf
from mxtpu_torch.parallel import spmd
from mxtpu_torch.parallel import transformer as ttf
from test_torch_spmd_step import (LR, check_adam, check_moment_memory,
                                  check_sgd, cfg_kw, data, meshes, run_both)

torch.set_num_threads(1)

AXES = dict(dp=2, pp=2, tp=2)


def test_sgd_pipeline_step_matches_jax_dp2_pp2_tp2():
    runs, _, _ = run_both(AXES, "sgd", n_micro=2, steps=2)
    check_sgd(runs)


def test_zero1_adam_pipeline_step_matches_jax_dp2_pp2_tp2():
    runs, jstate, tstate = run_both(AXES, "adam", n_micro=2)
    check_adam(runs)
    check_moment_memory(jstate, tstate,
                        ttf.TransformerConfig(**cfg_kw(pp=2)))


@pytest.mark.parametrize("axes", [dict(dp=2, pp=2, tp=2),
                                  dict(pp=2, tp=2, sp=2)])
def test_sharded_forward_matches_jax(axes):
    """`make_forward` over the mesh: the logits, gathered (f32 rtol 2e-4
    / atol 2e-4, the bound `tests/test_torch_transformer.py` holds the
    forward to)."""
    jm, tm = meshes(**axes)
    jcfg = jtf.TransformerConfig(**cfg_kw(pp=2))
    tcfg = ttf.TransformerConfig(**cfg_kw(pp=2))
    jp = jtf.init_params(jcfg, jm, seed=2)
    tp = ttf.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             tcfg, tm)
    tok, _ = data(seed=2, shape=(4, 32))
    tok[0, :3] = [-1, 32, 40]   # outside the vocabulary: embedded as zeros
    want = np.asarray(jtf.make_forward(jcfg, jm)(jp, tok))
    got = ttf.make_forward(tcfg, tm)(tp, tok)
    assert got.shape == (4, 32, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_remat_policies_keep_the_sharded_step():
    """Under every remat policy the sharded step computes the same loss
    and parameters as without one, bitwise (the policies only choose what
    the backward recomputes)."""
    _, tm = meshes(dp=2, pp=2, tp=2)
    base = ttf.TransformerConfig(**cfg_kw(pp=2))
    tok, lab = data(seed=4)
    results = []
    for remat in ("none", "dots", "dots_no_batch", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        params = ttf.init_params(cfg, tm, seed=3)
        step, _ = ttf.make_train_step(cfg, tm, n_micro=2, lr=LR)
        params, loss = step(params, tok, lab)
        results.append((loss, {n: spmd.gather(p) for n, p in
                               params.items()}))
    for loss, params in results[1:]:
        assert torch.equal(loss, results[0][0])
        for n in params:
            assert torch.equal(params[n], results[0][1][n]), n


@pytest.mark.parametrize("axes", [dict(), dict(dp=2, pp=2, tp=2)])
def test_the_step_updates_parameters_and_moments_in_place(axes):
    """On every mesh, one body: the Adam step writes the new values into
    the caller's tensors (a one-device mesh hands out plain tensors, a
    larger one Sharded values) and returns those same objects."""
    _, tm = meshes(**axes)
    cfg = ttf.TransformerConfig(**cfg_kw(pp=2))
    params = ttf.init_params(cfg, tm, seed=5)
    opt = ttf.init_opt_state(cfg, tm)

    def local(x):
        return [x] if isinstance(x, torch.Tensor) else x.shards

    held = {n: local(p) for n, p in params.items()}
    before = {n: [t.clone() for t in ts] for n, ts in held.items()}
    moments = {n: local(m) for n, m in opt["m"].items()}
    step, _ = ttf.make_train_step(cfg, tm, n_micro=2, lr=LR,
                                  optimizer="adam")
    out_p, out_o, _ = step(params, opt, *data(seed=5))
    assert out_p is params and out_o is opt
    assert float(spmd.gather(opt["t"]) if isinstance(
        opt["t"], spmd.Sharded) else opt["t"]) == 1.0
    for n, ts in held.items():
        assert all(a is b for a, b in zip(ts, local(params[n]))), n
        assert any(not torch.equal(a, b) for a, b in zip(ts, before[n])), n
        assert all(a is b for a, b in zip(moments[n], local(opt["m"][n])))


def test_only_the_last_stage_computes_the_head(monkeypatch):
    """The final norm, the unembedding and the cross-entropy run at the
    last pp stage's coordinates only, in the loss and in the forward; the
    other stages add zeros to the loss's psum."""
    _, tm = meshes(dp=2, pp=2, tp=2)
    cfg = ttf.TransformerConfig(**cfg_kw(pp=2))
    calls = []
    head = ttf._head

    def recording(params, h, members):
        calls.append(list(members))
        return head(params, h, members)

    monkeypatch.setattr(ttf, "_head", recording)
    params = ttf.init_params(cfg, tm, seed=6)
    tok, lab = data(seed=6)
    step, _ = ttf.make_train_step(cfg, tm, n_micro=2, lr=LR)
    step(params, tok, lab)
    ttf.make_forward(cfg, tm)(params, tok)
    pp_idx = spmd.axis_index(tm, "pp")
    last = [c for c in range(tm.size) if pp_idx[c] == 1]
    assert calls == [last, last]
