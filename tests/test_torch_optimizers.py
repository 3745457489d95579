"""The PyTorch port's sixteen optimizers (`mxtpu_torch/optimizer/`)
against the JAX package's, on the CPU.

* Every optimizer but SGLD runs three steps on the same three
  parameters (one with `lr_mult`, one with `wd_mult`, a bias that takes
  no weight decay) from the same numpy weights and gradients, with
  non-default `wd`, `clip_gradient`, `rescale_grad` and a
  `FactorScheduler`, one parameter at a time (the Updater's
  `__call__`) and through `update_multi`.  Every weight and every state
  must agree within `TOL` (relative L2): float32 arithmetic in other
  orders, at most 7e-7 apart, but for the JAX package's whole-tree Adam,
  whose second moments lie 1.3e-5 from its own per-parameter path's
  (the port's lie within 5e-8 of that path on both of its paths).
* `multi_precision` on bfloat16 and float16 weights (SGD, NAG, Adam,
  RMSProp; SGD's whole-tree path and a tree that mixes precisions):
  the float32 masters within `TOL`, the low-precision weights within
  one unit in their last place of the JAX package's, and equal to the
  port's own masters rounded.
* `get_states(dump_optimizer=True)`/`set_states`: two steps, a round
  trip into a fresh optimizer, a third step, bitwise equal to three
  uninterrupted steps (Nadam's `m_schedule` included).
* SGLD by distribution: its noise (the weight less the deterministic
  step) is normal of variance `lr` in both packages.
* The class flags `zero1_compatible` and `single_apply_update` are the
  JAX package's.
"""
import pickle

import numpy as np
import pytest
from scipy import stats

import mxtpu as jmx
import mxtpu_torch as tmx
from test_torch_op_cases import moment_errors
import torch

torch.set_num_threads(1)

TOL = 5e-5
SHAPES = [(4, 3), (5,), (2, 3, 2)]
IDX2NAME = {0: "fc_weight", 1: "fc_bias", 2: "conv_weight"}
NAMES = sorted(n for n in jmx.optimizer.Optimizer.opt_registry
               if n != "sgld")
# settings beyond the common ones, where the default leaves a path unrun
EXTRA = {"sgd": dict(momentum=0.9), "nag": dict(momentum=0.9),
         "signum": dict(momentum=0.9, wd_lh=0.01),
         "rmsprop": dict(centered=True, clip_weights=2.0),
         "dcasgd": dict(momentum=0.9), "lbsgd": dict(momentum=0.9),
         "ftrl": dict(lamda1=0.001)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _data(seed=0, steps=3):
    rng = np.random.RandomState(seed)
    w = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    g = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
         for _ in range(steps)]
    return w, g


def _optimizer(mx, name, **kw):
    opt = mx.optimizer.create(
        name, param_idx2name=IDX2NAME, learning_rate=0.05, wd=0.01,
        clip_gradient=0.8, rescale_grad=0.7,
        lr_scheduler=mx.lr_scheduler.FactorScheduler(step=2, factor=0.5),
        **dict(EXTRA.get(name, {}), **kw))
    opt.set_lr_mult({"conv_weight": 0.5})
    opt.set_wd_mult({"conv_weight": 2.0})
    return opt


def _flat_states(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat_states(s)]
    return [state.asnumpy().astype(np.float32)]


def _steps(mx, name, mode, w, g, dtype=None, updater=None, **kw):
    """The weights and each parameter's states after ``len(g)`` steps."""
    u = updater or mx.optimizer.get_updater(_optimizer(mx, name, **kw))
    dts = dtype if isinstance(dtype, list) else [dtype or "float32"] * 3
    ws = [mx.nd.array(x, ctx=mx.cpu(), dtype=d) for x, d in zip(w, dts)]
    for grads in g:
        gs = [mx.nd.array(x, ctx=mx.cpu(), dtype=d)
              for x, d in zip(grads, dts)]
        if mode == "multi":
            u.update_multi([(i, gs[i], ws[i]) for i in range(len(ws))])
        else:
            for i in range(len(ws)):
                u(i, gs[i], ws[i])
    return ([a.asnumpy().astype(np.float32) for a in ws],
            {i: _flat_states(s) for i, s in u.states.items()}, u)


@pytest.mark.parametrize("mode", ["one", "multi"])
@pytest.mark.parametrize("name", NAMES)
def test_three_steps_match_the_reference(name, mode):
    w, g = _data()
    tw, ts, _ = _steps(tmx, name, mode, w, g)
    jw, js, _ = _steps(jmx, name, mode, w, g)
    for i, (a, b) in enumerate(zip(tw, jw)):
        assert _rel(a, b) <= TOL, (name, i, _rel(a, b))
        assert not np.array_equal(a, w[i]) or name == "ftrl", (name, i)
    assert sorted(ts) == sorted(js)
    for i in js:
        assert len(ts[i]) == len(js[i]), (name, i)
        for a, b in zip(ts[i], js[i]):
            assert _rel(a, b) <= TOL, (name, i, _rel(a, b))


def _ulp_bound(dtype):
    # the gap between neighbours, relative to the value
    return {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}[dtype]


@pytest.mark.parametrize("mode", ["one", "multi"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", ["sgd", "nag", "adam", "rmsprop"])
def test_multi_precision_matches_the_reference(name, dtype, mode):
    w, g = _data(seed=1)
    tw, ts, tu = _steps(tmx, name, mode, w, g, dtype=dtype,
                        multi_precision=True)
    jw, js, _ = _steps(jmx, name, mode, w, g, dtype=dtype,
                       multi_precision=True)
    for i in js:
        # (float32 master, the master's state...)
        assert len(ts[i]) == len(js[i]) >= 1, (name, i)
        for a, b in zip(ts[i], js[i]):
            assert _rel(a, b) <= TOL, (name, i, _rel(a, b))
        master = tu.states[i][0]
        assert master.dtype == np.float32
        np.testing.assert_array_equal(
            tw[i], master.astype(dtype).asnumpy().astype(np.float32))
    for i, (a, b) in enumerate(zip(tw, jw)):
        assert np.all(np.abs(a - b) <= _ulp_bound(dtype) * np.abs(b)), \
            (name, i, np.abs(a - b).max())


def test_sgd_on_a_tree_of_mixed_precisions_matches_the_reference():
    """The whole-tree path declines the tree; each parameter takes its
    own path (the float32 one without a master)."""
    w, g = _data(seed=2)
    dts = ["bfloat16", "float32", "float16"]
    tw, ts, _ = _steps(tmx, "sgd", "multi", w, g, dtype=dts,
                       multi_precision=True)
    jw, js, _ = _steps(jmx, "sgd", "multi", w, g, dtype=dts,
                       multi_precision=True)
    assert [len(ts[i]) for i in range(3)] == [2, 1, 2]
    for i in js:
        for a, b in zip(ts[i], js[i]):
            assert _rel(a, b) <= TOL
    for i, (a, b, d) in enumerate(zip(tw, jw, dts)):
        bound = _ulp_bound(d) if d != "float32" else TOL
        assert np.all(np.abs(a - b) <= bound * np.abs(b) + 1e-30), i


@pytest.mark.parametrize("name", NAMES)
def test_states_round_trip_resumes_bitwise(name):
    w, g = _data(seed=3)
    whole, whole_states, _ = _steps(tmx, name, "multi", w, g)
    first, _, u = _steps(tmx, name, "multi", w, g[:2])
    blob = u.get_states(dump_optimizer=True)
    host, opt_state = pickle.loads(blob)
    if name == "nadam":
        assert opt_state["m_schedule"] == u.optimizer.m_schedule != 1.0
    fresh = tmx.optimizer.get_updater(_optimizer(tmx, name))
    fresh.set_states(blob, ctx=tmx.cpu())
    assert fresh.optimizer._index_update_count == \
        u.optimizer._index_update_count
    rest, rest_states, _ = _steps(tmx, name, "multi", first, g[2:],
                                  updater=fresh)
    for a, b in zip(rest, whole):
        np.testing.assert_array_equal(a, b)
    for i in whole_states:
        for a, b in zip(rest_states[i], whole_states[i]):
            np.testing.assert_array_equal(a, b)


def test_sgld_noise_is_normal_of_variance_lr_in_both_packages():
    lr, n = 0.04, 40000
    w = np.random.RandomState(4).randn(n).astype(np.float32)
    g = np.random.RandomState(5).randn(n).astype(np.float32)
    noise = {}
    for mx in (jmx, tmx):
        mx.random.seed(7)
        opt = mx.optimizer.create("sgld", learning_rate=lr, wd=0.1,
                                  rescale_grad=0.5, clip_gradient=0.6)
        arr = mx.nd.array(w, ctx=mx.cpu())
        mx.optimizer.get_updater(opt)(0, mx.nd.array(g, ctx=mx.cpu()), arr)
        step = w - lr / 2 * (np.clip(0.5 * g, -0.6, 0.6) + 0.1 * w)
        noise[mx] = arr.asnumpy().astype(np.float64) - step
        err_mean, err_var = moment_errors(noise[mx], 0.0, np.sqrt(lr))
        assert err_mean < 5 and err_var < 5, (mx.__name__, err_mean,
                                              err_var)
    assert stats.ks_2samp(noise[jmx], noise[tmx]).pvalue > 1e-3


def test_registry_and_flags_match_the_reference():
    jreg = jmx.optimizer.Optimizer.opt_registry
    treg = tmx.optimizer.Optimizer.opt_registry
    assert sorted(jreg) == sorted(treg) and len(treg) == 16
    for name in jreg:
        for flag in ("zero1_compatible", "single_apply_update"):
            assert getattr(treg[name], flag) == getattr(jreg[name], flag), \
                (name, flag)
        assert treg[name].__name__ == jreg[name].__name__
