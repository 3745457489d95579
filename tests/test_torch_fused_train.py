"""The PyTorch port's FusedTrainLoop (`mxtpu_torch/fused_train.py`) and
the optimizers' scan steps (`mxtpu_torch/optimizer/`) against the JAX
package's (`mxtpu/fused_train.py`, `mxtpu/optimizer/optimizer.py`).

The reference's own cases (`tests/test_fused_train.py`) run in both
packages from the same numpy parameters and batches: SGD, SGD with
momentum and weight decay, Adam, a FactorScheduler advancing per step,
the stacked outputs and a switch back to the per-step path, the
rejections.  Parameters and moving stats are held at the reference's
own tolerances (2e-5; Adam 2e-4, which divides by sqrt(v) + eps with v
near zero early on).  Then resnet18_v1 at batch 2 and 64x64, K = 2,
against the reference's FusedTrainLoop: the loss trajectory and the
final parameters and moving stats, at the fp32 bounds of
`tests/test_torch_module.py` (the reference's BatchNorm statistics in
two passes, as there).  Not at 32x32: there the last stage is 1x1 and
its BatchNorms normalise two values a channel, which leaves each
package's float32 forward too far from float64 to hold the two to 1e-4.  On the CPU the port runs its step eagerly K
times; on the card the same step is a CUDA graph (`chip_smoke.py`).
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu.ops.nn as jnn
from mxtpu import sym as jsym
from mxtpu.gluon.model_zoo import vision
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
from mxtpu_torch.optimizer.optimizer import lr_groups


def _ctx(mx):
    return {"ctx": mx.cpu()} if mx is tmx else {}


def _params(seed, batch=8):
    """The numpy parameters of `_mlp`, drawn as the reference's test
    draws them (sorted by name, randn * 0.1)."""
    shapes = _mlp(jsym).infer_shape(data=(batch, 10),
                                    softmax_label=(batch,))
    names = _mlp(jsym).list_arguments()
    rng = np.random.RandomState(seed)
    shaped = {n: s for n, s in zip(names, shapes[0])
              if n not in ("data", "softmax_label")}
    return {k: rng.randn(*shaped[k]).astype(np.float32) * 0.1
            for k in sorted(shaped)}


def _mlp(sym):
    # no_bias before BatchNorm, as the reference's test (a bias feeding
    # BN has ~zero true gradient)
    x = sym.FullyConnected(data=sym.Variable("data"), num_hidden=16,
                           no_bias=True, name="fc1")
    x = sym.BatchNorm(data=x, name="bn1")
    x = sym.Activation(data=x, act_type="relu")
    x = sym.FullyConnected(data=x, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(data=x, label=sym.Variable("softmax_label"),
                             name="softmax")


def _make_module(mx, seed, optimizer="sgd", opt_params=None, batch=8):
    mod = mx.mod.Module(_mlp(mx.sym), data_names=("data",),
                        label_names=("softmax_label",), context=mx.cpu())
    mod.bind(data_shapes=[("data", (batch, 10))],
             label_shapes=[("softmax_label", (batch,))])
    _, aux = _mlp(jsym).infer_shape(data=(batch, 10),
                                    softmax_label=(batch,))[::2]
    aux_names = _mlp(jsym).list_auxiliary_states()
    aux_p = {n: (np.ones if n.endswith("var") else np.zeros)(s, np.float32)
             for n, s in zip(aux_names, aux)}
    mod.init_params(arg_params={k: mx.nd.array(v, **_ctx(mx)) for k, v in
                                _params(seed, batch).items()},
                    aux_params={k: mx.nd.array(v, **_ctx(mx)) for k, v in
                                aux_p.items()})
    if isinstance(optimizer, str):
        mod.init_optimizer(optimizer=optimizer, optimizer_params=dict(
            opt_params or {"learning_rate": 0.05}))
    else:
        mod.init_optimizer(optimizer=optimizer)
    return mod


def _batches(mx, n, batch=8, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        d = rng.randn(batch, 10).astype(np.float32)
        lab = rng.randint(0, 4, (batch,)).astype(np.float32)
        out.append(mx.io.DataBatch(data=[mx.nd.array(d, **_ctx(mx))],
                                   label=[mx.nd.array(lab, **_ctx(mx))]))
    return out


def _run_per_step(mod, batches):
    for b in batches:
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()


def _assert_params_close(tmod, jmod, tol):
    (ta, tx), (ja, jx) = tmod.get_params(), jmod.get_params()
    assert set(ta) == set(ja) and set(tx) == set(jx)
    for name in ja:
        np.testing.assert_allclose(ta[name].asnumpy(), ja[name].asnumpy(),
                                   rtol=tol, atol=tol, err_msg=name)
    for name in jx:
        np.testing.assert_allclose(tx[name].asnumpy(), jx[name].asnumpy(),
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("optimizer,opt_params,tol", [
    ("sgd", {"learning_rate": 0.05}, 2e-5),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}, 2e-5),
    ("adam", {"learning_rate": 0.01, "wd": 1e-4}, 2e-4),
])
def test_fused_matches_the_reference_loop(optimizer, opt_params, tol):
    """Two calls of K = 3 in both packages' loops: every parameter and
    every moving stat (advanced per step, not per call); and the port's
    loop against its own per-step path."""
    K = 3
    mods = {}
    for mx in (tmx, jmx):
        mod = _make_module(mx, 7, optimizer, opt_params)
        loop = mx.FusedTrainLoop(mod, steps_per_program=K)
        batches = _batches(mx, 2 * K)
        loop.run(batches[:K])
        loop.run(batches[K:])
        mods[mx] = mod
    _assert_params_close(mods[tmx], mods[jmx], tol)
    per_step = _make_module(tmx, 7, optimizer, opt_params)
    _run_per_step(per_step, _batches(tmx, 2 * K))
    (pa, px), (fa, fx) = per_step.get_params(), mods[tmx].get_params()
    for name in list(pa) + list(px):
        got = (fa if name in fa else fx)[name].asnumpy()
        want = (pa if name in pa else px)[name].asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    assert mods[tmx]._optimizer.num_update == \
        mods[jmx]._optimizer.num_update == 2 * K


def test_fused_lr_schedule_advances_per_step():
    """A FactorScheduler sees every step of a call, not one per call."""
    K = 4
    mods = {}
    for mx in (tmx, jmx):
        mod = _make_module(mx, 11, "sgd", {
            "learning_rate": 0.1,
            "lr_scheduler": mx.lr_scheduler.FactorScheduler(step=2,
                                                            factor=0.5)})
        mx.FusedTrainLoop(mod, steps_per_program=K).run(_batches(mx, K))
        mods[mx] = mod
    _assert_params_close(mods[tmx], mods[jmx], 2e-5)
    assert mods[tmx]._optimizer.num_update == \
        mods[jmx]._optimizer.num_update == K
    assert mods[tmx]._optimizer.lr_scheduler.base_lr == \
        mods[jmx]._optimizer.lr_scheduler.base_lr == 0.1 * 0.5


def test_fused_outputs_stacked_and_switchable():
    """The collected outputs are (K, ...) stacks equal to the
    reference's, and per-step training continues seamlessly after a
    call, in both packages."""
    K = 2
    mods, stacked = {}, {}
    for mx in (tmx, jmx):
        mod = _make_module(mx, 5)
        batches = _batches(mx, K + 1)
        loop = mx.FusedTrainLoop(mod, steps_per_program=K)
        stacked[mx] = loop.run(batches[:K])[0].asnumpy()
        _run_per_step(mod, batches[K:])
        mods[mx] = mod
    assert stacked[tmx].shape == stacked[jmx].shape == (K, 8, 4)
    np.testing.assert_allclose(stacked[tmx], stacked[jmx], rtol=2e-5,
                               atol=2e-5)
    _assert_params_close(mods[tmx], mods[jmx], 2e-5)


def test_fused_without_collecting_and_from_a_stack():
    """collect_outputs=False returns None; stack_batches gives (K, ...)
    tensors in the arguments' dtypes, and run_stacked checks them."""
    K = 2
    mod = _make_module(tmx, 5)
    loop = tmx.FusedTrainLoop(mod, steps_per_program=K,
                              collect_outputs=False)
    stack = loop.stack_batches(_batches(tmx, K))
    assert [tuple(s.shape) for s in stack] == [(K, 8, 10), (K, 8)]
    assert all(s.dtype == torch.float32 for s in stack)
    assert loop.run_stacked(stack) is None
    with pytest.raises(MXNetError, match="expected stacks"):
        loop.run_stacked([s[:1] for s in stack])
    with pytest.raises(MXNetError, match="expected 2 batches"):
        loop.run(_batches(tmx, 3))


def test_fused_follows_a_replaced_optimizer():
    """init_optimizer(force_init=True) between calls replaces the
    optimizer and the updater's states: the loop's next call uses the
    new ones, as the per-step path does; collect_outputs may change
    between calls."""
    K = 2
    batches = _batches(tmx, 2 * K)
    opts = ({"learning_rate": 0.05, "momentum": 0.9},
            {"learning_rate": 0.02, "momentum": 0.5, "wd": 1e-3})
    per_step, fused = _make_module(tmx, 9, "sgd", opts[0]), \
        _make_module(tmx, 9, "sgd", opts[0])
    loop = tmx.FusedTrainLoop(fused, steps_per_program=K)
    _run_per_step(per_step, batches[:K])
    assert loop.run(batches[:K])[0].shape == (K, 8, 4)
    for mod in (per_step, fused):
        mod.init_optimizer(optimizer="sgd", optimizer_params=opts[1],
                           force_init=True)
    _run_per_step(per_step, batches[K:])
    loop.collect_outputs = False
    assert loop.run(batches[K:]) is None
    assert fused._optimizer.num_update == per_step._optimizer.num_update \
        == K
    (pa, px), (fa, fx) = per_step.get_params(), fused.get_params()
    for name in list(pa) + list(px):
        got = (fa if name in fa else fx)[name].asnumpy()
        want = (pa if name in pa else px)[name].asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    for idx, state in per_step._updater.states.items():
        np.testing.assert_allclose(fused._updater.states[idx].asnumpy(),
                                   state.asnumpy(), rtol=1e-6, atol=1e-6)


class _NoScan(tmx.optimizer.Optimizer):
    def update(self, index, weight, grad, state):
        pass


def test_fused_rejects_unsupported(monkeypatch):
    mod = _make_module(tmx, 1)
    with pytest.raises(MXNetError, match="steps_per_program"):
        tmx.FusedTrainLoop(mod, steps_per_program=0)
    with pytest.raises(MXNetError, match="no scan step"):
        tmx.FusedTrainLoop(_make_module(tmx, 1, optimizer=_NoScan()))
    unbound = tmx.mod.Module(_mlp(tmx.sym), context=tmx.cpu())
    with pytest.raises(MXNetError, match="bound"):
        tmx.FusedTrainLoop(unbound)
    adding = tmx.mod.Module(_mlp(tmx.sym), context=tmx.cpu())
    adding.bind(data_shapes=[("data", (8, 10))],
                label_shapes=[("softmax_label", (8,))], grad_req="add")
    adding.init_params()
    adding.init_optimizer()
    with pytest.raises(MXNetError, match="'add'"):
        tmx.FusedTrainLoop(adding)
    monkeypatch.setenv("MXTPU_STEPS_PER_PROGRAM", "3")
    assert tmx.FusedTrainLoop(mod)._K == 3
    monkeypatch.setenv("MXTPU_MAX_BAD_STEPS", "1")
    with pytest.raises(MXNetError, match="A17"):
        tmx.FusedTrainLoop(mod, steps_per_program=2)


def test_multi_precision_on_a_low_precision_weight_raises():
    opt = tmx.optimizer.create("sgd", multi_precision=True)
    w16 = tmx.nd.zeros((2, 2), ctx=tmx.cpu(), dtype="bfloat16")
    with pytest.raises(MXNetError, match="A10c"):
        opt.create_state_multi_precision(0, w16)
    w32 = tmx.nd.zeros((2, 2), ctx=tmx.cpu())
    assert opt.create_state_multi_precision(0, w32) is None


# ---------------------------------------------------------------------------
# the optimizers: Adam, and the scan steps against fused_update_multi
# ---------------------------------------------------------------------------

_NAMES = ["fc_weight", "fc_bias", "bn_gamma"]


def _updates(mx, name, kw, fused, steps=3, seed=5):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(4, 3).astype(np.float32) for _ in _NAMES]
    gs = [[rng.randn(4, 3).astype(np.float32) for _ in _NAMES]
          for _ in range(steps)]
    opt = mx.optimizer.create(name, param_idx2name=dict(enumerate(_NAMES)),
                              **kw)
    upd = mx.optimizer.get_updater(opt)
    w = [mx.nd.array(v, **_ctx(mx)) for v in ws]
    for step in gs:
        g = [mx.nd.array(v, **_ctx(mx)) for v in step]
        if fused:
            upd.update_multi([(i, g[i], w[i]) for i in range(3)])
        else:
            for i in range(3):
                upd(i, g[i], w[i])
    assert opt.num_update == steps
    return [v.asnumpy() for v in w]


@pytest.mark.parametrize("kw", [
    dict(learning_rate=0.01, wd=1e-2, rescale_grad=0.5),
    dict(learning_rate=0.05, beta1=0.8, beta2=0.99, clip_gradient=0.3),
])
def test_adam_fused_and_per_parameter_match_the_reference(kw):
    want = _updates(jmx, "adam", kw, fused=True)
    for fused in (True, False):
        for a, b in zip(_updates(tmx, "adam", kw, fused), want):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-2,
                 rescale_grad=0.5)),
    ("sgd", dict(learning_rate=0.05, clip_gradient=0.1)),
    ("adam", dict(learning_rate=0.01, wd=1e-3, clip_gradient=0.5)),
])
def test_scan_step_with_a_rate_row_equals_fused_update_multi(name, kw):
    """The scan step reads its rates from a float32 tensor row (scaled
    by one 0-d element per group of equal rates); it must give exactly
    what fused_update_multi's per-parameter float rates give, with an lr
    multiplier splitting the groups and a scheduler moving the rate."""
    def run(scan):
        rng = np.random.RandomState(9)
        ws = [tmx.nd.array(rng.randn(4, 3).astype(np.float32),
                           ctx=tmx.cpu()) for _ in _NAMES]
        opt = tmx.optimizer.create(
            name, param_idx2name=dict(enumerate(_NAMES)),
            lr_scheduler=tmx.lr_scheduler.FactorScheduler(step=1,
                                                          factor=0.7),
            **kw)
        opt.set_lr_mult({"fc_bias": 2.0})
        upd = tmx.optimizer.get_updater(opt)
        states = [upd._state(i, w) for i, w in enumerate(ws)]
        step = opt.make_scan_step([0, 1, 2], ws)
        if scan:  # (the scheduler keeps state: one caller a run)
            rows = step.host_sched(3)
            assert lr_groups(rows) == [(0, 2), (1,)]
        for k in range(3):
            g = [torch.tensor(rng.randn(4, 3).astype(np.float32))
                 for _ in _NAMES]
            if scan:
                step.step([w._data for w in ws], step.pack_states(states),
                          g, torch.from_numpy(rows[k]), lr_groups(rows))
            else:
                upd.update_multi([(i, tmx.nd.NDArray(g[i]), ws[i])
                                  for i in range(3)])
        if scan:
            opt.commit_scan_steps([0, 1, 2], 3)
        assert opt.num_update == 3
        return [w.asnumpy() for w in ws]

    for a, b in zip(run(True), run(False)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_fused_loop_continues_the_per_step_counters(name):
    """Per-step updates, then a fused call, then per-step again: the
    same trajectory as per-step throughout (Adam's bias correction and
    the scheduler read the counts the per-step path left)."""
    params = {"learning_rate": 0.05, "momentum": 0.9} if name == "sgd" \
        else {"learning_rate": 0.01}
    params["lr_scheduler"] = tmx.lr_scheduler.FactorScheduler(step=2,
                                                              factor=0.5)
    a = _make_module(tmx, 3, name, dict(params))
    params["lr_scheduler"] = tmx.lr_scheduler.FactorScheduler(step=2,
                                                              factor=0.5)
    b = _make_module(tmx, 3, name, dict(params))
    batches = _batches(tmx, 7)
    _run_per_step(a, batches)
    _run_per_step(b, batches[:2])
    tmx.FusedTrainLoop(b, steps_per_program=3).run(batches[2:5])
    _run_per_step(b, batches[5:])
    (aa, ax), (ba, bx) = a.get_params(), b.get_params()
    for k in list(aa) + list(ax):
        got = (ba if k in ba else bx)[k].asnumpy()
        want = (aa if k in aa else ax)[k].asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# resnet18_v1 against the reference's loop
# ---------------------------------------------------------------------------

B, HW, K_RESNET = 2, 64, 2
OUT_TOL, PARAM_TOL, AUX_TOL = 1e-4, 1e-3, 1e-4


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def resnet18_json():
    with jsym.NameManager():
        net = vision.resnet18_v1(classes=10)
        net.initialize(jmx.init.Zero(), ctx=jmx.cpu())
        out, _, _ = net._trace_symbol(jmx.nd.zeros((B, 3, HW, HW),
                                                   ctx=jmx.cpu()))
        return jsym.SoftmaxOutput(data=out,
                                  label=jsym.Variable("softmax_label"),
                                  name="softmax").tojson()


def _xavier(symbol, rng):
    arg_shapes, _, aux_shapes = symbol.infer_shape(
        data0=(B, 3, HW, HW), softmax_label=(B,))
    args = {}
    for n, s in zip(symbol.list_arguments(), arg_shapes):
        if n.endswith("weight"):
            hw = float(np.prod(s[2:]))
            lim = np.sqrt(3.0 / ((s[0] * hw + s[1] * hw) / 2.0))
            args[n] = rng.uniform(-lim, lim, s).astype(np.float32)
        elif n.endswith("gamma"):
            args[n] = np.ones(s, np.float32)
        elif n not in ("data0", "softmax_label"):
            args[n] = np.zeros(s, np.float32)
    aux = {n: (np.ones if n.endswith("var") else np.zeros)(s, np.float32)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _resnet_module(mx, js, args, aux):
    mod = mx.mod.Module(mx.sym.load_json(js), data_names=("data0",),
                        label_names=("softmax_label",), context=mx.cpu())
    mod.bind(data_shapes=[("data0", (B, 3, HW, HW))],
             label_shapes=[("softmax_label", (B,))])
    mod.init_params(arg_params={k: mx.nd.array(v, **_ctx(mx))
                                for k, v in args.items()},
                    aux_params={k: mx.nd.array(v, **_ctx(mx))
                                for k, v in aux.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.01, "momentum": 0.9})
    return mod


def _state(mod):
    a, x = mod.get_params()
    return {k: v.asnumpy() for k, v in list(a.items()) + list(x.items())}


def test_resnet18_fused_matches_the_reference_loop(resnet18_json,
                                                   monkeypatch):
    """One call of K = 2 (SGD, momentum 0.9) in both packages' loops from
    the same Xavier state: both steps' outputs and cross-entropies, and
    the parameters and moving stats after it.  Then a second call of the
    port's loop against the port's per-step path over the same four
    batches, to 1e-6.  The two packages are not held together past two
    updates: at batch 2 training grows f32 rounding step by step, and
    their own per-step paths leave the fp32 bounds by the fourth step,
    while each loop equals its per-step path."""
    two_pass = jnn._single_pass_stats
    monkeypatch.setattr(jnn, "_single_pass_stats",
                        lambda jnp, x, axes, keepdims=False, force=False:
                        two_pass(jnp, x, axes, keepdims, force=False))
    rng = np.random.RandomState(0)
    args, aux = _xavier(jsym.load_json(resnet18_json), rng)
    xs = rng.rand(2 * K_RESNET, B, 3, HW, HW).astype(np.float32)
    ys = rng.randint(0, 10, (2 * K_RESNET, B)).astype(np.float32)

    def batches(mx, sl):
        return [mx.io.DataBatch([mx.nd.array(x, **_ctx(mx))],
                                [mx.nd.array(y, **_ctx(mx))])
                for x, y in zip(xs[sl], ys[sl])]

    first, second = slice(0, K_RESNET), slice(K_RESNET, 2 * K_RESNET)
    res = {}
    for mx in (tmx, jmx):
        mod = _resnet_module(mx, resnet18_json, args, aux)
        loop = mx.FusedTrainLoop(mod, steps_per_program=K_RESNET)
        res[mx] = (mod, loop, loop.run(batches(mx, first))[0].asnumpy())
    (tmod, tloop, to), (jmod, _, jo) = res[tmx], res[jmx]
    assert to.shape == jo.shape == (K_RESNET, B, 10)
    for k in range(K_RESNET):
        assert _rel(to[k], jo[k]) <= OUT_TOL, k
    lab = ys[first].astype(int)
    ce = [-np.log(o[np.arange(K_RESNET)[:, None], np.arange(B)[None, :],
                    lab]).mean(1) for o in (to, jo)]
    np.testing.assert_allclose(ce[0], ce[1], rtol=1e-4)
    ts, js = _state(tmod), _state(jmod)
    worst = max((_rel(ts[k], js[k]), k) for k in jmod.get_params()[0])
    assert worst[0] <= PARAM_TOL, worst
    for k in jmod.get_params()[1]:
        assert _rel(ts[k], js[k]) <= AUX_TOL, k

    t2 = tloop.run(batches(tmx, second))[0].asnumpy()
    per_step = _resnet_module(tmx, resnet18_json, args, aux)
    outs = []
    for b in batches(tmx, slice(0, 2 * K_RESNET)):
        per_step.forward(b, is_train=True)
        outs.append(per_step.get_outputs()[0].asnumpy())
        per_step.backward()
        per_step.update()
    np.testing.assert_allclose(np.concatenate([to, t2]), np.stack(outs),
                               rtol=1e-6, atol=1e-6)
    ts, ps = _state(tmod), _state(per_step)
    for k in ps:
        np.testing.assert_allclose(ts[k], ps[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
