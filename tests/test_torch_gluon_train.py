"""The PyTorch port's gluon Trainer (`mxtpu_torch/gluon/trainer.py`) and
utilities against the JAX package's: the optimizer seeing each
Parameter's `lr_mult` and `wd_mult` (SGD with momentum, weight decay,
`rescale_grad` and clipping; Adam), within a relative L2 of 1e-5 over
three steps of a small MLP; the states' save/load round trip (bitwise);
the learning rate and the kvstore rule; `split_data`/`split_and_load`
and `clip_global_norm`.  ResNet-18 trained through gluon is
`test_torch_gluon_resnet.py`, which shares this file's helpers.
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
from test_torch_gluon import _build, _rel, _x

def _xavier(make, x, rng):
    """Xavier-uniform weights, zero biases and betas, unit gammas, zero
    moving means and unit moving variances for ``make``, drawn with
    numpy (as `test_torch_module.py` draws them); the shapes come from a
    forward of the port's block, which infers the deferred ones."""
    net = _build(tmx, make)
    net.initialize(tmx.init.Zero(), ctx=tmx.cpu())
    with tmx.autograd.pause():
        net(tmx.nd.array(x, ctx=tmx.cpu()))
    out = {}
    for k, p in net.collect_params().items():
        s = p.shape
        if k.endswith("weight"):
            lim = np.sqrt(3.0 / ((s[0] + s[1]) * float(np.prod(s[2:])) / 2))
            out[k] = rng.uniform(-lim, lim, s).astype(np.float32)
        elif k.endswith(("gamma", "running_var")):
            out[k] = np.ones(s, np.float32)
        else:
            out[k] = np.zeros(s, np.float32)
    return out


def _from(mx, make, arrays, dtype="float32"):
    """``make`` built in ``mx`` and set from ``arrays`` by name (the
    deferred Parameters take the arrays' shapes)."""
    net = _build(mx, make)
    net.initialize(mx.init.Zero(), ctx=mx.cpu())
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(arrays[k], ctx=mx.cpu()))
    if dtype != "float32":
        net.cast(dtype)
    return net


def _train(mx, net, x, y, steps, optimizer="sgd", opt=None, hybridize=True,
           dtype="float32"):
    if hybridize:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), optimizer, dict(
        opt or {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    xd, yd = (mx.nd.array(a, ctx=mx.cpu(), dtype=dtype) for a in (x, y))
    losses, params = [], []
    for _ in range(steps):
        with mx.autograd.record():
            out = loss_fn(net(xd), yd)
        out.backward()
        trainer.step(x.shape[0])
        losses.append(out.asnumpy())
        params.append({k: p.data().asnumpy()
                       for k, p in net.collect_params().items()})
    return losses, params, trainer


def _mlp(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(8, activation="relu"),
                mx.gluon.nn.Dense(3))
    return net


@pytest.mark.parametrize("optimizer,opt", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
             "rescale_grad": 2.0, "clip_gradient": 0.5}),
    ("adam", {"learning_rate": 0.01, "wd": 0.001})])
def test_lr_mult_wd_mult_and_the_optimizers_match_the_reference(optimizer,
                                                                 opt):
    x, y = _x(6, 5), (np.arange(6) % 3).astype(np.float32)
    init = _xavier(_mlp, x, np.random.RandomState(0))
    res = []
    for mx in (jmx, tmx):
        net = _from(mx, _mlp, init)
        params = net.collect_params()
        params["hybridsequential0_dense0_weight"].lr_mult = 0.5
        params["hybridsequential0_dense1_bias"].wd_mult = 0.0
        params["hybridsequential0_dense1_weight"].wd_mult = 3.0
        res.append(_train(mx, net, x, y, 3, optimizer, opt))
    (jl, jp, _), (tl, tp, _) = res
    for step in range(3):
        assert _rel(tl[step], jl[step]) <= 1e-5
        for k in jp[step]:
            assert _rel(tp[step][k], jp[step][k]) <= 1e-5, (step, k)


def test_save_and_load_states_resume_the_same_steps(tmp_path):
    x, y = _x(6, 5), (np.arange(6) % 3).astype(np.float32)

    def trainer_of(net, opt="adam"):
        return tmx.gluon.Trainer(net.collect_params(), opt,
                                 {"learning_rate": 0.01})

    def step(net, trainer):
        with tmx.autograd.record():
            out = tmx.gluon.loss.SoftmaxCELoss()(
                net(tmx.nd.array(x, ctx=tmx.cpu())),
                tmx.nd.array(y, ctx=tmx.cpu()))
        out.backward()
        trainer.step(6)

    net = _build(tmx, _mlp)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    net(tmx.nd.array(x, ctx=tmx.cpu()))
    trainer = trainer_of(net)
    step(net, trainer)
    net.save_parameters(str(tmp_path / "net.params"))
    trainer.save_states(str(tmp_path / "net.states"))
    step(net, trainer)
    step(net, trainer)
    want = {k: p.data().asnumpy() for k, p in net.collect_params().items()}

    again = _build(tmx, _mlp)
    again.load_parameters(str(tmp_path / "net.params"), ctx=tmx.cpu())
    resumed = trainer_of(again)
    resumed.load_states(str(tmp_path / "net.states"))
    assert resumed.optimizer.num_update == 1
    step(again, resumed)
    step(again, resumed)
    for k, p in again.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), want[k], err_msg=k)


def test_learning_rate_and_the_kvstore_rule():
    net = _build(tmx, _mlp)
    net.initialize(ctx=tmx.cpu())
    net(tmx.nd.ones((2, 5), ctx=tmx.cpu()))
    for kv in ("device", "local", None, "none"):
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.5}, kvstore=kv)
        trainer.allreduce_grads()
        trainer.update(2)
        assert trainer.optimizer.rescale_grad == 0.5
    assert trainer.learning_rate == 0.5
    trainer.set_learning_rate(0.25)
    assert trainer.learning_rate == 0.25
    sched = tmx.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 1.0, "lr_scheduler": tmx.lr_scheduler.FactorScheduler(
            step=1, factor=0.5)})
    with pytest.raises(MXNetError, match="lr_scheduler"):
        sched.set_learning_rate(0.1)
    for kv in ("dist_sync", "tpu"):
        with pytest.raises(MXNetError, match="not ported"):
            tmx.gluon.Trainer(net.collect_params(), "sgd",
                              kvstore=kv).step(2)
    with pytest.raises(MXNetError, match="not ported"):
        tmx.gluon.Trainer(net.collect_params(), "sgd",
                          update_on_kvstore=True)
    with pytest.raises(MXNetError, match="Optimizer instance"):
        tmx.gluon.Trainer(net.collect_params(), tmx.optimizer.SGD(),
                          {"learning_rate": 0.1})
    fresh = _build(tmx, _mlp)
    fresh.initialize(ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="not been initialized"):
        tmx.gluon.Trainer([fresh.collect_params()[
            "hybridsequential0_dense0_weight"]], "sgd").step(1)


def test_split_and_load_and_clip_global_norm_match_the_reference():
    x = _x(7, 3)
    for even, n in ((True, 1), (False, 3)):
        res = []
        for mx in (jmx, tmx):
            if n == 1:
                parts = mx.gluon.utils.split_and_load(x, [mx.cpu()])
            else:
                parts = mx.gluon.utils.split_data(
                    mx.nd.array(x, ctx=mx.cpu()), n, even_split=even)
            res.append([p.asnumpy() for p in parts])
        assert [p.shape for p in res[1]] == [p.shape for p in res[0]]
        for a, b in zip(*res):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(MXNetError, match="evenly"):
        tmx.gluon.utils.split_data(tmx.nd.array(x, ctx=tmx.cpu()), 3)
    for max_norm in (0.5, 100.0):
        res = []
        for mx in (jmx, tmx):
            arrs = [mx.nd.array(_x(3, 4, seed=s), ctx=mx.cpu())
                    for s in (1, 2)]
            total = mx.gluon.utils.clip_global_norm(arrs, max_norm)
            res.append((total, [a.asnumpy() for a in arrs]))
        assert abs(res[1][0] - res[0][0]) <= 1e-5 * res[0][0]
        for a, b in zip(res[1][1], res[0][1]):
            np.testing.assert_allclose(a, b, rtol=1e-6)
    with pytest.warns(UserWarning, match="nan or inf"):
        tmx.gluon.utils.clip_global_norm(
            [tmx.nd.array([np.inf], ctx=tmx.cpu())], 1.0)
