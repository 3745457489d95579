"""The PyTorch port's `Monitor` (`mxtpu_torch/monitor.py`) against the
JAX package's (`mxtpu/monitor.py`): `toc()` on a bound executor (the
default statistic and one of the caller's, `pattern`, `sort`,
`monitor_all`), and the monitor through `Module.fit` (every `interval`
batches), through `BucketingModule` (installed on the buckets bound
later too) and across `Module.reshape` (the monitor follows the new
executor).  Both packages train the same net from the same weights on
the same batches; the printed statistics are held at float32's bound
(rtol 1e-4, atol 1e-5 times the largest magnitude of the reference).
"""
import logging

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _values(text):
    return np.array([float(v) for v in
                     text.replace("[", " ").replace("]", " ").split()])


def _same_records(t, j):
    assert [(n, k) for n, k, _ in t] == [(n, k) for n, k, _ in j]
    assert t, "the monitor recorded nothing"
    for (n, k, tv), (_, _, jv) in zip(t, j):
        want = _values(jv)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(_values(tv), want, rtol=RTOL,
                                   atol=ATOL * scale,
                                   err_msg="batch %d %s" % (n, k))


def _mlp(mx):
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, num_hidden=6, name="fc1")
    h = mx.sym.Activation(h, act_type="relu", name="relu1")
    h = mx.sym.BatchNorm(h, fix_gamma=False, name="bn1")
    h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _weights(symbol, data_shape, seed=0):
    arg_shapes, _, aux_shapes = symbol.infer_shape(
        data=data_shape, softmax_label=data_shape[:1])
    rng = np.random.RandomState(seed)
    args = {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(symbol.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s) if "var" in n else np.zeros(s)).astype(np.float32)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _data(n=12, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 5).astype(np.float32),
            rng.randint(0, 3, n).astype(np.float32))


def _recorder(mon):
    """Keep what ``toc_print`` would log, as ``toc`` returns it."""
    rec = []
    mon.toc_print = lambda: rec.extend(mon.toc())
    return rec


def _fit(mx, mon_kw, num_epoch=2):
    x, y = _data()
    kw = dict(ctx=mx.cpu()) if mx is tmx else {}
    it = mx.io.NDArrayIter(x, y, batch_size=4, **kw)
    symbol = _mlp(mx)
    args, aux = _weights(symbol, (4, 5))
    mod = mx.mod.Module(symbol, context=mx.cpu())
    mon = mx.monitor.Monitor(**mon_kw)
    rec = _recorder(mon)
    mod.fit(it, num_epoch=num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            arg_params={k: mx.nd.array(v, **kw) for k, v in args.items()},
            aux_params={k: mx.nd.array(v, **kw) for k, v in aux.items()},
            monitor=mon)
    return rec, mon


FIT_CASES = [
    dict(interval=1),
    dict(interval=2, pattern="soft.*", sort=True),
    dict(interval=3, sort=True, monitor_all=True),
    dict(interval=2, pattern=".*(weight|moving).*", monitor_all=True),
    dict(interval=1, stat_func=lambda x: x.max(axis=0), pattern="softmax.*"),
]


@pytest.mark.parametrize("mon_kw", FIT_CASES)
def test_monitor_through_module_fit_matches_the_reference(mon_kw):
    t, t_mon = _fit(tmx, mon_kw)
    j, _ = _fit(jmx, mon_kw)
    _same_records(t, j)
    batches = sorted({n for n, _, _ in t})
    # 2 epochs of 3 batches: the monitor arms at every interval-th tic
    assert batches == [s + 1 for s in range(6) if s % mon_kw["interval"]
                       == 0]
    assert len(t_mon.exes) == 1


def test_toc_print_logs_each_record(caplog):
    with tmx.cpu():
        symbol = _mlp(tmx)
        ex = symbol.simple_bind(tmx.cpu(), data=(4, 5),
                                softmax_label=(4,))
    mon = tmx.monitor.Monitor(1, pattern="softmax.*")
    mon.install(ex)
    mon.tic()
    ex.forward(is_train=False)
    with caplog.at_level(logging.INFO):
        mon.toc_print()
    assert [r.getMessage().split()[1:3] for r in caplog.records] == \
        [["1", "softmax_output"]]
    assert mon.toc() == []  # not armed


@pytest.mark.parametrize("monitor_all,sort", [(False, False), (True, True)])
def test_toc_on_an_executor_matches_the_reference(monitor_all, sort):
    got = []
    for mx in (tmx, jmx):
        symbol = _mlp(mx)
        args, aux = _weights(symbol, (4, 5), seed=3)
        x, y = _data(4, seed=4)
        ex = symbol.simple_bind(mx.cpu(), data=(4, 5), softmax_label=(4,))
        for name, arr in ex.arg_dict.items():
            arr[:] = {"data": x, "softmax_label": y}.get(name,
                                                          args.get(name))
        for name, arr in ex.aux_dict.items():
            arr[:] = aux[name]
        mon = mx.monitor.Monitor(1, monitor_all=monitor_all, sort=sort)
        mon.install(ex)
        mon.tic()
        ex.forward(is_train=True)
        got.append(mon.toc())
    _same_records(*got)
    names = [k for _, k, _ in got[0]]
    assert names == (sorted(names) if sort else names)
    assert ("bn1_moving_var" in names) == monitor_all


def _bucket_sym_gen(mx):
    def sym_gen(length):
        data = mx.sym.Variable("data")
        h = mx.sym.sum(data, axis=1)
        h = mx.sym.FullyConnected(h, num_hidden=3, name="fc")
        return (mx.sym.SoftmaxOutput(h, name="softmax"), ("data",),
                ("softmax_label",))
    return sym_gen


def _bucket_batches(mx, kw):
    rng = np.random.RandomState(5)
    out = []
    for length in (4, 2, 4, 3, 2, 4):
        x = rng.randn(2, length, 5).astype(np.float32)
        y = rng.randint(0, 3, 2).astype(np.float32)
        out.append(mx.io.DataBatch(
            data=[mx.nd.array(x, **kw)], label=[mx.nd.array(y, **kw)],
            bucket_key=length,
            provide_data=[mx.io.DataDesc("data", x.shape)],
            provide_label=[mx.io.DataDesc("softmax_label", y.shape)]))
    return out


def test_monitor_through_bucketing_module_matches_the_reference():
    got, mons = [], []
    for mx in (tmx, jmx):
        kw = dict(ctx=mx.cpu()) if mx is tmx else {}
        mod = mx.mod.BucketingModule(_bucket_sym_gen(mx),
                                     default_bucket_key=4,
                                     context=mx.cpu())
        mod.bind(data_shapes=[("data", (2, 4, 5))],
                 label_shapes=[("softmax_label", (2,))])
        rng = np.random.RandomState(6)
        mod.init_params(arg_params={
            "fc_weight": mx.nd.array(rng.randn(3, 5).astype(np.float32) * .3,
                                     **kw),
            "fc_bias": mx.nd.array(np.zeros(3, np.float32), **kw)})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        mon = mx.monitor.Monitor(1, pattern=".*", monitor_all=True,
                                 sort=True)
        mod.install_monitor(mon)
        rec = []
        for batch in _bucket_batches(mx, kw):
            mon.tic()
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            rec.extend(mon.toc())
        got.append(rec)
        mons.append(mon)
    _same_records(*got)
    # one executor a bucket, each installed once
    assert len(mons[0].exes) == 3 == len(mons[1].exes)


def test_the_monitor_follows_module_reshape():
    got = []
    for mx in (tmx, jmx):
        kw = dict(ctx=mx.cpu()) if mx is tmx else {}
        symbol = _mlp(mx)
        args, aux = _weights(symbol, (4, 5), seed=7)
        mod = mx.mod.Module(symbol, context=mx.cpu())
        mod.bind(data_shapes=[("data", (4, 5))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(arg_params={k: mx.nd.array(v, **kw)
                                    for k, v in args.items()},
                        aux_params={k: mx.nd.array(v, **kw)
                                    for k, v in aux.items()})
        mon = mx.monitor.Monitor(1, pattern="softmax.*")
        mod.install_monitor(mon)
        first = mon.exes[0]
        x, y = _data(2, seed=8)
        mod.reshape(data_shapes=[("data", (2, 5))],
                    label_shapes=[("softmax_label", (2,))])
        assert first not in mon.exes and len(mon.exes) == 1
        mon.tic()
        mod.forward(mx.io.DataBatch([mx.nd.array(x, **kw)],
                                    [mx.nd.array(y, **kw)]), is_train=False)
        rec = mon.toc()
        assert mon.exes[0].outputs[0].shape == (2, 3)
        got.append(rec)
    _same_records(*got)
