"""The PyTorch port's legacy and utility names against the JAX
package's: `model.FeedForward` (fit, predict, score, save and load),
`log.get_logger`, `util.makedirs`, `libinfo`, `gluon.utils.check_sha1`,
`download` and `autograd.get_symbol` raising as there, `group2ctx` on
`bind`/`simple_bind` and Module's `group2ctxs` (one device accepted,
several refused), and `BucketingModule.save_checkpoint` with
`save_optimizer_states=True`, which writes what the JAX package writes
and raises nothing.

Tolerance: float32's (rtol 1e-4, atol 1e-5 times the largest magnitude
of the reference).
"""
import hashlib
import logging
import os

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, what=""):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=what)


def _lenet(mx):
    data = mx.sym.Variable("data")
    c = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, name="conv1")
    c = mx.sym.Activation(c, act_type="tanh", name="tanh1")
    c = mx.sym.Pooling(c, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="pool1")
    f = mx.sym.FullyConnected(mx.sym.Flatten(c), num_hidden=10, name="fc1")
    return mx.sym.SoftmaxOutput(f, name="softmax")


def _mnist_like(n=24, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 1, 10, 10).astype(np.float32),
            rng.randint(0, 10, n).astype(np.float32))


def _init(symbol, seed=1):
    shapes, _, _ = symbol.infer_shape(data=(8, 1, 10, 10),
                                      softmax_label=(8,))
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.2).astype(np.float32)
            for n, s in zip(symbol.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


@pytest.mark.parametrize("num_epoch", [1, 2])
def test_feedforward_fit_predict_score_match_the_reference(num_epoch):
    x, y = _mnist_like()
    got = []
    for mx in (tmx, jmx):
        kw = dict(ctx=mx.cpu()) if mx is tmx else {}
        symbol = _lenet(mx)
        args = {n: mx.nd.array(v, **kw) for n, v in _init(symbol).items()}
        ff = mx.model.FeedForward(symbol, ctx=mx.cpu(), num_epoch=num_epoch,
                                  optimizer="sgd", arg_params=args,
                                  aux_params={})
        train = mx.io.NDArrayIter(x, y, batch_size=8, **kw)
        ff.fit(train, optimizer_params={"learning_rate": 0.5})
        test = mx.io.NDArrayIter(x[:20], y[:20], batch_size=8, **kw)
        pred = ff.predict(test)
        score = ff.score(test, eval_metric="acc")
        assert pred.shape == (20, 10)
        got.append((pred, score, {n: v.asnumpy()
                                  for n, v in ff.arg_params.items()}))
    (tp, ts, ta), (jp, js, ja) = got
    _close(tp, jp, "predict")
    assert ts == pytest.approx(js)
    for n in ja:
        _close(ta[n], ja[n], n)


def test_feedforward_predict_equals_the_modules():
    x, y = _mnist_like(16, seed=2)
    symbol = _lenet(tmx)
    init = _init(symbol, seed=3)
    ff = tmx.model.FeedForward(
        symbol, ctx=tmx.cpu(), num_epoch=1,
        arg_params={n: tmx.nd.array(v, ctx=tmx.cpu())
                    for n, v in init.items()}, aux_params={})
    ff.fit(tmx.io.NDArrayIter(x, y, batch_size=8, ctx=tmx.cpu()))
    mod = tmx.mod.Module(symbol, context=tmx.cpu())
    it = tmx.io.NDArrayIter(x, y, batch_size=8, ctx=tmx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=False)
    mod.set_params(ff.arg_params, ff.aux_params)
    np.testing.assert_array_equal(ff.predict(it), mod.predict(it).asnumpy())
    with pytest.raises(MXNetError, match="fit"):
        tmx.model.FeedForward(symbol).predict(it)


def test_feedforward_save_and_load(tmp_path):
    x, y = _mnist_like(8)
    symbol = _lenet(tmx)
    ff = tmx.model.FeedForward(
        symbol, ctx=tmx.cpu(), num_epoch=1,
        arg_params={n: tmx.nd.array(v, ctx=tmx.cpu())
                    for n, v in _init(symbol).items()}, aux_params={})
    ff.fit(tmx.io.NDArrayIter(x, y, batch_size=8, ctx=tmx.cpu()))
    prefix = str(tmp_path / "ff")
    ff.save(prefix)
    back = tmx.model.FeedForward.load(prefix, 1, ctx=tmx.cpu())
    assert back.begin_epoch == 1 and back.ctx == [tmx.cpu()]
    for n, v in ff.arg_params.items():
        np.testing.assert_array_equal(back.arg_params[n].asnumpy(),
                                      v.asnumpy())
    # the JAX package reads the same files
    _, j_args, _ = jmx.model.load_checkpoint(prefix, 1)
    for n, v in ff.arg_params.items():
        np.testing.assert_array_equal(j_args[n].asnumpy(), v.asnumpy())


def test_get_logger_matches_the_reference(tmp_path):
    for mx, name in ((tmx, "port_legacy_log"), (jmx, "ref_legacy_log")):
        path = str(tmp_path / (name + ".log"))
        logger = mx.log.get_logger(name, filename=path, level=logging.INFO)
        assert logger.level == logging.INFO
        # a second call leaves the level the user set
        logger.setLevel(logging.DEBUG)
        assert mx.log.get_logger(name).level == logging.DEBUG
        logger.info("hello %d", 7)
        for h in logger.handlers:
            h.flush()
        line = open(path).read().strip()
        assert line.startswith("[I ") and line.endswith(
            "%s] hello 7" % name)
        assert mx.log.get_logger() is logging.getLogger()
        with pytest.warns(DeprecationWarning):
            mx.log.getLogger(name)
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()


def test_makedirs(tmp_path):
    for mx in (tmx, jmx):
        d = tmp_path / mx.__name__ / "a" / "b"
        mx.util.makedirs(str(d))
        mx.util.makedirs(str(d))
        assert d.is_dir()


def test_libinfo_reports_the_ports_capabilities():
    feats = tmx.libinfo.features()
    ref = jmx.libinfo.features()
    shared = ("NATIVE_ENGINE", "BF16", "INT8_QUANTIZATION", "DIST_KVSTORE",
              "C_PREDICT_ABI", "C_API")
    assert set(shared) <= set(ref)
    assert set(feats) == set(shared) | {"CUDA", "CUDA_KERNELS"}
    assert feats["CUDA"] is torch.cuda.is_available()
    assert not feats["C_PREDICT_ABI"] and not feats["C_API"]
    assert feats["BF16"] and feats["INT8_QUANTIZATION"] \
        and feats["DIST_KVSTORE"]
    assert feats["NATIVE_ENGINE"]
    tmx.engine.get_lib()
    libs = tmx.libinfo.find_lib_path()
    assert str(tmx.engine.library_path()) in libs
    assert all(os.path.dirname(p).endswith(os.path.join("mxtpu_torch",
                                                        "_build"))
               for p in libs)
    assert tmx.libinfo.__version__ == jmx.libinfo.__version__


def test_check_sha1_matches_the_reference(tmp_path):
    path = tmp_path / "blob.bin"
    data = np.random.RandomState(0).bytes(3 << 20)
    path.write_bytes(data)
    digest = hashlib.sha1(data).hexdigest()
    for mx in (tmx, jmx):
        assert mx.gluon.utils.check_sha1(str(path), digest)
        assert not mx.gluon.utils.check_sha1(str(path), "0" * 40)


def test_download_and_get_symbol_raise_as_the_reference(tmp_path):
    local = tmp_path / "model.params"
    local.write_bytes(b"x")
    for mx, err in ((tmx, MXNetError), (jmx, jmx.MXNetError)):
        with pytest.raises(err, match="no network"):
            mx.gluon.utils.download(local.as_uri(), path=str(tmp_path))
        with pytest.raises(err, match="hybridize"):
            mx.autograd.get_symbol(None)


def _fc(mx):
    data = mx.sym.Variable("data")
    with mx.AttrScope(ctx_group="dev1"):
        f = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    return f


@pytest.mark.parametrize("how", ["bind", "simple_bind"])
def test_group2ctx_takes_one_device_and_refuses_several(how):
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    outs = []
    for mx, several in ((tmx, NotImplementedError),
                        (jmx, NotImplementedError)):
        kw = dict(ctx=mx.cpu()) if mx is tmx else {}
        sym = _fc(mx)
        args = {"data": mx.nd.array(x, **kw),
                "fc_weight": mx.nd.ones((3, 4), **kw),
                "fc_bias": mx.nd.zeros((3,), **kw)}

        def make(g2c):
            if how == "bind":
                return sym.bind(mx.cpu(), args, group2ctx=g2c)
            ex = sym.simple_bind(mx.cpu(), grad_req="null", group2ctx=g2c,
                                 data=x.shape)
            for n, v in args.items():
                ex.arg_dict[n][:] = v
            return ex

        ex = make({"dev1": mx.cpu()})
        outs.append(ex.forward()[0].asnumpy())
        with pytest.raises(several):
            make({"dev1": mx.cpu(), "dev2": mx.gpu(0)})
    _close(*outs)


def test_module_group2ctxs():
    sym = _fc(tmx)
    tmx.mod.Module(sym, label_names=None, context=tmx.cpu(),
                   group2ctxs={"dev1": tmx.cpu()})
    tmx.mod.Module(sym, label_names=None, context=tmx.cpu(),
                   group2ctxs=[{"dev1": tmx.cpu()}])
    with pytest.raises(NotImplementedError):
        tmx.mod.Module(sym, label_names=None, context=tmx.cpu(),
                       group2ctxs={"dev1": tmx.gpu(1)})


def _bucketing(mx, kw):
    def sym_gen(length):
        data = mx.sym.Variable("data")
        h = mx.sym.FullyConnected(mx.sym.sum(data, axis=1), num_hidden=3,
                                  name="fc")
        return (mx.sym.SoftmaxOutput(h, name="softmax"), ("data",),
                ("softmax_label",))

    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=4,
                                 context=mx.cpu())
    mod.bind(data_shapes=[("data", (2, 4, 5))],
             label_shapes=[("softmax_label", (2,))])
    rng = np.random.RandomState(0)
    mod.init_params(arg_params={
        "fc_weight": mx.nd.array(rng.randn(3, 5).astype(np.float32), **kw),
        "fc_bias": mx.nd.array(rng.randn(3).astype(np.float32), **kw)})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    x = rng.randn(2, 3, 5).astype(np.float32)
    mod.forward(mx.io.DataBatch(
        [mx.nd.array(x, **kw)], [mx.nd.array([0.0, 2.0], **kw)],
        bucket_key=3, provide_data=[mx.io.DataDesc("data", x.shape)],
        provide_label=[mx.io.DataDesc("softmax_label", (2,))]),
        is_train=True)
    mod.backward()
    mod.update()
    return mod


def test_bucketing_save_checkpoint_with_optimizer_states(tmp_path):
    files = {}
    for mx in (tmx, jmx):
        kw = dict(ctx=mx.cpu()) if mx is tmx else {}
        prefix = str(tmp_path / mx.__name__ / "bucket")
        os.makedirs(os.path.dirname(prefix))
        _bucketing(mx, kw).save_checkpoint(prefix, 3,
                                           save_optimizer_states=True)
        files[mx] = sorted(f for f in os.listdir(os.path.dirname(prefix))
                           if not f.endswith(".json.manifest")
                           and "manifest" not in f)
        assert "bucket-0003.params" in files[mx]
        assert "bucket-symbol.json" in files[mx]
        assert not any(f.endswith(".states") for f in files[mx])
    assert files[tmx] == files[jmx]
    t_sym, t_args, _ = tmx.model.load_checkpoint(
        str(tmp_path / "mxtpu_torch" / "bucket"), 3, ctx=tmx.cpu())
    j_sym, j_args, _ = jmx.model.load_checkpoint(
        str(tmp_path / "mxtpu" / "bucket"), 3)
    assert t_sym.list_arguments() == j_sym.list_arguments()
    for n in j_args:
        _close(t_args[n].asnumpy(), j_args[n].asnumpy(), n)
