"""The PyTorch port's initializers (`mxtpu_torch/initializer.py`) and
metrics (`mxtpu_torch/metric.py`) against the JAX package's, on the
CPU.

* `Bilinear`, `Load` (a dict and an `nd.save` file, `arg:`/`aux:`
  keys, the default for the rest) and `Mixed` give exactly the JAX
  package's arrays; `Orthogonal` gives `scale^2 I` for `W W^T` (rows no
  more than columns) or `W^T W`; `MSRAPrelu` draws normal values of
  variance `2 / (1 + slope^2) / fan` (within 5 standard errors) whose
  distribution matches the JAX package's draws (two-sample KS, p above
  1e-4); the names of `mx.init` and `mx.initializer.init`.
* Every metric, each alias and `np`/`CustomMetric`, updated twice with
  the same arrays in both packages: the same names and, computed on
  the host in float64 as in the JAX package, the same values within
  1e-12 (Perplexity, which the port reduces on the arrays' device in
  float32 and adds in float64, within 1e-6).
"""
import numpy as np
import pytest
from scipy import stats

import mxtpu as jmx
import mxtpu_torch as tmx
import torch

torch.set_num_threads(1)


def _filled(mx, init, name, shape):
    arr = mx.nd.zeros(shape, ctx=mx.cpu())
    init(mx.init.InitDesc(name) if hasattr(mx.init, "InitDesc")
         else name, arr)
    return arr.asnumpy()


@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 1, 3, 5)])
def test_bilinear_matches_the_reference(shape):
    np.testing.assert_array_equal(
        _filled(tmx, tmx.init.Bilinear(), "up_weight", shape),
        _filled(jmx, jmx.init.Bilinear(), "up_weight", shape))


def test_load_and_mixed_match_the_reference(tmp_path):
    rng = np.random.RandomState(0)
    saved = {"arg:fc_weight": rng.randn(3, 4).astype(np.float32),
             "aux:bn_moving_var": rng.rand(3).astype(np.float32)}
    path = str(tmp_path / "init.params")
    tmx.nd.save(path, {k: tmx.nd.array(v, ctx=tmx.cpu())
                       for k, v in saved.items()})
    got = {}
    for mx in (tmx, jmx):
        for source in (path, {k: mx.nd.array(v, ctx=mx.cpu())
                              for k, v in saved.items()}):
            load = mx.init.Load(source, default_init=mx.init.One())
            got[mx, isinstance(source, str)] = [
                _filled(mx, load, n, s) for n, s in
                (("fc_weight", (3, 4)), ("bn_moving_var", (3,)),
                 ("fc2_weight", (4,)))]
        with pytest.raises(Exception):
            _filled(mx, mx.init.Load({"w": mx.nd.zeros((2,), ctx=mx.cpu())}),
                    "w", (3,))
        mixed = mx.init.Mixed([".*bias", "conv.*", ".*"],
                              [mx.init.Constant(0.5), mx.init.One(),
                               mx.init.Zero()])
        got[mx, "mixed"] = [_filled(mx, mixed, n, (2, 3)) for n in
                            ("fc_bias", "conv1_weight", "fc_weight")]
    for key in (True, False, "mixed"):
        for a, b in zip(got[tmx, key], got[jmx, key]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[tmx, True][0], saved["arg:fc_weight"])
    np.testing.assert_array_equal(got[tmx, True][2], np.ones(4))


@pytest.mark.parametrize("shape,rand_type", [((4, 6), "uniform"),
                                             ((6, 2, 2, 1), "normal")])
def test_orthogonal_is_orthogonal(shape, rand_type):
    tmx.random.seed(3)
    w = _filled(tmx, tmx.init.Orthogonal(scale=1.5, rand_type=rand_type),
                "fc_weight", shape).reshape(shape[0], -1).astype(np.float64)
    gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    np.testing.assert_allclose(gram, 2.25 * np.eye(gram.shape[0]),
                               atol=1e-5)


@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
def test_msraprelu_variance_and_distribution(factor_type):
    shape = (64, 32, 3, 3)
    fan = {"avg": (32 + 64) * 9 / 2.0, "in": 32 * 9.0,
           "out": 64 * 9.0}[factor_type]
    var = 2.0 / (1 + 0.25 ** 2) / fan
    draws = {}
    for mx in (tmx, jmx):
        mx.random.seed(1)
        draws[mx] = _filled(mx, mx.init.MSRAPrelu(factor_type=factor_type),
                            "conv_weight", shape).reshape(-1)
    x = draws[tmx].astype(np.float64)
    se = np.sqrt(((x - x.mean()) ** 4).mean() - x.var() ** 2) / \
        np.sqrt(x.size)
    assert abs(x.var() - var) < 5 * se
    assert abs(x.mean()) < 5 * np.sqrt(var / x.size)
    assert stats.ks_2samp(draws[tmx], draws[jmx]).pvalue > 1e-4


def test_init_namespaces_and_registry():
    for ref, port in ((jmx.init, tmx.init),
                      (jmx.initializer.init, tmx.initializer.init)):
        names = [n for n in dir(ref) if not n.startswith("_")]
        assert [n for n in names if not hasattr(port, n)] == []
    for name in ("msraprelu", "orthogonal", "bilinear"):
        assert type(tmx.initializer.create(name)).__name__ == \
            type(jmx.initializer.create(name)).__name__
    assert tmx.init.MSRAPrelu(slope=0.1).dumps() == \
        jmx.init.MSRAPrelu(slope=0.1).dumps()


def _metric_inputs(mx, seed):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.ones(6), 10).astype(np.float32)
    labels = rng.randint(0, 6, 10).astype(np.float32)
    bin_pred = rng.rand(10, 2).astype(np.float32)
    bin_label = rng.randint(0, 2, 10).astype(np.float32)
    reg_pred = rng.randn(10, 1).astype(np.float32)
    reg_label = rng.randn(10).astype(np.float32)
    nd = lambda a: mx.nd.array(a, ctx=mx.cpu())  # noqa: E731
    return dict(cls=([nd(labels)], [nd(probs)]),
                bin=([nd(bin_label)], [nd(bin_pred)]),
                reg=([nd(reg_label)], [nd(reg_pred)]))


def _feval(label, pred):
    return float(np.abs(label.reshape(-1) - pred.argmax(-1)).sum()), 3


METRICS = {
    "acc": ("cls", {}), "accuracy": ("cls", {}),
    "top_k_accuracy": ("cls", dict(top_k=3)), "top_k_acc": ("cls",
                                                            dict(top_k=2)),
    "f1": ("bin", {}), "f1_micro": ("bin", dict(average="micro")),
    "mcc": ("bin", {}), "mae": ("reg", {}), "mse": ("reg", {}),
    "rmse": ("reg", {}), "ce": ("cls", {}), "crossentropy": ("cls", {}),
    "nll_loss": ("cls", {}), "negativeloglikelihood": ("cls", {}),
    "pearsoncorrelation": ("reg", {}), "loss": ("reg", {}),
    "perplexity": ("cls", dict(ignore_label=2)), "Torch": ("reg", {}),
    "Caffe": ("reg", {}), "custom": ("cls", {}), "np": ("cls", {}),
    "composite": ("cls", {}),
}


def _make(mx, name, kw):
    if name == "f1_micro":
        return mx.metric.create("f1", **kw)
    if name in ("Torch", "Caffe"):
        return getattr(mx.metric, name)()
    if name == "custom":
        return mx.metric.create(_feval)
    if name == "np":
        return mx.metric.np(_feval, name="abs_err")
    if name == "composite":
        return mx.metric.create(["acc", mx.metric.TopKAccuracy(top_k=4),
                                 "ce"])
    return mx.metric.create(name, **kw)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_the_reference(name):
    kind, kw = METRICS[name]
    results = {}
    for mx in (tmx, jmx):
        m = _make(mx, name, kw)
        for seed in (0, 1):
            labels, preds = _metric_inputs(mx, seed)[kind]
            m.update(labels, preds)
        results[mx] = m.get_name_value()
        assert type(m).__name__ in dir(mx.metric) or name == "np"
    tol = 1e-6 if name == "perplexity" else 1e-12
    assert [n for n, _ in results[tmx]] == [n for n, _ in results[jmx]]
    for (_, a), (_, b) in zip(results[tmx], results[jmx]):
        assert abs(a - b) <= tol * max(1.0, abs(b)), (name, a, b)


def test_metric_surface():
    names = [n for n in dir(jmx.metric) if not n.startswith("_")
             and not n[0].isupper() or n in jmx.metric.__all__]
    assert [n for n in names if not hasattr(tmx.metric, n)] == []
    m = tmx.metric.create("acc", output_names=["out"], label_names=["lab"])
    labels, preds = _metric_inputs(tmx, 0)["cls"]
    m.update_dict({"lab": labels[0]}, {"out": preds[0], "x": preds[0]})
    ref = jmx.metric.create("acc")
    jl, jp = _metric_inputs(jmx, 0)["cls"]
    ref.update(jl, jp)
    assert m.get() == ref.get()
    assert m.get_config() == ref.get_config()
    c = tmx.metric.create(["mse", "mae"])
    assert c.get_metric(1).name == "mae"
