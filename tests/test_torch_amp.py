"""The PyTorch port's AMP policy (`mxtpu_torch/amp.py`, applied per node
by `mxtpu_torch/executor.py`) against the JAX package's (`mxtpu/amp.py`,
`mxtpu/executor.py`).

`cast_op_inputs` must cast exactly as the reference's for every listed
op.  Training under `amp.scope("bfloat16")` is held to the reference's
bf16 training, which runs in a child process whose XLA rounds every
result to the dtype its op names (by default XLA keeps fused chains of
bf16 elementwise ops in float32).  Both then round at the same nodes:

* two convolutions deep, the first step's outputs agree to a hundredth
  of the reference's distance from the float32 run (they read about
  2e-5 of it; a port that skips a cast or rounds at another node reads
  about 1);
* deeper, a rounding that flips on a float32-level difference
  (BatchNorm's statistics, the order of a sum) spreads from layer to
  layer: ResNet-18's first outputs lie 0.7 of that distance apart.
  There, and on every later step and the updates, the port's bf16 must
  lie within twice the reference's distance from float32 (two runs
  whose roundings are independent lie about sqrt(2) times it apart)
  and at least half as far from float32 as the reference's (a run in
  float32 reads 0).  A fixed number could not serve: at batch 4 bf16
  moves ResNet-18's updates about 0.5 from the float32 updates in both
  packages (BatchNorm's backward cancels most of each gradient; each
  test records its distances as `bf16_distances`).

The float32 run is the port's, which `tests/test_torch_module.py` holds
to the reference's within 1e-4.  Parameters, their gradients and the
optimizer's states stay float32.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxtpu as jmx
from mxtpu import amp as jamp
from mxtpu import sym as jsym
from mxtpu.gluon.model_zoo import vision
import mxtpu_torch as tmx
from mxtpu_torch import amp as tamp

torch.set_num_threads(1)

B, HW = 4, 64


def _ctx(mx):
    return {"ctx": mx.cpu()} if mx is tmx else {}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_op_lists_match_the_reference():
    assert tamp.LOWP_OPS == jamp.LOWP_OPS
    assert tamp.FP32_OPS == jamp.FP32_OPS
    assert tamp._LOWP_SKIP_INPUTS == jamp._LOWP_SKIP_INPUTS


@pytest.mark.parametrize("op", sorted(jamp.LOWP_OPS | jamp.FP32_OPS) +
                         ["BatchNorm", "Activation", "elemwise_add"])
def test_cast_op_inputs_matches_the_reference(op):
    vals = [np.array([1.5, 300.25], np.float32),
            np.array([2.0, -1.0], np.float32),
            np.array([3, 4], np.int32)]
    jin = [jnp.asarray(vals[0]), jnp.asarray(vals[1]).astype(jnp.bfloat16),
           jnp.asarray(vals[2])]
    tin = [torch.tensor(vals[0]), torch.tensor(vals[1]).bfloat16(),
           torch.tensor(vals[2])]
    jout = jamp.cast_op_inputs(op, jin, "bfloat16")
    tout = tamp.cast_op_inputs(op, tin, "bfloat16")
    assert [str(t.dtype).replace("torch.", "") for t in tout] == \
        [str(j.dtype) for j in jout]
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))


def test_scope_nests_and_an_executor_keeps_its_policy():
    assert tamp.get_compute_dtype() is None
    with tamp.scope("bfloat16"):
        with tamp.scope(None):
            assert tamp.get_compute_dtype() is None
        assert tamp.get_compute_dtype() == "bfloat16"
        ex = _convnet(tmx.sym).simple_bind(ctx=tmx.cpu(), grad_req="write",
                                           data=(8, 3, 8, 8),
                                           softmax_label=(8,))
    assert tamp.get_compute_dtype() is None
    assert ex._amp_dtype == "bfloat16"
    out = ex.forward(is_train=True)[0]
    ex.backward()
    assert out.dtype == np.float32  # SoftmaxOutput runs in float32
    for name, arr in ex.arg_dict.items():
        assert arr._data.dtype == torch.float32, name
        grad = ex.grad_dict[name]
        assert grad is None or grad._data.dtype == torch.float32, name


def _convnet(sym):
    x = sym.Convolution(sym.Variable("data"), kernel=(3, 3), num_filter=8,
                        pad=(1, 1), name="c1")
    x = sym.BatchNorm(x, fix_gamma=False, name="bn1")
    x = sym.Activation(x, act_type="relu")
    x = sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    x = sym.Convolution(x, kernel=(3, 3), num_filter=8, pad=(1, 1),
                        name="c2")
    x = sym.Activation(x, act_type="relu")
    x = sym.Pooling(x, global_pool=True, kernel=(1, 1), pool_type="avg")
    x = sym.FullyConnected(sym.Flatten(x), num_hidden=5, name="fc")
    return sym.SoftmaxOutput(x, sym.Variable("softmax_label"),
                             name="softmax")


def _train(mx, symbol, dtype, args, aux, x, y, opt, steps=3):
    """Bind under the policy, train ``steps`` steps on one batch: each
    step's outputs, every update (final minus initial) and the
    module."""
    data_name = symbol.list_arguments()[0]
    with mx.amp.scope(dtype):
        mod = mx.mod.Module(symbol, data_names=(data_name,),
                            label_names=("softmax_label",), context=mx.cpu())
        mod.bind(data_shapes=[(data_name, x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
    mod.init_params(arg_params={k: mx.nd.array(v, **_ctx(mx))
                                for k, v in args.items()},
                    aux_params={k: mx.nd.array(v, **_ctx(mx))
                                for k, v in aux.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    batch = mx.io.DataBatch([mx.nd.array(x, **_ctx(mx))],
                            [mx.nd.array(y, **_ctx(mx))])
    outs = []
    for _ in range(steps):
        mod.forward(batch, is_train=True)
        outs.append(mod.get_outputs()[0].asnumpy().astype(np.float64))
        mod.backward()
        mod.update()
    a, _ = mod.get_params()
    upd = {k: a[k].asnumpy().astype(np.float64) - args[k] for k in args}
    return outs, upd, mod


def _reference_child(dst):
    """In the child process: the reference's bf16 training of each of
    ``_cases()``, pickled to ``dst``."""
    runs = {name: _train(jmx, jsym.load_json(c["json"]), "bfloat16",
                         c["args"], c["aux"], c["x"], c["y"], c["opt"])[:2]
            for name, c in _cases().items()}
    with open(dst, "wb") as f:
        pickle.dump(runs, f)


_CHILD = ("import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
          "sys.path[:0] = sys.argv[1:3]; import test_torch_amp as t; "
          "t._reference_child(sys.argv[3])")


def _start_reference_child(dst):
    """The reference's bf16 training of ``_cases()`` in a child process
    whose XLA rounds every result to the dtype its op names
    (``--xla_allow_excess_precision=false``).  By default XLA keeps a
    fused chain of bf16 elementwise ops in float32 and rounds once at
    its end, where the port rounds after each op as the reference's ops
    say; the flag is read when XLA starts, hence the child, which runs
    while this process trains the port."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
        [os.environ.get("XLA_FLAGS", ""),
         "--xla_allow_excess_precision=false"]).strip())
    tests = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen([sys.executable, "-c", _CHILD, tests,
                             os.path.dirname(tests), str(dst)], env=env)


def _check_bf16_against_the_reference(case, reference, record,
                                      first_step_within=None):
    """The port's bf16 training of ``case`` against the reference's
    (``reference``: its outputs and updates) and the port's float32."""
    t, tu, tmod = _train(tmx, tmx.sym.load_json(case["json"]), "bfloat16",
                         case["args"], case["aux"], case["x"], case["y"],
                         case["opt"])
    f, fu, _ = _train(tmx, tmx.sym.load_json(case["json"]), None,
                      case["args"], case["aux"], case["x"], case["y"],
                      case["opt"])
    j, ju = reference

    def flat(u):
        return np.concatenate([u[k].ravel() for k in sorted(u)])
    pairs = list(zip(t, j, f)) + [(flat(tu), flat(ju), flat(fu))]
    # per step, then the updates: (port to reference, reference to f32,
    # port to f32)
    dists = [(_rel(to, jo), _rel(jo, fo), _rel(to, fo))
             for to, jo, fo in pairs]
    record("bf16_distances", dists)
    for k, (tj, jf, tf) in enumerate(dists):
        assert tj <= 2 * jf, (k, dists)
        assert tf >= jf / 2, (k, dists)
    if first_step_within is not None:
        assert dists[0][0] <= first_step_within * dists[0][1], dists
    for name, arr in tmod._exec_group.execs[0].arg_dict.items():
        assert arr._data.dtype == torch.float32, name
    for state in tmod._updater.states.values():
        assert state._data.dtype == torch.float32


def _convnet_case():
    rng = np.random.RandomState(3)
    js = _convnet(jsym).tojson()
    symbol = jsym.load_json(js)
    shapes, _, aux_shapes = symbol.infer_shape(data=(8, 3, 8, 8),
                                               softmax_label=(8,))
    args = {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(symbol.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (np.ones if n.endswith("var") else np.zeros)(s, np.float32)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    x = rng.randn(8, 3, 8, 8).astype(np.float32)
    y = rng.randint(0, 5, (8,)).astype(np.float32)
    return dict(json=js, args=args, aux=aux, x=x, y=y, opt={
        "learning_rate": 0.1, "momentum": 0.9})


def _resnet18_case(resnet18_json):
    rng = np.random.RandomState(0)
    symbol = jsym.load_json(resnet18_json)
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
    x = rng.rand(B, 3, HW, HW).astype(np.float32)
    y = rng.randint(0, 10, (B,)).astype(np.float32)
    return dict(json=resnet18_json, args=args, aux=aux, x=x, y=y, opt={
        "learning_rate": 0.01, "momentum": 0.9})


def _resnet18_json(dtype):
    with jamp.scope(dtype), jsym.NameManager():
        net = vision.resnet18_v1(classes=10)
        net.initialize(jmx.init.Zero(), ctx=jmx.cpu())
        out, _, _ = net._trace_symbol(jmx.nd.zeros((B, 3, HW, HW),
                                                   ctx=jmx.cpu()))
        return jsym.SoftmaxOutput(data=out,
                                  label=jsym.Variable("softmax_label"),
                                  name="softmax").tojson()


def _cases():
    """The cases of the bf16 tests, made alike here and in the child."""
    return {"convnet": _convnet_case(),
            "resnet18": _resnet18_case(_resnet18_json(None))}


@pytest.fixture(scope="module", autouse=True)
def _reference_child_process(tmp_path_factory):
    dst = tmp_path_factory.mktemp("amp") / "runs.pkl"
    child = _start_reference_child(dst)
    yield child, dst
    if child.poll() is None:
        child.kill()
        child.wait()


@pytest.fixture(scope="module")
def resnet18_json():
    return _resnet18_json(None)


@pytest.fixture(scope="module")
def cases(resnet18_json):
    return {"convnet": _convnet_case(),
            "resnet18": _resnet18_case(resnet18_json)}


@pytest.fixture(scope="module")
def reference_runs(_reference_child_process):
    child, dst = _reference_child_process
    assert child.wait(timeout=300) == 0
    with open(dst, "rb") as f:
        return pickle.load(f)


def test_tracing_under_the_scope_gives_the_same_graph(resnet18_json):
    """bench.py traces the net under amp.scope; the reference's trace is
    the same JSON either way, so binding the float32 export under the
    scope is the same graph."""
    assert _resnet18_json("bfloat16") == resnet18_json


def test_convnet_trains_under_bf16_as_the_reference(cases, reference_runs,
                                                    record_property):
    """Two convolutions deep, a rounding that flips on float32-level
    differences (BatchNorm's statistics, the order of a sum) has no
    depth to spread through: the first step's outputs must agree to a
    hundredth of the reference's distance from float32."""
    _check_bf16_against_the_reference(cases["convnet"],
                                      reference_runs["convnet"],
                                      record_property,
                                      first_step_within=1e-2)


def test_resnet18_trains_under_bf16_as_the_reference(cases, reference_runs,
                                                     record_property):
    _check_bf16_against_the_reference(cases["resnet18"],
                                      reference_runs["resnet18"],
                                      record_property)
