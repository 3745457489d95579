"""The PyTorch port's model zoo families (`mxtpu_torch/gluon/model_zoo/
vision/`: AlexNet, DenseNet, Inception v3, MobileNet v1 and v2,
SqueezeNet, VGG) against the JAX package's.

* Every model of `get_model`'s registry has `mxtpu`'s parameter names,
  so `gluon.parameter.load_numpy` carries its weights across by name;
  one model of each family, traced and shape-inferred at its full
  input (224², Inception 299²), has `mxtpu`'s parameter shapes too.
* In `test_torch_zoo_b.py`, MobileNet v2 0.25 and MobileNet 0.25 at
  32², SqueezeNet 1.1 at 64², VGG-11-bn at 32² and AlexNet at 67² (the
  smallest inputs their pools take), batch 4, run a hybridized forward
  and backward from the same Xavier weights in both packages
  (`_zoo_parity`: the checks of `test_torch_gluon.py`'s `_parity` on
  the weights of `test_torch_gluon_train.py`'s `_xavier`): the output,
  the input gradient and every parameter gradient within a relative L2
  of `ZOO_TOL`.  They run in predict mode, where Dropout is the
  identity in both packages and BatchNorm uses the moving statistics.
  The reference is loaded by name (`Parameter.set_data` initializes a
  deferred Parameter), so it compiles one program and runs no
  imperative forward.
* In `test_torch_zoo_c.py` and `_d` the two MobileNets run the same
  pass in training mode, at batch 16, held to an independent float64
  run of the reference (`reference_float64`, in a child process with
  `jax_enable_x64`; the reference's BatchNorm casts to float32 whatever
  its input, so there it computes in float64).  The port's float64 must
  agree with it within `F64_TOL`; each float32 result must lie within
  `ZOO_TOL` plus twice the reference's own float32 error of the
  reference's float32, and within `ZOO_TOL` plus that error of float64.
  At batch 4 the last BatchNorm of these nets normalizes four values a
  channel and float32 is no oracle for either package: over three
  draws of the weights, against float64, MobileNet v2 0.25's input
  gradient read 1.4e-2 to 6.8e-2 in the reference and 3.4e-2 to 0.13
  in the port.  At batch 16 (seed 0) it reads 8.3e-5 in the reference
  and 3.2e-5 in the port; MobileNet 0.25's reads 1.8e-2 and 5.1e-4.
* DenseNet-121 pools 7x7 at the end and Inception v3 8x8, so they take
  only their full inputs whole; here each of their blocks (a dense
  block, a transition, Inception's A to E blocks) is held in training
  at a small input, the same way.  `chip_smoke.py`'s zoo phase runs
  them whole on the card.
"""
import contextlib
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu.ops.nn as jnn
import mxtpu_torch as tmx
from test_torch_gluon import _build, _rel, _x
from test_torch_gluon_train import _xavier

torch.set_num_threads(1)

ZOO_TOL = 1e-5
# the port's float64 against the reference's (`reference_float64`)
F64_TOL = 1e-8


def _zoo(mx):
    return mx.gluon.model_zoo.vision


def test_the_registry_has_mxtpus_models_and_parameter_names():
    jz, tz = _zoo(jmx), _zoo(tmx)
    assert sorted(tz._models) == sorted(jz._models)
    for name in sorted(jz._models):
        names = []
        for mx in (jmx, tmx):
            with mx.sym.NameManager():
                net = _zoo(mx).get_model(name, classes=10)
            names.append(sorted(net.collect_params()))
        assert names[1] == names[0], name


FULL = {"alexnet": 224, "densenet121": 224, "inception_v3": 299,
        "mobilenet1_0": 224, "mobilenet_v2_1_0": 224, "squeezenet1_0": 224,
        "squeezenet1_1": 224, "vgg16_bn": 224}


def _shapes(mx, name, side):
    with mx.sym.NameManager():
        net = getattr(_zoo(mx), name)(classes=1000)
        out, _, _ = net._trace_symbol(mx.sym.var("data0"))
    args, outs, aux = out.infer_shape(data0=(1, 3, side, side))
    shapes = dict(zip(out.list_arguments(), args))
    shapes.update(zip(out.list_auxiliary_states(), aux))
    shapes.pop("data0")
    return sorted(net.collect_params()), shapes, outs


@pytest.mark.parametrize("name", sorted(FULL))
def test_parameter_shapes_match_mxtpu_at_full_input(name):
    (jn, js, jo), (tn, ts, to) = (_shapes(mx, name, FULL[name])
                                  for mx in (jmx, tmx))
    assert tn == jn and sorted(ts) == tn
    assert ts == js
    assert to == jo == [(1, 1000)]


SMALL = {"mobilenet_v2_0_25": 32, "mobilenet0_25": 32, "squeezenet1_1": 64,
         "vgg11_bn": 32, "alexnet": 67}


def two_pass_batch_norm(mp):
    """The reference's training BatchNorm statistics in two passes
    (ROADMAP §C: its one-pass form cancels)."""
    one_pass = jnn._single_pass_stats
    mp.setattr(jnn, "_single_pass_stats",
               lambda jnp, x, axes, keepdims=False, force=False:
               one_pass(jnp, x, axes, keepdims, force=False))


def widen_reference(mp):
    """The reference's float64 computed in float64: its normalization
    ops cast their input to float32 whatever its type (`mxtpu/ops/
    nn.py`, `_batch_norm`), so under `jax_enable_x64` they read
    ``jnp.float32`` as float64 (the same formulas, without the
    narrowing)."""
    import jax.numpy as jnp

    class Wide:
        def __getattr__(self, name):
            return getattr(jnp, "float64" if name == "float32" else name)

    mp.setattr(jnn, "_jnp", Wide)


def reference_float64(mp):
    two_pass_batch_norm(mp)
    widen_reference(mp)


def zoo_net(mx, make, arrays, dtype="float32"):
    """``make`` built in ``mx`` and set from ``arrays`` by name in
    ``dtype`` (cast before the weights are set: the reference compiles a
    cast for each shape otherwise)."""
    net = _build(mx, make)
    if dtype != "float32":
        net.cast(dtype)
    net.initialize(mx.init.Zero(), ctx=mx.cpu())
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(arrays[k], ctx=mx.cpu(), dtype=dtype))
    return net


def zoo_pass(mx, make, arrays, x, head, train, dtype="float32"):
    """One hybridized recorded forward and backward of ``make`` set from
    ``arrays`` by name, in ``dtype``: (output, input gradient,
    {parameter: gradient}, {parameter: value after the pass})."""
    net = zoo_net(mx, make, arrays, dtype)
    net.hybridize()
    xd = mx.nd.array(x, ctx=mx.cpu(), dtype=dtype)
    xd.attach_grad()
    with mx.autograd.record(train_mode=train):
        out = net(xd)
    out.backward(mx.nd.array(head, ctx=mx.cpu(), dtype=dtype))
    params = net.collect_params()
    return (out.asnumpy(), xd.grad.asnumpy(),
            {k: p.grad().asnumpy() for k, p in params.items()
             if p.grad_req != "null"},
            {k: p.data().asnumpy() for k, p in params.items()})


def _floored(t, j, floor):
    """Relative L2 of each of ``t`` from ``j``, against the norm of
    ``j``'s or ``floor`` of the largest such norm, for a result that is
    zero in exact arithmetic."""
    least = floor * max(np.linalg.norm(v) for v in j.values())
    return {k: float(np.linalg.norm(t[k].astype(np.float64) - j[k]) /
                     max(np.linalg.norm(j[k]), least, 1e-30)) for k in j}


def pass_distances(t, j, value_floor=0.0):
    """Relative L2 of ``t``'s results from ``j``'s (``zoo_pass``): the
    output, the input gradient, each parameter's gradient (against its
    own norm or 1e-2 of the largest: a bias a BatchNorm follows has
    none in exact arithmetic) and each parameter's value (against its
    own norm or ``value_floor`` of the largest: a moving mean after a
    pass whose input has zero mean in exact arithmetic)."""
    assert set(t[2]) == set(j[2]) and set(t[3]) == set(j[3])
    d = {"output": _rel(t[0], j[0]), "input grad": _rel(t[1], j[1])}
    d.update(("grad " + k, v)
             for k, v in _floored(t[2], j[2], 1e-2).items())
    d.update(("value " + k, v)
             for k, v in _floored(t[3], j[3], value_floor).items())
    return d


def zoo_draws(make, x):
    """Xavier weights for ``make`` and a normal head gradient for its
    output, drawn with numpy."""
    rng = np.random.RandomState(0)
    arrays = _xavier(make, x, rng)
    net = _build(tmx, make)
    net.initialize(tmx.init.Zero(), ctx=tmx.cpu())
    for k, p in net.collect_params().items():
        p.set_data(tmx.nd.array(arrays[k], ctx=tmx.cpu()))
    with tmx.autograd.pause():
        shape = net(tmx.nd.array(x, ctx=tmx.cpu())).shape
    return arrays, rng.normal(0, 1, shape).astype(np.float32)


def _zoo_parity(make, x, train, tol=ZOO_TOL):
    arrays, head = zoo_draws(make, x)
    with pytest.MonkeyPatch.context() as mp:
        two_pass_batch_norm(mp)
        j = zoo_pass(jmx, make, arrays, x, head, train)
    t = zoo_pass(tmx, make, arrays, x, head, train)
    bad = {k: v for k, v in pass_distances(t, j).items() if not v <= tol}
    assert not bad, bad
    return t[0]


# the reference in float64 (``reference_float64``) in a child process
# (`jax_enable_x64` is the process's), started early so that its imports
# overlap the test's work: each task is a model of ``_zoo(mx)`` by name
# with 10 classes, its weights and inputs, and "pass" (``zoo_pass``) or
# "train" (`test_torch_gluon_train.py`'s ``_train``)
_CHILD = ("import sys, jax; jax.config.update('jax_enable_x64', True); "
          "import torch; torch.set_num_threads(1); "
          "sys.path.insert(0, sys.argv[1]); import test_torch_zoo as t; "
          "t.reference64_child(sys.argv[2], sys.argv[3])")


def reference64_child(src, dst, wait=600):
    from test_torch_gluon_train import _train
    end = time.monotonic() + wait
    while not os.path.exists(src):
        assert time.monotonic() < end, "no tasks in %s" % src
        time.sleep(0.05)
    with open(src, "rb") as f:
        tasks = pickle.load(f)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        reference_float64(mp)
        for key, task in tasks.items():
            def make(mx, name=task["name"]):
                return getattr(_zoo(mx), name)(classes=10)
            if task["kind"] == "pass":
                out[key] = zoo_pass(jmx, make, task["arrays"], task["x"],
                                    task["head"], task["train"], "float64")
            else:
                net = zoo_net(jmx, make, task["arrays"], "float64")
                out[key] = _train(jmx, net, task["x"], task["y"],
                                  task["steps"], dtype="float64")[:2]
    with open(dst, "wb") as f:
        pickle.dump(out, f)


@contextlib.contextmanager
def one_torch_thread():
    """torch on one thread: these small runs gain nothing from more, and
    many threads spin against a busy machine (the child process, other
    test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


class Reference64:
    """A child process running ``reference64_child``: ``submit(tasks)``
    hands it its tasks, ``results()`` waits for them, ``close()`` kills
    it if it still runs."""

    def __init__(self, tmp, timeout=600):
        self.src, self.dst = str(tmp / "tasks.pkl"), str(tmp / "out.pkl")
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.dirname(here),
                        os.environ.get("PYTHONPATH", "")]))
        # its float64 programs are compiled once: writing them to the
        # persistent compile cache would only cost time
        env.pop("MXTPU_COMPILE_CACHE", None)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD, here, self.src, self.dst],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True)
        self.timeout, self.out = timeout, None

    def submit(self, tasks):
        with open(self.src + ".part", "wb") as f:
            pickle.dump(tasks, f)
        os.rename(self.src + ".part", self.src)

    def results(self):
        if self.out is None:
            try:
                log, _ = self.proc.communicate(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)
                self.proc.communicate()
                raise
            assert self.proc.returncode == 0, log[-3000:]
            with open(self.dst, "rb") as f:
                self.out = pickle.load(f)
        return self.out

    def close(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.communicate()


BLOCKS = {
    "dense_block": (lambda mx: _zoo(mx).densenet._make_dense_block(
        3, 4, 8, 0, 1), (2, 16, 6, 6)),
    "transition": (lambda mx: _zoo(mx).densenet._make_transition(8),
                   (2, 16, 6, 6)),
    "inception_A": (lambda mx: _zoo(mx).inception._make_A(8, "A1_"),
                    (2, 16, 7, 7)),
    "inception_B": (lambda mx: _zoo(mx).inception._make_B("B_"),
                    (2, 16, 9, 9)),
    "inception_C": (lambda mx: _zoo(mx).inception._make_C(8, "C1_"),
                    (2, 16, 5, 5)),
    "inception_D": (lambda mx: _zoo(mx).inception._make_D("D_"),
                    (2, 16, 9, 9)),
    "inception_E": (lambda mx: _zoo(mx).inception._make_E("E1_"),
                    (2, 16, 3, 3)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_densenet_and_inception_blocks_match_mxtpu(name):
    make, shape = BLOCKS[name]
    _zoo_parity(make, _x(*shape), train=True)
