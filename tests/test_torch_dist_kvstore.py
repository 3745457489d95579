"""The PyTorch port's distributed store (`KVStoreDist`, the `dist_*`
names of `mx.kv.create`) under `Module` and `gluon.Trainer`, and its
launcher, against the JAX package on the CPU.

* One worker in the test's thread, the scheduler and the server of the
  same package in threads (`test_torch_ps.py`'s `_within` watchdog):
  `Module.fit` of a small LeNet over a `dist_sync` store object (the
  optimizer on the server, `rescale_grad` = 1/(batch x workers), the
  weights pulled back), and `gluon.Trainer` over one with
  `update_on_kvstore` True and False, with and without 2-bit
  compression; each from the same numpy weights as `mxtpu`'s same run,
  the parameters within `test_torch_module.py`'s relative L2 of 1e-3.
  The `Module` run also matches the port's run with no store.
* `python -m mxtpu_torch.tools.launch -n 2 -s 1` runs
  `examples/sparse/linear_classification.py`, its imports renamed to
  the port, with `tests/test_examples.py::
  test_sparse_linear_classification_dist`'s arguments (1,500 rows,
  50,000 features, 2 epochs, `dist_sync`, `--min-accuracy 0.9`): both
  workers print `FINAL_ACCURACY` of at least 0.9.  The subprocess runs
  in a session of its own, one thread a process, and its group is
  killed if it outlives its timeout.
* The store's surface: `rank`, `num_workers`, `barrier`,
  `send_command_to_servers` (to a server's controller),
  `num_dead_node`, and `tpu` still raising.
* What `set_optimizer` pickles: SGD, AdaGrad and Adam with an
  lr_scheduler, under 1 KB; a Trainer's optimizer with its Parameters'
  multipliers and none of their arrays.
"""
import contextlib
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import _ps as J
import mxtpu_torch as tmx
from mxtpu_torch import _ps as T
from mxtpu_torch import context as tcontext
from test_torch_gluon_train import _from, _mlp, _xavier
from test_torch_ps import (_within, join_new_threads,  # noqa: F401
                           ps_env)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_TOL = 1e-3


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture
def cpu_default(monkeypatch):
    monkeypatch.setattr(tcontext, "default_ctx", lambda: torch.device("cpu"))


@contextlib.contextmanager
def roles(env, P, controller=None):
    """A one-worker job of package ``P``: its scheduler and one server
    run in threads until the worker (the caller) closes its store;
    then every thread started here must end."""
    before = set(threading.enumerate())
    env.setenv("MXTPU_NUM_WORKER", "1")
    env.setenv("MXTPU_NUM_SERVER", "1")
    sched = P.Scheduler(port=0)
    env.setenv("MXTPU_PS_ROOT_PORT", str(sched._port))
    threading.Thread(target=sched.run, daemon=True).start()
    threading.Thread(target=lambda: P.Server(controller=controller).run(),
                     daemon=True).start()
    yield
    join_new_threads(before)


def _lenet(S):
    data = S.Variable("data")
    c1 = S.Convolution(data=data, kernel=(3, 3), num_filter=4, name="conv1")
    a1 = S.Activation(data=c1, act_type="tanh", name="tanh1")
    p1 = S.Pooling(data=a1, pool_type="max", kernel=(2, 2), stride=(2, 2),
                   name="pool1")
    fc1 = S.FullyConnected(data=S.Flatten(p1), num_hidden=16, name="fc1")
    a3 = S.Activation(data=fc1, act_type="tanh", name="tanh3")
    fc2 = S.FullyConnected(data=a3, num_hidden=10, name="fc2")
    return S.SoftmaxOutput(data=fc2, name="softmax",
                           label=S.Variable("softmax_label"))


def _fit(mx, kvstore, args, x, y):
    it = mx.io.NDArrayIter(x, y, batch_size=8, label_name="softmax_label")
    mod = mx.mod.Module(_lenet(mx.sym), context=mx.cpu())
    mod.fit(it, kvstore=kvstore, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in args.items()},
            aux_params={}, num_epoch=2)
    return mod


def _lenet_data():
    rng = np.random.RandomState(0)
    x = rng.rand(32, 1, 10, 10).astype(np.float32)
    y = rng.randint(0, 10, 32).astype(np.float32)
    arg_shapes, _, _ = _lenet(tmx.sym).infer_shape(data=(8, 1, 10, 10),
                                                   softmax_label=(8,))
    args = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(_lenet(tmx.sym).list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    return args, x, y


def test_module_fit_over_a_dist_sync_store_matches_mxtpu(ps_env,
                                                         cpu_default):
    args, x, y = _lenet_data()
    got = {}
    for P, mx in ((J, jmx), (T, tmx)):
        with roles(ps_env, P):
            def run():
                kv = mx.kv.create("dist_sync")
                mod = _fit(mx, kv, args, x, y)
                assert mod._update_on_kvstore and mod._kvstore is kv
                assert mod._optimizer.rescale_grad == 1.0 / 8
                params = {k: v.asnumpy()
                          for k, v in mod.get_params()[0].items()}
                kv.close()
                return params
            got[mx] = _within(60, run)
    local = {k: v.asnumpy() for k, v in
             _fit(tmx, "local", args, x, y).get_params()[0].items()}
    for k in args:
        assert _rel(got[tmx][k], got[jmx][k]) <= PARAM_TOL, k
        assert _rel(got[tmx][k], local[k]) <= PARAM_TOL, k
        assert not np.array_equal(got[tmx][k], args[k]), k


@pytest.mark.parametrize("update_on_kvstore", [True, False])
@pytest.mark.parametrize("compression", [None, "2bit"])
def test_trainer_over_a_dist_sync_store_matches_mxtpu(update_on_kvstore,
                                                      compression, ps_env,
                                                      cpu_default):
    rng = np.random.RandomState(1)
    x = rng.randn(6, 5).astype(np.float32)
    y = rng.randint(0, 3, 6).astype(np.float32)
    weights = _xavier(_mlp, x, rng)
    comp = {"type": "2bit", "threshold": 0.02} if compression else None
    got = {}
    for P, mx in ((J, jmx), (T, tmx)):
        with roles(ps_env, P):
            def run():
                net = _from(mx, _mlp, weights)
                kv = mx.kv.create("dist_sync")
                trainer = mx.gluon.Trainer(
                    net.collect_params(), "sgd",
                    {"learning_rate": 0.1, "momentum": 0.9}, kvstore=kv,
                    update_on_kvstore=update_on_kvstore,
                    compression_params=comp)
                loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
                xd, yd = (mx.nd.array(a, ctx=mx.cpu()) for a in (x, y))
                steps = []
                for _ in range(3):
                    with mx.autograd.record():
                        loss = loss_fn(net(xd), yd)
                    loss.backward()
                    trainer.step(x.shape[0])
                    steps.append({k: p.data().asnumpy() for k, p in
                                  net.collect_params().items()})
                assert trainer._kvstore is kv
                assert trainer._update_on_kvstore == update_on_kvstore
                kv.close()
                return steps
            got[mx] = _within(60, run)
    for ts, js in zip(got[tmx], got[jmx]):
        for k in ts:
            assert _rel(ts[k], js[k]) <= PARAM_TOL, k
    for k in got[tmx][-1]:
        assert not np.array_equal(got[tmx][-1][k], weights[k]), k


def test_the_store_surface(ps_env, cpu_default):
    heard = []
    with roles(ps_env, T, controller=lambda h, b: heard.append((h, b))):
        def run():
            kv = tmx.kv.create("dist_async")
            assert (kv.type, kv.rank, kv.num_workers) == ("dist_async", 0, 1)
            kv.init("k", tmx.nd.ones((3,)))
            kv.barrier()
            kv.send_command_to_servers("hello", b"body")
            assert kv.num_dead_node(6) == 0
            with pytest.raises(tmx.MXNetError, match="set_optimizer"):
                kv.set_updater(lambda *a: None)
            out = tmx.nd.zeros((3,))
            kv.push("k", tmx.nd.ones((3,)) * 4)
            kv.pull("k", out=out)
            kv.close()
            return out.asnumpy()
        np.testing.assert_array_equal(_within(30, run), [4, 4, 4])
    assert heard == [("hello", b"body")]
    with pytest.raises(tmx.MXNetError, match="A15b"):
        tmx.kv.create("tpu")


WORKER = r"""
import re, sys, types, torch
torch.set_num_threads(1)
from mxtpu_torch import context
context.default_ctx = lambda: torch.device("cpu")
path = sys.argv[1]
src, n = re.subn(r"^(import|from) mxtpu\b", r"\1 mxtpu_torch",
                 open(path).read(), flags=re.M)
assert n == 4, n
mod = types.ModuleType("linear_classification_port")
mod.__file__ = path
exec(compile(src, path, "exec"), mod.__dict__)
sys.argv = sys.argv[1:]
mod.main()
"""


def test_the_launcher_runs_the_sparse_example_on_two_workers(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", MXTPU_DATA_DIR=str(tmp_path),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for name in ("MXTPU_ROLE", "DMLC_ROLE", "MXTPU_PS_ROOT_PORT"):
        env.pop(name, None)
    example = os.path.join(REPO, "examples", "sparse",
                           "linear_classification.py")
    cmd = [sys.executable, "-m", "mxtpu_torch.tools.launch", "-n", "2",
           "-s", "1", "--timeout", "150", sys.executable, "-c", WORKER,
           example, "--synthesize", "--num-epoch", "2", "--num-rows",
           "1500", "--num-features", "50000", "--kvstore", "dist_sync",
           "--min-accuracy", "0.9"]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-2000:] + err[-2000:]
    accs = [float(line.split()[1]) for line in out.splitlines()
            if line.startswith("FINAL_ACCURACY")]
    assert len(accs) == 2 and min(accs) >= 0.9, out


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("adagrad", dict(learning_rate=0.1)),
    ("adam", dict(learning_rate=0.01))])
def test_optimizers_pickle_small_with_a_scheduler_and_parameters(name, kw,
                                                                cpu_default):
    """What `set_optimizer` sends to the servers: the optimizer with an
    lr_scheduler attached, and a Trainer's optimizer, whose Parameters
    travel as their lr_mult and wd_mult only (no arrays)."""
    import pickle

    sched = tmx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    opt = tmx.optimizer.create(name, lr_scheduler=sched, **kw)
    blob = pickle.dumps(opt)
    assert len(blob) < 1024, len(blob)
    back = pickle.loads(blob)
    assert back.lr_scheduler(5) == opt.lr_scheduler(5)
    net = _from(tmx, _mlp, _xavier(_mlp, np.ones((2, 5), np.float32),
                                   np.random.RandomState(0)))
    params = list(net.collect_params().values())
    params[0].lr_mult = 0.5
    trainer = tmx.gluon.Trainer(params, name, dict(kw))
    blob = pickle.dumps(trainer.optimizer)
    assert len(blob) < 2048, len(blob)
    back = pickle.loads(blob)
    assert back._get_lr_mult(0) == 0.5 and back._get_lr_mult(1) == 1.0
    assert trainer.optimizer.param_dict[0] is params[0]
