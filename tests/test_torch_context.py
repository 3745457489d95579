"""The PyTorch port's contexts (`mxtpu_torch/context.py`) against the JAX
package's (`mxtpu/context.py`): `Context`'s names, equality and hashing,
the `with` scope nested and per thread, `MXNET_DEFAULT_CONTEXT`,
creation under a scope, `cpu_shared` arrays, and `cpu_pinned` raising
with no card.  The JAX package's `gpu(i)` is its `tpu(i)`; the port's is
CUDA device `i`.
"""
import threading

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch import context as tcontext
from mxtpu_torch.base import MXNetError

torch.set_num_threads(1)

KINDS = [("cpu", 0), ("cpu", 3), ("gpu", 0), ("gpu", 2), ("cpu_pinned", 0),
         ("cpu_shared", 1)]
J_NAME = {"cpu": "cpu", "gpu": "tpu", "cpu_pinned": "cpu_pinned",
          "cpu_shared": "cpu_shared"}


def _in_thread(fn):
    """fn() run on a new thread, joined with a timeout; its result."""
    out = []
    th = threading.Thread(target=lambda: out.append(fn()))
    th.start()
    th.join(30)
    assert not th.is_alive() and len(out) == 1
    return out[0]


@pytest.mark.parametrize("kind,idx", KINDS)
def test_context_names_and_equality_match_the_reference(kind, idx):
    t = getattr(tmx, kind)(idx)
    j = getattr(jmx, kind)(idx)
    assert isinstance(t, tmx.Context)
    assert t.device_type == kind and t.device_id == idx
    assert J_NAME[t.device_type] == j.device_type
    assert str(t) == "%s(%d)" % (kind, idx) == repr(t)
    assert str(j) == "%s(%d)" % (J_NAME[kind], idx)
    assert t == tmx.Context(kind, idx) == tmx.Context(t)
    assert hash(t) == hash(tmx.Context(kind, idx))
    assert t.device_typeid == j.device_typeid
    others = [tmx.Context(k, i) for k, i in KINDS if (k, i) != (kind, idx)]
    assert all(t != o for o in others)
    assert len({t} | set(others)) == len(KINDS)


def test_devtype_codes_match_the_reference():
    t, j = tmx.Context.devtype2str, jmx.Context.devtype2str
    assert sorted(t) == sorted(j) == [1, 2, 3, 5]
    assert {k: J_NAME[v] for k, v in t.items()} == j
    with pytest.raises(MXNetError):
        tmx.Context("tpu")


def test_context_is_the_torch_device_it_names():
    assert tmx.cpu() == torch.device("cpu")
    assert torch.device("cpu") == tmx.cpu()
    assert tmx.gpu(1) == torch.device("cuda", 1)
    assert torch.device("cuda", 1) != tmx.gpu(0)
    assert hash(tmx.gpu(1)) == hash(torch.device("cuda", 1))
    assert hash(tmx.cpu()) == hash(torch.device("cpu"))
    assert {torch.device("cpu"): 1}[tmx.cpu()] == 1
    # the host kinds name the CPU but are not plain CPU memory
    assert tmx.cpu_pinned() != torch.device("cpu")
    assert tmx.cpu_shared().torch_device == torch.device("cpu")
    assert tmx.gpu(3).torch_device == torch.device("cuda", 3)
    assert tcontext.torch_device("gpu") == torch.device("cuda", 0)
    assert tcontext.torch_device("cuda:1") == torch.device("cuda", 1)
    assert tcontext.as_context(torch.device("cuda", 2)) == tmx.gpu(2)
    assert tcontext.resolve(tmx.cpu_shared()) == torch.device("cpu")
    tmx.cpu().empty_cache()


def test_scopes_nest_and_each_thread_has_its_own():
    seen = {}
    for name, mx in (("t", tmx), ("j", jmx)):
        with mx.cpu(1):
            outer = mx.current_context()
            with mx.cpu_shared(2):
                inner = mx.current_context()
                other = _in_thread(mx.current_context)
            back = mx.current_context()
        seen[name] = (outer, inner, back, other)
        assert outer == mx.cpu(1) and inner == mx.cpu_shared(2)
        assert back == mx.cpu(1)
    # a thread never sees another thread's scope: the default there is
    # the card (the port) or what JAX found (the reference, the CPU here)
    assert seen["t"][3] == tmx.gpu(0)
    assert seen["j"][3] == jmx.cpu(0)
    assert tmx.current_context() == tmx.gpu(0)


def test_scopes_in_two_threads_do_not_mix():
    barrier = threading.Barrier(2, timeout=30)

    def worker(ctx):
        with ctx:
            barrier.wait()
            got = tmx.current_context()
            barrier.wait()
        return got, tmx.current_context()

    out = {}
    ths = [threading.Thread(target=lambda c=c: out.update({str(c): worker(c)}))
           for c in (tmx.cpu(1), tmx.cpu_shared(2))]
    for th in ths:
        th.start()
    for th in ths:
        th.join(30)
        assert not th.is_alive()
    assert out == {"cpu(1)": (tmx.cpu(1), tmx.gpu(0)),
                   "cpu_shared(2)": (tmx.cpu_shared(2), tmx.gpu(0))}


@pytest.mark.parametrize("value,kind,idx", [("cpu", "cpu", 0),
                                            ("gpu:1", "gpu", 1),
                                            ("cpu_shared:0", "cpu_shared", 0)])
def test_mxnet_default_context_matches_the_reference(monkeypatch, value,
                                                     kind, idx):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", value)
    t = _in_thread(tmx.current_context)
    j = _in_thread(jmx.current_context)
    assert t == tmx.Context(kind, idx)
    assert (j.device_type, j.device_id) == (J_NAME[kind], idx)
    with tmx.cpu(5):
        assert tmx.current_context() == tmx.cpu(5)
    monkeypatch.setenv("MXTPU_DEFAULT_CONTEXT", "cpu:2")
    assert _in_thread(tmx.current_context) == tmx.cpu(2)


def test_no_scope_and_no_context_raises_without_a_card():
    assert not torch.cuda.is_available()
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.nd.zeros((2,))
    with tmx.cpu():
        tmx.nd.zeros((2,))
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.nd.array([1.0, 2.0])


def test_creation_under_a_scope_matches_the_reference():
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    made = {}
    for name, mx in (("t", tmx), ("j", jmx)):
        with mx.cpu():
            made[name] = [mx.nd.array(x), mx.nd.zeros((2, 3)),
                          mx.nd.ones((3,)), mx.nd.full((2,), 7.0),
                          mx.nd.arange(0, 5), mx.nd.array(x) * 2]
            assert all(a.ctx == mx.cpu() for a in made[name])
    for t, j in zip(made["t"], made["j"]):
        assert isinstance(t.ctx, tmx.Context) and t.context == t.ctx
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_gluon_and_module_take_the_scope():
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(3, in_units=4)
        net.initialize()
        assert net.weight.data().ctx == tmx.cpu()
        assert net.weight.list_ctx() == [tmx.cpu()]
        data = tmx.sym.var("data")
        out = tmx.sym.FullyConnected(data, num_hidden=2, name="fc")
        mod = tmx.mod.Module(out, label_names=None)
        mod.bind(data_shapes=[("data", (2, 4))], for_training=False)
        mod.init_params()
        assert mod.get_params()[0]["fc_weight"].ctx == tmx.cpu()


def test_as_in_context_and_copyto_take_a_context():
    with tmx.cpu():
        a = tmx.nd.array(np.arange(6, dtype=np.float32))
    assert a.as_in_context(tmx.cpu()) is a
    assert a.as_in_context(torch.device("cpu")) is a
    b = a.copyto(tmx.cpu())
    assert b is not a and b.ctx == tmx.cpu()
    s = a.as_in_context(tmx.cpu_shared())
    assert s is not a and s.ctx == tmx.cpu_shared() and s._data.is_shared()
    assert s.as_in_context(tmx.cpu()).ctx == tmx.cpu()
    assert tcontext.device_of(s) == tmx.cpu_shared()


def test_cpu_shared_arrays_match_the_reference():
    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    t = tmx.nd.array(x, ctx=tmx.cpu_shared())
    j = jmx.nd.array(x, ctx=jmx.cpu_shared())
    assert t._data.is_shared() and t.ctx == tmx.cpu_shared()
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    z = tmx.nd.zeros((2, 2), ctx=tmx.cpu_shared())
    assert z._data.is_shared() and not z.asnumpy().any()
    with tmx.cpu_shared():
        w = tmx.nd.ones((3,))
    assert w.ctx == tmx.cpu_shared()
    # an op on shared arrays gives an ordinary host array, as arithmetic
    # on the card's arrays stays on the card
    np.testing.assert_array_equal((t + 1).asnumpy(), (j + 1).asnumpy())


def test_cpu_pinned_raises_without_cuda():
    x = np.ones((2, 3), np.float32)
    if torch.cuda.is_available():
        assert tmx.nd.array(x, ctx=tmx.cpu_pinned())._data.is_pinned()
        return
    for make in (lambda: tmx.nd.array(x, ctx=tmx.cpu_pinned()),
                 lambda: tmx.nd.zeros((2,), ctx=tmx.cpu_pinned())):
        with pytest.raises(MXNetError, match="cpu_pinned needs CUDA"):
            make()
    with tmx.cpu():
        a = tmx.nd.array(x)
    with pytest.raises(MXNetError, match="cpu_pinned needs CUDA"):
        a.copyto(tmx.cpu_pinned())
