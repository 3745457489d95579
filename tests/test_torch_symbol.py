"""The PyTorch port's Symbol (`mxtpu_torch/symbol/`) against the JAX
package's (`mxtpu/symbol/`): composition and the graph queries, the
JSON format both ways, shape inference over whole ResNets, and the
port's own ResNet-50 v1 trace (`sym.ZOO`) against a fresh trace by the
JAX package.

ResNets are traced by `mxtpu`'s gluon model zoo with `_trace_symbol`
and a `SoftmaxOutput(name="softmax")` head, as `bench.py` builds them,
inside a fresh `NameManager` so that their names do not depend on what
ran before.
"""
import json

import numpy as np
import pytest

import mxtpu as jmx
from mxtpu import sym as jsym
from mxtpu.gluon.model_zoo import vision
import mxtpu_torch as tmx
from mxtpu_torch import sym as tsym
from mxtpu_torch.base import MXNetError
import torch

torch.set_num_threads(1)


def _trace(name, batch=1, hw=224, classes=1000):
    with jsym.NameManager():
        net = getattr(vision, name)(classes=classes)
        net.initialize(jmx.init.Zero(), ctx=jmx.cpu())
        out, _, _ = net._trace_symbol(
            jmx.nd.zeros((batch, 3, hw, hw), ctx=jmx.cpu()))
        return jsym.SoftmaxOutput(data=out,
                                  label=jsym.Variable("softmax_label"),
                                  name="softmax")


@pytest.fixture(scope="module")
def resnet18():
    return _trace("resnet18_v1", hw=64)


@pytest.fixture(scope="module")
def resnet50():
    return _trace("resnet50_v1")


def _mlp(sym):
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data=data, num_hidden=8, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    bn = sym.BatchNorm(act, fix_gamma=False, name="bn1")
    fc2 = sym.FullyConnected(bn, num_hidden=3, no_bias=True, name="fc2")
    return sym.SoftmaxOutput(data=fc2, name="softmax")


def test_composition_and_queries_match_the_reference():
    t, j = _mlp(tsym), _mlp(jsym)
    for q in ("list_arguments", "list_auxiliary_states", "list_outputs",
              "list_inputs"):
        assert getattr(t, q)() == getattr(j, q)(), q
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    assert t.attr_dict() == j.attr_dict()
    assert json.loads(t.tojson()) == json.loads(j.tojson())
    kw = dict(data=(4, 6), softmax_label=(4,))
    assert t.infer_shape(**kw) == j.infer_shape(**kw)


def test_call_substitutes_variables():
    x = tsym.Variable("x")
    y = tsym.FullyConnected(x, num_hidden=2, name="fc")
    z = tsym.Activation(tsym.Variable("inp"), act_type="tanh", name="act")
    composed = y(x=z)
    assert composed.list_arguments() == ["inp", "fc_weight", "fc_bias"]
    assert composed.infer_shape(inp=(3, 5))[1] == [(3, 2)]
    assert tsym.elemwise_add(z, z).list_arguments() == ["inp"]
    assert tsym._mul_scalar(z, scalar=2.0).infer_shape(inp=(3, 5))[1] == \
        [(3, 5)]
    with pytest.raises(MXNetError, match="not a Symbol"):
        tsym.FullyConnected(3, num_hidden=2)
    with pytest.raises(MXNetError, match="cannot infer shape"):
        y.infer_shape()


def test_port_json_loads_in_the_reference_and_back(resnet18):
    """mxtpu's trace loads in the port and writes back the same JSON;
    the port's own composition loads in mxtpu node for node."""
    js = resnet18.tojson()
    t = tsym.load_json(js)
    assert json.loads(t.tojson()) == json.loads(js)
    back = jsym.load_json(_mlp(tsym).tojson())
    assert json.loads(back.tojson()) == json.loads(_mlp(jsym).tojson())
    assert t.list_arguments() == resnet18.list_arguments()
    assert t.list_auxiliary_states() == resnet18.list_auxiliary_states()


def test_save_and_load(tmp_path, resnet18):
    path = str(tmp_path / "net-symbol.json")
    tsym.load_json(resnet18.tojson()).save(path)
    assert json.loads(jsym.load(path).tojson()) == \
        json.loads(resnet18.tojson())
    assert tsym.load(path).list_outputs() == ["softmax_output"]


@pytest.mark.parametrize("net,shape", [("resnet18", (4, 3, 64, 64)),
                                       ("resnet50", (32, 3, 224, 224))])
def test_infer_shape_matches_on_whole_resnets(net, shape, request):
    ref = request.getfixturevalue(net)
    t = tsym.load_json(ref.tojson())
    kw = dict(data0=shape, softmax_label=(shape[0],))
    got, want = t.infer_shape(**kw), ref.infer_shape(**kw)
    assert got == want
    arg, out, aux = got
    assert out == [(shape[0], 1000)] and len(aux) == len(
        ref.list_auxiliary_states())


def test_committed_resnet50_symbol_is_the_reference_trace(resnet50):
    """`sym.ZOO["resnet50_v1"]()`, the port's own gluon trace, is, node
    for node and attr for attr, what the JAX package traces now."""
    ported = json.loads(tsym.ZOO["resnet50_v1"]().tojson())
    fresh = json.loads(resnet50.tojson())
    assert ported == fresh
    ops = [n["op"] for n in ported["nodes"]]
    counts = {op: ops.count(op) for op in set(ops)}
    assert counts == {"null": 301, "Convolution": 53, "BatchNorm": 53,
                      "Activation": 49, "Pooling": 2, "elemwise_add": 16,
                      "FullyConnected": 1, "SoftmaxOutput": 1}
    s = tsym.load_json(json.dumps(ported))
    assert (len(s.list_arguments()), len(s.list_auxiliary_states())) == \
        (195, 106)


def test_attrs_decode_to_python_values(resnet50):
    s = tsym.load_json(tsym.ZOO["resnet50_v1"]().tojson())
    conv = [n for n in s._topo() if not n.is_variable
            and n.op.name == "Convolution"][0]
    assert conv.attrs["kernel"] == (7, 7) and conv.attrs["no_bias"] is True
    assert conv.attrs["layout"] == "NCHW"
    bn = [n for n in s._topo() if not n.is_variable
          and n.op.name == "BatchNorm"][0]
    assert bn.attrs["fix_gamma"] is False and bn.attrs["eps"] == 1e-5
    j = jsym.load_json(tsym.ZOO["resnet50_v1"]().tojson())
    jconv = [n for n in j._topo() if not n.is_variable
             and n.op.name == "Convolution"][0]
    assert jconv.attrs == conv.attrs


def test_group_and_indexing():
    a = tsym.Variable("a")
    b = tsym.BatchNorm(a, output_mean_var=True, name="bn")
    assert b.list_outputs() == ["bn_output0", "bn_output1", "bn_output2"]
    g = tsym.Group([b[0], tsym.Flatten(a, name="flat")])
    assert g.list_outputs() == ["bn_output0", "flat_output"]
    assert g["flat_output"].name == "flat"
