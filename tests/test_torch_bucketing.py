"""The PyTorch port's symbolic recurrent path against the JAX package's,
on the CPU: the cells of ``rnn`` (their unrolled graphs equal node for
node, names included, and their outputs), ``BucketSentenceIter`` (the
same batches in the same order under the same seeds),
``Module.bind(shared_module=...)`` and ``BucketingModule`` (one set of
tensors and one optimizer for every bucket; one epoch of ``fit`` from
the same weights), and the callbacks.

Outputs and trained weights are held to a relative L2 of ``TOL``
(1e-5: float32 sums in other orders, and for ``fit`` carried through
the epoch's updates).
"""
import json
import logging
import random
import re

import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
import torch

torch.set_num_threads(1)

TOL = 1e-5
BATCH, LENGTH, WIDTH = 2, 3, 4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


CELLS = {
    "rnn": lambda mx: mx.rnn.RNNCell(5, prefix="rnn_"),
    "lstm": lambda mx: mx.rnn.LSTMCell(5, prefix="lstm_"),
    "gru": lambda mx: mx.rnn.GRUCell(5, prefix="gru_"),
    "fused_lstm": lambda mx: mx.rnn.FusedRNNCell(5, num_layers=2),
    "fused_gru_bidirectional": lambda mx: mx.rnn.FusedRNNCell(
        4, mode="gru", bidirectional=True),
    "bidirectional": lambda mx: mx.rnn.BidirectionalCell(
        mx.rnn.LSTMCell(3, prefix="l_"), mx.rnn.GRUCell(4, prefix="r_")),
}


def _sequential(mx):
    stack = mx.rnn.SequentialRNNCell()
    stack.add(mx.rnn.LSTMCell(5, prefix="l0_"))
    stack.add(mx.rnn.DropoutCell(0.5, prefix="d0_"))
    stack.add(mx.rnn.GRUCell(4, prefix="l1_"))
    return stack


CELLS["sequential_with_dropout"] = _sequential


def _unrolled(mx, name, merge, layout):
    with mx.sym.NameManager():
        cell = CELLS[name](mx)
        outputs, states = cell.unroll(
            LENGTH, mx.sym.Variable("data"), layout=layout,
            merge_outputs=merge, batch_size=BATCH)
        outputs = outputs if isinstance(outputs, list) else [outputs]
        return mx.sym.Group(outputs + list(states))


def _forward(mx, group, values):
    cpu = mx.cpu()
    args = {n: mx.nd.array(values[n], ctx=cpu)
            for n in group.list_arguments()}
    ex = group.bind(cpu, args=args)
    return [o.asnumpy() for o in ex.forward(is_train=False)]


@pytest.mark.parametrize("merge,layout", [(True, "NTC"), (False, "TNC")])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_unrolled_cell_matches_the_reference(name, merge, layout):
    jg, tg = _unrolled(jmx, name, merge, layout), \
        _unrolled(tmx, name, merge, layout)
    assert json.loads(tg.tojson()) == json.loads(jg.tojson())
    data = (BATCH, LENGTH, WIDTH) if layout == "NTC" else \
        (LENGTH, BATCH, WIDTH)
    shapes = dict(zip(jg.list_arguments(),
                      jg.infer_shape(data=data)[0]))
    rng = np.random.RandomState(0)
    values = {n: rng.normal(0, 0.5, s).astype(np.float32)
              for n, s in shapes.items()}
    want, got = _forward(jmx, jg, values), _forward(tmx, tg, values)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) <= TOL


def test_lstm_cell_bias_starts_at_the_forget_bias():
    with tmx.sym.NameManager():
        out, _ = tmx.rnn.LSTMCell(3, prefix="c_", forget_bias=2.5).unroll(
            2, tmx.sym.Variable("data"), batch_size=2, merge_outputs=True)
    mod = tmx.mod.Module(out, data_names=("data",), label_names=(),
                         context=tmx.cpu())
    mod.bind([("data", (2, 2, 4))], for_training=False)
    mod.init_params(tmx.init.Uniform(0.1))
    bias = mod.get_params()[0]["c_i2h_bias"].asnumpy()
    assert np.array_equal(bias, np.repeat([0.0, 2.5, 0.0, 0.0], 3))


def _sentences(n, vocab, lengths, seed=0):
    """lstm_bucketing.py's synthetic sentences: the next token
    (3 t + 1) mod vocab with probability 0.9, else uniform."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = [rng.randint(1, vocab)]
        for _ in range(rng.randint(*lengths) - 1):
            toks.append((toks[-1] * 3 + 1) % vocab if rng.rand() < 0.9
                        else rng.randint(1, vocab))
        out.append(toks)
    return out


def _iterator(mx, sents, buckets, **kwargs):
    random.seed(7)
    np.random.seed(7)
    return mx.rnn.BucketSentenceIter(sents, 4, buckets=buckets,
                                     invalid_label=0, **kwargs)


def test_bucket_sentence_iter_matches_the_reference():
    sents = _sentences(60, 20, (2, 12))
    jit = _iterator(jmx, sents, [4, 8, 12])
    tit = _iterator(tmx, sents, [4, 8, 12], ctx=tmx.cpu())
    assert tit.provide_data[0].shape == jit.provide_data[0].shape == (4, 12)
    for epoch in range(2):
        seen = 0
        for jb, tb in zip(jit, tit):
            assert tb.bucket_key == jb.bucket_key
            assert tb.provide_data[0].shape == jb.provide_data[0].shape
            assert np.array_equal(tb.data[0].asnumpy(), jb.data[0].asnumpy())
            assert np.array_equal(tb.label[0].asnumpy(),
                                  jb.label[0].asnumpy())
            seen += 1
        assert seen == len(jit.idx) > 0
        with pytest.raises(StopIteration):
            next(tit)
        # reset draws from the global generators: the same seed for each
        for it in (jit, tit):
            random.seed(epoch)
            np.random.seed(epoch)
            it.reset()


def _sym_gen(mx, vocab, hidden=6, embed=5, batch=4):
    """lstm_bucketing.py's model: Embedding -> an LSTM stack unrolled
    over the bucket -> FullyConnected -> SoftmaxOutput."""
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        emb = mx.sym.Embedding(data=data, input_dim=vocab, output_dim=embed,
                               name="embed")
        stack = mx.rnn.SequentialRNNCell()
        stack.add(mx.rnn.LSTMCell(num_hidden=hidden, prefix="lstm_l0_"))
        outputs, _ = stack.unroll(seq_len, inputs=emb, layout="NTC",
                                  merge_outputs=True, batch_size=batch)
        pred = mx.sym.Reshape(outputs, shape=(-1, hidden))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=vocab,
                                     name="pred")
        flat = mx.sym.Reshape(data=label, shape=(-1,))
        return (mx.sym.SoftmaxOutput(data=pred, label=flat, name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def _initial_weights(sym_gen, key):
    sym = sym_gen(key)[0]
    shapes = sym.infer_shape(data=(4, key), softmax_label=(4, key))[0]
    rng = np.random.RandomState(5)
    return {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _fit(mx, sents, vocab, buckets, **iter_kwargs):
    it = _iterator(mx, sents, buckets, **iter_kwargs)
    with mx.sym.NameManager():
        sym_gen = _sym_gen(mx, vocab)
        weights = _initial_weights(sym_gen, max(buckets))
    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=max(buckets),
                                 context=mx.cpu())
    metric = mx.metric.Perplexity(ignore_label=0)
    mod.fit(it, eval_metric=metric, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            num_epoch=1, arg_params={n: mx.nd.array(w, ctx=mx.cpu())
                                     for n, w in weights.items()})
    return mod, metric


def test_bucketing_fit_matches_the_reference():
    sents = _sentences(40, 30, (3, 9))
    jmod, jmetric = _fit(jmx, sents, 30, [4, 8])
    tmod, tmetric = _fit(tmx, sents, 30, [4, 8], ctx=tmx.cpu())
    assert sorted(tmod._buckets) == sorted(jmod._buckets) == [4, 8]
    want, got = jmod.get_params()[0], tmod.get_params()[0]
    assert sorted(got) == sorted(want)
    for n in want:
        assert _rel(got[n].asnumpy(), want[n].asnumpy()) <= TOL, n
    assert tmetric.num_inst == jmetric.num_inst
    assert abs(tmetric.get()[1] / jmetric.get()[1] - 1) <= TOL


def test_buckets_share_one_set_of_tensors_and_one_optimizer():
    sents = _sentences(40, 30, (2, 13))
    tmod, _ = _fit(tmx, sents, 30, [4, 8, 12], ctx=tmx.cpu())
    mods = list(tmod._buckets.values())
    assert len(mods) == 3
    first = mods[0]._exec_group
    for mod in mods[1:]:
        assert mod._updater is mods[0]._updater
        assert mod._optimizer is mods[0]._optimizer
        g = mod._exec_group
        assert g.param_names == first.param_names
        for a, b in zip(g.param_arrays + g.grad_arrays,
                        first.param_arrays + first.grad_arrays):
            assert a[0]._data.data_ptr() == b[0]._data.data_ptr()
        ex = g.execs[0]
        for name in g.param_names:
            assert ex.arg_dict[name] is first.execs[0].arg_dict[name]
    # one momentum per parameter, whichever bucket ran
    assert len(mods[0]._updater.states) == len(first.param_names)


def test_shared_module_must_be_bound_and_initialized():
    with tmx.sym.NameManager():
        sym = _sym_gen(tmx, 10)(4)[0]
    shared = tmx.mod.Module(sym, context=tmx.cpu())
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    with pytest.raises(MXNetError, match="shared_module"):
        mod.bind([("data", (4, 4))], [("softmax_label", (4, 4))],
                 shared_module=shared)


class _Param(object):
    def __init__(self, nbatch, metric, epoch=0):
        self.epoch, self.nbatch, self.eval_metric = epoch, nbatch, metric


def _speedometer_lines(mx, caplog):
    metric = mx.metric.Perplexity(ignore_label=None)
    metric.sum_metric, metric.num_inst = 6.0, 3
    cb = mx.callback.Speedometer(8, frequent=2)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for nbatch in range(5):
            cb(_Param(nbatch, metric))
    return [re.sub(r"Speed: [0-9.]+", "Speed: S", r.getMessage())
            for r in caplog.records]


def test_speedometer_logs_as_the_reference(caplog):
    want = _speedometer_lines(jmx, caplog)
    got = _speedometer_lines(tmx, caplog)
    assert got == want and len(got) == 2
    assert got[0] == "Epoch[0] Batch [2]\tSpeed: S samples/sec\t" \
        "perplexity=%f" % np.exp(2.0)


def test_checkpoint_callbacks_write_what_the_reference_reads(tmp_path):
    sents = _sentences(20, 30, (3, 9))
    tmod, _ = _fit(tmx, sents, 30, [4, 8], ctx=tmx.cpu())
    arg, aux = tmod.get_params()
    prefix = str(tmp_path / "lm")
    tmx.callback.do_checkpoint(prefix, period=2)(1, tmod.symbol, arg, aux)
    tmx.callback.module_checkpoint(tmod, prefix + "-mod")(0)
    for pre, epoch in ((prefix, 2), (prefix + "-mod", 1)):
        sym, args, auxs = jmx.model.load_checkpoint(pre, epoch)
        assert sorted(args) == sorted(arg) and not auxs
        for n in arg:
            assert np.array_equal(args[n].asnumpy(), arg[n].asnumpy())
        assert sym.list_arguments() == \
            tmod._buckets[8].symbol.list_arguments()
    # period 2: epoch index 0 writes nothing
    tmx.callback.do_checkpoint(prefix + "-p", period=2)(0, tmod.symbol,
                                                        arg, aux)
    assert not list(tmp_path.glob("lm-p*"))
