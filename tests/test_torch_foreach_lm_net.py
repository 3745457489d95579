"""The word language model written with `sym.contrib.foreach`, for either
package (`mx` is passed in): an Embedding, one foreach over the time
steps whose body is the LSTM layers built from FullyConnected gates in
the fused op's order (i, f, c, o), and a decoder tied to the embedding
under SoftmaxOutput; and the same model over the fused `RNN` op, whose
flat parameter vector is `_rnn_param_concat` of the same named weights.
Both graphs take the same arguments, so weights and gradients compare by
name.  Used by `test_torch_foreach_lm.py` at narrow widths and by
`chip_smoke.py`'s cflow phase at the word LM's (vocabulary 33,278, width
650, 2 layers, bptt 35, batch 32).  Imports numpy only and holds no
test.
"""
import numpy as np

DATA = "data"
LABEL = "softmax_label"


def begin_names(layers):
    return ["l%d_begin_%s" % (l, k) for l in range(layers) for k in "hc"]


def weight_shapes(vocab, width, layers):
    shapes = {"embed_weight": (vocab, width), "decoder_bias": (vocab,)}
    for l in range(layers):
        shapes.update({"l%d_i2h_weight" % l: (4 * width, width),
                       "l%d_h2h_weight" % l: (4 * width, width),
                       "l%d_i2h_bias" % l: (4 * width,),
                       "l%d_h2h_bias" % l: (4 * width,)})
    return shapes


def lm_weights(vocab, width, layers, seed=0, scale=0.1):
    """Uniform(-scale, scale) weights and biases, drawn with numpy in
    sorted name order."""
    rng = np.random.RandomState(seed)
    return {k: rng.uniform(-scale, scale, s).astype(np.float32)
            for k, s in sorted(weight_shapes(vocab, width, layers).items())}


def _head(mx, out, embed_weight, vocab, width):
    """The tied decoder and the loss head over (T, N, width) outputs,
    whose rows are taken batch-major, as the labels' (N, T)."""
    s = mx.sym
    flat = s.Reshape(s.transpose(out, axes=(1, 0, 2)), shape=(-1, width))
    logits = s.FullyConnected(flat, weight=embed_weight,
                              bias=s.var("decoder_bias"), num_hidden=vocab,
                              name="decoder")
    return s.SoftmaxOutput(logits, label=s.Reshape(s.var(LABEL),
                                                   shape=(-1,)),
                           name="softmax")


def _embed(mx, embed_weight, vocab, width):
    """(N, T) ids -> (T, N, width): the Module slices every input along
    its first axis, the batch's."""
    s = mx.sym
    return s.transpose(s.Embedding(s.var(DATA), weight=embed_weight,
                                   input_dim=vocab, output_dim=width,
                                   name="embed"), axes=(1, 0, 2))


def foreach_lm(mx, vocab, width, layers):
    """data (N, T) token ids -> softmax over (N * T, vocab), the LSTM
    layers stepped by one foreach over T."""
    s = mx.sym
    w = {k: s.var(k) for k in weight_shapes(vocab, width, layers)}

    def body(xt, states):
        h, new = xt, []
        for l in range(layers):
            gates = s.FullyConnected(
                h, weight=w["l%d_i2h_weight" % l], bias=w["l%d_i2h_bias" % l],
                num_hidden=4 * width) + s.FullyConnected(
                    states[2 * l], weight=w["l%d_h2h_weight" % l],
                    bias=w["l%d_h2h_bias" % l], num_hidden=4 * width)
            i, f, c, o = s.SliceChannel(gates, num_outputs=4, axis=1)
            cell = s.sigmoid(f) * states[2 * l + 1] + s.sigmoid(i) * s.tanh(c)
            h = s.sigmoid(o) * s.tanh(cell)
            new += [h, cell]
        return h, new

    outs, _ = mx.sym.contrib.foreach(
        body, _embed(mx, w["embed_weight"], vocab, width),
        [s.var(n) for n in begin_names(layers)], name="lstm_loop")
    return _head(mx, outs, w["embed_weight"], vocab, width)


def fused_lm(mx, vocab, width, layers):
    """The same model over the fused RNN op (cuDNN on the card).  The
    weights declare their shapes: nothing solves them back through the
    flat vector's concatenation."""
    s = mx.sym
    shapes = weight_shapes(vocab, width, layers)

    def w(l, n):
        name = "l%d_%s" % (l, n)
        return s.var(name, shape=shapes[name])

    flat = s._rnn_param_concat(
        *[w(l, n) for l in range(layers) for n in ("i2h_weight",
                                                   "h2h_weight")],
        *[w(l, n) for l in range(layers) for n in ("i2h_bias", "h2h_bias")],
        dim=0)
    names = begin_names(layers)
    h0 = s.stack(*[s.var(n) for n in names[0::2]], axis=0)
    c0 = s.stack(*[s.var(n) for n in names[1::2]], axis=0)
    embed_weight = s.var("embed_weight")
    out = s.RNN(_embed(mx, embed_weight, vocab, width), flat, h0, c0,
                state_size=width, num_layers=layers, mode="lstm", name="lstm")
    return _head(mx, out, embed_weight, vocab, width)


def markov_tokens(n, vocab, seed=0):
    """examples/rnn/word_lm/train.py's synthetic corpus: the next token
    (7 t + 3) mod vocab with probability 0.85, else uniform."""
    rng = np.random.RandomState(seed)
    toks = [rng.randint(1, vocab)]
    for _ in range(n - 1):
        toks.append((toks[-1] * 7 + 3) % vocab if rng.rand() < 0.85
                    else rng.randint(0, vocab))
    return np.array(toks, np.float32)


def lm_batches(vocab, bptt, batch, steps, seed=0):
    """(x, y) numpy pairs of (batch, bptt) tokens, one row a sequence,
    y the next tokens."""
    n = (bptt * steps + 1) * batch
    data = markov_tokens(n, vocab, seed).reshape(batch, -1)
    return [(np.ascontiguousarray(data[:, i:i + bptt]),
             np.ascontiguousarray(data[:, i + 1:i + 1 + bptt]))
            for i in range(0, steps * bptt, bptt)]


def lm_module(mx, symbol, vocab, width, layers, bptt, batch, weights, ctx,
              lr=1.0):
    """A Module bound on ``ctx`` from ``weights``; SGD at ``lr`` on the
    mean loss (``rescale_grad`` 1 / (bptt * batch))."""
    names = [DATA] + begin_names(layers)
    mod = mx.mod.Module(symbol, data_names=names, label_names=[LABEL],
                        context=ctx)
    mod.bind(data_shapes=[(DATA, (batch, bptt))] +
             [(n, (batch, width)) for n in names[1:]],
             label_shapes=[(LABEL, (batch, bptt))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in weights.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": lr, "rescale_grad": 1.0 / (bptt * batch)})
    return mod


def lm_data_batch(mx, x, y, width, layers, ctx):
    zeros = np.zeros((x.shape[0], width), np.float32)
    return mx.io.DataBatch(
        data=[mx.nd.array(x, ctx=ctx)] +
        [mx.nd.array(zeros, ctx=ctx) for _ in begin_names(layers)],
        label=[mx.nd.array(y, ctx=ctx)])


def cross_entropy(probs, y):
    """The mean of -log p(label) over the (N * T, vocab) softmax rows."""
    p = np.asarray(probs, np.float64)
    idx = np.asarray(y).reshape(-1).astype(np.int64)
    return float(-np.log(np.maximum(p[np.arange(len(idx)), idx],
                                    1e-30)).mean())
