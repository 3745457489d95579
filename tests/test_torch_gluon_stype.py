"""`Parameter(stype="row_sparse")` in the PyTorch port's gluon
(`mxtpu_torch/gluon/parameter.py`), against the JAX package's: the
argument is accepted and stored, and the weight stays dense, as in
`mxtpu/gluon/parameter.py`.  A block whose embedding table has
`stype="row_sparse"` and `grad_stype="row_sparse"` (its gradient a
row-sparse array, updated lazily) and a dense head trains three SGD
steps through `Trainer` in both packages from the same numpy weights;
the outputs and the weights after each step agree within
`test_torch_ops`'s bound (1e-5 relative plus 1e-6 of the largest
magnitude).
"""
import numpy as np
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from test_torch_ops import close

torch.set_num_threads(1)

VOCAB, DIM, CLASSES = 20, 4, 3


def make_net(mx):
    class Net(mx.gluon.Block):
        def __init__(self):
            super().__init__(prefix="net_")
            with self.name_scope():
                self.table = self.params.get(
                    "table", shape=(VOCAB, DIM), stype="row_sparse",
                    grad_stype="row_sparse")
                self.head = mx.gluon.nn.Dense(CLASSES, in_units=2 * DIM)

        def forward(self, x):
            e = mx.nd.Embedding(x, self.table.data(), input_dim=VOCAB,
                                output_dim=DIM, sparse_grad=True)
            return self.head(e.reshape((x.shape[0], -1)))

    return Net()


def run(mx, steps=3):
    rng = np.random.RandomState(0)
    init = {"net_table": rng.uniform(-1, 1, (VOCAB, DIM)),
            "net_dense0_weight": rng.uniform(-0.5, 0.5, (CLASSES, 2 * DIM)),
            "net_dense0_bias": np.zeros(CLASSES)}
    ids = rng.randint(0, VOCAB, (steps, 5, 2)).astype(np.float32)
    labels = rng.randint(0, CLASSES, (steps, 5)).astype(np.float32)
    net = make_net(mx)
    net.initialize(mx.init.Zero(), ctx=mx.cpu())
    params = net.collect_params()
    assert params["net_table"]._stype == "row_sparse"
    for k, p in params.items():
        p.set_data(mx.nd.array(init[k].astype(np.float32), ctx=mx.cpu()))
    trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.5})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    history = []
    for k in range(steps):
        x = mx.nd.array(ids[k], ctx=mx.cpu())
        with mx.autograd.record():
            out = net(x)
            loss = loss_fn(out, mx.nd.array(labels[k], ctx=mx.cpu()))
        loss.backward()
        grad = params["net_table"].grad()
        trainer.step(5)
        history.append((out.asnumpy(), grad.stype,
                        {n: p.data().asnumpy() for n, p in params.items()},
                        params["net_table"].data().stype))
    return history


def test_row_sparse_weight_trains_like_mxtpu():
    for (jo, jg, jw, js), (to, tg, tw, ts) in zip(run(jmx), run(tmx)):
        close(to, jo, "outputs")
        assert tg == jg == "row_sparse" and ts == js == "default"
        for name in jw:
            close(tw[name], jw[name], name)
