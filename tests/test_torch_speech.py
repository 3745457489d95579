"""`examples/speech_recognition/speech_ctc.py` on the port held to the
JAX package's run from the same initial weights.

The example's gate (`FINAL_LER < 0.6` after 12 epochs,
`tests/test_examples.py`) is a draw of the initial weights: `mxtpu`
meets it at 2 of 5 seeds on the CPU, the port at 2 of 8 (not at the
default 5), and from `mxtpu`'s seed-5 weights the port follows
`mxtpu`'s epoch losses to four places for all 12 epochs.  The 12
epochs take minutes under JAX, so this file holds the first epoch:
the example's model (a bidirectional LSTM and a Dense over the band
energies), its batches and its Adam loop over `nd.CTCLoss` with label
lengths, built from the loaded script in both packages, the port's
weights copied from `mxtpu`'s draw.  Each of the 30 steps' losses must
agree within `TOL`, 1e-4 relative (float32 sums in other orders,
carried through Adam; measured about 2e-5 after 60 steps), and the
epoch's loss must fall.  `chip_smoke.py`'s seq phase runs the whole
script on the card.
"""
import os
import re
import types

import numpy as np

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.gluon.parameter import load_numpy
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "examples", "speech_recognition",
                      "speech_ctc.py")
TOL, STEPS, SEED = 1e-4, 30, 5


def _script(package):
    src, n = re.subn(r"^(import|from) mxtpu\b", r"\1 " + package,
                     open(SCRIPT).read(), flags=re.M)
    assert n == 2
    mod = types.ModuleType("speech_ctc_" + package)
    mod.__file__ = SCRIPT
    exec(compile(src, SCRIPT, "exec"), mod.__dict__)
    return mod


def _epoch(mx, weights=None):
    """The example's first epoch from ``weights`` (or from its own draw
    at seed 5): the draw and the steps' losses."""
    ex = _script(mx.__name__)
    mx.random.seed(SEED)
    with mx.sym.NameManager():
        model = ex.AcousticModel()
    model.initialize(ctx=mx.cpu())
    model(mx.nd.zeros((2, ex.MAX_T, ex.N_BANDS), ctx=mx.cpu()))
    if weights is None:
        weights = {k: p.data().asnumpy()
                   for k, p in model.collect_params().items()}
    else:
        load_numpy(model.collect_params(), weights)
    trainer = mx.gluon.Trainer(model.collect_params(), "adam",
                               {"learning_rate": 5e-3})
    rng, losses = np.random.RandomState(SEED), []
    for _ in range(STEPS):
        x, y, _, ylen = ex.make_batch(rng, 16)
        with mx.autograd.record():
            loss = mx.nd.CTCLoss(
                model(mx.nd.array(x, ctx=mx.cpu())),
                mx.nd.array(y, ctx=mx.cpu()),
                mx.nd.array(ylen, ctx=mx.cpu()),
                use_label_lengths=True).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
    return weights, np.array(losses)


def test_the_first_epoch_follows_mxtpu_from_its_weights():
    weights, want = _epoch(jmx)
    _, got = _epoch(tmx, weights)
    err = np.abs(got - want) / np.abs(want)
    assert err.max() <= TOL, (err.argmax(), err.max())
    assert got[-5:].mean() < got[:5].mean()
