"""`examples/deep-embedded-clustering/dec_mini.py` on the PyTorch port
and on the JAX package from the same initial weights, in this process:
every Uniform draw of its Dense layers is taken, in order, from one
numpy stream in both.  The whole run (pretraining, k-means, the DEC
refinement) must end at the same cluster accuracy.  The script's own
gate depends on the draws (`test_torch_examples.py`'s docstring).
And `examples/rnn/large_word_lm/train.py` run to its end on the port."""
import os
import re
import sys
import types

import numpy as np
import torch

from test_torch_examples import REPO, final_metric

torch.set_num_threads(1)


def _load(port):
    """dec_mini.py as a module of the JAX package or of the port."""
    import mxtpu  # noqa: F401  (the reference must import first here)

    path = os.path.join(REPO, "examples", "deep-embedded-clustering",
                        "dec_mini.py")
    src = open(path).read()
    if port:
        src = re.sub(r"^(import|from) mxtpu\b", r"\1 mxtpu_torch", src,
                     flags=re.M)
    mod = types.ModuleType("dec_mini_" + ("torch" if port else "jax"))
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def _dec_run(port, monkeypatch, capsys):
    """The example's main() with every Uniform draw (its Dense layers'
    initial weights) taken in order from one numpy stream."""
    mod = _load(port)
    rng = np.random.RandomState(0)

    def draw(self, desc, arr):
        arr[:] = rng.uniform(-self.scale, self.scale,
                             arr.shape).astype(np.float32)

    monkeypatch.setattr(mod.mx.initializer.Uniform, "_init_weight", draw)
    monkeypatch.setattr(sys, "argv", ["dec_mini.py"])
    with mod.mx.sym.NameManager():
        mod.main()
    out = capsys.readouterr()
    return out.out + out.err


def test_dec_from_the_same_weights_matches_mxtpu(monkeypatch, capsys):
    from mxtpu_torch import context

    monkeypatch.setattr(context, "default_ctx", lambda: torch.device("cpu"))
    j = _dec_run(False, monkeypatch, capsys)
    t = _dec_run(True, monkeypatch, capsys)
    assert final_metric(t, "FINAL_CLUSTER_ACCURACY") == \
        final_metric(j, "FINAL_CLUSTER_ACCURACY")


def test_large_word_lm_sampled_softmax():
    """`examples/rnn/large_word_lm/train.py` at its defaults (3 epochs),
    its sampled softmax drawing its negatives with
    `nd._sample_unique_zipfian`: the full validation perplexity over the
    10,000 words must fall under the JAX package's gate of 5000
    (`tests/test_examples.py`; uniform is 10,000), and below it epoch
    by epoch."""
    from test_torch_examples import run_example

    out = run_example("rnn/large_word_lm/train.py")
    ppl = [float(p) for p in re.findall(r"full valid ppl ([0-9.]+)", out)]
    assert len(ppl) == 3 and ppl[0] > ppl[1] > ppl[2], ppl
    assert final_metric(out, "FINAL_VALID_PPL") < 5000
