"""`examples/deep-embedded-clustering/dec_mini.py` on the PyTorch port
and on the JAX package from the same initial weights, in this process:
every Uniform draw of its Dense layers is taken, in order, from one
numpy stream in both.  The whole run (pretraining, k-means, the DEC
refinement) must end at the same cluster accuracy.  The script's own
gate depends on the draws (`test_torch_examples.py`'s docstring)."""
import os
import re
import sys
import types

import numpy as np
import torch

from test_torch_examples import REPO, final_metric


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
