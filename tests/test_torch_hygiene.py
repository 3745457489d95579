"""Rules of the PyTorch port that no parity test covers.

* `mxtpu_torch/` and `chip_smoke.py` import neither JAX nor the JAX
  package (`mxtpu`): the port runs where JAX is not installed.
* Entry points called without a device run on the card, and raise when
  there is none instead of carrying on quietly on the CPU.
* `chip_smoke.py` fails, and prints no result, without a card.
"""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxtpu_torch as tmx
from mxtpu_torch import context
from mxtpu_torch.base import MXNetError
from mxtpu_torch.parallel import mesh as tmesh
from mxtpu_torch.parallel import transformer as ttf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|mxtpu)(?![\w])|from\s+(jax|mxtpu)(?![\w])"
    r"|import\s+[\w.]+\s*,\s*(jax|mxtpu)(?![\w]))", re.M)


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "mxtpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax_and_no_mxtpu():
    files = _port_sources()
    assert len(files) >= 10
    bad = []
    for path in files:
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                bad.append("%s: %s" % (os.path.relpath(path, REPO),
                                       m.group(0).strip()))
    assert not bad, bad


def test_the_import_check_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import mxtpu as mx",
                 "from mxtpu.parallel import transformer",
                 "  import jax.numpy as jnp", "import os, jax"):
        assert _FORBIDDEN.search(line), line
    for line in ("import mxtpu_torch", "from mxtpu_torch.base import x",
                 "from .parallel import transformer", "import jaxlike"):
        assert not _FORBIDDEN.search(line), line


def test_importing_the_port_loads_no_jax():
    code = ("import sys, mxtpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'mxtpu' "
            "or m.startswith('mxtpu.')]; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_gluon_loads_no_jax():
    code = ("import sys, mxtpu_torch.gluon; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'mxtpu' "
            "or m.startswith('mxtpu.')]; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_without_a_device_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttf.TransformerConfig(vocab=16, d_model=16, n_heads=2,
                                n_layers=1, d_ff=32, max_len=8,
                                dtype="float32")
    assert context.default_ctx() == torch.device("cuda", 0)
    for call in (lambda: ttf.init_params(cfg),
                 lambda: ttf.make_forward(cfg),
                 lambda: ttf.params_from_jax({}, cfg),
                 lambda: ttf.init_opt_state(cfg),
                 lambda: ttf.make_train_step(cfg),
                 lambda: ttf.make_train_step(cfg, optimizer="adam"),
                 lambda: ttf.make_fused_train_steps(cfg, 2),
                 lambda: tmesh.create_mesh(),
                 lambda: context.resolve("cuda")):
        with pytest.raises(MXNetError, match="no CUDA device"):
            call()
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=2, name="fc"), name="softmax")
    for call in (lambda: tmx.nd.zeros((2,)),
                 lambda: tmx.nd.ones((2,)),
                 lambda: tmx.nd.array(np.zeros(2)),
                 lambda: tmx.random.uniform(shape=(2,)),
                 lambda: tmx.mod.Module(net),
                 lambda: net.simple_bind(data=(2, 3), softmax_label=(2,))):
        with pytest.raises(MXNetError, match="no CUDA device"):
            call()
    assert context.current_context() == torch.device("cuda", 0)
    assert context.resolve("cpu") == torch.device("cpu")
    assert context.gpu(1) == torch.device("cuda", 1)
    with pytest.raises(MXNetError, match="unsupported device"):
        context.resolve("meta")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    """Run with no arguments, from the repo root and from a
    directory that holds chip_smoke.py and nothing else: it must exit
    non-zero and print no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
