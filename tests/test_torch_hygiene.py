"""Rules of the PyTorch port that no parity test covers.

* `mxtpu_torch/` and `chip_smoke.py` import neither JAX nor the JAX
  package (`mxtpu`): the port runs where JAX is not installed.
* Entry points called without a device run on the card, and raise when
  there is none instead of carrying on quietly on the CPU.
* `chip_smoke.py` fails, and prints no result, without a card.
* The DataLoader's process workers run only numpy: nothing they call
  touches torch, so no CUDA state reaches a forked child.
* Importing the port in a process whose `MXTPU_ROLE` is `server`
  starts no role; a distributed store with no scheduler to reach
  raises a typed error within its connect budget, and does not hang.
* Every port test file that imports torch or the port calls
  `torch.set_num_threads(1)` at import: small ops on torch's default
  intra-op threads, beside JAX's pool and other pytest workers, run
  many times slower.
"""
import ast
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mxtpu_torch as tmx
from mxtpu_torch import _ps, context
from mxtpu_torch.base import MXNetError, PSConnectError
from mxtpu_torch.parallel import mesh as tmesh
from mxtpu_torch.parallel import transformer as ttf

torch.set_num_threads(1)

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


def test_entry_points_without_a_device_need_a_card(monkeypatch, tmp_path):
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
                 lambda: ttf.make_fused_train_steps(cfg, None, 2),
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
    libsvm = tmp_path / "d.libsvm"
    libsvm.write_text("1 0:1.5 3:2.0\n0 2:1.0\n")
    for call in (lambda: tmx.nd.sparse.zeros("row_sparse", (4, 2)),
                 lambda: tmx.nd.sparse.zeros("csr", (4, 2)),
                 lambda: tmx.nd.sparse.csr_matrix(
                     ([1.0], [0], [0, 1]), shape=(1, 4)),
                 lambda: tmx.nd.sparse.csr_matrix(np.eye(2)),
                 lambda: tmx.io.LibSVMIter(data_libsvm=str(libsvm),
                                           data_shape=(4,),
                                           batch_size=2).next(),
                 lambda: tmx.kv.create("local")):
        with pytest.raises(MXNetError, match="no CUDA device"):
            call()
    assert context.current_context() == torch.device("cuda", 0)
    assert context.resolve("cpu") == torch.device("cpu")
    assert context.gpu(1) == torch.device("cuda", 1)
    with pytest.raises(MXNetError, match="unsupported device"):
        context.resolve("meta")


def test_the_import_check_covers_the_op_corpus_and_the_zoo():
    names = {os.path.relpath(p, REPO) for p in _port_sources()}
    for mod in ("ops/elemwise", "ops/reduce", "ops/matrix", "ops/init_ops",
                "ops/indexing", "ops/nn", "ndarray/ndarray", "symbol/symbol",
                "autograd", "name", "gluon/model_zoo/vision/__init__",
                "gluon/model_zoo/vision/alexnet",
                "gluon/model_zoo/vision/densenet",
                "gluon/model_zoo/vision/inception",
                "gluon/model_zoo/vision/mobilenet",
                "gluon/model_zoo/vision/squeezenet",
                "gluon/model_zoo/vision/vgg"):
        assert os.path.join("mxtpu_torch", mod + ".py") in names, mod


def test_the_import_check_covers_the_optimizers_samplers_and_io():
    names = {os.path.relpath(p, REPO) for p in _port_sources()}
    for mod in ("ops/optimizer_ops", "ops/random_ops", "optimizer/optimizer",
                "random", "initializer", "metric", "io/io",
                "module/module", "model"):
        assert os.path.join("mxtpu_torch", mod + ".py") in names, mod
    # the loader of train_imagenet.py that chip_smoke.py imports
    with open(os.path.join(REPO, "tests", "test_torch_example_port.py")) as f:
        assert not _FORBIDDEN.search(f.read())


def test_the_import_check_covers_slice_14():
    names = {os.path.relpath(p, REPO) for p in _port_sources()}
    for mod in ("ops/linalg", "gluon/rnn/rnn_cell", "gluon/rnn/__init__",
                "gluon/nn/conv_layers", "gluon/nn/basic_layers",
                "gluon/loss", "symbol/op_meta"):
        assert os.path.join("mxtpu_torch", mod + ".py") in names, mod
    # the DCGAN's nets and loop, which chip_smoke.py imports
    with open(os.path.join(REPO, "tests", "test_torch_dcgan_net.py")) as f:
        assert not _FORBIDDEN.search(f.read())


def test_the_import_check_covers_slice_15():
    names = {os.path.relpath(p, REPO) for p in _port_sources()}
    for mod in ("control_flow", "ops/control_flow", "ops/image",
                "telemetry", "gluon/data/__init__", "gluon/data/dataset",
                "gluon/data/sampler", "gluon/data/dataloader",
                "gluon/data/vision/datasets", "gluon/data/vision/transforms",
                "gluon/contrib/__init__", "gluon/contrib/data/sampler",
                "gluon/contrib/nn/basic_layers", "gluon/contrib/rnn/rnn_cell",
                "gluon/contrib/rnn/conv_rnn_cell"):
        assert os.path.join("mxtpu_torch", mod + ".py") in names, mod


def test_the_import_check_covers_slice_17():
    names = {os.path.relpath(p, REPO) for p in _port_sources()}
    for mod in ("ops/quantization", "ops/dgl", "ops/custom_op", "operator",
                "subgraph", "contrib/__init__", "contrib/quantization"):
        assert os.path.join("mxtpu_torch", mod + ".py") in names, mod


def test_the_import_check_covers_slice_19():
    names = {os.path.relpath(p, REPO) for p in _port_sources()}
    for mod in ("parallel/mesh", "parallel/spmd", "parallel/collectives",
                "parallel/ring_attention", "parallel/transformer",
                "sharding/__init__", "sharding/plan", "sharding/reshard",
                "sharding/zero1"):
        assert os.path.join("mxtpu_torch", mod + ".py") in names, mod


def test_the_mesh_entry_points_need_a_card(monkeypatch):
    """Without a device the mesh and the sharded entry points run on the
    card, and raise when there is none, whatever the default context."""
    from mxtpu_torch.parallel import collectives

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttf.TransformerConfig(vocab=16, d_model=16, n_heads=2,
                                n_layers=1, d_ff=32, max_len=8,
                                dtype="float32")
    state = {"m": {}, "v": {}, "t": 0.0}
    for call in (lambda: tmesh.create_mesh({"dp": 2}),
                 lambda: ttf.opt_state_from_jax(state, cfg),
                 lambda: ttf.make_fused_train_steps(cfg, None, 2),
                 lambda: ttf.make_train_step(cfg, None, optimizer="adam"),
                 lambda: ttf.init_opt_state(cfg, None)):
        with pytest.raises(MXNetError, match="no CUDA device"):
            call()
    monkeypatch.setattr(context, "default_ctx", lambda: torch.device("cpu"))
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmesh.create_mesh()
    with pytest.raises(MXNetError, match="no mesh"):
        collectives.all_reduce(np.zeros((2, 2), np.float32))


def _imports_torch(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        if any(m.split(".")[0] in ("torch", "mxtpu_torch") for m in mods):
            return True
    return False


def _sets_one_thread(tree):
    """A module-level ``torch.set_num_threads(1)`` statement."""
    for node in tree.body:
        call = node.value if isinstance(node, ast.Expr) else None
        if isinstance(call, ast.Call) \
                and isinstance(call.func, ast.Attribute) \
                and call.func.attr == "set_num_threads" \
                and isinstance(call.func.value, ast.Name) \
                and call.func.value.id == "torch" \
                and [getattr(a, "value", None) for a in call.args] == [1]:
            return True
    return False


def test_every_port_test_file_sets_one_torch_thread():
    files = sorted(f for f in os.listdir(os.path.join(REPO, "tests"))
                   if f.startswith("test_torch_") and f.endswith(".py"))
    assert len(files) > 80
    bad = []
    for f in files:
        with open(os.path.join(REPO, "tests", f)) as fh:
            tree = ast.parse(fh.read())
        if _imports_torch(tree) and not _sets_one_thread(tree):
            bad.append(f)
    assert not bad, bad


def test_the_thread_check_catches_what_it_should():
    for src, want in (("import torch\n", True),
                      ("from mxtpu_torch import nd\n", True),
                      ("def f():\n    import torch\n", True),
                      ("import numpy\n", False),
                      ("X = 'import torch'\n", False)):
        assert _imports_torch(ast.parse(src)) == want, src
    assert _sets_one_thread(ast.parse("import torch\n"
                                      "torch.set_num_threads(1)\n"))
    for src in ("import torch\n",
                "import torch\ndef f():\n    torch.set_num_threads(1)\n",
                "import torch\ntorch.set_num_threads(8)\n",
                'W = """\ntorch.set_num_threads(1)\n"""\n'):
        assert not _sets_one_thread(ast.parse(src)), src


def _names_reached(fn, module, seen=None):
    """The global names that ``fn`` and the functions of ``module`` it
    calls refer to, followed through the module."""
    seen = set() if seen is None else seen
    names = set()
    for name in fn.__code__.co_names:
        names.add(name)
        target = getattr(module, name, None)
        if callable(target) and getattr(target, "__module__", None) == \
                module.__name__ and hasattr(target, "__code__") \
                and name not in seen:
            seen.add(name)
            names |= _names_reached(target, module, seen)
    return names


def test_the_process_workers_path_touches_no_torch():
    """What a forked worker runs (``_worker_init``, ``_worker_fn`` and
    the numpy batchify they reach) names nothing of torch and makes no
    array: with CUDA up in the parent, a child that touched CUDA would
    fail.  ``test_torch_gluon_data_b.py`` runs such workers and checks
    that CUDA is not initialized in the parent after them."""
    from mxtpu_torch.gluon.data import dataloader as dl

    reached = set()
    for fn in (dl._worker_init, dl._worker_fn, dl._np_batchify):
        reached |= _names_reached(fn, dl)
    forbidden = {"torch", "nd_array", "default_batchify_fn", "_to_nd",
                 "stack", "array", "cuda"}
    assert not reached & forbidden, reached & forbidden


def test_the_cells_begin_states_need_a_card(monkeypatch):
    """A cell's ``begin_state`` without ``ctx=`` is on the card, as
    ``nd.zeros`` is; an unroll of arrays starts on their device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = tmx.gluon.rnn.LSTMCell(3, input_size=2)
    with pytest.raises(MXNetError, match="no CUDA device"):
        cell.begin_state(2)
    cell.initialize(ctx=tmx.cpu())
    outs, states = cell.unroll(2, tmx.nd.zeros((4, 2, 2), ctx=tmx.cpu()),
                               layout="NTC")
    assert [s.shape for s in states] == [(4, 3), (4, 3)]


def test_the_samplers_and_the_optimizer_states_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = tmx.nd.zeros((2,), ctx=tmx.cpu())
    upd = tmx.optimizer.get_updater(tmx.optimizer.create("nag",
                                                         momentum=0.9))
    upd(0, tmx.nd.ones((2,), ctx=tmx.cpu()), w)
    states = upd.get_states()
    for call in (lambda: tmx.random.gamma(2.0, shape=(2,)),
                 lambda: tmx.random.randint(0, 5, shape=(2,)),
                 lambda: tmx.random.poisson(3.0, shape=(2,)),
                 lambda: tmx.nd._sample_unique_zipfian(range_max=9,
                                                       shape=(2,)),
                 lambda: tmx.io.NDArrayIter(np.zeros((4, 2)),
                                            batch_size=2).next(),
                 lambda: upd.set_states(states)):
        with pytest.raises(MXNetError, match="no CUDA device"):
            call()
    upd.set_states(states, ctx=tmx.cpu())


def _first_forward(net):
    """``initialize()`` with no device, then a forward: the deferred
    Parameters take their device when the forward gives their shapes."""
    net.initialize()
    net(tmx.nd.zeros((1, 3, 32, 32), ctx=tmx.cpu()))


def test_the_zoo_and_the_creation_functions_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vision = tmx.gluon.model_zoo.vision
    for call in (lambda: _first_forward(vision.get_model("mobilenetv2_1.0")),
                 lambda: vision.densenet121().initialize(),
                 lambda: tmx.nd.arange(3),
                 lambda: tmx.nd.eye(2),
                 lambda: tmx.nd.empty((2,)),
                 lambda: tmx.nd.from_numpy(np.zeros(2))):
        with pytest.raises(MXNetError, match="no CUDA device"):
            call()


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


def test_importing_the_port_as_a_server_role_starts_nothing():
    env = dict(os.environ, MXTPU_ROLE="server", MXTPU_PS_ROOT_PORT="1",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", "import mxtpu_torch"],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out + err


def test_a_dist_store_without_a_scheduler_raises_a_typed_error(monkeypatch):
    # a port that is bound and not listening refuses every connection
    with socket.socket() as closed:
        closed.bind(("127.0.0.1", 0))
        monkeypatch.setenv("MXTPU_PS_ROOT_URI", "127.0.0.1")
        monkeypatch.setenv("MXTPU_PS_ROOT_PORT",
                           str(closed.getsockname()[1]))
        monkeypatch.delenv("MXTPU_PS_REPLICATION", raising=False)
        monkeypatch.setattr(_ps, "_CONNECT_TIMEOUT", 2.0)
        t0 = time.monotonic()
        with pytest.raises(PSConnectError, match="within 2.0s"):
            tmx.kv.create("dist_sync", ctx=tmx.cpu())
        assert time.monotonic() - t0 < 10
