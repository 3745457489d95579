"""Loading `examples/image-classification/train_imagenet.py` and its
helper packages (`common`, `symbols`) into the PyTorch port, as
`chip_smoke.py`'s imagenet phase and `tests/test_torch_imagenet.py`
run it; and `examples/transformer_lm/train.py`, as `chip_smoke.py`'s
spmd phase and `tests/test_torch_transformer_lm.py` run it
(`run_transformer_lm`).  The examples stay as they are: their source is read, each
import of the JAX package (indented ones included) is renamed to the
port, `mx.tpu()`/`mx.num_tpus()` become `mx.gpu()`/`mx.num_gpus()`,
`fit.py`'s device list without a TPU (the JAX package's CPU devices)
becomes the CPU, and `util.apply_platform_env` (JAX's platform
settings) does nothing.  The counts of each rewrite are checked, so an
edit of the examples that a rewrite misses fails here.  With
`port=False` the same files load unchanged, for the JAX package's run.

This file imports neither JAX nor the JAX package, and holds no test of
its own.
"""
import contextlib
import re
import sys
import types
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
IMAGENET_DIR = REPO / "examples" / "image-classification"
IMAGENET_SCRIPT = IMAGENET_DIR / "train_imagenet.py"
# each file: (imports of the JAX package, TPU calls, JAX device lists)
IMAGENET_FILES = {"common/util.py": (0, 0, 0), "common/data.py": (4, 0, 0),
                  "common/fit.py": (6, 2, 1), "symbols/zoo.py": (4, 0, 0),
                  "train_imagenet.py": (0, 0, 0)}
_JAX_DEVICES = re.compile(
    r"^(\s*)import jax\n\n(\s*)devs = \[mx\.cpu\(i\) for i in "
    r"range\(len\(jax\.devices\(\)\)\)\]", re.M)


def port_source(rel):
    """The source of ``examples/image-classification/<rel>`` rewritten
    for the port."""
    src = (IMAGENET_DIR / rel).read_text()
    src, n = re.subn(r"^(\s*)(import|from) mxtpu\b", r"\1\2 mxtpu_torch",
                     src, flags=re.M)
    src, m = re.subn(r"\bmx\.(tpu|num_tpus)\(",
                     lambda g: "mx.%s(" % {"tpu": "gpu",
                                           "num_tpus": "num_gpus"}[
                                               g.group(1)], src)
    src, j = _JAX_DEVICES.subn(r"\2devs = [mx.cpu()]", src)
    if (n, m, j) != IMAGENET_FILES[rel]:
        raise AssertionError("%s: %d imports of the JAX package, %d TPU "
                             "calls and %d JAX device lists, not %s"
                             % (rel, n, m, j, IMAGENET_FILES[rel]))
    return src


@contextlib.contextmanager
def imagenet_helpers(port=True):
    """``common`` and ``symbols`` (the port's rewrite, or with ``port``
    False the files as they are) in ``sys.modules`` while the block
    runs; yields them by name.  What stood under those names, and
    ``sys.path``, are put back after."""
    subs = [rel[:-3].replace("/", ".") for rel in IMAGENET_FILES
            if "/" in rel]
    names = ["common", "symbols"] + subs
    saved = {n: sys.modules.get(n) for n in names}
    saved_path = list(sys.path)
    mods = {}
    try:
        for pkg in ("common", "symbols"):
            mod = types.ModuleType(pkg)
            mod.__path__ = [str(IMAGENET_DIR / pkg)]
            mod.__file__ = str(IMAGENET_DIR / pkg / "__init__.py")
            sys.modules[pkg] = mods[pkg] = mod
        for name in subs:
            rel = name.replace(".", "/") + ".py"
            path = IMAGENET_DIR / rel
            src = port_source(rel) if port else path.read_text()
            mod = types.ModuleType(name)
            mod.__file__ = str(path)
            sys.modules[name] = mods[name] = mod
            exec(compile(src, str(path), "exec"), mod.__dict__)
            pkg, _, leaf = name.partition(".")
            setattr(mods[pkg], leaf, mod)
        if port:
            mods["common.util"].apply_platform_env = lambda: None
        yield mods
    finally:
        sys.path[:] = saved_path
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def run_train_imagenet(argv, port=True, trace=True):
    """``train_imagenet.py argv`` run as ``__main__`` (on the port, or
    with ``port`` False on the JAX package); returns the Module that
    ``common.fit.fit`` trained.  ``trace=False`` skips the script's
    trace of the network, for a run that loads a checkpoint
    (``--load-epoch``), whose symbol replaces the traced one."""
    src = port_source("train_imagenet.py") if port \
        else IMAGENET_SCRIPT.read_text()
    with imagenet_helpers(port) as mods:
        if not trace:
            mods["symbols.zoo"].get_symbol = lambda **kwargs: None
        fit = mods["common.fit"]
        trained, real_fit = [], fit.fit

        def fit_and_keep(*args, **kwargs):
            trained.append(real_fit(*args, **kwargs))
            return trained[-1]

        fit.fit = fit_and_keep
        saved_argv = sys.argv
        sys.argv = [str(IMAGENET_SCRIPT)] + [str(a) for a in argv]
        try:
            exec(compile(src, str(IMAGENET_SCRIPT), "exec"),
                 {"__name__": "__main__", "__file__": str(IMAGENET_SCRIPT)})
        finally:
            sys.argv = saved_argv
    return trained[0]


TRANSFORMER_LM = REPO / "examples" / "transformer_lm" / "train.py"
# rewrites of train.py: imports of the JAX package, `import jax`, JAX's
# device list, its device_put, and the mesh's devices
TRANSFORMER_LM_REWRITES = (2, 1, 1, 1, 1)


def transformer_lm_source():
    """The source of `examples/transformer_lm/train.py` rewritten for the
    port: its imports of the JAX package renamed, `import jax` made the
    port's `spmd` (whose `device_put` takes the step's `"data"`
    layout), and `jax.devices()` and the mesh's devices read from the
    global `DEVICES` that :func:`run_transformer_lm` sets."""
    src = TRANSFORMER_LM.read_text()
    src, n = re.subn(r"^(\s*)(import|from) mxtpu\b", r"\1\2 mxtpu_torch",
                     src, flags=re.M)
    src, i = re.subn(r"^(\s*)import jax\n",
                     r"\1from mxtpu_torch.parallel import spmd\n", src,
                     flags=re.M)
    src, d = re.subn(r"\bjax\.devices\(\)", "DEVICES", src)
    src, p = re.subn(r"\bjax\.device_put\(", "spmd.device_put(", src)
    src, m = re.subn(r"\bcreate_mesh\(\{", "create_mesh(devices=DEVICES, "
                     "shape={", src)
    if (n, i, d, p, m) != TRANSFORMER_LM_REWRITES:
        raise AssertionError("transformer_lm/train.py: rewrites %s, not %s"
                             % ((n, i, d, p, m), TRANSFORMER_LM_REWRITES))
    return src


def run_transformer_lm(argv, devices):
    """``train.py argv`` run as ``__main__`` on the port, its mesh over
    ``devices`` (such as ``[torch.device("cpu")] * 8``)."""
    saved_argv = sys.argv
    sys.argv = [str(TRANSFORMER_LM)] + [str(a) for a in argv]
    try:
        exec(compile(transformer_lm_source(), str(TRANSFORMER_LM), "exec"),
             {"__name__": "__main__", "__file__": str(TRANSFORMER_LM),
              "DEVICES": list(devices)})
    finally:
        sys.argv = saved_argv
