"""The examples this slice unlocks, run on the PyTorch port on the CPU.

Each script runs in a subprocess of its own (`run_example`) as a user
would run it after `import mxtpu_torch as mx`: its `import mxtpu` lines
renamed to the port, `mx.tpu()`/`mx.num_tpus()` to `mx.gpu()`/
`mx.num_gpus()` (the port's card), and `context.default_ctx` patched to
the CPU in the worker, since nothing in the port falls back to the CPU
by itself.  The arguments are those `tests/test_examples.py` gives
`mxtpu`, and where that file sets a `FINAL_*` gate the port meets it.
Scripts that file does not run keep their defaults.  The subprocesses
follow ROADMAP's rules: a session of their own, a timeout that kills
the group, one thread.

`dec_mini.py`'s gate (cluster accuracy > 0.6) is a property of the
draws of the initial weights, not of the code: over seeds 1-4 the JAX
package reads 0.70 / 0.50 / 0.51 / 0.50 and the port 0.75 / 0.75 / 0.50
/ 0.51, and at the default seed 0.75 and 0.50.  So the script runs to
its end here, and `test_torch_examples_d.py` holds
its whole run to the JAX package's from the same initial weights.

The examples are split over this file and `test_torch_examples_b.py`,
`_c.py` and `_d.py`, each under 30 s.
"""
import os
import re
import signal
import subprocess
import sys


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import re, sys, torch
torch.set_num_threads(1)
from mxtpu_torch import context
context.default_ctx = lambda: torch.device("cpu")
path = sys.argv[1]
src, n = re.subn(r"^(import|from) mxtpu\b", r"\1 mxtpu_torch",
                 open(path).read(), flags=re.M)
assert n >= 1, path
src = src.replace("mx.tpu()", "mx.gpu()").replace("mx.num_tpus()",
                                                  "mx.num_gpus()")
sys.argv = sys.argv[1:]
exec(compile(src, path, "exec"), {"__name__": "__main__",
                                  "__file__": path})
"""


def run_example(relpath, *args, timeout=120):
    """The example's output (stdout and stderr) from its run on the
    port; fails unless it exits 0."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", WORKER,
         os.path.join(REPO, "examples", relpath)] + list(args), cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-2000:] + err[-2000:]
    return out + err


def final_metric(out, tag):
    m = re.search(r"^%s ([-0-9.e]+)" % tag, out, re.M)
    assert m, "no %s line" % tag
    return float(m.group(1))


def test_fgsm_adversary():
    out = run_example("adversary/fgsm_mnist.py", "--epochs", "1",
                      "--batch-size", "32")
    assert "FGSM" in out


def test_capsnet():
    out = run_example("capsnet/capsnet_mini.py", "--epochs", "4")
    assert final_metric(out, "FINAL_ACCURACY") > 0.55  # chance 1/3


def test_dec_runs_to_its_end():
    out = run_example("deep-embedded-clustering/dec_mini.py")
    assert 0.0 <= final_metric(out, "FINAL_CLUSTER_ACCURACY") <= 1.0
