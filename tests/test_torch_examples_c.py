"""The examples of `test_torch_examples.py` (whose docstring says how
they run), third part: among them BASELINE config #2's script,
`examples/gluon/image_classification.py`, training MobileNet v2."""
import re

from test_torch_examples import final_metric, run_example


def test_nce_lm():
    out = run_example("nce-loss/nce_lm.py")
    losses = [float(v) for v in re.findall(r"NCE loss ([0-9.]+)", out)]
    assert losses and losses[-1] < losses[0]


def test_binary_rbm():
    out = run_example("restricted-boltzmann-machine/binary_rbm.py",
                      "--epochs", "8")
    assert final_metric(out, "FINAL_RECON_ERROR") < 0.15


def test_vae():
    out = run_example("vae/vae_mnist.py")
    losses = [float(v) for v in re.findall(r"ELBO loss ([0-9.]+)", out)]
    assert losses and losses[-1] < losses[0]
    assert "prior samples decoded: (4, 784)" in out


def test_image_classification_trains_mobilenet_v2():
    out = run_example("gluon/image_classification.py", "--model",
                      "mobilenet_v2_0_25", "--image-shape", "3,32,32")
    assert re.search(r"epoch 0: accuracy=[0-9.]+, [0-9.]+ img/s", out)
