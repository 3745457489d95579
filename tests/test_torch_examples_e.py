"""The examples on Conv2DTranspose, run on the port (as
`test_torch_examples.py`'s docstring says), with the arguments and
gates `tests/test_examples.py` gives `mxtpu`; `gan/dcgan_mnist.py`,
which that file does not run, at its defaults and on its own final
assertion."""
from test_torch_examples import final_metric, run_example


def test_dcgan_mnist():
    out = run_example("gan/dcgan_mnist.py")
    assert "generated sample range" in out


def test_conv_autoencoder():
    out = run_example("autoencoder/conv_autoencoder.py", "--epochs", "2",
                      "--batch-size", "64")
    assert "reconstruction loss" in out


def test_vae_gan():
    out = run_example("vae-gan/vae_gan_mini.py", "--epochs", "1")
    assert final_metric(out, "FINAL_PIXEL_RECON") < 0.2
