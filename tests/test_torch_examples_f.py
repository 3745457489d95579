"""The FCN, SVM and OCR CTC examples, run on the port (as
`test_torch_examples.py`'s docstring says), with the arguments and
gates `tests/test_examples.py` gives `mxtpu`: the FCN (on
Conv2DTranspose), the SVM head and the OCR CTC (which ends on its own
assertion, more than 10 of 64 strips read exactly).
`speech_recognition/speech_ctc.py --epochs 12` runs whole on the card
only (`chip_smoke.py`'s seq phase): alone it takes about 35 s on the
CPU; `test_torch_speech.py` holds its first epoch to `mxtpu`'s."""
from test_torch_examples import run_example


def test_fcn_segmentation():
    out = run_example("fcn-xs/fcn_mini.py", "--epochs", "5")
    assert "pixel accuracy" in out


def test_svm_mnist():
    out = run_example("svm_mnist/svm_mnist.py", "--epochs", "3")
    assert "SVM" in out


def test_ocr_ctc():
    out = run_example("ctc/ocr_ctc.py", "--epochs", "8")
    assert "exact-sequence accuracy" in out
