"""The two examples this slice unlocks, run on the port on the CPU (as
`test_torch_examples.py`'s docstring says), with the arguments and
assertions `tests/test_examples.py` gives `mxtpu`:
`quantization/quantize_model.py --epochs 2` (train, calibrate, rewrite
to int8 through `mx.contrib.quantization`; its own assertion of more
than 0.9 top-1 agreement with fp32) and `numpy-ops/custom_softmax.py
--epochs 5` (a softmax loss written as an `mx.operator.CustomOp`; its
own assertion of accuracy above 0.9).  Each takes under 10 s alone;
`chip_smoke.py`'s quant phase runs both on the card."""
from test_torch_examples import run_example


def test_quantize_model():
    out = run_example("quantization/quantize_model.py", "--epochs", "2")
    assert "int8" in out and "top-1 agreement" in out


def test_custom_softmax():
    out = run_example("numpy-ops/custom_softmax.py", "--epochs", "5")
    assert "custom softmax" in out
