"""The examples of `test_torch_examples.py` (whose docstring says how
they run), second part."""
import re

from test_torch_examples import final_metric, run_example


def test_neural_style():
    out = run_example("neural-style/neural_style_mini.py", "--steps", "15")
    m = re.search(r"loss ([0-9.e-]+) -> ([0-9.e-]+)", out)
    assert m and float(m.group(2)) < float(m.group(1))


def test_bi_lstm_sort():
    out = run_example("bi-lstm-sort/bi_lstm_sort.py")
    accs = [float(a) for a in re.findall(r"per-position accuracy ([0-9.]+)",
                                         out)]
    assert accs and accs[-1] > accs[0]


def test_char_cnn():
    out = run_example("cnn_chinese_text_classification/char_cnn.py",
                      "--epochs", "4")
    assert final_metric(out, "FINAL_ACCURACY") > 0.7  # chance 1/3
