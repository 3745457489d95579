"""MobileNet v2 0.25's forward and backward in training mode against
the JAX package's (`test_torch_zoo_c.py`'s docstring says how)."""
from test_torch_zoo_c import training_pass_check


def test_mobilenet_v2_training_pass_matches_mxtpu(tmp_path):
    training_pass_check("mobilenet_v2_0_25", tmp_path)
