"""`examples/transformer_lm/train.py` on the PyTorch port, with its
defaults (dp 2, tp 2, sp 2, 60 steps of ZeRO-1 Adam on the copy task),
its mesh over [cpu] * 8.  The example stays as it is: the loader
(`tests/test_torch_example_port.py`, which `chip_smoke.py` runs over
[cuda:0] * 8) renames its imports, reads `jax.devices()` and the mesh's
devices as the given list, and places its batches with the port's
`spmd.device_put` and the step's `"data"` layout; each rewrite is
counted.
"""
import pytest
import torch

from test_torch_example_port import (TRANSFORMER_LM_REWRITES,
                                     run_transformer_lm,
                                     transformer_lm_source)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_transformer_lm_converges_on_the_port(capsys):
    run_transformer_lm([], [CPU] * 8)
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "CONVERGED", out
    first, last = (float(x) for x in out[-2].split(":")[1].split("->"))
    assert last < 0.5 * first


def test_the_loader_rewrites_what_it_counts():
    src = transformer_lm_source()
    assert "import jax" not in src and "mxtpu." not in src.replace(
        "mxtpu_torch.", "")
    assert "create_mesh(devices=DEVICES, shape={" in src
    assert sum(TRANSFORMER_LM_REWRITES) == 6


def test_too_few_devices_stop_the_example():
    with pytest.raises(SystemExit, match="need 8 devices"):
        run_transformer_lm([], [CPU] * 4)
