"""Shard 6 of the op sweep of `test_torch_ops.py` (its docstring says
what each case holds); the sweep is split so that each file stays
under 30 s."""
import pytest

from test_torch_ops import run_case, shard


@pytest.mark.parametrize("name", shard(6))
def test_op_sweep(name):
    run_case(name)
