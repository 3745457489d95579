"""The norms, activations, resizes, Sequence ops and small contrib ops
of `test_torch_nn_ops.py` (`OPS`; its docstring says what each holds),
apart so that each file stays under 30 s."""
import pytest

from test_torch_nn_ops import OPS, check_case


@pytest.mark.parametrize("case", sorted(OPS))
def test_op(case):
    check_case(case)
