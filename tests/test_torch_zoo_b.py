"""The model zoo families' forward and backward against the JAX
package's (`test_torch_zoo.py`'s docstring says how), split from that
file to keep each under 30 s; the first three families here, the rest
in `test_torch_zoo_e.py`."""
import numpy as np
import pytest

from test_torch_gluon import _x
from test_torch_zoo import SMALL, _zoo, _zoo_parity


@pytest.mark.parametrize("name", sorted(SMALL)[:3])
def test_family_forward_and_backward_match_mxtpu(name):
    side = SMALL[name]
    out = _zoo_parity(lambda mx: getattr(_zoo(mx), name)(classes=10),
                      _x(4, 3, side, side), train=False)
    assert out.shape == (4, 10) and np.isfinite(out).all()
