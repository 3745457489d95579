"""gluon.contrib's layers (`Concurrent`, `HybridConcurrent`,
`Identity`, `SyncBatchNorm`, `PixelShuffle2D`) and a HybridBlock looping
with `F.contrib.foreach`, the rows of `test_torch_gluon.py`'s
`CONTRIB_LAYERS`, against the JAX package's by that file's `_parity`
harness (a relative L2 of 1e-5 of the output, the input and Parameter
gradients and the Parameters, moving statistics included), hybridized
and not."""
import pytest

from test_torch_gluon import CONTRIB_LAYERS, _parity, _x


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("name", sorted(CONTRIB_LAYERS))
def test_layer_matches_the_reference(name, hybridize):
    make, shapes = CONTRIB_LAYERS[name]
    _parity(make, [_x(*s, seed=i + 1) for i, s in enumerate(shapes)],
            hybridize=hybridize, key=("contrib", name))
