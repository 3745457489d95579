"""The PyTorch port's 3-D convolutional recurrent cells
(`mxtpu_torch/gluon/contrib/rnn/conv_rnn_cell.py`) against the JAX
package's: `test_torch_gluon_contrib.py`'s unroll harness and bound
(a relative L2 of 1e-5), split off to keep each file under 30 s."""
import pytest

from test_torch_gluon_contrib import shard, unroll_case


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("name", shard(2))
def test_cell_unroll_matches_the_reference(name, layout):
    unroll_case(name, layout)
