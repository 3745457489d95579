"""Shard 1 of the recurrent cells' unrolls of `test_torch_rnn_cell.py`
(its docstring says what each case holds), apart so that each file
stays under 30 s."""
import pytest

from test_torch_rnn_cell import shard, unroll_case


@pytest.mark.parametrize("states", [False, True])
@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("name", shard(1))
def test_unroll_matches_the_reference(name, layout, merge, states):
    unroll_case(name, layout, merge, states)
