"""The PyTorch port's CTCLoss (`mxtpu_torch/ops/nn.py`) against the JAX
package's (`mxtpu/ops/nn.py`, `optax.ctc_loss`), with
`test_torch_nn_ops.py`'s harness and bounds (the same inputs and head
gradients through `jax.vjp` and torch autograd; within 1e-5 of the
value plus 1e-6 of the largest): the four names, under both blank
conventions, with and without data and label lengths, with a -1 pad
that the "last" convention reads as a label, and with a row longer
than its frames.  That row is float32 rounding at magnitude 1e5 (its
cost is about `log_epsilon`, where one ulp is 0.0078 and moves a
path's weight by 0.8%): the reference's own float32 gradient lies
4.9e-3 (relative L2) from its float64 value, so the row's gradient is
held to `INFEASIBLE_TOL` (2e-2) and its cost to 1e-6.
"""
import numpy as np
import pytest
import torch

from mxtpu_torch.ops import registry as treg
from test_torch_nn_ops import check, port, reference
from test_torch_op_cases import _a, _f

torch.set_num_threads(1)

INFEASIBLE_TOL = 2e-2

# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------

FIRST = _f([[1, 2, 2, 0], [3, 0, 0, 0], [4, 1, 3, 2]])
LAST = _f([[0, 1, 1, 4], [2, 4, 4, 4], [3, 0, 2, 1]])
CTC = {
    "first": ([FIRST], {}),
    "last": ([LAST], dict(blank_label="last")),
    "first_data_lengths": ([FIRST, _f([8, 5, 7])],
                           dict(use_data_lengths=True)),
    "last_label_lengths": ([LAST, _f([2, 1, 3])], dict(
        blank_label="last", use_label_lengths=True)),
    "first_both_lengths": ([FIRST, _f([6, 8, 7]), _f([3, 1, 4])], dict(
        use_data_lengths=True, use_label_lengths=True)),
    # a -1 pad is a label under "last" (the reference's one-hot of -1 is
    # zero: it costs nothing)
    "last_minus_one_pad": ([_f([[0, 1, -1, -1], [2, 3, 4, 4],
                                [1, 1, 2, -1]])], dict(blank_label="last")),
}


@pytest.mark.parametrize("alias", ["CTCLoss", "ctc_loss", "_contrib_CTCLoss",
                                   "_contrib_ctc_loss"])
@pytest.mark.parametrize("case", sorted(CTC))
def test_ctc(case, alias):
    labels, attrs = CTC[case]
    out, _ = check(alias, [_a(8, 3, 5, lo=-2, hi=2)] + labels, attrs)
    assert np.isfinite(out[0]).all() and out[0].shape == (3,)


def test_ctc_of_a_row_longer_than_its_frames_is_finite():
    """Four labels in three frames: the reference's finite cost (about
    1e5, from ``log_epsilon``) and its gradient; the other row as
    exact as any."""
    inputs = [_a(3, 2, 5, lo=-2, hi=2), _f([[1, 2, 3, 4], [1, 0, 0, 0]])]
    jo, jg = reference("CTCLoss", inputs, {}, (0,))
    to, tg = port("CTCLoss", inputs, {}, (0,))
    assert 9e4 < to[0][0] < 2e5 and np.isfinite(tg[0]).all()
    np.testing.assert_allclose(to[0], jo[0], rtol=1e-6)
    for row, tol in ((0, INFEASIBLE_TOL), (1, 1e-5)):
        t, j = tg[0][:, row], jg[0][:, row]
        assert np.linalg.norm(t - j) <= tol * np.linalg.norm(j), row


def test_ctc_matches_the_library_on_feasible_rows():
    """The port's own recursion (the reference's) and ``F.ctc_loss``
    agree where both apply."""
    from mxtpu_torch.ops.nn import _ctc_recursion

    x = torch.tensor(_a(8, 3, 5, lo=-2, hi=2))
    lp = torch.log_softmax(x, -1)
    labels = torch.tensor(FIRST).long()
    lib = treg.get_op("CTCLoss").fn(x, torch.tensor(FIRST))
    rec = _ctc_recursion(lp.transpose(0, 1), torch.zeros(3, 8, dtype=bool),
                         labels, labels <= 0, 0)
    np.testing.assert_allclose(lib.numpy(), rec.numpy(), rtol=1e-5)
