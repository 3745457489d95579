"""MobileNet v2 0.25's three float32 Trainer steps against the JAX
package's (`test_torch_zoo_train.py` says how they run, and why
ResNet-18's `STEP_TOL` does not fit them).

The port's float64 run stands in for the exact steps here:
`test_torch_zoo_train.py` holds it within 1e-8 of the reference's own
float64 run at every step.  Each step's losses, parameters and moving
statistics (each group as one relative L2) must lie as close to the
reference's float32 as twice the reference's own distance from float64
(plus 1e-6), and that distance must stay within `OWN_CAP`, three
times its reading on the CPU (that file's table: loss / parameters /
moving stats 1.1e-5 / 1.9e-3 / 1.7e-6 after step 1, 0.40 / 4.9e-2 /
1.3e-2 after step 2, 0.22 / 9.5e-2 / 2.4e-2 after step 3), so that
the bound cannot grow with an error of the port's.
"""
import numpy as np

from test_torch_zoo_train import (STEPS, _distance, case, port_steps,
                                  reference_steps)

OWN_CAP = [(3.3e-5, 5.7e-3, 5.1e-6), (1.2, 0.15, 3.9e-2),
           (0.66, 0.29, 7.2e-2)]


def test_mobilenet_v2_float32_steps_match_the_reference():
    x, y, init = case()
    (tl, tp), (el, ep) = port_steps(x, y, init), port_steps(x, y, init,
                                                            "float64")
    jl, jp = reference_steps(x, y, init)
    for step in range(STEPS):
        port = _distance(tl[step], tp[step], jl[step], jp[step])
        own = _distance(jl[step], jp[step], el[step], ep[step])
        for what, p, r, cap in zip(("loss", "parameters", "moving stats"),
                                   port, own, OWN_CAP[step]):
            assert r <= cap, (step + 1, what, "the reference's own", r)
            assert p <= 2 * r + 1e-6, (step + 1, what, p, r)
    assert all(np.isfinite(l).all() for l in tl)
