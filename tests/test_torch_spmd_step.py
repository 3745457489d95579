"""The PyTorch port's sharded TransformerLM step
(`mxtpu_torch/parallel/transformer.py` over a mesh: `make_train_step`,
`make_fused_train_steps`, `init_opt_state`, `params_from_jax`) against
the JAX package's shard_map step (`mxtpu/parallel/transformer.py`) on the
conftest's 8 CPU devices, the port's mesh over [cpu] * n.  This file:
the mesh {dp 2, tp 2, sp 2}, SGD and ZeRO-1 Adam, and K = 3 fused steps;
`_b` and `_c` hold the other meshes and use the helpers here.

Weights are drawn by `mxtpu` and carried over with `params_from_jax`;
tokens and labels come from numpy.  Bounds (float32): the loss and
every SGD parameter at rtol 2e-4 / atol 2e-5, as `dryrun_parity` holds
the loss; the gathered Adam moments at rtol 2e-4 with an atol of 2e-5 of
each moment's largest element (the gradients agree to about 1e-6 of
their largest, `tests/test_torch_train.py`).  Adam's first update is
about lr * sign(g), and lr * g / (|g| + eps) where |g| is near eps, so
a weight whose gradient is that small moves by another amount in each
package: the Adam parameters are held to 2 * lr, with at most 0.1% of
them more than 1e-4 apart.
"""
import numpy as np
import pytest
import torch

import jax

import mxtpu.parallel as jpar
from mxtpu.parallel import transformer as jtf
from mxtpu_torch.parallel import mesh as tmesh
from mxtpu_torch.parallel import spmd
from mxtpu_torch.parallel import transformer as ttf

torch.set_num_threads(1)

CPU = torch.device("cpu")
LR = 1e-2
B, T = 8, 32
F32_TOL = dict(rtol=2e-4, atol=2e-5)


def cfg_kw(pp=1, **over):
    kw = dict(vocab=32, d_model=64, n_heads=4, n_layers=2 * pp, d_ff=128,
              max_len=T, dtype="float32")
    kw.update(over)
    return kw


def meshes(**axes):
    shape = {a: 1 for a in ("dp", "pp", "tp", "sp", "ep")}
    shape.update(axes)
    n = int(np.prod(list(shape.values())))
    return (jpar.create_mesh(shape, devices=jax.devices()[:n]),
            tmesh.create_mesh(shape, devices=[CPU] * n))


def data(seed=0, shape=(B, T), vocab=32):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, shape).astype(np.int32),
            rng.randint(0, vocab, shape).astype(np.int32))


def per_device_bytes(tree, mesh):
    """Bytes a port tree holds at each coordinate."""
    total = [0] * mesh.size
    for s in tree.values():
        for c, b in enumerate(s.device_nbytes()):
            total[c] += b
    return total


def jax_device_bytes(tree, jmesh):
    """Bytes a JAX tree holds on each device, in the mesh's row-major
    order."""
    by_id = {}
    for arr in tree.values():
        for sh in arr.addressable_shards:
            by_id[sh.device.id] = by_id.get(sh.device.id, 0) + sh.data.nbytes
    return [by_id[d.id] for d in jmesh.devices.flat]


def run_both(axes, optimizer, n_micro=1, steps=1, **over):
    """One config's step in both packages, `steps` times on one batch:
    a list per step of (JAX loss, port loss, JAX params, port params,
    JAX moments, port moments), all gathered to float32 numpy; and the
    final (JAX state, port state) for the memory checks."""
    jm, tm = meshes(**axes)
    pp = tm.shape["pp"]
    jcfg = jtf.TransformerConfig(**cfg_kw(pp, **over))
    tcfg = ttf.TransformerConfig(**cfg_kw(pp, **over))
    jp = jtf.init_params(jcfg, jm, seed=0)
    tp = ttf.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             tcfg, tm)
    tok, lab = data(vocab=jcfg.vocab)
    jstep, sh = jtf.make_train_step(jcfg, jm, n_micro=n_micro, lr=LR,
                                    optimizer=optimizer)
    tstep, info = ttf.make_train_step(tcfg, tm, n_micro=n_micro, lr=LR,
                                      optimizer=optimizer)
    assert info["mesh"] is tm and info["data"].spec == ("dp", "sp")
    jtok, jlab = (jax.device_put(a, sh["data"]) for a in (tok, lab))
    ttok, tlab = (spmd.device_put(a, info["data"]) for a in (tok, lab))
    jo = to = None
    if optimizer == "adam":
        jo, to = jtf.init_opt_state(jcfg, jm), ttf.init_opt_state(tcfg, tm)
    out = []
    for _ in range(steps):
        if optimizer == "sgd":
            jp, jl = jstep(jp, jtok, jlab)
            tp, tl = tstep(tp, ttok, tlab)
        else:
            jp, jo, jl = jstep(jp, jo, jtok, jlab)
            tp, to, tl = tstep(tp, to, ttok, tlab)
        moms = (None, None) if jo is None else (
            {(m, k): np.asarray(jo[m][k]) for m in "mv" for k in jo[m]},
            {(m, k): spmd.gather(to[m][k]).numpy() for m in "mv"
             for k in to[m]})
        out.append((float(jl), tl.item(),
                    {k: np.asarray(v, np.float32) for k, v in jp.items()},
                    {k: spmd.gather(v).float().numpy()
                     for k, v in tp.items()}) + moms)
    return out, (jm, jo), (tm, to)


def check_sgd(runs):
    for jl, tl, jp, tp, _, _ in runs:
        np.testing.assert_allclose(tl, jl, **F32_TOL)
        for name in jp:
            np.testing.assert_allclose(tp[name], jp[name], err_msg=name,
                                       **F32_TOL)


def check_adam(runs):
    for jl, tl, jp, tp, jm, tm in runs:
        np.testing.assert_allclose(tl, jl, rtol=2e-4)
        for key in jm:
            np.testing.assert_allclose(
                tm[key], jm[key], rtol=2e-4,
                atol=2e-5 * np.abs(jm[key]).max(), err_msg=str(key))
        diff = np.concatenate([np.abs(tp[k] - jp[k]).ravel() for k in jp])
        assert diff.max() <= 2 * LR
        assert (diff > 1e-4).mean() <= 1e-3


def check_moment_memory(jstate, tstate, cfg):
    """Each device holds 1/dp of every moment ZeRO-1 splits, as many
    bytes as the JAX package's device at the same coordinate."""
    (jm, jo), (tm, to) = jstate, tstate
    dp = tm.shape["dp"]
    zdims = ttf._zero1_dims(cfg, tm)
    specs = ttf.param_specs(cfg)
    for key in ("m", "v"):
        got = per_device_bytes(to[key], tm)
        assert got == jax_device_bytes(jo[key], jm)
        for c in range(tm.size):
            whole = sum(spmd.shard(torch.zeros(s.shape), tm,
                                   specs[n]).device_nbytes()[c]
                        for n, s in to[key].items())
            split = sum(s.device_nbytes()[c] for n, s in to[key].items()
                        if zdims[n] is not None)
            kept = sum(s.device_nbytes()[c] for n, s in to[key].items()
                       if zdims[n] is None)
            assert got[c] == split + kept
            assert split * dp + kept == whole
    assert any(d is not None for d in zdims.values()) or dp == 1


AXES = dict(dp=2, tp=2, sp=2)


def test_sgd_step_matches_jax_dp2_tp2_sp2():
    runs, _, _ = run_both(AXES, "sgd", steps=2)
    check_sgd(runs)


def test_zero1_adam_step_matches_jax_dp2_tp2_sp2():
    runs, jstate, tstate = run_both(AXES, "adam", steps=2)
    check_adam(runs)
    check_moment_memory(jstate, tstate,
                        ttf.TransformerConfig(**cfg_kw()))


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_fused_steps_equal_three_single_steps(optimizer):
    """`make_fused_train_steps` at K = 3 is three `make_train_step`
    calls on the three batches, bitwise; both take the data as global
    arrays or as values laid out by their `info["data"]`."""
    _, tm = meshes(**AXES)
    cfg = ttf.TransformerConfig(**cfg_kw())
    toks = np.stack([data(seed=s)[0] for s in range(3)])
    labs = np.stack([data(seed=s)[1] for s in range(3)])
    single, _ = ttf.make_train_step(cfg, tm, lr=LR, optimizer=optimizer)
    fused, info = ttf.make_fused_train_steps(cfg, tm, 3, lr=LR,
                                             optimizer=optimizer)
    assert info["k_steps"] == 3 and info["data"].spec == (None, "dp", "sp")
    p1 = ttf.init_params(cfg, tm, seed=1)
    p2 = ttf.init_params(cfg, tm, seed=1)
    if optimizer == "adam":
        o1, o2 = ttf.init_opt_state(cfg, tm), ttf.init_opt_state(cfg, tm)
        losses = []
        for i in range(3):
            p1, o1, loss = single(p1, o1, toks[i], labs[i])
            losses.append(loss)
        p2, o2, fl = fused(p2, o2, spmd.device_put(toks, info["data"]),
                           labs)
        for key in ("m", "v"):
            for n in o1[key]:
                assert torch.equal(spmd.gather(o1[key][n]),
                                   spmd.gather(o2[key][n]))
        assert o2["t"].shards[0].item() == 3.0
    else:
        losses = []
        for i in range(3):
            p1, loss = single(p1, toks[i], labs[i])
            losses.append(loss)
        p2, fl = fused(p2, toks, labs)
    assert fl.shape == (3,) and torch.equal(fl, torch.stack(losses))
    for n in p1:
        assert torch.equal(spmd.gather(p1[n]), spmd.gather(p2[n]))
