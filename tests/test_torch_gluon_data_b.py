"""The PyTorch port's DataLoader with forked worker processes
(`thread_pool=False`, `mxtpu_torch/gluon/data/dataloader.py`): the
batches equal the reference's inline batches (the JAX package's
DataLoader with 0 workers, made in this process), the samples are made
outside the parent, a worker killed while it holds a batch has the batch
resubmitted, a worker's exception crosses back with its traceback, and
NDArray samples, which the workers refuse, are batched in the parent as
the reference's DataLoader batches them.

A fork after torch's thread pool has run can hang, so every loader with
process workers runs in a subprocess of its own (a new session, one
thread, `OMP_NUM_THREADS=1`, a timeout, its process group killed on
timeout), which prints its results as JSON.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import mxtpu as jmx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60

CHILD = r'''
import json, os, signal, sys
import numpy as np
import torch
torch.set_num_threads(1)
from mxtpu_torch import context
context.default_ctx = lambda: torch.device("cpu")
import mxtpu_torch as mx
from mxtpu_torch.base import MXNetError


class Numbered(object):
    def __init__(self, n=23):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((2, 3), float(i), np.float32), float(i % 5),
                float(os.getpid()))


class Dying(Numbered):
    """The first worker to make sample 9 kills itself."""

    def __getitem__(self, i):
        if i == 9 and not os.path.exists(sys.argv[2]):
            open(sys.argv[2], "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
        return Numbered.__getitem__(self, i)


class Failing(Numbered):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("bad sample %d" % i)
        return Numbered.__getitem__(self, i)


class Arrays(Numbered):
    def __getitem__(self, i):
        return mx.nd.array(np.full((2,), float(i), np.float32),
                           ctx=mx.cpu())


def run(ds, **kw):
    out = []
    for b in mx.gluon.data.DataLoader(ds, thread_pool=False, **kw):
        out.append([x.asnumpy().tolist() for x in b])
    return out


mode = sys.argv[1]
kw = dict(batch_size=4, shuffle=True, seed=3, num_workers=2)
if mode == "equal":
    result = {"batches": run(Numbered(), **kw),
              "discard": run(Numbered(), batch_size=5, num_workers=3,
                             last_batch="discard")}
elif mode == "cuda":
    class Modules(Numbered):
        def __getitem__(self, i):
            return np.array([float("torch" in sys.modules),
                             float(torch.cuda.is_initialized())])
    result = {"batches": run(Modules(), batch_size=4, num_workers=2),
              "initialized": torch.cuda.is_initialized()}
elif mode == "abandon":
    class Big(Numbered):
        def __getitem__(self, i):
            return np.full((3, 64, 64), float(i), np.float32)
    firsts = []
    for k in range(8):
        for b in mx.gluon.data.DataLoader(Big(96), batch_size=16,
                                          num_workers=4, thread_pool=False):
            firsts.append(float(b.asnumpy()[0, 0, 0, 0]))
            break
    result = {"firsts": firsts}
elif mode == "ndarray":
    result = {"batches": run(Arrays(), **kw)}
elif mode == "killed":
    result = {"batches": run(Dying(), **kw),
              "died": os.path.exists(sys.argv[2])}
else:
    try:
        run(Failing(), **kw)
        result = {"raised": None}
    except MXNetError as e:
        result = {"raised": str(e)}
result["parent"] = os.getpid()
print("RESULT " + json.dumps(result))
'''


def _child(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-c", CHILD] + list(args),
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail("the loader's subprocess did not end in %d s" % TIMEOUT)
    assert proc.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


class _Numbered(object):
    """The child's dataset without the pid: the reference's side."""

    def __len__(self):
        return 23

    def __getitem__(self, i):
        return np.full((2, 3), float(i), np.float32), float(i % 5)


def _reference(**kw):
    return [[x.asnumpy() for x in b]
            for b in jmx.gluon.data.DataLoader(_Numbered(), **kw)]


def _check_batches(got, want, parent):
    assert len(got) == len(want)
    pids = set()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g[0], np.float32), w[0])
        np.testing.assert_array_equal(np.asarray(g[1], np.float32), w[1])
        pids.update(int(p) for p in g[2])
    assert parent not in pids and pids


def test_process_workers_give_the_reference_batches():
    r = _child("equal")
    _check_batches(r["batches"], _reference(batch_size=4, shuffle=True,
                                            seed=3), r["parent"])
    _check_batches(r["discard"], _reference(batch_size=5,
                                            last_batch="discard"),
                   r["parent"])


def test_a_killed_worker_has_its_batch_resubmitted(tmp_path):
    r = _child("killed", str(tmp_path / "died"))
    assert r["died"]
    _check_batches(r["batches"], _reference(batch_size=4, shuffle=True,
                                            seed=3), r["parent"])


def test_a_worker_exception_crosses_with_its_traceback():
    r = _child("error")
    assert r["raised"] is not None
    assert "ValueError: bad sample 5" in r["raised"]
    assert "original worker traceback" in r["raised"]
    assert "Traceback (most recent call last)" in r["raised"]


def test_ndarray_samples_are_refused():
    """The workers refuse NDArray samples; each batch is retried in a
    fresh worker and then made in the parent, so every batch arrives
    with the reference's values (the JAX package's DataLoader over the
    same NDArray samples)."""
    r = _child("ndarray")

    class Arrays(object):
        def __len__(self):
            return 23

        def __getitem__(self, i):
            return jmx.nd.array(np.full((2,), float(i), np.float32),
                                ctx=jmx.cpu())

    want = [b.asnumpy() for b in jmx.gluon.data.DataLoader(
        Arrays(), batch_size=4, shuffle=True, seed=3)]
    assert len(r["batches"]) == len(want) == 6
    for got, w in zip(r["batches"], want):
        np.testing.assert_array_equal(np.asarray(got, np.float32), w)


def test_forked_workers_leave_cuda_uninitialized():
    """The workers inherit torch from the parent but never initialize
    CUDA, and the parent's CUDA stays uninitialized after them."""
    r = _child("cuda")
    assert r["initialized"] is False
    assert all(row == [1.0, 0.0] for b in r["batches"] for row in b)


def test_abandoning_a_loader_with_batches_in_flight_ends_it():
    """A consumer that stops after the first batch while workers are
    still sending larger ones: the loader waits for those batches
    before it terminates the pool (a worker killed mid-send leaves the
    result queue's lock held and terminate() waiting for ever)."""
    r = _child("abandon")
    assert r["firsts"] == [0.0] * 8
