"""Launcher of a distributed-store job on one host (counterpart of the
local mode of ``tools/launch.py``, the reference's dmlc-tracker).

    python -m mxtpu_torch.tools.launch -n 2 -s 1 [--timeout S] CMD ARGS...

It binds the scheduler's socket first, on 127.0.0.1 and a port the
system picks, then starts the scheduler (handing it that socket), the
``-s`` servers and the ``-n`` workers (``CMD ARGS...``), each with its
role's environment: ``MXTPU_ROLE``, ``MXTPU_PS_ROOT_URI``,
``MXTPU_PS_ROOT_PORT``, ``MXTPU_NUM_WORKER``, ``MXTPU_NUM_SERVER``.  A
server or the scheduler runs ``import mxtpu_torch.kvstore_server as s;
s.init_module()``.

The children form a process group of their own, and each is killed if
the launcher dies.  The launch ends when every worker has exited, when
a worker or a server or the scheduler fails, or after ``--timeout``
seconds; then the group gets SIGTERM and, 10 s later, SIGKILL.  The
exit code is the first failing worker's (1 for a failed server or
scheduler, or a timeout), else 0.

Not ported: the ssh launcher, serving fleets (``--serve-replicas``),
respawned workers, tolerated server failures, the fleet restart and
the chaos harness's pid files (ROADMAP A17), the telemetry directory,
tracing and the live observability plane (ROADMAP A18): those options
raise.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import signal
import socket
import subprocess
import sys
import time

_SERVE_ROLE = "import mxtpu_torch.kvstore_server as s; s.init_module()"
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PR_SET_PDEATHSIG = 1

try:
    _prctl = ctypes.CDLL(None, use_errno=True).prctl
except (OSError, AttributeError):  # not Linux
    _prctl = None


def _die_with_launcher():
    """In the child, before exec: SIGKILL when the launcher dies."""
    if _prctl is not None:
        _prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m mxtpu_torch.tools.launch",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", "--num-workers", type=int, default=0)
    ap.add_argument("-s", "--num-servers", type=int, default=None)
    ap.add_argument("--launcher", choices=["local", "ssh"], default="local")
    ap.add_argument("--timeout", type=float, default=None, metavar="S",
                    help="kill the job and fail after S seconds")
    for flag, item in (("--hostfile", "A17"), ("--sync-dst-dir", "A17"),
                       ("--pid-dir", "A17"),
                       ("--restart-workers", "A17"),
                       ("--allow-server-failures", "A17"),
                       ("--auto-resume", "A17"),
                       ("--max-fleet-restarts", "A17"),
                       ("--serve-replicas", "A17"),
                       ("--allow-serve-failures", "A17"),
                       ("--trace-sample", "A18"),
                       ("--telemetry-dir", "A18")):
        ap.add_argument(flag, dest="unported_" + flag[2:].replace("-", "_"),
                        default=None, nargs="?", const=True, metavar="V",
                        help="not ported (ROADMAP %s)" % item)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    unported = [k[len("unported_"):] for k, v in vars(args).items()
                if k.startswith("unported_") and v is not None]
    if args.launcher == "ssh" or unported:
        ap.error("not ported (ROADMAP A17/A18): %s"
                 % ", ".join(["--launcher ssh"] * (args.launcher == "ssh")
                             + ["--" + u.replace("_", "-")
                                for u in unported]))
    if not args.command:
        ap.error("no command given")
    if args.num_workers < 1:
        ap.error("need -n/--num-workers >= 1")
    ns = args.num_servers if args.num_servers is not None \
        else args.num_workers
    if ns < 1:
        ap.error("need -s/--num-servers >= 1")
    return _run(args, ns)


def _run(args, ns: int) -> int:
    # the scheduler's socket is bound and listening before any role
    # starts, so no other process can take its port in between
    sched_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sched_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sched_sock.bind(("127.0.0.1", 0))
    sched_sock.listen(128)
    base = dict(os.environ)
    base.update({
        "MXTPU_PS_ROOT_URI": "127.0.0.1",
        "MXTPU_PS_ROOT_PORT": str(sched_sock.getsockname()[1]),
        "MXTPU_NUM_WORKER": str(args.num_workers),
        "MXTPU_NUM_SERVER": str(ns),
        "PYTHONPATH": os.pathsep.join(
            p for p in (_PKG_ROOT, base.get("PYTHONPATH")) if p),
    })
    procs = []
    pgid = [0]  # the first child leads the group

    def spawn(role, cmd, pass_fds=()):
        env = dict(base)
        env["MXTPU_ROLE"] = role
        if pass_fds:
            env["MXTPU_PS_SCHEDULER_FD"] = str(pass_fds[0])
        p = subprocess.Popen(cmd, env=env, pass_fds=pass_fds,
                             process_group=pgid[0],
                             preexec_fn=_die_with_launcher)
        if not pgid[0]:
            pgid[0] = p.pid
        procs.append(p)
        return p

    t0 = time.monotonic()
    rc = 0
    try:
        serve = [sys.executable, "-c", _SERVE_ROLE]
        infra = [("scheduler", spawn("scheduler", serve,
                                     pass_fds=(sched_sock.fileno(),)))]
        sched_sock.close()
        infra += [("server", spawn("server", serve)) for _ in range(ns)]
        workers = {i: spawn("worker", args.command)
                   for i in range(args.num_workers)}
        while workers and rc == 0:
            time.sleep(0.1)
            for i, w in list(workers.items()):
                code = w.poll()
                if code is None:
                    continue
                del workers[i]
                if code != 0:
                    print("launch: worker %d exited %d" % (i, code),
                          file=sys.stderr, flush=True)
                    rc = code if 0 < code < 256 else 1
                    break
            for role, p in infra:
                code = p.poll()
                if code not in (None, 0) and rc == 0:
                    print("launch: %s exited %d while workers ran"
                          % (role, code), file=sys.stderr, flush=True)
                    rc = 1
            if rc == 0 and args.timeout is not None and workers \
                    and time.monotonic() - t0 > args.timeout:
                print("launch: workers %s still running after %.0f s; "
                      "killing the job" % (sorted(workers), args.timeout),
                      file=sys.stderr, flush=True)
                rc = 1
        if rc == 0:
            # the scheduler stops the servers once every worker is done
            # (a worker that exits without closing its store leaves
            # them to the teardown)
            deadline = time.monotonic() + 3
            while time.monotonic() < deadline and \
                    any(p.poll() is None for _, p in infra):
                time.sleep(0.05)
            for role, p in infra:
                if p.poll() not in (None, 0):
                    print("launch: %s exited %d" % (role, p.returncode),
                          file=sys.stderr, flush=True)
                    rc = 1
    finally:
        sched_sock.close()
        _teardown(procs, pgid[0])
    return rc


def _teardown(procs, pgid: int):
    """SIGTERM to the children's group, then SIGKILL 10 s later."""
    if not pgid or all(p.poll() is not None for p in procs):
        return
    for sig, wait in ((signal.SIGTERM, 10.0), (signal.SIGKILL, 5.0)):
        try:
            os.killpg(pgid, sig)
        except ProcessLookupError:
            return
        deadline = time.monotonic() + wait
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        if all(p.poll() is not None for p in procs):
            return


if __name__ == "__main__":
    sys.exit(main())
