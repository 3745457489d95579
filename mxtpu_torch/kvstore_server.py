"""The server and scheduler roles of a distributed store (counterpart
of ``mxtpu/kvstore_server.py``, the reference's
``python/mxnet/kvstore_server.py``).

A process that the launcher (``python -m mxtpu_torch.tools.launch``)
starts as a server or the scheduler runs
``import mxtpu_torch.kvstore_server as s; s.init_module()``: it serves
until the workers are done, then exits.  Importing ``mxtpu_torch`` does
not start a role, whatever ``MXTPU_ROLE`` says.
"""
from __future__ import annotations

import os

from . import _ps

__all__ = ["KVStoreServer", "init_module"]


class KVStoreServer(object):
    def __init__(self):
        self._role = _ps.role_from_env()

    def run(self, controller=None):
        """Serve this process's role; ``controller(head, body)``
        receives the commands that ``send_command_to_servers`` sends,
        other than ``set_optimizer``."""
        if self._role == "scheduler":
            _ps.run_scheduler()
        elif self._role == "server":
            _ps.run_server(controller=controller)
        else:
            raise RuntimeError("KVStoreServer started with role %r"
                               % self._role)


def init_module():
    """In a server or scheduler process: serve, then exit at once.
    The hard exit skips the interpreter's teardown, which the role's
    daemon threads (its connections, its heartbeat) could otherwise
    stall; call it only in a launched role process."""
    if _ps.role_from_env() in ("server", "scheduler"):
        KVStoreServer().run()
        os._exit(0)
