"""Monitor of the PyTorch port: statistics of an executor's arrays.

Counterpart of ``mxtpu/monitor.py``: ``Monitor(interval, stat_func,
pattern, sort, monitor_all)`` is installed on executors (``install``,
or ``Module.install_monitor``/``fit(monitor=...)``); every ``interval``
batches ``tic`` arms it, and ``toc`` collects ``(batch, name, stat)``
for every output whose name matches ``pattern`` (with ``monitor_all``,
the arguments and aux states too), ``stat_func`` being ``|x|``'s mean
by default.  ``toc_print`` logs them.  The JAX package also writes each
record into its telemetry stream; that waits for the port's telemetry
(ROADMAP A18).
"""
from __future__ import annotations

import logging
import re
from typing import Any, Callable, List, Optional, Tuple

from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


class Monitor(object):
    def __init__(self, interval: int, stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False,
                 monitor_all: bool = False):
        if stat_func is None:
            def stat_func(x):
                return x.abs().mean()
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue: List[Tuple[int, str, Any]] = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self.monitor_all = monitor_all

    def install(self, exe):
        exe.set_monitor_callback(self.stat_func, self.monitor_all)
        self.exes.append(exe)

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self) -> List[Tuple[int, str, str]]:
        """The statistics of the batch ``tic`` armed, as (batch, name,
        value as text); [] when it did not arm."""
        if not self.activated:
            return []
        for exe in self.exes:
            named = list(zip(exe._symbol.list_outputs(), exe.outputs))
            if self.monitor_all:
                named += list(exe.arg_dict.items())
                named += list(exe.aux_dict.items())
            for name, arr in named:
                if self.re_prog.match(name) and isinstance(arr, NDArray):
                    self.queue.append((self.step, name,
                                       self.stat_func(arr)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            for v in v_list:
                if v.shape == (1,) or v.shape == ():
                    res.append((n, k, str(float(v.asscalar()))))
                else:
                    res.append((n, k, str(v.asnumpy())))
        self.queue = []
        return res

    def toc_print(self):
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
