"""Training callbacks of the PyTorch port (counterpart of
``mxtpu/callback.py``): ``do_checkpoint`` and ``module_checkpoint``
(epoch callbacks writing ``prefix-symbol.json`` and
``prefix-%04d.params``), ``Speedometer`` (samples a second and the
running metric, every ``frequent`` batches), ``log_train_metric``,
``ProgressBar`` and ``LogValidationMetricsCallback``.
"""
from __future__ import annotations

import logging
import math
import time

from .model import save_checkpoint

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch callback: ``mod.save_checkpoint`` every ``period``
    epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch callback writing ``prefix-symbol.json`` and
    ``prefix-%04d.params`` every ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer(object):
    """Batch-end callback logging samples/sec (and, optionally, the
    running metric values) once every `frequent` batches.

    The rate covers the batches since the previous report, the metric
    is reset after each report when ``auto_reset`` (so values are per
    window), and a batch counter that moved backwards (a new epoch)
    restarts the window.  The window is counted on a monotonic clock,
    so the rate is right whatever the cadence of the calls.
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = max(1, int(frequent))
        self.auto_reset = auto_reset
        self._window_start = None   # monotonic ts of window begin
        self._window_batches = 0    # batches accumulated in the window
        self._prev_nbatch = None

    def _restart_window(self):
        self._window_start = time.monotonic()
        self._window_batches = 0

    def __call__(self, param):
        nbatch = param.nbatch
        if self._window_start is None or self._prev_nbatch is None \
                or nbatch < self._prev_nbatch:
            # first call, or the batch counter wrapped (new epoch)
            self._prev_nbatch = nbatch
            self._restart_window()
            return
        self._window_batches += max(0, nbatch - self._prev_nbatch)
        self._prev_nbatch = nbatch
        if nbatch % self.frequent != 0 or self._window_batches == 0:
            return
        elapsed = time.monotonic() - self._window_start
        rate = (self._window_batches * self.batch_size / elapsed
                if elapsed > 0 else float("inf"))
        parts = ["Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                 % (param.epoch, nbatch, rate)]
        if param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                parts.append("%s=%f" % (name, value))
            if self.auto_reset:
                param.eval_metric.reset()
        logging.info("\t".join(parts))
        self._restart_window()


class ProgressBar(object):
    """A text progress bar for each epoch."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback(object):
    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
