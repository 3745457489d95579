"""INT8 post-training quantization of the PyTorch port: calibration
and the graph rewrite (counterpart of ``mxtpu/contrib/quantization.py``).

``quantize_model`` is the JAX package's workflow, after MXNet's:

1. calibration runs batches through the fp32 graph and records the
   range of every tensor that feeds a quantized op: ``naive`` (the
   global min and max) or ``entropy`` (the KL-optimal threshold over a
   histogram, ``_optimal_threshold``);
2. the graph is rebuilt with ``_contrib_quantize_v2`` ->
   ``_contrib_quantized_{conv,fully_connected}`` -> ``_contrib_dequantize``
   around every Convolution and FullyConnected, through the subgraph
   framework (``QuantizeProperty``, one-node regions);
3. the weights and biases those ops read are quantized offline to int8
   with their own symmetric ranges (``quantize_params``; ranges of
   shape (1,)).

The int8 ops accumulate in int32 (``mxtpu_torch/ops/quantization.py``:
cuBLASLt's int8 GEMM on the card).  Calibration binds the graph on
``ctx`` (default: the card), where the JAX package binds it on the host.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array as nd_array
from ..subgraph import SubgraphProperty as _SubgraphProperty
from ..symbol.register import invoke_symbol
from ..symbol.symbol import Symbol, Variable

__all__ = ["quantize_model", "quantize_symbol", "quantize_params",
           "calibrate_ranges"]

# ops with an int8 kernel (reference quantize_graph_pass.cc
# quantized-op registry); value = quantized op name
_QUANTIZABLE = {
    "Convolution": "_contrib_quantized_conv",
    "FullyConnected": "_contrib_quantized_fully_connected",
}


def _max_abs(arr: np.ndarray) -> float:
    """Symmetric range of a tensor; never 0 (an all-zero param — e.g. a
    freshly-initialized bias — must quantize to zeros, not NaN)."""
    t = float(np.max(np.abs(arr))) if arr.size else 1.0
    return t if t > 0 else 1.0


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def _optimal_threshold(hist: np.ndarray, edges: np.ndarray,
                       num_quantized_bins: int = 255,
                       max_clip_frac: float = 0.01) -> float:
    """KL-divergence-optimal |threshold| over a symmetric histogram
    (reference `quantization.py _get_optimal_threshold` / TensorRT's
    entropy calibration).  Scans candidate clip points and keeps the one
    whose clipped+quantized distribution diverges least from the
    original.

    `max_clip_frac` bounds the calibration mass a candidate may clip:
    the raw KL objective hides clipped mass in the edge bins, so on
    concentrated distributions (ReLU stacks, untrained nets) it would
    happily clip half the data — the bound keeps the search inside the
    99th-percentile window, which is also where TensorRT-style
    calibration lands on well-behaved data."""
    n_bins = len(hist)
    assert n_bins % 2 == 1  # symmetric around zero
    zero = n_bins // 2
    best_kl, best_t = np.inf, float(edges[-1])
    total = hist.sum()
    if total == 0:
        return best_t
    p_full = hist.astype(np.float64)
    for width in range(num_quantized_bins // 2, zero + 1):
        lo, hi = zero - width, zero + width + 1
        clipped = p_full[:lo].sum() + p_full[hi:].sum()
        if clipped > max_clip_frac * total:
            continue
        p = p_full[lo:hi].copy()
        # outliers collapse into the edge bins (clipping)
        p[0] += p_full[:lo].sum()
        p[-1] += p_full[hi:].sum()
        nonzero = p > 0
        if nonzero.sum() < 2:
            continue
        # quantize p into num_quantized_bins, then expand back
        # (vectorized: per-bin sums/counts via add.reduceat)
        factor = len(p) / num_quantized_bins
        starts = np.floor(np.arange(num_quantized_bins) * factor) \
            .astype(np.int64)
        bin_of = np.minimum((np.arange(len(p)) / factor).astype(np.int64),
                            num_quantized_bins - 1)
        sums = np.add.reduceat(p, starts)
        counts = np.add.reduceat(nonzero.astype(np.float64), starts)
        avg = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
        q = np.where(nonzero, avg[bin_of], 0.0)
        p_n = p / p.sum()
        q_n = q / q.sum() if q.sum() > 0 else q
        mask = (p_n > 0) & (q_n > 0)
        if not mask.any():
            continue
        kl = float(np.sum(p_n[mask] * np.log(p_n[mask] / q_n[mask])))
        if kl < best_kl:
            best_kl = kl
            best_t = float(max(abs(edges[lo]), abs(edges[hi])))
    return best_t


class _RangeCollector(object):
    """Accumulates per-tensor ranges over calibration batches."""

    def __init__(self, mode: str, num_bins: int = 8001):
        self.mode = mode
        self.num_bins = num_bins
        self.minmax: Dict[str, Tuple[float, float]] = {}
        self.hists: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def update(self, name: str, arr: np.ndarray):
        lo, hi = float(arr.min()), float(arr.max())
        if name in self.minmax:
            plo, phi = self.minmax[name]
            self.minmax[name] = (min(lo, plo), max(hi, phi))
        else:
            self.minmax[name] = (lo, hi)
        if self.mode == "entropy":
            t = max(abs(lo), abs(hi), 1e-8)
            if name in self.hists:
                hist, edges = self.hists[name]
                if t > edges[-1]:  # re-bin into the wider range
                    new_edges = np.linspace(-t, t, self.num_bins + 1)
                    centers = (edges[:-1] + edges[1:]) / 2
                    new_hist, _ = np.histogram(centers, bins=new_edges,
                                               weights=hist)
                    hist, edges = new_hist, new_edges
                add, _ = np.histogram(arr, bins=edges)
                self.hists[name] = (hist + add, edges)
            else:
                edges = np.linspace(-t, t, self.num_bins + 1)
                hist, _ = np.histogram(arr, bins=edges)
                self.hists[name] = (hist, edges)

    def ranges(self) -> Dict[str, Tuple[float, float]]:
        if self.mode != "entropy":
            return dict(self.minmax)
        out = {}
        for name, (hist, edges) in self.hists.items():
            t = _optimal_threshold(hist, edges)
            out[name] = (-t, t)
        return out


def calibrate_ranges(sym: Symbol, arg_params, aux_params, calib_data,
                     data_names=("data",), label_names=("softmax_label",),
                     num_calib_examples: Optional[int] = None,
                     calib_mode: str = "naive",
                     excluded_sym_names=(),
                     ctx=None) -> Dict[str, Tuple[float, float]]:
    """Run calibration batches through the fp32 graph and return
    {internal-output-name: (min, max)} for every tensor feeding a
    quantized op (reference `_collect_layer_statistics`), the graph
    bound on ``ctx`` (default: the card)."""
    need: List[str] = []
    for node in sym._topo():
        if node.is_variable or node.name in excluded_sym_names:
            continue
        if node.op.name in _QUANTIZABLE:
            src, idx = node.inputs[0]
            if not src.is_variable:
                nm = src.name + "_output" \
                    if src.num_outputs() == 1 \
                    else "%s_output%d" % (src.name, idx)
            else:
                nm = src.name
            need.append(nm)
    internals = sym.get_internals()
    outs = [internals[nm] for nm in dict.fromkeys(need)
            if nm not in sym.list_arguments()]
    collector = _RangeCollector(calib_mode)

    if outs:
        from ..symbol.symbol import Group

        group = Group(outs)
        shapes = {}
        batch0 = None
        calib_data.reset()
        for batch in calib_data:
            batch0 = batch
            break
        if batch0 is None:
            raise MXNetError("empty calibration data")
        for n, d in zip(data_names, batch0.data):
            shapes[n] = d.shape
        exe = group.simple_bind(ctx=ctx, grad_req="null", **shapes)
        for k, v in (arg_params or {}).items():
            if k in exe.arg_dict:
                v.copyto(exe.arg_dict[k])
        for k, v in (aux_params or {}).items():
            if k in exe.aux_dict:
                v.copyto(exe.aux_dict[k])

        seen = 0
        calib_data.reset()
        names = group.list_outputs()
        for batch in calib_data:
            feed = {n: d for n, d in zip(data_names, batch.data)}
            outs_nd = exe.forward(is_train=False, **feed)
            for nm, o in zip(names, outs_nd):
                collector.update(nm, o.asnumpy())
            # the graph INPUT also needs a range
            for n, d in zip(data_names, batch.data):
                collector.update(n, d.asnumpy())
            seen += batch.data[0].shape[0]
            if num_calib_examples is not None and seen >= num_calib_examples:
                break
    else:
        calib_data.reset()
        seen = 0
        for batch in calib_data:
            for n, d in zip(data_names, batch.data):
                collector.update(n, d.asnumpy())
            seen += batch.data[0].shape[0]
            if num_calib_examples is not None and seen >= num_calib_examples:
                break
    logging.getLogger(__name__).info(
        "calibrated %d tensors over %d examples (%s mode)",
        len(collector.minmax), seen, calib_mode)
    return collector.ranges()


# ---------------------------------------------------------------------------
# Graph rewrite
# ---------------------------------------------------------------------------

class _QuantizeSelector:
    """Single-node regions over quantizable ops (the INT8 rewrite is a
    per-op island; no growth)."""

    def __init__(self, prop):
        self._prop = prop

    def select(self, node):
        return self._prop._quantizable(node)

    def select_input(self, node, input_node):
        return False

    def select_output(self, node, output_node):
        return False

    def filter(self, candidates):
        return candidates


class QuantizeProperty(_SubgraphProperty):
    """INT8 rewrite as a subgraph backend (`mxtpu.subgraph`): each
    quantizable node is a one-node region replaced by a
    quantize → int8-op → dequantize island.  The reference implements
    the same rewrite as the MKLDNN_QUANTIZE subgraph property
    (`src/operator/subgraph/mkldnn/mkldnn_subgraph_property.cc`) over
    `quantize_graph_pass.cc`."""

    needs_params = False  # params are quantized separately (offline)

    def __init__(self, ranges, excluded_sym_names=()):
        self.ranges = ranges
        self.excluded = set(excluded_sym_names)
        self.offline: List[str] = []

    def _in_name(self, node):
        from ..subgraph import _entry_name

        return _entry_name(*node.inputs[0])

    def _quantizable(self, node):
        if node.is_variable or node.op.name not in _QUANTIZABLE:
            return False
        if node.name in self.excluded:
            return False
        if len(node.inputs) < 2 or not node.inputs[1][0].is_variable:
            return False
        return self.ranges is None or self._in_name(node) in self.ranges

    def create_selector(self):
        return _QuantizeSelector(self)

    def filter_region(self, region, consumers, head_ids):
        return region

    def create_subgraph_node(self, sub_sym, region, input_names, sid):
        node = region[0]
        qop = _QUANTIZABLE[node.op.name]
        qattrs = {}
        if self.ranges is not None:
            lo, hi = self.ranges[self._in_name(node)]
            qattrs = {"min_calib_range": float(lo),
                      "max_calib_range": float(hi)}
        data_ph = Variable(input_names[0])
        q = invoke_symbol("_contrib_quantize_v2", [data_ph], qattrs,
                          name=node.name + "_quantize")
        wname = node.inputs[1][0].name
        self.offline.append(wname)
        qw = Variable(wname + "_quantize")
        wmin, wmax = Variable(wname + "_min"), Variable(wname + "_max")
        no_bias = node.attrs.get("no_bias", False)
        if not no_bias and len(node.inputs) >= 3 \
                and node.inputs[2][0].is_variable:
            bname = node.inputs[2][0].name
            self.offline.append(bname)
            qb = Variable(bname + "_quantize")
            bmin, bmax = Variable(bname + "_min"), Variable(bname + "_max")
        else:
            qb = Variable(node.name + "_no_bias")  # zero int8 stand-in
            bmin, bmax = wmin, wmax  # same vars, no duplicates
        q_out = q  # quantize_v2 has 3 visible outputs (data, min, max)
        core = invoke_symbol(
            qop, [q_out[0], qw, qb, q_out[1], q_out[2],
                  wmin, wmax, bmin, bmax],
            dict(node.attrs), name=node.name + "_quantized")
        deq = invoke_symbol(
            "_contrib_dequantize", [core[0], core[1], core[2]], {},
            name=node.name + "_dequantize")
        return deq

    def transform_params(self, applied, arg_params, aux_params):
        return arg_params, aux_params


def quantize_symbol(sym: Symbol,
                    ranges: Optional[Dict[str, Tuple[float, float]]],
                    excluded_sym_names=(),
                    quantized_dtype: str = "int8") -> Tuple[Symbol, List[str]]:
    """Rebuild `sym` with int8 islands around every quantizable op whose
    input range was calibrated; ``ranges=None`` quantizes EVERY
    supported op with runtime (dynamic) min/max — the calib_mode='none'
    workflow.  Returns (qsym, names of params that `quantize_params`
    must convert offline).

    The rewrite itself runs through the pluggable subgraph framework
    (`mxtpu.subgraph.partition_with_property` with `QuantizeProperty`)."""
    if quantized_dtype != "int8":
        raise MXNetError("only int8 is supported (got %r)" % quantized_dtype)
    from ..subgraph import partition_with_property

    prop = QuantizeProperty(ranges, excluded_sym_names)
    qsym = partition_with_property(sym, prop)
    return qsym, prop.offline


def quantize_params(qsym: Symbol, arg_params: Dict[str, NDArray],
                    offline: List[str]) -> Dict[str, NDArray]:
    """Offline-quantize `offline` params to int8 with symmetric max-abs
    ranges; other params pass through (reference quantize_params).  The
    new arrays lie on the device of the parameter they come from (the
    no-bias stand-ins on the first parameter's)."""
    out: Dict[str, NDArray] = {}
    qargs = set(qsym.list_arguments())
    ctx = next(iter(arg_params.values())).ctx if arg_params else None
    for name, arr in arg_params.items():
        if name in offline:
            host = arr.asnumpy()
            t = _max_abs(host)
            qv = np.clip(np.round(host / t * 127.0), -127, 127) \
                .astype(np.int8)
            if name + "_quantize" in qargs:
                out[name + "_quantize"] = nd_array(qv, ctx=arr.ctx)
                out[name + "_min"] = nd_array(
                    np.asarray([-t], np.float32), ctx=arr.ctx)
                out[name + "_max"] = nd_array(
                    np.asarray([t], np.float32), ctx=arr.ctx)
        if name in qargs:
            out[name] = arr
    # zero int8 stand-ins for no-bias slots
    for name in qargs:
        if name.endswith("_no_bias") and name not in out:
            out[name] = nd_array(np.zeros((1,), np.int8), ctx=ctx)
    return out


def quantize_model(sym: Symbol, arg_params, aux_params,
                   data_names=("data",), label_names=("softmax_label",),
                   ctx=None, excluded_sym_names=(),
                   calib_mode: str = "naive", calib_data=None,
                   num_calib_examples: Optional[int] = None,
                   quantized_dtype: str = "int8", logger=None):
    """The reference's one-call workflow
    (`python/mxnet/contrib/quantization.py:423`): calibrate → rewrite →
    quantize params.  Returns (qsym, qarg_params, aux_params)."""
    if calib_mode not in ("none", "naive", "entropy"):
        raise MXNetError("calib_mode must be none/naive/entropy")
    if calib_mode != "none":
        if calib_data is None:
            raise MXNetError("calib_data required for calib_mode=%r"
                             % calib_mode)
        ranges = calibrate_ranges(
            sym, arg_params, aux_params, calib_data,
            data_names=data_names, label_names=label_names,
            num_calib_examples=num_calib_examples, calib_mode=calib_mode,
            excluded_sym_names=excluded_sym_names, ctx=ctx)
    else:
        ranges = None  # dynamic: runtime min/max in _contrib_quantize_v2
    qsym, offline = quantize_symbol(
        sym, ranges, excluded_sym_names=excluded_sym_names,
        quantized_dtype=quantized_dtype)
    qargs = quantize_params(qsym, arg_params or {}, offline)
    return qsym, qargs, dict(aux_params or {})
