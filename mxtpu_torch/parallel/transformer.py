"""TransformerLM forward of the PyTorch port, on one device.

Counterpart of ``mxtpu/parallel/transformer.py``: ``TransformerConfig``,
``param_shapes``, ``init_params``, ``_rms_norm``, ``_attention``,
``_dense_ffn``, the forward of ``_stage_fn`` and ``make_forward``.  The
JAX module runs a manual-SPMD step over a dp x pp x tp x sp x ep mesh;
here every axis is 1, so there is no shard_map and no collective, and
``lax.scan`` over the layer axis is a Python loop.

The parameters keep the JAX layout and names: a dict of tensors whose
per-layer entries carry leading (pp, layers_per_stage) axes with pp = 1
(:func:`param_shapes`).  :func:`params_from_jax` takes the JAX package's
parameters as numpy arrays, so both packages compute one function.

Left out: the MoE FFN (``_moe_ffn``: ``n_experts > 0`` raises), meshes
with an axis above 1, and training (loss, train steps, optimizer
state), which the next slice ports.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..context import resolve
from .mesh import AXIS_SP
from .ring_attention import ring_attention

__all__ = ["TransformerConfig", "param_shapes", "init_params",
           "params_from_jax", "make_forward"]

# the names of mxtpu/executor.py's _REMAT_POLICIES, which the config
# validates against (the policies themselves act in the backward pass)
_REMAT_POLICIES = ("dots", "dots_no_batch", "full")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 4          # total; must divide by pp stages
    d_ff: int = 128
    n_experts: int = 0         # 0 = dense FFN; MoE is not ported yet
    capacity_factor: float = 2.0
    max_len: int = 128
    dtype: Any = "bfloat16"
    remat: str = "none"        # "none" or a remat policy name

    def __post_init__(self):
        if self.remat != "none" and self.remat not in _REMAT_POLICIES:
            raise MXNetError(
                "TransformerConfig.remat must be 'none' or one of %s "
                "(got %r)" % (sorted(_REMAT_POLICIES), self.remat))
        if str(self.dtype) not in _DTYPES:
            raise MXNetError("TransformerConfig.dtype must be one of %s "
                             "(got %r)" % (sorted(_DTYPES), self.dtype))
        if self.n_experts:
            raise NotImplementedError(
                "n_experts=%d: the MoE FFN (_moe_ffn) is not ported yet "
                "(ROADMAP A12b)" % self.n_experts)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[str(self.dtype)]


def param_shapes(cfg: TransformerConfig, pp: int = 1) -> Dict[str, Tuple]:
    """Global parameter shapes (the JAX package's, dense FFN)."""
    if cfg.n_layers % pp:
        raise MXNetError("n_layers=%d not divisible by pp=%d"
                         % (cfg.n_layers, pp))
    lps = cfg.n_layers // pp
    E, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab
    return {
        "embed": (V, E), "pos": (cfg.max_len, E), "ln_f": (E,),
        "unembed": (E, V),
        "wq": (pp, lps, E, E), "wk": (pp, lps, E, E),
        "wv": (pp, lps, E, E), "wo": (pp, lps, E, E),
        "ln1": (pp, lps, E), "ln2": (pp, lps, E),
        "w1": (pp, lps, E, F_), "w2": (pp, lps, F_, E),
    }


def init_params(cfg: TransformerConfig, device=None, seed: int = 0):
    """Random parameters from a ``torch.Generator`` seeded with
    ``seed``, drawn on ``device`` (default the card): normal with std
    1/sqrt(fan_in), in name order as the JAX package draws them, and
    ones for the norm scales.  The values differ from the JAX package's
    (another generator); use :func:`params_from_jax` for equal weights."""
    dev = resolve(device)
    E, F_ = cfg.d_model, cfg.d_ff
    fan_in = {"embed": E, "pos": E, "unembed": E, "wq": E, "wk": E,
              "wv": E, "wo": E, "w1": E, "w2": F_}
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = cfg.torch_dtype
    params = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if name in ("ln_f", "ln1", "ln2"):
            params[name] = torch.ones(shape, dtype=dt, device=dev)
        else:
            w = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev)
            params[name] = (w * (1.0 / fan_in[name]) ** 0.5).to(dt)
    return params


def params_from_jax(np_params: Dict[str, np.ndarray],
                    cfg: TransformerConfig, device=None):
    """The JAX package's parameters (``{k: np.asarray(v)}`` of
    ``mxtpu.parallel.transformer.init_params`` on a one-device mesh) as
    the port's.  bfloat16 arrays (numpy's ``bfloat16`` extension dtype)
    are carried over by their bits, so the values are exactly equal;
    other dtypes convert through numpy."""
    dev = resolve(device)
    shapes = param_shapes(cfg)
    if set(np_params) != set(shapes):
        raise MXNetError("parameter names %s do not match the config's %s"
                         % (sorted(np_params), sorted(shapes)))
    out = {}
    for name, arr in np_params.items():
        arr = np.array(arr)  # a writable, contiguous copy
        if tuple(arr.shape) != tuple(shapes[name]):
            raise MXNetError("parameter %r has shape %s, the config says %s"
                             % (name, arr.shape, shapes[name]))
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out[name] = t.to(device=dev, dtype=cfg.torch_dtype)
    return out


def _rms_norm(x, scale):
    """x * rsqrt(mean(x^2) + 1e-6) in f32, cast to x's dtype, THEN the
    scale multiplies in x's dtype (the JAX package's cast order)."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.reciprocal(torch.sqrt(var + 1e-6))).to(x.dtype) \
        * scale


def _attention(cfg, x, wq, wk, wv, wo):
    """Causal self-attention: x [B, T, E]; wq/wk/wv/wo [E, E]."""
    B, T, E = x.shape
    H = cfg.n_heads
    D = E // H

    def split(h):  # a strided (B, H, T, D) view
        return h.reshape(B, T, H, D).transpose(1, 2)

    q, k, v = split(x @ wq), split(x @ wk), split(x @ wv)
    o = ring_attention(q, k, v, axis_name=AXIS_SP, causal=True)
    o = o.transpose(1, 2).reshape(B, T, E)
    return o @ wo


def _matmul_f32(x, w):
    """x @ w with f32 accumulation and an f32 result (JAX's
    ``preferred_element_type=float32``).  bf16 operands on the card go
    to cuBLAS's bf16 product with f32 output, on the tensor cores;
    elsewhere the operands are widened to f32, which is exact, so both
    compute the same products and f32 sums."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def _dense_ffn(x, w1, w2):
    """gelu(x @ w1) @ w2: the first product accumulates in f32, the
    GELU is the tanh approximation (``jax.nn.gelu``'s default) in f32,
    the result is cast to x's dtype, and the second product runs in x's
    dtype."""
    h = F.gelu(_matmul_f32(x, w1), approximate="tanh")
    return h.to(x.dtype) @ w2


def _stage_fn(cfg, params_stage, x):
    """This stage's layers over x (weights stacked on the layer axis)."""
    for i in range(params_stage["wq"].shape[0]):
        lw = {name: w[i] for name, w in params_stage.items()}
        h = x + _attention(cfg, _rms_norm(x, lw["ln1"]), lw["wq"],
                           lw["wk"], lw["wv"], lw["wo"])
        x = h + _dense_ffn(_rms_norm(h, lw["ln2"]), lw["w1"], lw["w2"])
    return x


def _set_matmul_numerics():
    """The JAX package's product numerics on the card: f32 products in
    full f32 (no TF32) and bf16 products reduced in f32.  torch's
    default lets cuBLAS reduce bf16 GEMMs in bf16.  The flags are
    process-wide, so the forward sets them on each call on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def make_forward(cfg: TransformerConfig, device=None):
    """The inference forward: ``fwd(params, tokens) -> logits [B, T, V]``
    in the config's dtype, on ``device`` (default the card).  ``tokens``
    is an int array or tensor [B, T]; a token outside [0, vocab) embeds
    as zeros, as the JAX package's vocab-sharded lookup does.  On the
    card each call first sets torch's matmul flags to the JAX package's
    numerics (:func:`_set_matmul_numerics`)."""
    dev = resolve(device)

    def fwd(params, tokens):
        if dev.type == "cuda":
            _set_matmul_numerics()
        with torch.inference_mode():
            tokens = torch.as_tensor(tokens, device=dev).long()
            B, T = tokens.shape
            if T > cfg.max_len:
                raise MXNetError("sequence length %d exceeds max_len %d"
                                 % (T, cfg.max_len))
            embed = params["embed"]
            valid = (tokens >= 0) & (tokens < cfg.vocab)
            emb = embed[tokens.clamp(0, cfg.vocab - 1)]
            emb = torch.where(valid[..., None], emb, torch.zeros_like(emb))
            x = (emb + params["pos"][:T][None]).to(cfg.torch_dtype)
            stage = {k: params[k][0] for k in params
                     if params[k].dim() >= 3 and k not in
                     ("embed", "pos", "unembed")}
            x = _stage_fn(cfg, stage, x)
            h = _rms_norm(x, params["ln_f"])
            return h @ params["unembed"]

    return fwd
