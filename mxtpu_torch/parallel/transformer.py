"""TransformerLM of the PyTorch port, forward and training, on one device.

Counterpart of ``mxtpu/parallel/transformer.py``: ``TransformerConfig``,
``param_shapes``, ``init_params``, ``init_opt_state``, ``_rms_norm``,
``_attention``, ``_dense_ffn``, ``_stage_fn`` (with ``apply_remat``),
``_sharded_xent`` (as :func:`_xent`), ``_build_loss_fn``, the SGD and
Adam device steps, ``make_train_step``, ``make_fused_train_steps`` and
``make_forward``.  The JAX module runs a manual-SPMD step over a
dp x pp x tp x sp x ep mesh; here every axis is 1, so there is no
shard_map and no collective, ``lax.scan`` over layers or steps is a
Python loop, and ZeRO-1's slice of each Adam moment is the whole
tensor.

The parameters keep the JAX layout and names: a dict of tensors whose
per-layer entries carry leading (pp, layers_per_stage) axes with pp = 1
(:func:`param_shapes`).  :func:`params_from_jax` takes the JAX package's
parameters as numpy arrays, so both packages compute one function.

Left out: the MoE FFN (``_moe_ffn``: ``n_experts > 0`` raises), meshes
with an axis above 1 (the ring's recompute backward for sp > 1, ZeRO-1
over dp > 1, the pp > 1 pipeline).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..context import resolve
from ..executor import _REMAT_POLICIES, apply_remat
from .mesh import AXIS_SP
from .ring_attention import ring_attention

__all__ = ["TransformerConfig", "param_shapes", "init_params",
           "params_from_jax", "init_opt_state", "make_forward",
           "make_train_step", "make_fused_train_steps"]

_LAYER_PARAMS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")
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
    remat: str = "none"        # "none" or an executor remat policy
    # ("full" | "dots" | "dots_no_batch"): per-layer rematerialization
    # in the backward pass (mxtpu_torch.executor.apply_remat)

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


def init_opt_state(cfg: TransformerConfig, device=None):
    """Adam state: per-parameter first and second moments, f32 zeros on
    ``device`` (default the card), and the step counter ``t`` (an f32
    scalar).  At dp = 1 the ZeRO-1 slice of each moment is all of it."""
    dev = resolve(device)
    shapes = param_shapes(cfg)
    state = {key: {name: torch.zeros(shape, dtype=torch.float32, device=dev)
                   for name, shape in shapes.items()} for key in ("m", "v")}
    state["t"] = torch.zeros((), dtype=torch.float32, device=dev)
    return state


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


class _MatmulF32(torch.autograd.Function):
    """bf16 x @ w with an f32 result on the card: cuBLAS's bf16 product
    with f32 output (``aten::mm.dtype``, which has no derivative in
    torch).  The backward makes the products of JAX's transpose rule,
    as autograd makes them on the widened path: the f32 cotangent meets
    the other operand widened to f32, and each gradient is rounded to
    its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        dx = (g2 @ w.float().t()).to(x.dtype).reshape(x.shape)
        dw = (x.reshape(-1, x.shape[-1]).float().t() @ g2).to(w.dtype)
        return dx, dw


def _matmul_f32(x, w):
    """x @ w with f32 accumulation and an f32 result (JAX's
    ``preferred_element_type=float32``).  bf16 operands on the card go
    to cuBLAS's bf16 product with f32 output, on the tensor cores
    (:class:`_MatmulF32`); elsewhere the operands are widened to f32,
    which is exact, so both compute the same products and f32 sums."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        return _MatmulF32.apply(x, w)
    return torch.matmul(x.float(), w.float())


def _dense_ffn(x, w1, w2):
    """gelu(x @ w1) @ w2: the first product accumulates in f32, the
    GELU is the tanh approximation (``jax.nn.gelu``'s default) in f32,
    the result is cast to x's dtype, and the second product runs in x's
    dtype."""
    h = F.gelu(_matmul_f32(x, w1), approximate="tanh")
    return h.to(x.dtype) @ w2


def _layer(cfg, x, ln1, wq, wk, wv, wo, ln2, w1, w2):
    h = x + _attention(cfg, _rms_norm(x, ln1), wq, wk, wv, wo)
    return h + _dense_ffn(_rms_norm(h, ln2), w1, w2)


def _stage_fn(cfg, params_stage, x):
    """This stage's layers over x (weights stacked on the layer axis),
    a Python loop in place of ``lax.scan``.  When the call is
    differentiated and ``cfg.remat`` names a policy, each layer runs
    under :func:`~mxtpu_torch.executor.apply_remat`; without a gradient
    remat has nothing to save and the layers run as they are."""
    layer = functools.partial(_layer, cfg)
    if cfg.remat != "none" and torch.is_grad_enabled():
        layer = apply_remat(layer, cfg.remat)
    for i in range(params_stage["wq"].shape[0]):
        x = layer(x, *(params_stage[name][i] for name in _LAYER_PARAMS))
    return x


def _embed(cfg, params, tokens):
    """Token plus position embedding of tokens [B, T] (a long tensor),
    in the param dtype, cast to ``cfg.dtype``.  A token outside
    [0, vocab) embeds as zeros, as the JAX package's vocab-sharded
    lookup does; its gradient is a scatter-add into ``embed`` in the
    param dtype (JAX's gather transpose)."""
    T = tokens.shape[1]
    if T > cfg.max_len:
        raise MXNetError("sequence length %d exceeds max_len %d"
                         % (T, cfg.max_len))
    valid = (tokens >= 0) & (tokens < cfg.vocab)
    emb = params["embed"][tokens.clamp(0, cfg.vocab - 1)]
    emb = torch.where(valid[..., None], emb, torch.zeros_like(emb))
    return (emb + params["pos"][:T][None]).to(cfg.torch_dtype)


def _logits(cfg, params, tokens, n_micro=1):
    """The model on tokens [B, T]: logits [B, T, V] in the config's
    dtype.  The batch runs through the layer stack in ``n_micro``
    microbatches, one after another (the JAX pipeline loop at pp = 1)."""
    B = tokens.shape[0]
    if B % n_micro:
        raise MXNetError("local batch %d %% n_micro %d" % (B, n_micro))
    x = _embed(cfg, params, tokens)
    stage = {name: params[name][0] for name in _LAYER_PARAMS}
    mb = B // n_micro
    h = torch.cat([_stage_fn(cfg, stage, x[i * mb:(i + 1) * mb])
                   for i in range(n_micro)])
    return _rms_norm(h, params["ln_f"]) @ params["unembed"]


def _xent(logits, labels):
    """Softmax cross-entropy per row, ``_sharded_xent`` at tp = 1:
    logits [N, V] widened to f32, the logsumexp shifted by the row max
    (held constant for the gradient, as JAX's stop_gradient does), minus
    the label's logit; a label outside [0, V) picks no logit."""
    lg = logits.float()
    V = lg.shape[-1]
    gmax = lg.max(-1).values.detach()
    lse = torch.log(torch.exp(lg - gmax[:, None]).sum(-1)) + gmax
    in_range = (labels >= 0) & (labels < V)
    label_logit = lg.gather(1, labels.clamp(0, V - 1)[:, None])[:, 0]
    return lse - torch.where(in_range, label_logit,
                             torch.zeros_like(label_logit))


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
            return _logits(cfg, params,
                           torch.as_tensor(tokens, device=dev).long())

    return fwd


def _build_loss_fn(cfg: TransformerConfig, n_micro: int):
    """loss(params, tokens, labels): the mean next-token nll over the
    B * T positions, f32 scalar (``_build_loss_fn`` at pp = tp = sp =
    ep = dp = 1)."""
    def loss_fn(params, tokens, labels):
        logits = _logits(cfg, params, tokens, n_micro)
        B, T, V = logits.shape
        return _xent(logits.reshape(B * T, V), labels.reshape(B * T)).mean()

    return loss_fn


def _loss_and_grads(cfg, n_micro):
    """fn(params, tokens, labels) -> (loss, {name: gradient}): the loss
    and its gradients with respect to every parameter, in the param
    dtypes.  The parameters themselves are not marked: the gradients
    are taken through detached aliases of them."""
    loss_fn = _build_loss_fn(cfg, n_micro)

    def loss_and_grads(params, tokens, labels):
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        loss = loss_fn(leaves, tokens, labels)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    return loss_and_grads


@torch.no_grad()
def _update(params, opt_state, grads, optimizer, lr, betas=(0.9, 0.999),
            eps=1e-8):
    """SGD (``_build_device_step``) or Adam (``_build_adam_zero1_step``
    at dp = 1) in place.  Gradients are cast to f32; the update is
    ``(p.float() - delta).to(p.dtype)``; Adam's moments are f32 and its
    bias corrections use t + 1."""
    if optimizer == "adam":
        b1, b2 = betas
        t = opt_state["t"] + 1.0
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    for name, g in grads.items():
        p, g32 = params[name], g.float()
        if optimizer == "sgd":
            delta = lr * g32
        else:
            m, v = opt_state["m"][name], opt_state["v"][name]
            m.copy_(b1 * m + (1.0 - b1) * g32)
            v.copy_(b2 * v + (1.0 - b2) * g32 * g32)
            delta = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p.copy_((p.float() - delta).to(p.dtype))
    if optimizer == "adam":
        opt_state["t"].copy_(t)


def _make_step_common(cfg, device, n_micro, lr, optimizer, betas, eps,
                      k_steps):
    """Shared plumbing of :func:`make_train_step` and
    :func:`make_fused_train_steps`: builds the device step (looped
    ``k_steps`` times when k_steps is not None) and returns
    (step, info)."""
    if optimizer not in ("sgd", "adam"):
        raise MXNetError("optimizer must be 'sgd' or 'adam' (got %r)"
                         % (optimizer,))
    dev = resolve(device)
    loss_and_grads = _loss_and_grads(cfg, int(n_micro))

    def device_step(params, opt_state, tokens, labels):
        loss, grads = loss_and_grads(params, tokens, labels)
        _update(params, opt_state, grads, optimizer, lr, betas, eps)
        return loss

    def run(params, opt_state, tokens, labels):
        """Parameters, moments and t are updated in place (JAX donates
        them); returns the loss or the K losses."""
        if dev.type == "cuda":
            _set_matmul_numerics()
        tokens = torch.as_tensor(tokens, device=dev).long()
        labels = torch.as_tensor(labels, device=dev).long()
        if k_steps is None:
            return device_step(params, opt_state, tokens, labels)
        return torch.stack([device_step(params, opt_state, tokens[i],
                                        labels[i]) for i in range(k_steps)])

    if optimizer == "sgd":
        def step(params, tokens, labels):
            return params, run(params, None, tokens, labels)
    else:
        def step(params, opt_state, tokens, labels):
            loss = run(params, opt_state, tokens, labels)
            return params, opt_state, loss
    info = {"device": dev, "optimizer": optimizer, "n_micro": int(n_micro),
            "k_steps": k_steps}
    return step, info


def make_train_step(cfg: TransformerConfig, device=None, n_micro: int = 1,
                    lr: float = 1e-2, optimizer: str = "sgd",
                    betas=(0.9, 0.999), eps: float = 1e-8):
    """Training step on ``device`` (default the card).

    optimizer="sgd" (default): (params, tokens, labels) ->
    (params, loss).

    optimizer="adam": (params, opt_state, tokens, labels) ->
    (params, opt_state, loss), with :func:`init_opt_state` building the
    moments.  tokens/labels are [B, T] int arrays or tensors; the loss
    is an f32 scalar tensor on the device.  Parameters and optimizer
    state are updated in place and returned (JAX donates them), so the
    caller's dicts hold the new values.  Returns (step, info)."""
    return _make_step_common(cfg, device, n_micro, lr, optimizer, betas,
                             eps, k_steps=None)


def make_fused_train_steps(cfg: TransformerConfig, k_steps: int,
                           device=None, n_micro: int = 1, lr: float = 1e-2,
                           optimizer: str = "adam", betas=(0.9, 0.999),
                           eps: float = 1e-8):
    """K training steps in one call (JAX's ``lax.scan`` over steps is a
    Python loop here).  Data arrives stacked: tokens/labels are
    [K, B, T].

    adam: (params, opt_state, toks_stack, labs_stack) ->
    (params, opt_state, losses[K]).
    sgd:  (params, toks_stack, labs_stack) -> (params, losses[K]).
    Updates in place, as :func:`make_train_step`.  Returns
    (step, info)."""
    k_steps = int(k_steps)
    if k_steps < 1:
        raise MXNetError("make_fused_train_steps: k_steps must be >= 1 "
                         "(got %d): a zero-length loop would train "
                         "nothing" % k_steps)
    return _make_step_common(cfg, device, n_micro, lr, optimizer, betas,
                             eps, k_steps=k_steps)
