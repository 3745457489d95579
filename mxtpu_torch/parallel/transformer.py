"""TransformerLM of the PyTorch port, forward and training, over a mesh.

Counterpart of ``mxtpu/parallel/transformer.py``: ``TransformerConfig``,
``param_specs``, ``param_shapes``, ``init_params``, ``_plan_for_mesh``,
``_zero1_dims``, ``_opt_state_specs``, ``init_opt_state``,
``_grad_psum_axes``, ``_rms_norm``, ``_attention``, ``_dense_ffn``,
``_stage_fn`` (with ``apply_remat``), ``_sharded_xent``,
``_build_loss_fn``, ``_build_device_step``, ``_gather_delta``,
``_build_adam_zero1_step``, ``make_train_step``,
``make_fused_train_steps`` and ``make_forward``.

The second argument of each entry point is a :class:`~.mesh.Mesh` or a
device (a device, a context or a string; None: the card), which is the
one-device mesh.  One body serves every mesh: the JAX module's
manual-SPMD step with one controller driving every shard (:mod:`.spmd`).
Each value is a list with one tensor per mesh coordinate, the step body
runs in lock-step over the coordinates, and the collectives sit where
the JAX code has them: dp shards the batch, pp stacks the layers per
stage and passes microbatches along with ``ppermute`` (``n_micro + pp -
1`` slots), tp splits attention and FFN Megatron-style and the
vocabulary of the embedding and the cross-entropy, sp rings attention
over the sequence shards (:func:`~.ring_attention.ring_attention`: the
flash kernels on the card), and ep replicates the dense FFN.  The loss
is that of the first coordinate; each gradient is then summed over the
axes its parameter is replicated on (``_grad_psum_axes``), which is what
shard_map's AD does.  On one device every group has one member, so the
collectives do nothing.

The entry points hand out plain tensors on a one-device mesh and
:class:`~.spmd.Sharded` values laid out by ``param_specs`` and
``_opt_state_specs`` on a larger one.  The steps update parameters and
moments in place and return them (JAX donates them).  The parameters
keep the JAX layout and names: a dict whose per-layer entries carry
leading (pp, layers_per_stage) axes (:func:`param_shapes`).
:func:`params_from_jax` and :func:`opt_state_from_jax` take the JAX
package's global values as numpy arrays, so both packages compute one
function.

Left out: the MoE FFN (``_moe_ffn``: ``n_experts > 0`` raises, ROADMAP
A12b), and with it ``dryrun`` and ``dryrun_parity``, whose rotation
runs experts.
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
from . import spmd
from .mesh import (AXIS_DP, AXIS_EP, AXIS_PP, AXIS_SP, AXIS_TP, Mesh,
                   create_mesh)
from .ring_attention import ring_attention
from .spmd import P

__all__ = ["TransformerConfig", "param_specs", "param_shapes",
           "init_params", "params_from_jax", "opt_state_from_jax",
           "init_opt_state", "make_forward", "make_train_step",
           "make_fused_train_steps"]

_LAYER_PARAMS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")
# params below this element count keep replicated optimizer state
# (ZeRO-sharding a LayerNorm vector costs a collective, saves nothing)
_ZERO1_MIN_ELEMS = 4096
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


def _as_mesh(mesh) -> Mesh:
    """The mesh an entry point runs on: ``mesh`` when it is a
    :class:`Mesh`, else the one-device mesh over it (a device, a context
    or a string; None: the card)."""
    return mesh if isinstance(mesh, Mesh) else create_mesh(devices=[mesh])


def _placed(x: spmd.Sharded):
    """A value as the entry points hand it out: on a one-device mesh its
    one tensor, else the :class:`~.spmd.Sharded` value."""
    return x.shards[0] if x.mesh.size == 1 else x


def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """PartitionSpec per parameter (Megatron layout on tp, stage-stacked
    on pp)."""
    return {
        "embed": P(AXIS_TP, None),       # vocab-sharded embedding
        "pos": P(None, None),
        "ln_f": P(None),
        "unembed": P(None, AXIS_TP),     # vocab-sharded unembedding
        "wq": P(AXIS_PP, None, None, AXIS_TP),   # column parallel
        "wk": P(AXIS_PP, None, None, AXIS_TP),
        "wv": P(AXIS_PP, None, None, AXIS_TP),
        "wo": P(AXIS_PP, None, AXIS_TP, None),   # row parallel
        "ln1": P(AXIS_PP, None, None),
        "ln2": P(AXIS_PP, None, None),
        "w1": P(AXIS_PP, None, None, AXIS_TP),
        "w2": P(AXIS_PP, None, AXIS_TP, None),
    }


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


def shard_params(params, cfg: TransformerConfig, mesh: Mesh):
    """Global parameters (tensors or numpy arrays, stacked for any pp)
    laid out on ``mesh``: each restacked to the mesh's pp and split by
    :func:`param_specs`."""
    shapes = param_shapes(cfg, mesh.shape[AXIS_PP])
    specs = param_specs(cfg)
    return {name: spmd.shard(spmd._as_tensor(x).reshape(shapes[name]),
                             mesh, specs[name])
            for name, x in params.items()}


def init_params(cfg: TransformerConfig, mesh=None, seed: int = 0):
    """Random parameters from a ``torch.Generator`` seeded with
    ``seed``: normal with std 1/sqrt(fan_in), in name order as the JAX
    package draws them, and ones for the norm scales.  ``mesh`` is a
    mesh or a device (default the card).  The values are drawn on the
    mesh's first device and do not depend on the mesh: they are laid
    out by :func:`param_specs`.  They differ from the JAX package's
    (another generator); use :func:`params_from_jax` for equal
    weights."""
    mesh = _as_mesh(mesh)
    dev = mesh.device
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
    return {name: _placed(x)
            for name, x in shard_params(params, cfg, mesh).items()}


def _from_numpy(arr) -> torch.Tensor:
    """A numpy array as a CPU tensor; bfloat16 (numpy's extension dtype)
    by its bits."""
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(np_params: Dict[str, np.ndarray],
                    cfg: TransformerConfig, mesh=None):
    """The JAX package's global parameters (``{k: np.asarray(v)}`` of
    ``mxtpu.parallel.transformer.init_params``, stacked for the mesh's
    pp) as the port's, on ``mesh`` (a mesh or a device).  bfloat16
    arrays are carried over by their bits, so the values are exactly
    equal; other dtypes convert through numpy."""
    mesh = _as_mesh(mesh)
    shapes = param_shapes(cfg, mesh.shape[AXIS_PP])
    if set(np_params) != set(shapes):
        raise MXNetError("parameter names %s do not match the config's %s"
                         % (sorted(np_params), sorted(shapes)))
    out = {}
    for name, arr in np_params.items():
        t = _from_numpy(arr)
        if tuple(t.shape) != tuple(shapes[name]):
            raise MXNetError("parameter %r has shape %s, the config says %s"
                             % (name, tuple(t.shape), shapes[name]))
        out[name] = t.to(dtype=cfg.torch_dtype)
    return {name: _placed(x)
            for name, x in shard_params(out, cfg, mesh).items()}


def _plan_for_mesh(cfg: TransformerConfig, mesh: Mesh):
    """The transformer stack's ShardingPlan: the Megatron specs plus
    ZeRO-1 state sharding over dp."""
    from ..sharding.plan import ShardingPlan

    return ShardingPlan(mesh=mesh, data_axis=AXIS_DP, model_axis=AXIS_TP,
                        param_specs=param_specs(cfg),
                        shard_optimizer_state=True,
                        min_shard_elems=_ZERO1_MIN_ELEMS, name="transformer")


def _zero1_dims(cfg: TransformerConfig, mesh: Mesh) -> Dict[str, Any]:
    """Per parameter, the dimension its Adam moments are split over dp
    (``ShardingPlan.shard_dim``), or None: replicated."""
    plan = _plan_for_mesh(cfg, mesh)
    shapes = param_shapes(cfg, mesh.shape[AXIS_PP])
    return {name: plan.shard_dim(name, shape)
            for name, shape in shapes.items()}


def _opt_state_specs(cfg: TransformerConfig, mesh: Mesh):
    """The moments' specs: the parameter's with dp on its ZeRO-1 dim
    (``ShardingPlan.opt_state_spec``)."""
    plan = _plan_for_mesh(cfg, mesh)
    shapes = param_shapes(cfg, mesh.shape[AXIS_PP])
    return {name: plan.opt_state_spec(name, shape)
            for name, shape in shapes.items()}


def init_opt_state(cfg: TransformerConfig, mesh=None):
    """Adam state: per-parameter first and second moments, f32 zeros,
    and the step counter ``t`` (an f32 scalar), on ``mesh`` (a mesh or
    a device, default the card).  Each device holds 1/dp of every moment
    that ZeRO-1 splits (:func:`_opt_state_specs`); on one device the
    slice is all of it."""
    mesh = _as_mesh(mesh)
    shapes = param_shapes(cfg, mesh.shape[AXIS_PP])
    ospecs = _opt_state_specs(cfg, mesh)
    state = {key: {name: _placed(spmd.zeros(shape, torch.float32, mesh,
                                            ospecs[name]))
                   for name, shape in shapes.items()} for key in ("m", "v")}
    state["t"] = _placed(spmd.zeros((), torch.float32, mesh, P()))
    return state


def opt_state_from_jax(np_state, cfg: TransformerConfig, mesh=None):
    """The JAX package's Adam state (``{"m": {k: array}, "v": {...},
    "t": scalar}`` as numpy, global) as the port's, on ``mesh``."""
    mesh = _as_mesh(mesh)
    shapes = param_shapes(cfg, mesh.shape[AXIS_PP])
    ospecs = _opt_state_specs(cfg, mesh)
    state = {}
    for key in ("m", "v"):
        if set(np_state[key]) != set(shapes):
            raise MXNetError("moment names %s do not match the config's %s"
                             % (sorted(np_state[key]), sorted(shapes)))
        state[key] = {
            name: _placed(spmd.shard(
                _from_numpy(arr).float().reshape(shapes[name]), mesh,
                ospecs[name]))
            for name, arr in np_state[key].items()}
    t = torch.tensor(float(np.asarray(np_state["t"])), dtype=torch.float32)
    state["t"] = _placed(spmd.shard(t, mesh, P()))
    return state


def _grad_psum_axes(cfg: TransformerConfig) -> Dict[str, Tuple[str, ...]]:
    """The axes each gradient is summed over: the mesh axes its
    parameter is replicated on."""
    axes = {}
    for name, spec in param_specs(cfg).items():
        sharded = {a for dim in spec for a in spmd._axes(dim)}
        axes[name] = tuple(a for a in (AXIS_DP, AXIS_PP, AXIS_TP, AXIS_SP,
                                       AXIS_EP) if a not in sharded)
    return axes


def _rms_norm(x, scale):
    """x * rsqrt(mean(x^2) + 1e-6) in f32, cast to x's dtype, THEN the
    scale multiplies in x's dtype (the JAX package's cast order)."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.reciprocal(torch.sqrt(var + 1e-6))).to(x.dtype) \
        * scale


def _attention(cfg, mesh, x, wq, wk, wv, wo):
    """Causal self-attention with tp: x [B, T_loc, E]; wq/wk/wv [E, E/tp]
    (the local columns), wo [E/tp, E] (the local rows), whose partial
    products sum over tp.  Each sp group's heads go round the ring."""
    h_loc = cfg.n_heads // mesh.shape[AXIS_TP]
    D = cfg.d_model // cfg.n_heads

    def qkv(x, wq, wk, wv):  # strided (B, H/tp, T_loc, D) views
        B, T, _ = x.shape
        return tuple(h.reshape(B, T, h_loc, D).transpose(1, 2)
                     for h in (x @ wq, x @ wk, x @ wv))

    q, k, v = spmd.pmap(qkv, x, wq, wk, wv)
    o = list(q)
    for members in spmd.groups(mesh, AXIS_SP):
        outs = ring_attention([q[c] for c in members],
                              [k[c] for c in members],
                              [v[c] for c in members], causal=True)
        for c, out in zip(members, outs):
            o[c] = out

    def project(o, wo):
        B, _, T, _ = o.shape
        return o.transpose(1, 2).reshape(B, T, h_loc * D) @ wo

    return spmd.psum(mesh, spmd.pmap(project, o, wo), AXIS_TP)


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


def _layer(cfg, mesh, x, ln1, wq, wk, wv, wo, ln2, w1, w2):
    """One pre-norm block over the mesh: tp column/row-parallel
    attention on the sp ring, then the tp-split dense FFN."""
    pmap = spmd.pmap
    h = pmap(torch.add, x, _attention(cfg, mesh, pmap(_rms_norm, x, ln1),
                                      wq, wk, wv, wo))
    f = pmap(_dense_ffn, pmap(_rms_norm, h, ln2), w1, w2)
    return pmap(torch.add, h, spmd.psum(mesh, f, AXIS_TP))


def _stage_fn(cfg, mesh, stage, x):
    """Each coordinate's pipeline stage over x (``stage[name]``: the
    per-coordinate [lps, ...] weights), a layer at a time over the whole
    mesh, a Python loop in place of ``lax.scan``.  When the call is
    differentiated and ``cfg.remat`` names a policy, each layer runs
    under :func:`~mxtpu_torch.executor.apply_remat`; without a gradient
    remat has nothing to save and the layers run as they are."""
    layer = functools.partial(_layer, cfg, mesh)
    if cfg.remat != "none" and torch.is_grad_enabled():
        layer = apply_remat(layer, cfg.remat)
    for i in range(stage["wq"][0].shape[0]):
        x = layer(x, *([w[i] for w in stage[name]]
                       for name in _LAYER_PARAMS))
    return x


def _stage_weights(params, members):
    """The layer weights of the coordinates ``members`` (one pipeline
    stage): the pp axis is split, so each has extent 1 there."""
    return {name: [params[name][c][0] for c in members]
            for name in _LAYER_PARAMS}


def _embed(cfg, mesh, params, tokens):
    """Token plus position embedding of the local tokens [B, T_loc]
    (long tensors), the vocab-sharded lookup: each tp member's rows,
    zeros for tokens outside its shard (so a token outside [0, vocab)
    embeds as zeros), summed over tp in the param dtype (one member
    contributes each row, so the sum is exact); plus this sp shard's
    positions, cast to ``cfg.dtype``.  The gradient of the lookup is a
    scatter-add into ``embed`` in the param dtype (JAX's gather
    transpose)."""
    V_loc = cfg.vocab // mesh.shape[AXIS_TP]
    T = tokens[0].shape[1]
    if T * mesh.shape[AXIS_SP] > cfg.max_len:
        raise MXNetError("sequence length %d exceeds max_len %d"
                         % (T * mesh.shape[AXIS_SP], cfg.max_len))

    def lookup(tok, embed, tp_idx):
        local = tok - tp_idx * V_loc
        rows = embed[local.clamp(0, V_loc - 1)]
        inside = (local >= 0) & (local < V_loc)
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    emb = spmd.psum(mesh, spmd.pmap(lookup, tokens, params["embed"],
                                    spmd.axis_index(mesh, AXIS_TP)), AXIS_TP)
    return spmd.pmap(
        lambda e, pos, i: (e + pos[i * T:(i + 1) * T][None]).to(
            cfg.torch_dtype),
        emb, params["pos"], spmd.axis_index(mesh, AXIS_SP))


def _pipeline(cfg, mesh, params, tokens, n_micro):
    """The embedding and the layer stack: at each last-stage coordinate
    its output [B_loc, T_loc, E], the microbatches in order; None at the
    other coordinates.  GPipe over n_micro + pp - 1 slots: the first
    stage takes a microbatch a slot, each stage passes its output to the
    next with a ppermute.  A stage runs only in the slots where it holds
    a microbatch: the JAX code also runs it in the others and drops what
    comes out."""
    pp = mesh.shape[AXIS_PP]
    B, T = tokens[0].shape
    if B % n_micro:
        raise MXNetError("local batch %d %% n_micro %d" % (B, n_micro))
    mb = B // n_micro
    x = [xi.reshape(n_micro, mb, T, cfg.d_model)
         for xi in _embed(cfg, mesh, params, tokens)]
    perm = [(i, (i + 1) % pp) for i in range(pp)]
    stages = [spmd.sub_mesh(mesh, AXIS_PP, p) for p in range(pp)]
    kept = [[None] * n_micro for _ in x]
    state = [None] * mesh.size
    n_slots = n_micro + pp - 1
    for s in range(n_slots):
        out = [None] * mesh.size
        for p, (members, sub) in enumerate(stages):
            k = s - p
            if not 0 <= k < n_micro:
                continue
            inp = [x[c][k] if p == 0 else state[c] for c in members]
            res = _stage_fn(cfg, sub, _stage_weights(params, members), inp)
            for c, r in zip(members, res):
                out[c] = r
                if p == pp - 1:
                    kept[c][k] = r
        if s < n_slots - 1:
            state = spmd.ppermute(mesh, out, AXIS_PP, perm)
    return [torch.cat(k) if k[0] is not None else None for k in kept]


def _head(params, h, members):
    """Logits [B_loc, T_loc, V/tp] at the coordinates ``members``: the
    final norm and this tp member's unembedding columns."""
    return [_rms_norm(h[c], params["ln_f"][c]) @ params["unembed"][c]
            for c in members]


def _sharded_xent(mesh, logits, labels, V_loc):
    """Softmax cross-entropy per row with the vocabulary split over tp:
    logits [N, V/tp] widened to f32, the logsumexp from a psum of the
    shards' sums (shifted by the pmax of their row maxima, held constant
    for the gradient, as JAX's stop_gradient does), minus the label's
    logit from the shard that holds it; a label outside [0, vocab)
    picks no logit."""
    lg = [x.float() for x in logits]
    gmax = spmd.pmax(mesh, [x.max(-1).values.detach() for x in lg], AXIS_TP)
    sums = spmd.pmap(lambda x, m: torch.exp(x - m[:, None]).sum(-1), lg,
                     gmax)
    lse = spmd.pmap(lambda s, m: torch.log(s) + m,
                    spmd.psum(mesh, sums, AXIS_TP), gmax)

    def label_logit(x, lab, tp_idx):
        local = lab - tp_idx * V_loc
        picked = x.gather(1, local.clamp(0, V_loc - 1)[:, None])[:, 0]
        inside = (local >= 0) & (local < V_loc)
        return torch.where(inside, picked, torch.zeros_like(picked))

    ll = spmd.psum(mesh, spmd.pmap(label_logit, lg, labels,
                                   spmd.axis_index(mesh, AXIS_TP)), AXIS_TP)
    return spmd.pmap(torch.sub, lse, ll)


def _build_loss_fn(cfg: TransformerConfig, mesh: Mesh, n_micro: int):
    """loss(params, tokens, labels), each a per-coordinate list
    (tokens/labels the local [B_loc, T_loc] shards of the (dp, sp)
    split): the mean next-token nll over the global B * T positions, an
    f32 scalar at every coordinate (the same value)."""
    pp, tp = mesh.shape[AXIS_PP], mesh.shape[AXIS_TP]
    n_rep = mesh.shape[AXIS_DP] * mesh.shape[AXIS_SP] * mesh.shape[AXIS_EP]
    V_loc = cfg.vocab // tp
    last, last_mesh = spmd.sub_mesh(mesh, AXIS_PP, pp - 1)

    def loss_fn(params, tokens, labels):
        h = _pipeline(cfg, mesh, params, tokens, n_micro)
        # only the last stage's output is the model's: its nll, zeros
        # from the other stages
        nll = _sharded_xent(last_mesh,
                            [x.reshape(-1, V_loc)
                             for x in _head(params, h, last)],
                            [labels[c].reshape(-1) for c in last], V_loc)
        mean = {c: n.mean() for c, n in zip(last, nll)}
        local = [mean[c] if c in mean else
                 torch.zeros((), dtype=torch.float32,
                             device=mesh.device_at(coord))
                 for c, coord in enumerate(mesh.coords)]
        # mean over dp x sp; the sum over pp picks the last stage; the
        # ep replicas hold equal copies
        total = spmd.psum(mesh, local, (AXIS_PP, AXIS_DP, AXIS_SP, AXIS_EP))
        return [t / n_rep for t in total]

    return loss_fn


def _loss_and_grads(cfg, mesh, n_micro):
    """fn(params, tokens, labels) -> (loss, {name: per-coordinate
    gradients}): the first coordinate's loss differentiated with respect
    to every coordinate's parameter shard, each gradient then summed
    over the axes its parameter is replicated on (shard_map's AD does
    that sum for a replicated input).  The parameters themselves are not
    marked: the gradients are taken through detached aliases of them."""
    loss_fn = _build_loss_fn(cfg, mesh, n_micro)
    psum_axes = _grad_psum_axes(cfg)

    def loss_and_grads(params, tokens, labels):
        leaves = {n: [t.detach().requires_grad_(True) for t in ts]
                  for n, ts in params.items()}
        loss = loss_fn(leaves, tokens, labels)[0]
        flat = [t for ts in leaves.values() for t in ts]
        got = iter(torch.autograd.grad(loss, flat, allow_unused=True,
                                       materialize_grads=True))
        grads = {n: spmd.psum(mesh, [next(got) for _ in ts], psum_axes[n])
                 for n, ts in leaves.items()}
        return loss.detach(), grads

    return loss_and_grads


@torch.no_grad()
def _sgd(params, grads, lr):
    """``_build_device_step``'s update at every coordinate, in place:
    ``(p.float() - lr * g.float()).to(p.dtype)``."""
    for n, ps in params.items():
        for p, g in zip(ps, grads[n]):
            p.copy_((p.float() - lr * g.float()).to(p.dtype))


def _gather_delta(mesh, deltas, dim):
    """Each dp member's slice of the weight update, gathered over dp
    along ``dim`` (in dp order)."""
    return spmd.all_gather(mesh, deltas, AXIS_DP, dim)


@torch.no_grad()
def _adam_zero1(cfg, mesh, params, opt, grads, lr, betas, eps):
    """``_build_adam_zero1_step``'s update, in place: each dp member
    updates the slice of every moment it owns along the parameter's
    ZeRO-1 dim with the matching slice of the f32 gradient (at dp = 1
    the slice is all of it); the weight deltas are gathered over dp and
    each parameter becomes ``(p.float() - delta).to(p.dtype)``.  The
    moments are f32 and the bias corrections use t + 1."""
    dp = mesh.shape[AXIS_DP]
    dp_idx = spmd.axis_index(mesh, AXIS_DP)
    zdims = _zero1_dims(cfg, mesh)
    b1, b2 = betas
    t = [x + 1.0 for x in opt["t"]]
    for name, gs in grads.items():
        dim = zdims[name]
        split = dim is not None and dp > 1
        deltas = []
        for c, g in enumerate(gs):
            g32 = g.float()
            if split:
                chunk = g32.shape[dim] // dp
                g32 = g32.narrow(dim, dp_idx[c] * chunk, chunk)
            m, v = opt["m"][name][c], opt["v"][name][c]
            m.copy_(b1 * m + (1.0 - b1) * g32)
            v.copy_(b2 * v + (1.0 - b2) * g32 * g32)
            bc1, bc2 = 1.0 - b1 ** t[c], 1.0 - b2 ** t[c]
            deltas.append(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
        if split:
            deltas = _gather_delta(mesh, deltas, dim)
        for p, d in zip(params[name], deltas):
            p.copy_((p.float() - d).to(p.dtype))
    for x, tn in zip(opt["t"], t):
        x.copy_(tn)


def _shards(tree, mesh: Mesh, specs):
    """{name: the per-coordinate list} of a tree as the entry points
    hand it out: on a one-device mesh each value is a tensor, the list's
    one member; on a larger mesh each must be a :class:`~.spmd.Sharded`
    value laid out on ``mesh`` by its spec."""
    out = {}
    for name, spec in specs.items():
        x = tree[name]
        if mesh.size == 1 and isinstance(x, torch.Tensor):
            out[name] = [x]
            continue
        if not (isinstance(x, spmd.Sharded) and x.mesh == mesh
                and x.spec == spec):
            raise MXNetError("%r is not laid out on the step's mesh by %r "
                             "(init_params, shard_params or params_from_jax "
                             "on the same mesh lay it out)" % (name, spec))
        out[name] = x.shards
    return out


def _local_data(x, sharding: spmd.NamedSharding):
    """Tokens or labels as per-coordinate long tensors laid out by
    ``sharding``: a global array or tensor is split, a sharded one laid
    out again unless it already is."""
    if not (isinstance(x, spmd.Sharded) and x.mesh == sharding.mesh
            and x.spec == sharding.spec):
        x = spmd.device_put(x, sharding)
    return [t.long() for t in x.shards]


def _make_step_common(cfg, mesh, n_micro, lr, optimizer, betas, eps,
                      k_steps):
    """Shared plumbing of :func:`make_train_step` and
    :func:`make_fused_train_steps`: builds the step on the mesh (looped
    ``k_steps`` times when k_steps is not None) and returns (step,
    info)."""
    if optimizer not in ("sgd", "adam"):
        raise MXNetError("optimizer must be 'sgd' or 'adam' (got %r)"
                         % (optimizer,))
    specs = param_specs(cfg)
    ospecs = _opt_state_specs(cfg, mesh) if optimizer == "adam" else None
    data = spmd.NamedSharding(mesh, P(AXIS_DP, AXIS_SP) if k_steps is None
                              else P(None, AXIS_DP, AXIS_SP))
    loss_and_grads = _loss_and_grads(cfg, mesh, int(n_micro))
    info = {"device": mesh.device, "mesh": mesh, "optimizer": optimizer,
            "n_micro": int(n_micro), "k_steps": k_steps, "data": data}

    def device_step(params, opt, tokens, labels):
        loss, grads = loss_and_grads(params, tokens, labels)
        if optimizer == "sgd":
            _sgd(params, grads, lr)
        else:
            _adam_zero1(cfg, mesh, params, opt, grads, lr, betas, eps)
        return loss

    def run(params, opt_state, tokens, labels):
        """Parameters, moments and t are updated in place (JAX donates
        them); returns the loss or the K losses."""
        if mesh.device.type == "cuda":
            _set_matmul_numerics()
        p = _shards(params, mesh, specs)
        o = None if opt_state is None else {
            "m": _shards(opt_state["m"], mesh, ospecs),
            "v": _shards(opt_state["v"], mesh, ospecs),
            "t": _shards({"t": opt_state["t"]}, mesh, {"t": P()})["t"]}
        toks, labs = _local_data(tokens, data), _local_data(labels, data)
        if k_steps is None:
            return device_step(p, o, toks, labs)
        return torch.stack([device_step(p, o, [t[i] for t in toks],
                                        [t[i] for t in labs])
                            for i in range(k_steps)])

    if optimizer == "sgd":
        def step(params, tokens, labels):
            return params, run(params, None, tokens, labels)
    else:
        def step(params, opt_state, tokens, labels):
            loss = run(params, opt_state, tokens, labels)
            return params, opt_state, loss
    return step, info


def _set_matmul_numerics():
    """The JAX package's product numerics on the card: f32 products in
    full f32 (no TF32) and bf16 products reduced in f32.  torch's
    default lets cuBLAS reduce bf16 GEMMs in bf16.  The flags are
    process-wide, so the forward sets them on each call on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def make_train_step(cfg: TransformerConfig, mesh=None, n_micro: int = 1,
                    lr: float = 1e-2, optimizer: str = "sgd",
                    betas=(0.9, 0.999), eps: float = 1e-8):
    """Training step on ``mesh`` (a mesh, or a device: default the
    card).

    optimizer="sgd" (default): (params, tokens, labels) ->
    (params, loss).

    optimizer="adam": ZeRO-1 sharded Adam, (params, opt_state, tokens,
    labels) -> (params, opt_state, loss), with :func:`init_opt_state`
    building the moments.  tokens/labels are global [B, T] int arrays or
    tensors (or values already laid out by ``info["data"]``, split over
    (dp, sp)); the loss is an f32 scalar tensor on the mesh's first
    device.  The parameters and the state are updated in place and
    returned (JAX donates them).  Returns (step, info): info carries the
    device, the mesh and the data's layout (``"data"``, as the JAX
    package's ``shardings["data"]``: ``spmd.device_put(tokens,
    info["data"])``)."""
    return _make_step_common(cfg, _as_mesh(mesh), n_micro, lr, optimizer,
                             betas, eps, k_steps=None)


def make_fused_train_steps(cfg: TransformerConfig, mesh, k_steps: int,
                           n_micro: int = 1, lr: float = 1e-2,
                           optimizer: str = "adam", betas=(0.9, 0.999),
                           eps: float = 1e-8):
    """K training steps in one call (JAX's ``lax.scan`` over steps is a
    Python loop here).  Data arrives stacked: tokens/labels are
    [K, B, T] (split over (None, dp, sp)).

    adam: (params, opt_state, toks_stack, labs_stack) ->
    (params, opt_state, losses[K]).
    sgd:  (params, toks_stack, labs_stack) -> (params, losses[K]).
    As :func:`make_train_step` otherwise.  Returns (step, info)."""
    k_steps = int(k_steps)
    if k_steps < 1:
        raise MXNetError("make_fused_train_steps: k_steps must be >= 1 "
                         "(got %d): a zero-length loop would train "
                         "nothing" % k_steps)
    return _make_step_common(cfg, _as_mesh(mesh), n_micro, lr, optimizer,
                             betas, eps, k_steps=k_steps)


def make_forward(cfg: TransformerConfig, mesh=None):
    """The inference forward on ``mesh`` (a mesh, or a device: default
    the card): ``fwd(params, tokens) -> logits [B, T, V]`` in the
    config's dtype, on the mesh's first device.  ``tokens`` is an int
    array or tensor [B, T] (split over (dp, sp)); a token outside
    [0, vocab) embeds as zeros, as the JAX package's vocab-sharded
    lookup does.  It runs the training loss's pipeline with one
    microbatch and reads the logits from the last stage.  On the card
    each call first sets torch's matmul flags to the JAX package's
    numerics (:func:`_set_matmul_numerics`)."""
    mesh = _as_mesh(mesh)
    data = spmd.NamedSharding(mesh, P(AXIS_DP, AXIS_SP))
    specs = param_specs(cfg)
    last, last_mesh = spmd.sub_mesh(mesh, AXIS_PP, mesh.shape[AXIS_PP] - 1)

    def fwd(params, tokens):
        if mesh.device.type == "cuda":
            _set_matmul_numerics()
        p = _shards(params, mesh, specs)
        with torch.inference_mode():
            h = _pipeline(cfg, mesh, p, _local_data(tokens, data), 1)
            # the ep replicas are equal copies: the first is read
            return spmd.Sharded(_head(p, h, last), last_mesh,
                                P(AXIS_DP, AXIS_SP, AXIS_TP)).gather(
                                    mesh.device)

    return fwd
