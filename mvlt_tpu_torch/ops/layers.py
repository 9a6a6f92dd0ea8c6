"""Layer primitives of the port (counterpart of ``mvlt_tpu/ops/layers.py``).

Numerics follow the JAX package: exact (erf) GELU, LayerNorm eps 1e-5 in
Swin and 1e-12 in the BERT fusion stack. Parameters live in the PyTorch
layout: a dense weight is ``(out, in)`` where flax keeps ``(in, out)``.
Dense weights and embeddings are stored in the parameter dtype: the compute
dtype for serving (cast once at load time), float32 masters for training
(cast to the compute dtype at every use, so the cast's backward returns f32
grads); LayerNorm parameters and the relative-position tables stay in
float32, as the JAX kernels take them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SWIN_LN_EPS = 1e-5
BERT_LN_EPS = 1e-12


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf GELU, computed in float32 and rounded back to ``x.dtype``."""
    return F.gelu(x.float()).to(x.dtype)


def gather_label_positions(hidden: torch.Tensor, labels: torch.Tensor,
                           k: int, ignore_index: int = -100):
    """Up to ``k`` positions per sample whose label is not ``ignore_index``,
    in their original order (``mvlt_tpu/ops/layers.py:119-147``): a stable
    argsort of ``labels == ignore_index`` puts the valid positions first,
    then the first ``min(k, L)`` are taken; valid positions beyond ``k`` are
    dropped. hidden: (B, L, H); labels: (B, L). Returns ``(hidden_g (B, k,
    H), labels_g (B, k))``."""
    k = min(k, labels.shape[1])
    order = torch.argsort((labels == ignore_index).to(torch.int32), dim=-1,
                          stable=True)
    idx = order[:, :k]
    hidden_g = hidden.gather(1, idx[..., None].expand(-1, -1, hidden.shape[-1]))
    return hidden_g, labels.gather(1, idx)


class DropoutMasks:
    """Where the train steps' dropout masks come from: ``draw(keep, shape,
    device)`` returns a bool keep-mask, ``bernoulli(keep)`` per element.

    ``DropoutMasks(generator)`` draws on the generator's device from that
    explicit ``torch.Generator`` (the JAX package draws with
    ``jax.random.bernoulli`` from its dropout key; the two streams differ).
    With ``record=True`` each draw is also kept, in order, in ``recorded``.
    ``DropoutMasks.replay(masks)`` hands out the given masks in order
    instead, checking each shape: two runs that replay one list see the same
    masks, and a test can replay the masks JAX drew. ``seed(device)`` draws
    the (2,) seed of in-kernel attention dropout in the same order, and is
    recorded and replayed as the masks are."""

    def __init__(self, generator: torch.Generator = None, *,
                 record: bool = False):
        self.generator = generator
        self.recorded = [] if record else None
        self._replay = None

    @classmethod
    def replay(cls, masks) -> "DropoutMasks":
        src = cls()
        src._replay = iter(list(masks))
        return src

    def _take(self, what: str, shape, dtype: torch.dtype, device,
              fresh) -> torch.Tensor:
        """The next replayed draw, checked against ``shape``, or ``fresh()``
        drawn on the generator's device; moved to ``device`` and
        recorded."""
        if self._replay is not None:
            t = next(self._replay, None)
            if t is None:
                raise RuntimeError(f"no recorded dropout {what} left to "
                                   "replay")
            t = torch.as_tensor(t).to(device=device, dtype=dtype)
            if tuple(t.shape) != shape:
                raise ValueError(f"replayed {what} {tuple(t.shape)} where "
                                 f"{shape} was drawn")
        else:
            t = fresh().to(device)
        if self.recorded is not None:
            self.recorded.append(t)
        return t

    def draw(self, keep: float, shape, device) -> torch.Tensor:
        shape = tuple(shape)
        return self._take("mask", shape, torch.bool, device, lambda: torch.rand(
            shape, generator=self.generator,
            device=self.generator.device) < keep)

    def seed(self, device) -> torch.Tensor:
        """A (2,) int32 seed of two 16-bit halves on ``device``, for the
        kernels' in-kernel attention dropout (JAX's ``jax.random.randint(key,
        (2,), 0, 2 ** 16)``, fusion.py:148-150). It is drawn on the
        generator's device and never read on the host: no synchronisation."""
        return self._take("seed", (2,), torch.int32, device,
                          lambda: torch.randint(
                              0, 2 ** 16, (2,), generator=self.generator,
                              device=self.generator.device,
                              dtype=torch.int32))

    def scaled(self, keep: float, shape, dtype: torch.dtype,
               device) -> torch.Tensor:
        """The multiplicative mask the fused kernels take: 0 or 1/keep in
        ``dtype`` (JAX's ``.astype(cdt) / keep``: 1.109375 in bf16 at keep
        0.9)."""
        return self.draw(keep, shape, device).to(dtype) / keep


class _UnitDraws(DropoutMasks):
    """The draws of one rematerialised unit: on the unit's first run each
    draw is taken from ``source`` (drawn, recorded or replayed there as
    usual) and kept; when the backward recomputes the unit,
    :meth:`rewind` makes it hand out the same draws again, in order, and
    ``source`` is not asked again."""

    def __init__(self, source: DropoutMasks):
        super().__init__()
        self.source = source
        self.taken = []
        self._pos = None

    def rewind(self) -> None:
        self._pos = 0

    def _next(self, what: str, shape, take) -> torch.Tensor:
        if self._pos is None:
            t = take()
            self.taken.append(t)
            return t
        if self._pos >= len(self.taken):
            raise RuntimeError(f"the recomputed unit drew a {what} more than "
                               "its first run did")
        t = self.taken[self._pos]
        self._pos += 1
        if tuple(t.shape) != tuple(shape):
            raise RuntimeError(f"the recomputed unit drew a {what} of shape "
                               f"{tuple(shape)} where its first run drew "
                               f"{tuple(t.shape)}")
        return t

    def draw(self, keep: float, shape, device) -> torch.Tensor:
        return self._next("mask", shape,
                          lambda: self.source.draw(keep, shape, device))

    def seed(self, device) -> torch.Tensor:
        return self._next("seed", (2,), lambda: self.source.seed(device))


def records_grad(x: torch.Tensor, module: nn.Module) -> bool:
    """Whether autograd records a call of ``module`` on ``x``: grad mode on
    and ``x`` or a parameter of the module needs a gradient."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in module.parameters()))


def rematerialized(unit: nn.Module, x: torch.Tensor, *args, masks=None):
    """``unit(x, *args, masks)`` under ``torch.utils.checkpoint`` (JAX's
    ``nn.remat``): the unit's activations are not kept for the backward,
    which runs its forward again first. Its dropout masks, DropPath
    multipliers and in-kernel dropout seeds are drawn once, on the first
    run, and the recompute takes the same ones (:class:`_UnitDraws`): the
    checkpoint's own RNG restore covers the default generators only, not
    the explicit one of a :class:`DropoutMasks`, nor a replayed list."""
    from torch.utils.checkpoint import checkpoint
    draws = None if masks is None else _UnitDraws(masks)
    first = [True]

    def run(x, *args):
        if draws is not None and not first[0]:
            draws.rewind()
        first[0] = False
        return unit(x, *args, masks=draws)

    # every draw is explicit: the default generators need no restore
    return checkpoint(run, x, *args, use_reentrant=False,
                      preserve_rng_state=False)


def drop_path_multipliers(masks, rate: float, batch: int, device):
    """The DropPath multipliers of one Swin block in training: ``(dp1,
    dp2)`` for its attention and MLP branches, each (B,) float32, 0 or
    ``1 / keep`` per image (the value that JAX's ``m.astype(f32) / keep``
    gives: 1.4285714 at rate 0.3, not a bf16 value), or None when ``masks``
    is None or the rate is 0 (no draw, as ``swin.py:291-300,324-333``).
    Two (B,) ``bernoulli(keep)`` draws from ``masks``, attention branch
    first."""
    if masks is None or rate <= 0.0:
        return None
    keep = 1.0 - rate
    scale = float(np.float32(1.0) / np.float32(keep))
    return tuple(masks.draw(keep, (batch,), device).float() * scale
                 for _ in range(2))


def drop_path_mask(masks, rate: float, batch: int, device):
    """One DropPath keep-mask of a Swin block on JAX's plain route: a (B, 1,
    1) bool ``bernoulli(1 - rate)`` draw from ``masks``, as flax
    ``DropPath`` draws it (``mvlt_tpu/ops/layers.py:75-89``), or None when
    ``masks`` is None or the rate is 0. The block draws ``drop_path1``'s
    after its attention's dropouts and ``drop_path2``'s after its MLP's."""
    if masks is None or rate <= 0.0:
        return None
    return masks.draw(1.0 - rate, (batch, 1, 1), device)


def drop_path(x: torch.Tensor, keep_mask, rate: float) -> torch.Tensor:
    """flax ``DropPath``: ``where(keep_mask, x / keep, 0)`` in x's dtype;
    ``keep_mask`` None leaves x as it is."""
    if keep_mask is None:
        return x
    return torch.where(keep_mask, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x: torch.Tensor, masks, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(mask, x / keep, 0)`` in x's dtype, the
    mask a ``bernoulli(1 - rate)`` draw of x's shape from ``masks``; x as it
    is, and no draw, when ``masks`` is None (deterministic) or the rate is
    0."""
    if masks is None or rate <= 0.0:
        return x
    return drop_path(x, masks.draw(1.0 - rate, x.shape, x.device), rate)


def dropout_part(x: torch.Tensor, masks, rate: float, tp,
                 dim: int = -1) -> torch.Tensor:
    """:func:`dropout` of a TP rank's block of a tensor split over ``tp``'s
    model group along ``dim`` (its heads, or its columns of a
    column-parallel product): the mask drawn at the whole tensor's shape,
    as one device draws it, and the rank's block of it kept. ``tp`` None is
    :func:`dropout`."""
    if tp is None or masks is None or rate <= 0.0:
        return dropout(x, masks, rate)
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * tp.size
    mask = masks.draw(1.0 - rate, shape, x.device).narrow(dim, tp.rank * n, n)
    return drop_path(x, mask, rate)


def cross_entropy_ignore_index(logits: torch.Tensor, labels: torch.Tensor,
                               ignore_index: int = -100, group=None,
                               vocab_group=None) -> torch.Tensor:
    """Mean cross entropy over labels != ignore_index, in f32 (0 if none is
    valid); ``mvlt_tpu/ops/layers.py:92``, torch ``F.cross_entropy``
    parity. logits: (..., classes); labels: (...) int.

    ``group`` (JAX's ``axis_name``, ``layers.py:101-116``): the NLL sum and
    the valid count are summed over that process group (the data group) so
    that the mean is over the global batch's valid labels, whatever each
    rank's count; the sum is Megatron's *g*, so each rank's backward
    carries its own terms, and the data group's gradient sum completes it.
    ``vocab_group``: ``logits`` hold this rank's contiguous block of the
    classes, split over that group (a vocab-parallel decoder), and the NLL
    is :func:`vocab_parallel_nll`'s."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    if vocab_group is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, safe[..., None])[..., 0]
    else:
        nll = vocab_parallel_nll(logits, safe, vocab_group)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    total, count = nll.sum(), valid.sum()
    if group is not None:
        from mvlt_tpu_torch.parallel import comm
        total = comm.reduce_from_group(total, group)
        count = comm.all_reduce_(count.clone(), group)
    return total / count.clamp(min=1)


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[label] over classes split in contiguous blocks
    over ``group`` (Megatron's vocab-parallel cross entropy): the row max,
    the sum of exponentials and the target logit are all-reduced, which
    gives the full log-softmax's value; the backward is local,
    ``softmax - onehot`` on this rank's block."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        import torch.distributed as dist
        from mvlt_tpu_torch.parallel import comm
        x = logits.float()
        v = x.shape[-1]
        v0 = comm.group_rank(group) * v
        m = x.amax(-1)
        comm.all_reduce_(m, group, dist.ReduceOp.MAX)
        x = x - m[..., None]
        e = x.exp()
        s = e.sum(-1)
        comm.all_reduce_(s, group)
        local = labels - v0
        mine = (local >= 0) & (local < v)
        idx = torch.where(mine, local, torch.zeros_like(local))
        t = torch.where(mine, x.gather(-1, idx[..., None])[..., 0],
                        torch.zeros_like(m))
        comm.all_reduce_(t, group)
        ctx.save_for_backward(e / s[..., None], idx, mine)
        ctx.dtype = logits.dtype
        return s.log() - t

    @staticmethod
    def backward(ctx, g):
        p, idx, mine = ctx.saved_tensors
        d = p.clone()
        d.scatter_add_(-1, idx[..., None], -mine[..., None].to(d.dtype))
        return (d * g[..., None]).to(ctx.dtype), None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       group) -> torch.Tensor:
    """Per-position NLL (f32) of ``labels`` (global class ids) under
    ``logits`` (..., V / n), this rank's block ``[rank * V / n, (rank + 1)
    * V / n)`` of the classes split over ``group``."""
    return _VocabParallelNLL.apply(logits, labels, group)


class Dense(nn.Module):
    """A dense layer's parameters: ``weight`` (out, in), optional ``bias``,
    cast to the input's dtype at use. Serving runs the product through
    ``ops.gemm`` (K1 or its plain version); where a gradient is needed it is
    a plain ``F.linear`` (the JAX package leaves these layers to XLA)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, *,
                 dtype: torch.dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, dtype=dtype,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(d_out, dtype=dtype,
                                              device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor, ops) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return F.linear(x, w, b)
        shape = x.shape
        y = ops.gemm(x.reshape(-1, shape[-1]).contiguous(), w, b)
        return y.view(*shape[:-1], y.shape[-1])


class LayerNorm(nn.Module):
    """LayerNorm parameters (float32 ``weight`` / ``bias``) and its eps.
    Serving runs the normalisation through ``ops.layernorm`` (K3 or its
    plain version); where a gradient is needed it is ``F.layer_norm`` in
    float32, rounded to the input's dtype (the JAX package leaves these
    norms, outside its kernels, to XLA)."""

    def __init__(self, dim: int, eps: float, *, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor, ops) -> torch.Tensor:
        shape = x.shape
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.weight.requires_grad):
            return F.layer_norm(x.float(), (shape[-1],), self.weight,
                                self.bias, self.eps).to(x.dtype)
        y = ops.layernorm(x.reshape(-1, shape[-1]).contiguous(), self.weight,
                          self.bias, self.eps)
        return y.view(shape)


class Mlp(nn.Module):
    """The two dense layers of the Swin / BERT MLP (``fc1`` -> GELU -> ``fc2``).
    The fused blocks in :mod:`mvlt_tpu_torch.ops.blocks` take their weights;
    the forward is flax ``Mlp`` (``mvlt_tpu/ops/layers.py:54-72``), each
    dense layer in its :class:`Dense` form, the erf GELU between, and a
    :func:`dropout` at rate ``drop`` after the GELU and after ``fc2`` (drawn
    in that order, only when ``masks`` is given)."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0, *,
                 dtype: torch.dtype, device):
        super().__init__()
        self.drop = drop
        self.fc1 = Dense(dim, hidden, dtype=dtype, device=device)
        self.fc2 = Dense(hidden, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, ops, masks=None) -> torch.Tensor:
        h = dropout(gelu_exact(self.fc1(x, ops)), masks, self.drop)
        return dropout(self.fc2(h, ops), masks, self.drop)
