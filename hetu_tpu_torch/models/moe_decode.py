"""MoE serving in PyTorch: the top-k routed expert FFN of the serving
cores, the port of the JAX package's ``models/moe_decode.py``.

``MoEDecodeConfig`` describes a GPT whose FFN blocks (every
``moe_every``-th layer) are top-k routed expert stacks; :func:`moe_ffn`
is the routed FFN itself (softmax gate, ``k * ceil(tokens / E * cf)``
static capacity per expert, rank-offset cumsum slotting, a token past
capacity contributing exactly 0 so that its residual stream carries
it).  Every core of ``models/gpt_decode.py`` swaps its dense FFN for
this function through ``_ffn_block``; the ``MoESpec`` rides the cores'
``cfg_tuple`` as its optional sixth element.

The speculative draft skips routing (``MoESpec.draft``): its MoE blocks
are attention-only, and the target's verify owns every emitted token.

PyTorch idiom: where the JAX function builds one-hot ``[T, E, cap]``
dispatch and combine tensors and contracts them with einsums, this one
computes each (token, rank)'s slot with the same cumsum, scatters the
kept rows into a static ``[E, cap, D]`` buffer, runs the two expert
products as ``torch.bmm`` and gathers each token's k rows back.  Shapes
stay static and nothing reads a device value on the host.  The per-
expert load and drop counts accumulate as device tensors in a ``stats``
dict; the engine reads them once a step.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import envvars
from .gpt_config import GPTConfig


class MoESpec(NamedTuple):
    """Hashable MoE routing descriptor, the optional sixth element of
    the serving ``cfg_tuple``.  ``draft=True`` marks the truncated-layer
    speculative draft, whose MoE layers skip the FFN sublayer (zero
    contribution; the residual stream carries)."""

    num_experts: int
    top_k: int
    capacity_factor: float
    moe_every: int
    draft: bool = False

    def is_moe_layer(self, i):
        """Block i carries the MoE FFN when ``i % moe_every ==
        moe_every - 1`` (1 = every block)."""
        return i % self.moe_every == self.moe_every - 1

    def moe_layers(self, L):
        """How many of the first ``L`` blocks are MoE blocks."""
        return sum(1 for i in range(L) if self.is_moe_layer(i))


class MoEDecodeConfig(GPTConfig):
    """GPTConfig plus MoE routing for the serving stack.  ``ffn_size``
    keeps GPTConfig's meaning for the dense interleaved blocks;
    ``expert_size`` (default ``ffn_size``) is each expert's hidden
    width: ``top_k * expert_size == ffn_size`` gives as many active
    parameters as the dense model.  Expert parallelism (``ep_axis``) is
    not ported: a config that asks for it is refused."""

    def __init__(self, num_experts=4, top_k=2, capacity_factor=1.0,
                 moe_every=1, expert_size=None, ep_axis=None, **kw):
        if ep_axis is not None:
            raise NotImplementedError(
                "expert-parallel MoE serving (ep_axis) is not ported yet "
                "(ROADMAP A9b item 2)")
        super().__init__(**kw)
        if num_experts < 2:
            raise ValueError(
                f"num_experts must be >= 2, got {num_experts}")
        if not 1 <= top_k <= num_experts:
            raise ValueError(
                f"top_k={top_k} outside [1, num_experts={num_experts}]")
        if not 1 <= moe_every <= self.num_hidden_layers:
            raise ValueError(
                f"moe_every={moe_every} outside [1, num_hidden_layers="
                f"{self.num_hidden_layers}]")
        if capacity_factor <= 0:
            raise ValueError(
                f"capacity_factor must be > 0, got {capacity_factor}")
        self.num_experts = int(num_experts)
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.moe_every = int(moe_every)
        self.expert_size = int(expert_size or self.ffn_size)


def resolve_moe_capacity():
    """Serving capacity-factor override: ``$HETU_MOE_CAPACITY`` (> 0),
    else None (the config's own)."""
    raw = envvars.get_str("HETU_MOE_CAPACITY")
    if raw:
        v = float(raw)
        if v > 0:
            return v
    return None


def moe_spec_of(config, draft=False):
    """The :class:`MoESpec` a config implies, or None for a dense one.
    Duck-typed on ``num_experts``."""
    e = getattr(config, "num_experts", None)
    if not e:
        return None
    cf = resolve_moe_capacity() or float(
        getattr(config, "capacity_factor", 1.0))
    return MoESpec(
        num_experts=int(e),
        top_k=int(getattr(config, "top_k", 1)),
        capacity_factor=cf,
        moe_every=int(getattr(config, "moe_every", 1)),
        draft=bool(draft))


def moe_capacity(spec, num_tokens):
    """Static per-expert slot count for a call of ``num_tokens`` (a
    Python int, pad rows included): ``k * ceil(tokens / E *
    capacity_factor)``, floored at ``k``."""
    cap = spec.top_k * math.ceil(
        (num_tokens / spec.num_experts) * spec.capacity_factor)
    return max(int(cap), spec.top_k)


def moe_ffn(params, us, x, spec, valid=None, stats=None, rows=None):
    """Top-k routed expert FFN over a flat token block.

    x: [T, D], the post-LN FFN input in the compute dtype; valid: [T]
    bool or None.  A False row (a pad position, an inert slot) neither
    routes nor claims capacity, so it never changes another row's
    output.  ``rows`` (default T) is the position count that sets the
    capacity (``moe_capacity``): a caller whose JAX counterpart pads its
    block (a prefill group to a pow2 row count, a chunk to its bucket)
    passes the padded count, so that capacity, and with it every kept
    and dropped pair, is the reference's without pad rows here.

    Returns y [T, D]: each kept (token, rank) pair adds its expert's
    output times the raw softmax gate (not renormalized, so with
    ``top_k == num_experts`` the weights sum to 1); a dropped pair and
    an invalid row add exactly 0.

    Routing runs in f32 on the compute-dtype gate weight; the expert
    products run in the compute dtype, and the gate-weighted sum of a
    token's k rows in f32 before its cast back.  Ties among the gates
    go to the lowest expert index (``jax.lax.top_k``'s order): a stable
    descending sort on either device.

    ``stats`` (a dict or None) accumulates ``load`` / ``drop``, int64
    [E] device tensors: the (token, rank) pairs kept / past capacity in
    this call, so load + drop sums to valid tokens x top_k per MoE
    layer."""
    E, k = spec.num_experts, spec.top_k
    T, D = x.shape
    cap = moe_capacity(spec, T if rows is None else int(rows))
    dev = x.device
    gw = params[f"{us}_moe_gate_weight"].float()
    gates = torch.softmax(x.float() @ gw, dim=-1)              # [T, E]
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    # the (rank, token) pairs in arrival order, rank-major: a pair's slot
    # is the count of earlier pairs of its expert (every pair of the
    # ranks before, then the tokens before), kept below capacity
    rt = topi.t().reshape(k * T)                                # [k*T]
    mask = (rt[:, None] == torch.arange(E, device=dev)).long()  # [k*T, E]
    live = None
    if valid is not None:
        live = valid.reshape(T).to(torch.bool).repeat(k)
        mask = mask * live[:, None]
    pos = ((torch.cumsum(mask, dim=0) - mask) * mask).sum(dim=1)
    kept = pos < cap if live is None else live & (pos < cap)
    load = (mask * kept[:, None]).sum(dim=0)
    drop = mask.sum(dim=0) - load
    dump = E * cap                      # the slot of a dropped pair
    slot = torch.where(kept, rt * cap + pos, dump)              # [k*T]
    # dispatch: each kept pair's row into its slot, every dropped pair
    # into the dump row (never read back into y)
    xe = torch.zeros((dump + 1, D), dtype=x.dtype, device=dev)
    xe[slot] = x.repeat(k, 1)
    w1 = params[f"{us}_moe_expert_stack_w1"]                    # [E, D, F]
    w2 = params[f"{us}_moe_expert_stack_w2"]                    # [E, F, D]
    h = torch.bmm(xe[:dump].view(E, cap, D), w1)
    b1 = params.get(f"{us}_moe_expert_stack_b1")
    if b1 is not None:
        h = h + b1[:, None, :]
    h = torch.bmm(_gelu_tanh(h), w2)
    b2 = params.get(f"{us}_moe_expert_stack_b2")
    if b2 is not None:
        h = h + b2[:, None, :]
    # combine: a zero row at the dump slot makes a dropped pair add 0
    he = torch.cat([h.reshape(dump, D),
                    torch.zeros((1, D), dtype=h.dtype, device=dev)])
    w = topv.t().to(x.dtype).float()                            # [k, T]
    y = (w[:, :, None] * he[slot].view(k, T, D).float()).sum(dim=0)
    if stats is not None:
        stats["load"] = stats.get("load", 0) + load
        stats["drop"] = stats.get("drop", 0) + drop
    return y.to(x.dtype)


def _gelu_tanh(x):
    # local twin of gpt_decode._gelu_tanh (models.gpt_decode imports
    # this module, not the other way round)
    return 0.5 * x * (1.0 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * x ** 3)))


# ------------------------- param builders ------------------------- #


def init_moe_params(config, name="moe", seed=0, scale=0.02):
    """Random MoE-GPT serving params (numpy): the dense GPT's names
    (``{name}_wte_table`` .. per-layer attention, LN and dense FFN) plus,
    on each MoE block, the gate ``{us}_moe_gate_weight`` [D, E] and the
    expert stacks ``{us}_moe_expert_stack_w1`` [E, D, F] / ``_w2`` [E, F,
    D] / ``_b1`` [E, F] / ``_b2`` [E, D].  Dense interleaved blocks keep
    ``ffn_wi/wo`` only."""
    c = config
    spec = moe_spec_of(c)
    rng = np.random.default_rng(seed)
    D = c.hidden_size
    F_dense, F_exp = c.ffn_size, c.expert_size
    E = c.num_experts

    def r(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {
        f"{name}_wte_table": r(c.vocab_size, D),
        f"{name}_wpe": r(c.max_position_embeddings, D),
        f"{name}_ln_f_scale": np.ones(D, np.float32),
        f"{name}_ln_f_bias": np.zeros(D, np.float32),
    }
    for i in range(c.num_hidden_layers):
        us = f"{name}_h{i}"
        p.update({
            f"{us}_ln1_scale": np.ones(D, np.float32),
            f"{us}_ln1_bias": np.zeros(D, np.float32),
            f"{us}_ln2_scale": np.ones(D, np.float32),
            f"{us}_ln2_bias": np.zeros(D, np.float32),
            f"{us}_attn_q_weight": r(D, D),
            f"{us}_attn_q_bias": np.zeros(D, np.float32),
            f"{us}_attn_k_weight": r(D, D),
            f"{us}_attn_k_bias": np.zeros(D, np.float32),
            f"{us}_attn_v_weight": r(D, D),
            f"{us}_attn_v_bias": np.zeros(D, np.float32),
            f"{us}_attn_proj_weight": r(D, D),
            f"{us}_attn_proj_bias": np.zeros(D, np.float32),
        })
        if spec.is_moe_layer(i):
            p.update({
                f"{us}_moe_gate_weight": r(D, E),
                f"{us}_moe_expert_stack_w1": r(E, D, F_exp),
                f"{us}_moe_expert_stack_b1": np.zeros((E, F_exp),
                                                      np.float32),
                f"{us}_moe_expert_stack_w2": r(E, F_exp, D),
                f"{us}_moe_expert_stack_b2": np.zeros((E, D),
                                                      np.float32),
            })
        else:
            p.update({
                f"{us}_ffn_wi_weight": r(D, F_dense),
                f"{us}_ffn_wi_bias": np.zeros(F_dense, np.float32),
                f"{us}_ffn_wo_weight": r(F_dense, D),
                f"{us}_ffn_wo_bias": np.zeros(D, np.float32),
            })
    return p


def convert_dense_to_moe(params, config, moe_config, name=None):
    """Replicate a dense GPT's FFN blocks into expert stacks: every
    expert of every MoE block carries the dense layer's wi/wo and
    biases, and the gate weights are zero (uniform gates).  With
    ``top_k == num_experts`` the raw softmax combine weights sum to 1,
    so routing reproduces the dense FFN: the dense oracle.  Numpy in,
    numpy out."""
    from .gpt_decode import _infer_name
    name = _infer_name(params, name)
    spec = moe_spec_of(moe_config)
    E = spec.num_experts
    out = {k: np.asarray(v) for k, v in params.items()
           if k.startswith(name + "_")}
    for i in range(moe_config.num_hidden_layers):
        if not spec.is_moe_layer(i):
            continue
        us = f"{name}_h{i}"
        wi = out.pop(f"{us}_ffn_wi_weight")
        bi = out.pop(f"{us}_ffn_wi_bias")
        wo = out.pop(f"{us}_ffn_wo_weight")
        bo = out.pop(f"{us}_ffn_wo_bias")
        D = wi.shape[0]
        out[f"{us}_moe_gate_weight"] = np.zeros((D, E), np.float32)
        out[f"{us}_moe_expert_stack_w1"] = np.broadcast_to(
            wi, (E,) + wi.shape).copy()
        out[f"{us}_moe_expert_stack_b1"] = np.broadcast_to(
            bi, (E,) + bi.shape).copy()
        out[f"{us}_moe_expert_stack_w2"] = np.broadcast_to(
            wo, (E,) + wo.shape).copy()
        out[f"{us}_moe_expert_stack_b2"] = np.broadcast_to(
            bo, (E,) + bo.shape).copy()
    return out


def _ep_later(what):
    return NotImplementedError(
        f"{what} (expert parallelism) is not in hetu_tpu_torch yet "
        f"(ROADMAP A9b item 2)")


def ep_shard_params(params, mesh, config, axis="ep", name=None):
    """Expert-parallel placement of a MoE-GPT parameter dict: waits for
    A9b item 2."""
    raise _ep_later("ep_shard_params")


def moe_ffn_ep_reference(params, us, x, spec, mesh, quant=None):
    """The explicit expert-parallel MoE FFN over a mesh: waits for
    A9b item 2."""
    raise _ep_later("moe_ffn_ep_reference")


def resolve_moe_quant(mode=None):
    """The int8 wire of the expert-parallel all-to-all: waits for A9b item 2."""
    raise _ep_later("resolve_moe_quant")
