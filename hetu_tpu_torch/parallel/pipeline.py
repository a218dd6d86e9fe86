"""Pipeline parallelism: the stage pipelines and the GPipe/1F1B/PipeDream/
HetPipe schedules, the port of the JAX package's ``parallel/pipeline.py``.

1. ``spmd_pipeline`` / ``spmd_pipeline_1f1b``: S uniform stages over the
   mesh axis ``axis`` run M microbatches in ticks; at tick t stage d
   works on microbatch t - d and hands its boundary activation to stage
   d + 1 for tick t + 1.  On a :class:`~.mesh.VirtualMesh` the stages run
   one after another in this process and a hand-off is a Python
   reference; on a ``DeviceMesh`` each rank runs its own stage and the
   boundary goes by ``torch.distributed`` send/recv
   (``batch_isend_irecv``) over the axis's group: NCCL on the card, gloo
   on the CPU.  Each is a ``torch.autograd.Function`` whose backward runs
   an explicit schedule (eager torch has no scan to differentiate):

   * gpipe: the forward keeps each (stage, microbatch)'s autograd graph
     (or, with ``checkpoint_stages``, only its input, and re-forwards in
     the backward), and the backward runs the ticks in reverse: M
     boundary inputs live per stage.
   * 1f1b: the forward keeps nothing but the microbatches (the pipeline
     input); the backward runs M + 2S - 1 one-forward-one-backward ticks,
     each stage re-forwarding microbatch t - d into a buffer of
     K = min(M, 2S - 1) boundary slots and differentiating microbatch
     t - (2S - 1 - d) from its slot (stage internals recomputed), so the
     live boundary activations stay O(S) where gpipe's are O(M).  The last
     stage stores its input without the re-forward (nothing reads its
     output there), so a step runs each stage's body M times forward,
     M times re-forward on the first S - 1 stages, and M times
     recompute-and-differentiate.

   ``HIGH_WATER`` holds each schedule's boundary-slot high-water of its
   last run (the most boundary inputs one stage held at once).
2. ``gpipe_schedule`` / ``one_f_one_b_schedule``: the (microbatch,
   fwd|bwd) orders, JAX's lists.
3. ``PipelineTrainer``: heterogeneous stages driven through a schedule on
   the host, with PipeDream's weight stashing (each backward differentiates
   the graph its forward built, with the weights that forward read) and
   HetPipe's local-update-then-sync against a duck-typed parameter server
   (``ps_delta_sync``).

Random streams: a stage function that takes the microbatch index (as the
pipeline executor's does) is called with the same index by every
schedule and by 1F1B's re-forward and recompute, so a stream keyed by it
draws the same mask each time.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .collectives import ProcessComm, send_recv
from .mesh import VirtualMesh, axis_size

# the boundary-slot high-water of the last run of each schedule
HIGH_WATER = {"gpipe": 0, "1f1b": 0}


class _Stages:
    """The stages this process runs and the hand-offs between them."""

    def __init__(self, stage_fn, per_stage, mesh, axis, mb):
        self.stage_fn = stage_fn        # (stage, params, x, microbatch)
        self.S = axis_size(mesh, axis)
        self.M = mb.shape[0]
        self.axis = axis
        if isinstance(mesh, VirtualMesh):
            self.comm = None
            self.local = list(range(self.S))
        else:
            self.comm = ProcessComm(mesh)
            self.local = [self.comm.index(axis)]
        self.specs = {}
        flat = []
        for d in self.local:
            leaves, self.specs[d] = pytree.tree_flatten(per_stage[d])
            flat.append(leaves)
        self.counts = [len(f) for f in flat]
        self.flat = [x for f in flat for x in f]

    def split(self, flat):
        out, i = {}, 0
        for d, n in zip(self.local, self.counts):
            out[d] = list(flat[i:i + n])
            i += n
        return out

    def apply(self, d, leaves, x, m):
        return self.stage_fn(d, pytree.tree_unflatten(leaves, self.specs[d]),
                             x, m)

    def active(self, d, t, lag=0):
        return 0 <= t - d - lag < self.M

    def hand_on(self, outs, like, t, lag=0):
        """Stage d's boundary of tick t to stage d + 1 for tick t + 1
        (``lag``: the schedule's offset of microbatches, t - d - lag)."""
        if self.comm is None:
            return {d + 1: y for d, y in outs.items()}
        (me,) = self.local
        send = outs.get(me)
        recv = torch.empty_like(like) \
            if me > 0 and self.active(me, t + 1, lag) else None
        send_recv(send, self.comm.peer(self.axis, me + 1), recv,
                  self.comm.peer(self.axis, me - 1),
                  self.comm.group(self.axis))
        return {me: recv}

    def hand_back(self, outs, like, t, when):
        """Stage d's input gradient to stage d - 1; ``when(d)`` says
        whether stage d sends one at this tick."""
        if self.comm is None:
            return {d - 1: g for d, g in outs.items()}
        (me,) = self.local
        send = outs.get(me)
        recv = torch.empty_like(like) \
            if me < self.S - 1 and when(me + 1) else None
        send_recv(send, self.comm.peer(self.axis, me - 1), recv,
                  self.comm.peer(self.axis, me + 1),
                  self.comm.group(self.axis))
        return {me: recv}

    def replicate(self, t, root):
        """``t`` of stage ``root`` on every rank."""
        if self.comm is None:
            return t
        return self.comm.broadcast(t, self.axis, root)


def _leaves(params, grad):
    return [p.detach().requires_grad_(grad and p.is_floating_point())
            for p in params]


def _vjp(y, x_leaf, leaves, g):
    """(dx, [d leaf]) of y under cotangent g, zeros where unused."""
    wrt = [x_leaf] + [p for p in leaves if p.requires_grad]
    got = iter(torch.autograd.grad(y, wrt, g.to(y.dtype),
                                   allow_unused=True))
    dx = next(got)
    dps = [next(got) if p.requires_grad else None for p in leaves]
    dx = torch.zeros_like(x_leaf) if dx is None else dx
    return dx, dps


def _accumulate(acc, dps):
    for i, g in enumerate(dps):
        if g is not None:
            acc[i] = g if acc[i] is None else acc[i] + g


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, st, checkpoint, mb, *flat):
        S, M = st.S, st.M
        leaves = {d: _leaves(ps, True) for d, ps in st.split(flat).items()}
        saved, ys, state = {}, [None] * M, {}
        live, hw = dict.fromkeys(st.local, 0), 0
        for t in range(M + S - 1):
            outs = {}
            for d in st.local:
                if not st.active(d, t):
                    continue
                m = t - d
                x = mb[m] if d == 0 else state[d]
                with torch.set_grad_enabled(not checkpoint):
                    x_leaf = x.detach().requires_grad_(x.is_floating_point())
                    y = st.apply(d, leaves[d], x_leaf, m)
                saved[d, m] = (x_leaf, None if checkpoint else y)
                live[d] += 1
                hw = max(hw, live[d])
                if d == S - 1:
                    ys[m] = y.detach()
                else:
                    outs[d] = y.detach()
            state = st.hand_on(outs, mb[0], t)
        HIGH_WATER["gpipe"] = hw
        out = torch.stack(ys) if S - 1 in st.local else torch.empty_like(mb)
        ctx.st, ctx.checkpoint = st, checkpoint
        ctx.leaves, ctx.saved, ctx.mb_like = leaves, saved, mb
        return st.replicate(out, S - 1)

    @staticmethod
    def backward(ctx, dys):
        st, leaves, saved = ctx.st, ctx.leaves, ctx.saved
        S, M = st.S, st.M
        dxs = torch.zeros_like(ctx.mb_like)
        acc = {d: [None] * len(leaves[d]) for d in st.local}
        g_in = {}
        for t in reversed(range(M + S - 1)):
            outs = {}
            for d in st.local:
                if not st.active(d, t):
                    continue
                m = t - d
                g = dys[m] if d == S - 1 else g_in[d]
                x_leaf, y = saved.pop((d, m))
                if y is None:
                    with torch.enable_grad():
                        y = st.apply(d, leaves[d], x_leaf, m)
                dx, dps = _vjp(y, x_leaf, leaves[d], g)
                _accumulate(acc[d], dps)
                if d == 0:
                    dxs[m] = dx
                else:
                    outs[d] = dx
            g_in = st.hand_back(outs, ctx.mb_like[0], t - 1,
                                lambda d, t=t: st.active(d, t))
        dxs = st.replicate(dxs, 0)
        grads = [g for d in st.local for g in acc[d]]
        return (None, None, dxs, *grads)


class _OneFOneB(torch.autograd.Function):
    @staticmethod
    def forward(ctx, st, mb, *flat):
        S, M = st.S, st.M
        leaves = {d: _leaves(ps, False) for d, ps in st.split(flat).items()}
        ys, state = [None] * M, {}
        with torch.no_grad():
            for t in range(M + S - 1):
                outs = {}
                for d in st.local:
                    if not st.active(d, t):
                        continue
                    x = mb[t] if d == 0 else state[d]
                    y = st.apply(d, leaves[d], x, t - d)
                    if d == S - 1:
                        ys[t - d] = y
                    else:
                        outs[d] = y
                state = st.hand_on(outs, mb[0], t)
        out = torch.stack(ys) if S - 1 in st.local else torch.empty_like(mb)
        ctx.st, ctx.flat = st, flat
        ctx.save_for_backward(mb)
        return st.replicate(out, S - 1)

    @staticmethod
    def backward(ctx, dys):
        st = ctx.st
        (mb,) = ctx.saved_tensors
        S, M = st.S, st.M
        K = min(M, 2 * S - 1)
        leaves = {d: _leaves(ps, True) for d, ps in st.split(ctx.flat).items()}
        buf = {d: [None] * K for d in st.local}
        live, hw = dict.fromkeys(st.local, 0), 0
        acc = {d: [None] * len(leaves[d]) for d in st.local}
        dxs = torch.zeros_like(mb)
        y_in, dx_in = {}, {}
        lag = 2 * S - 1

        def b_of(d, t):
            return t - (lag - d)

        for t in range(M + 2 * S - 1):
            y_outs, dx_outs = {}, {}
            for d in st.local:
                # backward slot first: at K = 2S - 1 < M stage 0 reads and
                # writes the same slot in one tick
                b = b_of(d, t)
                if 0 <= b < M:
                    x_res = buf[d][b % K]
                    buf[d][b % K] = None
                    live[d] -= 1
                    g = dys[b] if d == S - 1 else dx_in[d]
                    with torch.enable_grad():
                        x_leaf = x_res.detach().requires_grad_(
                            x_res.is_floating_point())
                        y = st.apply(d, leaves[d], x_leaf, b)
                    dx, dps = _vjp(y, x_leaf, leaves[d], g)
                    _accumulate(acc[d], dps)
                    if d == 0:
                        dxs[b] = dx
                    else:
                        dx_outs[d] = dx
                # forward slot: microbatch t - d into the buffer
                f = t - d
                if 0 <= f < M:
                    x_f = mb[f] if d == 0 else y_in[d]
                    buf[d][f % K] = x_f
                    live[d] += 1
                    hw = max(hw, live[d])
                    if d < S - 1:
                        with torch.no_grad():
                            y_outs[d] = st.apply(
                                d, [p.detach() for p in leaves[d]], x_f, f)
            y_in = st.hand_on(y_outs, mb[0], t)
            dx_in = st.hand_back(
                dx_outs, mb[0], t,
                lambda d, t=t: 0 <= b_of(d, t) < M)
        HIGH_WATER["1f1b"] = hw
        dxs = st.replicate(dxs, 0)
        grads = [g for d in st.local for g in acc[d]]
        return (None, dxs, *grads)


def _stacked(stage_fn, stage_params, mesh, axis, mb, takes_index):
    """The stages of a stacked-params call: stage d reads row d."""
    S = axis_size(mesh, axis)
    per_stage = [pytree.tree_map(lambda p, d=d: p[d], stage_params)
                 for d in range(S)]

    def fn(d, params, x, m):
        return stage_fn(params, x, m) if takes_index else stage_fn(params, x)
    return _Stages(fn, per_stage, mesh, axis, mb)


def spmd_pipeline(stage_fn, stage_params, microbatches, *, mesh,
                  axis="pp", checkpoint_stages=True, mb_spec=None,
                  stage_takes_index=False, manual_axes=None):
    """Run ``microbatches`` ``[M, mb, ...]`` through S uniform stages over
    mesh axis ``axis``; returns the last stage's ``[M, mb, ...]`` outputs
    on every rank (differentiable).

    ``stage_fn(params, x)`` (or ``(params, x, m)`` with
    ``stage_takes_index``, m the microbatch index) maps a boundary to one
    of the same shape; ``stage_params`` is a pytree whose leaves have a
    leading stage dim S (stage d reads row d).  ``checkpoint_stages``
    keeps only each stage's input for the backward and re-forwards there,
    as JAX's ``jax.checkpoint`` does.  ``mb_spec`` and ``manual_axes``
    are JAX's sharding arguments, taken for the same calls: the port's
    stages read whole values."""
    st = _stacked(stage_fn, stage_params, mesh, axis, microbatches,
                  stage_takes_index)
    return _GPipe.apply(st, checkpoint_stages, microbatches, *st.flat)


def spmd_pipeline_1f1b(stage_fn, stage_params, microbatches, *, mesh,
                       axis="pp", mb_spec=None, manual_axes=None):
    """``spmd_pipeline`` with ``stage_takes_index=True`` whose backward
    runs the staggered one-forward-one-backward schedule: at most
    min(M, 2S - 1) boundary inputs live per stage (``HIGH_WATER``).  The
    math is gpipe's (gradients summed over the microbatches)."""
    st = _stacked(stage_fn, stage_params, mesh, axis, microbatches, True)
    return _OneFOneB.apply(st, microbatches, *st.flat)


def run_stages(stage_fn, per_stage, microbatches, *, mesh, axis="pp",
               schedule="gpipe"):
    """The pipelines over a list of S per-stage parameter pytrees (None
    for a stage another rank runs) with ``stage_fn(d, params, x, m)``, d
    the stage: the pipeline executor's entry, where each stage's
    parameters are its own layers' and no stacking is needed."""
    st = _Stages(stage_fn, per_stage, mesh, axis, microbatches)
    if schedule == "1f1b":
        return _OneFOneB.apply(st, microbatches, *st.flat)
    return _GPipe.apply(st, False, microbatches, *st.flat)


def stack_stage_params(per_stage_params):
    """Stack a list of per-stage pytrees (same structure) into one pytree
    with a leading stage dim, the layout ``spmd_pipeline`` reads."""
    flat = [pytree.tree_flatten(p) for p in per_stage_params]
    spec = flat[0][1]
    return pytree.tree_unflatten(
        [torch.stack(xs) for xs in zip(*(f[0] for f in flat))], spec)


def shard_stacked_params(stacked, mesh, axis="pp"):
    """The stacked params on the mesh's device.  Stage d reads row d: on a
    VirtualMesh the rows are the virtual ranks' shards; on a DeviceMesh
    each rank reads its own."""
    if isinstance(mesh, VirtualMesh):
        return pytree.tree_map(lambda x: x.to(mesh.device), stacked)
    return stacked


def ps_delta_sync(ps, params, snapshot):
    """HetPipe's PS merge protocol: push the delta accumulated since the
    last sync (the server ADDS pushes into its copy), pull the merged view,
    rebase.

    ``params``: name-keyed numpy-able dict of current worker weights.
    ``snapshot``: previous merged view, or None on the first sync; then
    each key is seeded idempotently (exactly one worker wins the init and
    pushes its full weights).  Works against a server with ``param_init``
    and a client with ``parameter_init``.  Returns (merged_params,
    new_snapshot)."""
    init = getattr(ps, "param_init", None) or \
        getattr(ps, "parameter_init", None)
    merged_out, snap_out = {}, {}
    first = snapshot is None
    for k, v in params.items():
        arr = _numpy(v)
        if first:
            created = init(k, arr.shape) if init is not None else True
            if created:
                ps.push(k, arr)
        else:
            ps.push(k, arr - snapshot[k])
        merged = np.asarray(ps.pull(k)).copy()
        merged_out[k] = merged
        snap_out[k] = merged
    return merged_out, snap_out


def _numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu").numpy()
    return np.asarray(v)


# --------------------------------------------------------------------------- #
# schedules
# --------------------------------------------------------------------------- #

FWD, BWD = "fwd", "bwd"


def gpipe_schedule(num_microbatches, stage_id=0, num_stages=1):
    """All forwards, then all backwards in reverse."""
    order = [(m, FWD) for m in range(num_microbatches)]
    order += [(m, BWD) for m in reversed(range(num_microbatches))]
    return order


def one_f_one_b_schedule(num_microbatches, stage_id, num_stages):
    """1F1B: warmup fwds = num_stages - stage_id - 1, then alternate,
    then drain."""
    warmup = min(num_stages - stage_id - 1, num_microbatches)
    order = [(m, FWD) for m in range(warmup)]
    f, b = warmup, 0
    while b < num_microbatches:
        if f < num_microbatches:
            order.append((f, FWD))
            f += 1
        order.append((b, BWD))
        b += 1
    return order


GPipeSchedule = gpipe_schedule
OneFOneBSchedule = one_f_one_b_schedule


# --------------------------------------------------------------------------- #
# host-loop trainer
# --------------------------------------------------------------------------- #

@dataclass
class PipelineStage:
    """One stage: ``apply(params, x) -> y`` plus its parameter dict."""
    apply: callable
    params: dict


class PipelineTrainer:
    """Drives heterogeneous stages through a schedule on the host.  Modes:

    - 'gpipe':     all-fwd-then-all-bwd, one optimizer step per batch;
    - 'pipedream': 1F1B with per-microbatch updates and weight stashing
                   (each backward differentiates its forward's graph,
                   which read the weights live at that forward);
    - '1f1b':      synchronous 1F1B (gradients accumulated, one update);
    - 'hetpipe':   per-microbatch updates plus a push of the accumulated
                   delta to ``ps`` every ``sync_every`` batches.

    ``optimizer``: a ``hetu_tpu_torch.optimizer`` rule (``update_one``);
    None is SGD at 0.1."""

    def __init__(self, stages, optimizer=None, mode="gpipe",
                 loss_fn=None, sync_every=None, ps=None):
        self.stages = stages
        self.mode = mode
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.sync_every = sync_every
        self.ps = ps
        self._batches_seen = 0
        self._opt_states = None
        self._opt_step = 0
        self._ps_snapshot = None

    def train_batch(self, microbatches, labels):
        """One global batch as M microbatches.  Returns the mean loss."""
        M = len(microbatches)
        S = len(self.stages)
        mode = self.mode
        sched = (gpipe_schedule if mode == "gpipe"
                 else one_f_one_b_schedule)(M, 0, S)
        losses = []
        live = [st.params for st in self.stages]
        accum = [{k: torch.zeros_like(v) for k, v in st.params.items()}
                 for st in self.stages]
        inflight = {}
        for (m, direction) in sched:
            if direction == FWD:
                inflight[m] = self._fwd_loss(live, microbatches[m],
                                             labels[m])
            else:
                loss, leaves = inflight.pop(m)
                losses.append(float(loss.detach()))
                flat = [p for lv in leaves for p in lv.values()]
                got = iter(torch.autograd.grad(loss, flat))
                grads = [{k: next(got) for k in lv} for lv in leaves]
                if mode in ("pipedream", "hetpipe"):
                    live = self._apply_update(live, grads)
                else:
                    accum = [{k: a[k] + g[k] for k in a}
                             for a, g in zip(accum, grads)]
        if mode not in ("pipedream", "hetpipe"):
            scale = 1.0 / M
            accum = [{k: g * scale for k, g in a.items()} for a in accum]
            live = self._apply_update(live, accum)
        for st, p in zip(self.stages, live):
            st.params = p
        self._batches_seen += 1
        if mode == "hetpipe" and self.ps is not None and self.sync_every \
                and self._batches_seen % self.sync_every == 0:
            self._ps_sync()
        return float(np.mean(losses))

    def _fwd_loss(self, params_per_stage, x, y_true):
        """(loss, the parameter leaves it read): the stash."""
        leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                  for p in params_per_stage]
        with torch.enable_grad():
            h = x
            for st, p in zip(self.stages, leaves):
                h = st.apply(p, h)
            loss = self.loss_fn(h, y_true)
        return loss, leaves

    @torch.no_grad()
    def _apply_update(self, live, grads):
        opt = self.optimizer
        clip = getattr(opt, "clip_grad_norm", None) \
            if opt is not None else None
        if clip is not None:
            if clip <= 0:
                raise ValueError(
                    f"clip_grad_norm must be positive, got {clip}")
            sq = sum(torch.sum(g.float() ** 2)
                     for gr in grads for g in gr.values())
            factor = torch.clamp(clip / (torch.sqrt(sq) + 1e-6), max=1.0)
            grads = [{k: (g.float() * factor).to(g.dtype)
                      for k, g in gr.items()} for gr in grads]
        if opt is None or not hasattr(opt, "update_one"):
            lr = getattr(opt, "learning_rate", 0.1) \
                if opt is not None else 0.1
            return [{k: p - lr * gr[k] for k, p in pl.items()}
                    for pl, gr in zip(live, grads)]
        if self._opt_states is None:
            self._opt_states = [{k: opt.init_state_one(p)
                                 for k, p in pl.items()} for pl in live]
        dev = next(iter(live[0].values())).device
        lr = opt.lr_value(self._opt_step, dev)
        step = torch.tensor(self._opt_step, dtype=torch.float32, device=dev)
        new_live = []
        for s_idx, (pl, gr) in enumerate(zip(live, grads)):
            new_p = {}
            for k, p in pl.items():
                new_p[k], self._opt_states[s_idx][k] = opt.update_one(
                    p, gr[k].to(p.dtype), self._opt_states[s_idx][k], lr,
                    step)
            new_live.append(new_p)
        self._opt_step += 1
        return new_live

    def _ps_sync(self):
        flat = {f"stage{i}/{k}": v
                for i, st in enumerate(self.stages)
                for k, v in st.params.items()}
        merged, self._ps_snapshot = ps_delta_sync(
            self.ps, flat, self._ps_snapshot)
        for i, st in enumerate(self.stages):
            for k, v in st.params.items():
                st.params[k] = torch.as_tensor(
                    merged[f"stage{i}/{k}"]).to(v.device, v.dtype)
