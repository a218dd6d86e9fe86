"""The continuous-batching serving engine of the PyTorch port: the JAX
package's ``ServingEngine`` over both KV layouts and both schedulers.

- Layouts: the block-table paged pool (``PagedKVManager``) or the
  slot-contiguous cache (``KVCacheManager``).
- Schedulers: MIXED mode, in which every step packs arrivals, prompt
  chunk continuations and decode tokens into ONE ragged wave and runs
  ONE fused step (``_mixed_step``: the ragged kernel of the layout on
  each layer); or PHASE-SPLIT, in which a step first prefills (flash
  groups of same-bucket admissions, plus one-slot chunk passes on the
  pool) and then runs one decode wave over the slots whose prompts are
  written (the decode kernel of the layout on each layer).
- Speculation (``spec=``): a truncated-layer draft proposes through the
  decode kernel over its own contiguous cache, then the target verifies
  the carried token and the proposals in one step per wave — the verify
  kernel of the layout in a phase-split wave, verify rows of the mixed
  wave otherwise — with longest-prefix acceptance, a bonus token and KV
  rollback.

Division of labor: the DEVICE holds the weights and the KV cache; the
HOST owns every piece of scheduling state (queue, positions, current
tokens, per-request generators, sampling settings) as small numpy
arrays and Python objects.  Each request samples from its own
``torch.Generator`` seeded with ``request.seed``, drawn once per token
it emits (at its prompt's last position, then at each decode), so
outputs are a pure function of the request — identical across arrival
orders, slot assignments, layouts and schedulers — and greedy outputs
equal offline ``generate_fast``.  A speculative wave puts a request's
generator back at its state after the last EMITTED token's draw, so
speculation changes no output, sampled ones included.

- int8 KV (``kv_quant="int8"``, ``$HETU_KV_QUANT``): the target's cache
  is an int8 payload with one f32 scale per (position, head) in every
  layout and scheduler, with speculation, chunked prefill and prefix
  sharing; each core's attention then runs the int8 twin of its kernel.
  The draft's cache stays in the compute dtype.
- MoE models (``models.moe_decode.MoEDecodeConfig``) run through the
  same cores in every configuration, each call routing its live
  positions through the top-k expert FFN of the MoE blocks (the draft
  routes nothing).  The engine keeps the lifetime per-expert load and
  drops (``expert_load``, ``expert_drops``, ``moe_tokens``), reading
  each call's device counts once, and stamps every step record with
  its routing (``serve.expert_*`` counters and gauges).

- The serving fleet's seams (``router.py``, ``weight_sync.py``,
  ``kv_tiers.py``): ``swap_params`` copies new weights into the resident
  tensors between steps (addresses fixed; the draft shares them) and
  ``set_weight_version`` stamps each admission and its ``Result``; a
  paged engine with a ``tier_store`` fetches a prefix the tier ladder
  holds at admission (``_tier_admit``); ``retire_hook`` sees a retiring
  slot while it is live (the KV handoff's export).

Not ported yet, and refused with NotImplementedError whether asked for
by argument or environment variable: the parameter-server cold tier of
tiered KV (``HETU_KV_PS_TIER``, ROADMAP A10).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .. import envvars, telemetry
from ..analysis import validate_serving
from ..device import resolve_device
from ..models.gpt_decode import (
    _accept_span, _draft_cfg, _infer_name, _model_params, _pow2,
    _prefill_into, _serve_decode_step, _serve_mixed, _serve_prefill_batch,
    _serve_prefill_chunk, _serve_verify, _spec_propose,
    resolve_draft_layers, resolve_serve_ragged, resolve_spec_k,
)
from ..models.moe_decode import moe_spec_of
from ..telemetry import flight
from ..telemetry import slo as slo_mod
from ..weights import prep_param
from .kv_manager import (KVCacheManager, PagedKVManager,
                         assemble_mixed_wave, resolve_kv_block,
                         resolve_kv_quant)
from .metrics import ServingMetrics
from .request import Result


class QueueFull(RuntimeError):
    """Admission backpressure: the bounded request queue is at capacity.
    Callers shed load or retry after draining (``engine.step()``)."""


# consecutive QueueFull rejections that count as a storm: the flight
# recorder dumps once per storm
_STORM_REJECTS = 8


def _refuse_ps_tier():
    if envvars.get_bool("HETU_KV_PS_TIER"):
        raise NotImplementedError(
            "the parameter-server cold tier of tiered KV "
            "(HETU_KV_PS_TIER) waits for the port's PS (ROADMAP A10)")


def _shares_memory(t, src):
    """True when tensor ``t`` lies in the memory of ``src`` (a tensor, or
    a numpy array, which only a CPU tensor can share)."""
    if isinstance(src, torch.Tensor):
        return t.untyped_storage().data_ptr() == \
            src.untyped_storage().data_ptr()
    if t.device.type != "cpu" or t.dtype == torch.bfloat16:
        return False    # numpy holds no bf16: such a tensor was converted
    return np.may_share_memory(t.numpy(), np.asarray(src))


def _moe_rates(load, drop):
    """(imbalance, drop rate) of per-expert load and drop counts: max /
    mean load (0.0 before any kept pair) and dropped / (kept +
    dropped)."""
    mean = float(load.mean())
    imb = float(load.max()) / mean if mean > 0 else 0.0
    total = int(load.sum() + drop.sum())
    return imb, (int(drop.sum()) / total if total else 0.0)


class ServingEngine:
    """Continuous-batching engine over one model's weights.

    params: {name: array or tensor} (the JAX package's named params, as
    for ``generate_fast``); config: GPTConfig or ``MoEDecodeConfig``
    (``$HETU_MOE_CAPACITY`` overrides its capacity factor); slots: concurrent
    sequences (pow2-bucketed); queue_limit: bounded admission queue —
    ``submit`` raises QueueFull beyond it; max_seq_len: cap on
    prompt+generation (default max_position_embeddings); dtype: e.g.
    ``torch.bfloat16`` casts weights AND the KV cache, default FOLLOWS
    the params; device: CUDA unless ``"cpu"`` is passed.  kv_quant
    (``$HETU_KV_QUANT``, ``resolve_kv_quant``): "int8" stores the target's
    KV cache as int8 payload plus per-(position, head) f32 scales
    (``self.kv_quant``; None keeps the compute dtype).

    kv_block / paged / pool_blocks / prefix_share: the layout
    (``resolve_kv_block``: auto is the paged pool with block 16 when
    CUDA is available, the slot-contiguous cache elsewhere); on the
    pool, prefill_chunk (``$HETU_KV_CHUNK``): prompts longer than this
    fill their blocks one chunk per step, interleaved with decode.
    ragged (``$HETU_SERVE_RAGGED``, ``resolve_serve_ragged``: auto is
    mixed when CUDA is available, phase-split elsewhere): the scheduler.
    Every core attends through its kernel wrapper (the kernel on CUDA,
    its plain version on CPU tensors); the JAX engine's ``fast_path`` /
    ``$HETU_SERVE_FAST`` choice of a masked reference has no counterpart
    here, and the counters (``prefill_dispatches``, ``prefill_chunks``,
    ``steps``, ``peak_live``, prefix hits) count as the JAX engine's do
    with ``fast_path=True``.

    tier_store: a ``kv_tiers.TieredKVStore`` wired into a paged pool
    (``attach``): prefix evictions spill into it and admission fetches
    from it.  A fleet's router wires its own store into every replica.

    spec (``$HETU_SPEC_K``): > 0 decodes speculatively — a draft of
    ``spec_draft_layers`` of the target's own blocks (default
    ``$HETU_SPEC_DRAFT_LAYERS`` or max(1, L // 4)) proposes up to
    ``spec`` tokens per slot per wave over its own contiguous cache, the
    target verifies them with the carried token in one step, and each
    slot emits 1..spec+1 tokens; outputs stay those of the
    non-speculative engine.  spec_adapt (``$HETU_SPEC_ADAPT``, default
    on) moves the per-wave draft length through the pow2 ladder 1..spec
    on a sliding acceptance window.

    Observability: lifecycle-traced requests (``metrics``), an
    ``SLOMonitor`` behind ``health()``, and the flight recorder dumped
    when an exception escapes ``step()`` or on QueueFull storms.
    """

    def __init__(self, params, config, *, slots=8, queue_limit=64,
                 max_seq_len=None, name=None, dtype=None, log_path=None,
                 paged=None, kv_block=None,
                 pool_blocks=None, prefix_share=None, prefill_chunk=None,
                 kv_quant=None, slo=None, tags=None, spec=None,
                 spec_adapt=None, spec_draft_layers=None, ragged=None,
                 tier_store=None, device=None):
        c = config
        self.device = resolve_device(device)
        block = resolve_kv_block(paged, kv_block)
        _refuse_ps_tier()
        self.kv_quant = resolve_kv_quant(kv_quant)
        self.paged = block > 0
        self.ragged = resolve_serve_ragged(ragged)
        self._name = _infer_name(params, name)
        self.params = _model_params(params, self._name, self.device, dtype)
        # the engine owns its resident tensors, since swap_params writes
        # them in place: a tensor that shares memory with the caller's
        # value (a CUDA tensor passed as is, an f32 numpy array on the
        # CPU) is copied once here
        for k, t in self.params.items():
            if _shares_memory(t, params[k]):
                self.params[k] = t.clone()
        # static checks (HETU_VALIDATE=1): params against config before
        # the cache is allocated (no-op when validation is off)
        validate_serving(self.params, c, self._name)
        Dh = c.hidden_size // c.num_attention_heads
        want = int(max_seq_len or c.max_position_embeddings)
        cdtype = self.params[f"{self._name}_wte_table"].dtype
        shape = dict(layers=c.num_hidden_layers,
                     heads=c.num_attention_heads, head_dim=Dh, slots=slots,
                     max_seq_len=want, pos_cap=c.max_position_embeddings,
                     dtype=self.kv_quant or cdtype, device=self.device)
        if self.paged:
            self.kv = PagedKVManager(block=block, pool_blocks=pool_blocks,
                                     prefix_share=prefix_share, **shape)
            chunk = (prefill_chunk if prefill_chunk is not None
                     else envvars.get_int("HETU_KV_CHUNK"))
            self.chunk = max(int(chunk or 0), 0)
        else:
            self.kv = KVCacheManager(**shape)
            self.chunk = 0
        if tier_store is not None:
            tier_store.attach(None, self.kv)
        # ---- an MoE config's spec rides the cfg_tuple ---- #
        self.moe = moe_spec_of(c)
        self.cfg_tuple = (self._name, c.num_hidden_layers,
                          c.num_attention_heads, Dh, self.kv.s_max)
        if self.moe is not None:
            self.cfg_tuple += (self.moe,)
            E = self.moe.num_experts
            # lifetime (token, rank) pairs kept / dropped per expert
            self.expert_load = np.zeros(E, np.int64)
            self.expert_drops = np.zeros(E, np.int64)
            self.moe_tokens = 0       # routed positions of target calls
            self._moe_layers = self.moe.moe_layers(c.num_hidden_layers)
            self._moe_step = None     # this step's [load, drop, tokens]
        self.prefill_dispatches = 0   # prefill calls (a flash group, a
        # chunk pass, or a mixed wave that carried prompt rows)
        self.prefill_chunks = 0       # paged prompt chunks scored
        self.peak_live = 0            # max concurrent admitted slots
        self.queue_limit = int(queue_limit)
        self._queue = collections.deque()
        self.metrics = ServingMetrics(log_path, tags=tags)
        # mixed mode: the wave IS the prefill, chunk_stall residue folds
        self.metrics.mixed_mode = self.ragged
        # optional fn(request, slot) called at retirement while the
        # slot is still live
        self.retire_hook = None
        if isinstance(slo, slo_mod.SLOMonitor):
            self.slo = slo
            self.slo.emit_fn = self.metrics.event
        elif slo is not None:
            self.slo = slo_mod.SLOMonitor(slo,
                                          emit_fn=self.metrics.event)
        else:
            self.slo = slo_mod.SLOMonitor.from_env(
                emit_fn=self.metrics.event)
        self._reject_streak = 0
        self._step_end = None     # mixed mode: when the last step ended
        B = self.kv.n_slots
        self._pos = np.zeros(B, np.int32)     # input position per slot
        self._tok = np.zeros(B, np.int32)     # next input token per slot
        self._temp = np.zeros(B, np.float32)
        self._topk = np.zeros(B, np.int32)
        self._gens = [None] * B               # per-request generators
        self._reqs = [None] * B
        self._gen = [None] * B                # generated ids per slot
        self._prefill_off = np.zeros(B, np.int32)  # next prompt position
        self._prompt_arr = [None] * B              # to prefill
        # live weight sync: the version the resident params are stamped
        # with (None = unversioned) and each slot's ADMISSION version,
        # which its Result reports
        self.weight_version = None
        self.last_swap_at = None
        self._slot_version = [None] * B
        self.steps = 0
        # ---- speculative decoding (spec=/$HETU_SPEC_K) ---- #
        self.spec_k = resolve_spec_k(spec)
        self.spec_adapt = False
        if self.spec_k:
            dl = resolve_draft_layers(spec_draft_layers,
                                      c.num_hidden_layers)
            self.spec_draft_layers = dl
            # an MoE draft's spec routes nothing (draft=True)
            self.cfg_tuple_draft = _draft_cfg(self.cfg_tuple, dl)
            adapt = (spec_adapt if spec_adapt is not None
                     else envvars.get_bool("HETU_SPEC_ADAPT"))
            self.spec_adapt = bool(adapt) and self.spec_k > 1
            # adaptive runs ramp up from mid-ladder; pinned runs stay at k
            self._spec_kcur = (max(1, self.spec_k // 2)
                               if self.spec_adapt else self.spec_k)
            # the draft's own cache: always slot-contiguous, whatever the
            # target's layout; rollback there is position bookkeeping
            self._draft_ck = torch.zeros(
                (dl, B, self.kv.s_max, c.num_attention_heads, Dh),
                dtype=cdtype, device=self.device)
            self._draft_cv = torch.zeros_like(self._draft_ck)
            self._acc_window = collections.deque(maxlen=32)
            self.spec_proposed = 0    # draft tokens scored
            self.spec_accepted = 0    # draft tokens emitted
            self.spec_emitted = 0     # tokens emitted by verify waves
            self.spec_waves = 0
            self.spec_k_sum = 0       # sum of per-wave k (mean_k)
            self.spec_draft_prefills = 0
            self._spec_acc = np.zeros(B, np.int64)
            self._spec_prop = np.zeros(B, np.int64)
            self._spec_bonus = np.zeros(B, np.int64)

    # ------------------------------------------------------------- #
    # live weight sync (serving/weight_sync.py)
    # ------------------------------------------------------------- #

    def set_weight_version(self, version):
        """Stamp the CURRENT params with ``version``: rides
        ``metrics.tags`` so every later serve event carries
        ``weight_version``."""
        self.weight_version = int(version)
        self.metrics.tags["weight_version"] = self.weight_version

    def swap_params(self, params, *, version=None):
        """Replace the weights under the engine between steps, IN PLACE:
        every new value is copied into its resident tensor (``copy_``,
        in the resident dtype, through ``prep_param``'s conversion, so
        the result equals a fresh engine's on the new params), so no
        address changes and the draft, which shares the dict, swaps with
        it.  The new dict must match the resident one key for key and
        shape for shape; a corrupt push fails HERE, before any tensor
        moves.  Call only on a drained engine (the coordinator's job):
        live slots would mix versions mid-request.  A paged pool drops
        its registered prefixes after the copy (``clear_prefixes``):
        their KV came from the old weights, and a request attaching them
        would decode the new weights over the old keys and values (the
        JAX engine keeps them: ROADMAP Queue C, C5)."""
        name = self._name
        new = {}
        for k, v in params.items():
            if not k.startswith(name + "_"):
                continue
            old = self.params.get(k)
            shape = tuple(v.shape) if hasattr(v, "shape") else np.shape(v)
            if old is not None and tuple(shape) != tuple(old.shape):
                raise ValueError(
                    f"swap_params: {k} has shape {tuple(shape)}, "
                    f"resident is {tuple(old.shape)}")
            new[k] = v
        if set(new) != set(self.params):
            missing = sorted(set(self.params) - set(new))
            extra = sorted(set(new) - set(self.params))
            raise ValueError(
                f"swap_params key mismatch: missing {missing[:4]}, "
                f"unexpected {extra[:4]}")
        with torch.no_grad():
            for k, v in new.items():
                old = self.params[k]
                old.copy_(prep_param(v, old.device, old.dtype))
        if self.paged:
            self.kv.clear_prefixes()
        self.last_swap_at = time.perf_counter()
        if version is not None:
            self.set_weight_version(version)
        self.metrics.event("weight_swap", version=self.weight_version)

    # ------------------------------------------------------------- #
    # MoE accounting
    # ------------------------------------------------------------- #

    def _moe_stats(self):
        """A fresh ``stats`` dict for one target call (None when dense)."""
        return {} if self.moe is not None else None

    def _moe_take(self, stats, tokens):
        """Account one target call's routing of ``tokens`` positions from
        its ``stats`` (one device-to-host copy of the load and drop sums)
        into the lifetime and the step's totals.  No-op when dense."""
        if stats is None:
            return
        load, drop = torch.stack([stats["load"], stats["drop"]]).cpu() \
            .numpy().astype(np.int64)
        tokens = int(tokens)
        self.expert_load += load
        self.expert_drops += drop
        self.moe_tokens += tokens
        if self._moe_step is None:
            self._moe_step = [load, drop, tokens]
        else:
            self._moe_step[0] = self._moe_step[0] + load
            self._moe_step[1] = self._moe_step[1] + drop
            self._moe_step[2] += tokens
        telemetry.inc("serve.expert_load", int(load.sum()))
        telemetry.inc("serve.expert_drops", int(drop.sum()))

    def _moe_record(self):
        """Drain the step's routing totals into a ``record_step`` payload
        (None when dense or when nothing routed since the last record):
        ``routed + dropped == tokens * k * layers``; ``imb`` is max/mean
        expert load, ``drop_rate`` dropped / (routed + dropped)."""
        if self.moe is None or self._moe_step is None:
            return None
        load, drop, tokens = self._moe_step
        self._moe_step = None
        imb, rate = _moe_rates(load, drop)
        telemetry.set_gauge("serve.expert_imbalance", imb)
        telemetry.set_gauge("serve.expert_drop_rate", rate)
        return {"tokens": tokens, "routed": int(load.sum()),
                "dropped": int(drop.sum()),
                "k": self.moe.top_k, "layers": self._moe_layers,
                "imb": imb, "drop_rate": rate,
                "load": [int(x) for x in load],
                "drop": [int(x) for x in drop]}

    @property
    def expert_imbalance(self):
        """Lifetime max/mean expert load (None when dense, 0.0 before any
        routed pair)."""
        if self.moe is None:
            return None
        return _moe_rates(self.expert_load, self.expert_drops)[0]

    @property
    def expert_drop_rate(self):
        """Lifetime dropped / (routed + dropped) (None when dense)."""
        if self.moe is None:
            return None
        return _moe_rates(self.expert_load, self.expert_drops)[1]

    # ------------------------------------------------------------- #

    def submit(self, request):
        """Enqueue a Request; raises QueueFull at ``queue_limit``
        pending admissions, ValueError if it can never fit the cache.
        Returns the request."""
        req = request
        total = len(req.prompt) + req.max_new_tokens
        if total > self.kv.s_max:
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds the "
                f"engine's S_max {self.kv.s_max}")
        if self.paged and \
                self.kv.blocks_needed(total) > self.kv.capacity_blocks:
            raise ValueError(
                f"request needs {self.kv.blocks_needed(total)} KV "
                f"blocks; the pool holds {self.kv.capacity_blocks}")
        if len(self._queue) >= self.queue_limit:
            self.metrics.record_reject(req.request_id, len(self._queue))
            self._reject_streak += 1
            if self._reject_streak == _STORM_REJECTS:
                flight.RECORDER.dump(
                    "queue_storm", rejects=self._reject_streak,
                    queue_depth=len(self._queue),
                    queue_limit=self.queue_limit)
            raise QueueFull(
                f"admission queue at capacity ({self.queue_limit})")
        self._reject_streak = 0
        req.submitted_at = time.perf_counter()
        self._queue.append(req)
        self.metrics.record_submit(req.request_id, len(self._queue))
        return req

    @property
    def pending(self):
        """Requests not yet finished (queued + in slots)."""
        return len(self._queue) + len(self.kv.live())

    @property
    def queue_depth(self):
        return len(self._queue)

    # ------------------------------------------------------------- #

    def step(self):
        """One scheduler iteration: ``_step_mixed`` in mixed mode, else
        the phase-split ``_step_paged`` or ``_step_contiguous``.  Returns
        the Results that completed this iteration.  An exception escaping
        the scheduler dumps the flight recorder before propagating."""
        try:
            if self.ragged:
                self._credit_away()
                try:
                    return self._step_mixed()
                finally:
                    self._step_end = time.perf_counter()
            if self.paged:
                return self._step_paged()
            return self._step_contiguous()
        except QueueFull:
            raise
        except Exception as e:   # noqa: BLE001 — dump-and-reraise
            flight.RECORDER.dump(
                "engine_exception",
                error=f"{type(e).__name__}: {e}"[:200],
                step=self.steps, live=len(self.kv.live()),
                queue_depth=len(self._queue))
            raise

    def _credit_away(self):
        """Mixed mode: credit the wall time since the last step ended to
        every request mid-prefill (``ServingMetrics.lc_away``) — time in
        which the engine did not step at all (a fleet's router stepping
        the peers), so no wave of this engine carries it."""
        if self._step_end is None:
            return
        gap = time.perf_counter() - self._step_end
        for s in self.kv.live():
            if self._gen[s] is None:
                self.metrics.lc_away(self._reqs[s].request_id, gap)

    def _put(self, a, dtype):
        """A host array as a tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype)

    def _tables(self):
        """The pool's block tables on the device (None when contiguous)."""
        return self._put(self.kv.tables, torch.int32) if self.paged else None

    def _claim(self, slot, req, cached=0):
        """Slot state for a freshly admitted request whose prompt is
        written from position ``cached`` on."""
        self._reqs[slot] = req
        self._slot_version[slot] = self.weight_version
        self._gen[slot] = None
        self._prompt_arr[slot] = np.asarray(req.prompt, np.int32)
        self._prefill_off[slot] = cached
        self._pos[slot] = 0
        self._tok[slot] = 0
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        gen = None
        if req.temperature > 0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(req.seed))
        self._gens[slot] = gen

    def _admit_contiguous(self):
        """Claim a free slot for each queued request, FIFO, while slots
        last.  Returns [(request, slot)]."""
        admits = []
        while self._queue and self.kv.free_slots:
            req = self._queue.popleft()
            t_a = time.perf_counter()
            slot = self.kv.alloc(req.request_id, len(req.prompt))
            self.metrics.lc_claimed(
                req.request_id, (time.perf_counter() - t_a) * 1e3)
            self._claim(slot, req)
            admits.append((req, slot))
        if admits:
            telemetry.inc("serve.admission_waves")
        return admits

    def _admit_paged(self):
        """Claim slots + block tables for queued requests, FIFO, until
        slots or pool blocks run short (the head request then waits —
        backpressure, not loss).  A prompt starting with a registered
        prefix attaches those blocks refcounted and prefills only the
        tail."""
        admitted = []
        with telemetry.span("serve.kv_alloc", queue=len(self._queue)):
            while self._queue:
                req = self._queue[0]
                if self._defer_for_prefix(req):
                    self.metrics.lc_blocked(req.request_id)
                    break
                # tiered KV: a prompt no local prefix covers may be
                # warm in the tier ladder — fetch and import it now so
                # the alloc below attaches the blocks
                self._tier_admit(req)
                t_a = time.perf_counter()
                slot, cached = self.kv.alloc(
                    req.request_id, req.prompt,
                    len(req.prompt) + req.max_new_tokens)
                if slot is None:
                    self.metrics.lc_blocked(req.request_id)
                    break
                self.metrics.lc_claimed(
                    req.request_id, (time.perf_counter() - t_a) * 1e3)
                self._queue.popleft()
                self._claim(slot, req, cached)
                admitted.append(slot)
        if admitted:
            telemetry.inc("serve.admission_waves")
        return admitted

    def _tier_admit(self, req):
        """Tier miss-escalation at admission (serving/kv_tiers.py): when
        the tier ladder holds a longer prefix of this prompt than the
        pool does, fetch it and import it (``import_blocks``, prompt
        re-registered), so the ``kv.alloc`` that follows attaches the
        blocks refcounted — token-identical to the original prefill.
        Local warmth always wins, and every failure (tier miss, chaos
        corruption, a pool too full for the import) degrades to a cold
        prefill, never an error.  Returns True when a span landed."""
        store = getattr(self.kv, "tier_store", None)
        if store is None or not self.kv.prefix_share:
            return False
        hit = store.lookup(req.prompt, self.kv.block)
        if hit is None:
            return False
        toks, length, _tier = hit
        _, cached = self.kv.match_prefix(req.prompt)
        if cached >= length:
            return False   # the pool already covers at least as much
        payload = store.fetch(toks)
        if payload is None:
            return False
        try:
            slot = self.kv.import_blocks(
                payload, f"{req.request_id}~tierfetch",
                prompt=list(toks))
        except ValueError:
            slot = None
        if slot is None:
            store.note_import_failed()
            return False
        # the slot was only a write vehicle: the re-registered prefix
        # keeps the blocks alive (refcounted) for this admission
        self.kv.release(slot)
        return True

    def _defer_for_prefix(self, req):
        """True when ``req`` should WAIT one step rather than duplicate
        work: its first KV block of prompt matches a prompt another slot
        is prefilling right now, and no registered prefix covers it yet
        — once that prefill registers, this request admits with the
        blocks attached (a BURST of same-system-prompt requests stores
        the prefix once)."""
        if not self.kv.prefix_share:
            return False
        bs = self.kv.block
        pr = [int(t) for t in req.prompt]
        if len(pr) <= bs:
            return False
        _, cached = self.kv.match_prefix(pr)
        if cached >= bs:
            return False
        head = pr[:bs]
        for s in self.kv.live():
            if self._gen[s] is None and self._prompt_arr[s] is not None \
                    and len(self._prompt_arr[s]) >= bs \
                    and [int(t) for t in self._prompt_arr[s][:bs]] == head:
                telemetry.inc("serve.prefix_deferrals")
                return True
        return False

    def _finish_prefill(self, slot, tok0):
        """Prompt fully written: the slot joins the decode wave (or
        retires right here on max_new_tokens=1 / instant EOS).  On the
        pool, registers the prompt's blocks for prefix sharing.  A
        speculative engine prefills the draft's cache row first."""
        req = self._reqs[slot]
        if self.spec_k:
            t_d = time.perf_counter()
            self._draft_prefill_slot(slot)
            self.metrics.lc_prefill(req.request_id,
                                    time.perf_counter() - t_d)
        now = time.perf_counter()
        req.first_token_at = now
        self._pos[slot] = len(self._prompt_arr[slot])
        self._tok[slot] = tok0
        self._gen[slot] = [tok0]
        if self.paged:
            self.kv.register_prefix(self._prompt_arr[slot], slot)
        self.metrics.record_admit(
            req.request_id, slot, now - req.submitted_at,
            now - req.submitted_at)
        if req.stream_cb:
            req.stream_cb(req, tok0)
        return self._maybe_finish(slot, tok0)

    def _chunk_take(self, slot):
        """(offset, width, final) of the slot's next prompt q-block: one
        chunk on a chunked pool, else the rest of the prompt."""
        P = len(self._prompt_arr[slot])
        off = int(self._prefill_off[slot])
        if self.paged and self.chunk > 0:
            C_b = min(_pow2(self.chunk, floor=8), self.kv.s_max)
            take = min(self.chunk, C_b, P - off)
        else:
            take = P - off
        return off, take, off + take >= P

    # ------------------------------------------------------------- #
    # phase-split schedulers
    # ------------------------------------------------------------- #

    def _step_contiguous(self):
        """One phase-split iteration over the slot-contiguous cache:
        admission WAVES — each claims every free slot, groups its
        admissions by prompt bucket and prefills one group per flash
        dispatch; a request finishing AT prefill frees its slot for the
        next wave of the same step — then one decode wave over every
        live slot."""
        done = []
        prefill_s = 0.0
        while True:
            admits = self._admit_contiguous()
            if not admits:
                break
            groups = {}
            for req, slot in admits:
                pb = self.kv.bucket_prompt(len(req.prompt))
                groups.setdefault(pb, []).append(slot)
            for pb, group in sorted(groups.items()):
                firsts, dt = self._prefill_group_flash(pb, group)
                prefill_s += dt
                for slot, tok0 in zip(group, firsts):
                    r = self._finish_prefill(slot, tok0)
                    if r:
                        done.append(r)   # frees the slot: next wave
        live = self.kv.live()
        self.peak_live = max(self.peak_live, len(live))
        if live and self.spec_k:
            done.extend(self._spec_wave(live, prefill_s))
        elif live:
            done.extend(self._decode_wave(live, prefill_s))
        return done

    def _step_paged(self):
        """One phase-split iteration over the pool: admit into block
        tables, advance every mid-prefill slot (a flash group for whole
        fresh prompts, one chunk for a long prompt or a prefix tail, so
        long prompts fill their blocks INTERLEAVED with decode waves),
        then one decode wave over the slots whose prompts are written.
        A request finishing at prefill frees capacity for another
        admission wave within the same step."""
        done = []
        prefill_s = 0.0
        while True:
            self._admit_paged()
            fin, dt = self._prefill_wave_paged()
            prefill_s += dt
            done.extend(fin)
            if not fin:
                break   # nothing retired at prefill: no freed capacity
        # a request deferred for a prefix that REGISTERED this step can
        # claim its (shared) blocks now and prefill next step
        self._admit_paged()
        live = self.kv.live()
        decoding = [s for s in live if self._gen[s] is not None]
        self.peak_live = max(self.peak_live, len(live))
        if decoding and self.spec_k:
            done.extend(self._spec_wave(decoding, prefill_s))
        elif decoding:
            done.extend(self._decode_wave(decoding, prefill_s))
        return done

    def _prefill_wave_paged(self):
        """Advance every mid-prefill slot: fresh whole-prompt slots in
        flash groups by prompt bucket, K/V straight into their blocks;
        slots with a shared-prefix tail or a chunked long prompt by one
        chunk pass each.  Returns (finished Results, prefill seconds)."""
        t_all = time.perf_counter()
        fin = []
        pre = [s for s in self.kv.live() if self._gen[s] is None]
        if not pre:
            return fin, 0.0
        groups, chunked = {}, []
        for s in pre:
            P = len(self._prompt_arr[s])
            if self._prefill_off[s] == 0 and (self.chunk == 0
                                              or P <= self.chunk):
                groups.setdefault(self.kv.bucket_prompt(P), []).append(s)
            else:
                chunked.append(s)
        for pb, group in sorted(groups.items()):
            firsts, _ = self._prefill_group_flash(pb, group)
            for s, tok0 in zip(group, firsts):
                P = len(self._prompt_arr[s])
                self.kv.advance(s, P)
                self._prefill_off[s] = P
                r = self._finish_prefill(s, tok0)
                if r:
                    fin.append(r)
        for s in chunked:
            tok0 = self._chunk_advance(s)
            if tok0 is not None:
                r = self._finish_prefill(s, tok0)
                if r:
                    fin.append(r)
        return fin, time.perf_counter() - t_all

    def _prefill_group_flash(self, pb, group):
        """ONE flash-prefill dispatch for a group of same-bucket fresh
        prompts (slots ``group``), K/V into their cache rows or blocks.
        Returns (first tokens, seconds)."""
        t0 = time.perf_counter()
        n = len(group)
        prompts = np.zeros((n, pb), np.int64)
        lens = np.zeros(n, np.int32)
        for row, slot in enumerate(group):
            P = len(self._prompt_arr[slot])
            prompts[row, :P] = self._prompt_arr[slot]
            lens[row] = P
        st = self._moe_stats()
        # MoE capacity counts the JAX engine's pow2-padded group
        nb = min(_pow2(n), self.kv.n_slots)
        firsts = _serve_prefill_batch(
            self.params, self.cfg_tuple, self.kv.cache_k, self.kv.cache_v,
            np.asarray(group), prompts, lens, self._temp[group],
            self._topk[group], [self._gens[s] for s in group],
            block_tables=self._tables(), stats=st, moe_rows=nb * pb)
        self._moe_take(st, lens.sum())
        self.prefill_dispatches += 1
        dt = time.perf_counter() - t0
        self.metrics.record_prefill(n, pb, dt, batched=True)
        for slot in group:
            self.metrics.lc_prefill(self._reqs[slot].request_id, dt)
        return [int(t) for t in firsts], dt

    def _chunk_advance(self, slot):
        """One prefill chunk pass for one slot of the pool; returns the
        first token when this chunk completed the prompt, else None."""
        req = self._reqs[slot]
        off, take, final = self._chunk_take(slot)
        t0 = time.perf_counter()
        st = self._moe_stats()
        # MoE capacity counts the JAX engine's chunk bucket C_b
        C_b = (min(_pow2(self.chunk, floor=8), self.kv.s_max)
               if self.chunk > 0 else
               self.kv.bucket_prompt(len(self._prompt_arr[slot]) - off))
        tok0, _ = _serve_prefill_chunk(
            self.params, self.cfg_tuple, self.kv.cache_k, self.kv.cache_v,
            self._put(self.kv.tables[slot], torch.int32),
            self._put(self._prompt_arr[slot][off:off + take], torch.int64),
            off, sample=((req.temperature, req.top_k, self._gens[slot])
                         if final else None), stats=st, moe_rows=C_b)
        self._moe_take(st, take)
        self.prefill_dispatches += 1
        self.prefill_chunks += 1
        telemetry.inc("serve.prefill_chunks")
        self.kv.advance(slot, take)
        self._prefill_off[slot] = off + take
        dt = time.perf_counter() - t0
        self.metrics.record_prefill(1, take, dt, batched=False)
        self.metrics.lc_prefill(req.request_id, dt)
        return tok0

    def _decode_wave(self, decoding, prefill_s):
        """One fused decode step over the slots ``decoding`` (the decode
        kernel of the layout on each layer); every other slot rides
        along inert.  Returns the Results that completed."""
        done = []
        wave_reqs = [self._reqs[s].request_id for s in decoding]
        B = self.kv.n_slots
        live = np.zeros(B, bool)
        live[decoding] = True
        t0 = time.perf_counter()
        st = self._moe_stats()
        sampled = _serve_decode_step(
            self.params, self.cfg_tuple, self.kv.cache_k, self.kv.cache_v,
            self._put(self._pos, torch.int32),
            self._put(self._tok, torch.int64), live, self._temp,
            self._topk, self._gens, block_tables=self._tables(), stats=st)
        self._moe_take(st, len(decoding))
        dt = time.perf_counter() - t0
        for slot in decoding:
            req = self._reqs[slot]
            t = int(sampled[slot])
            self._pos[slot] += 1
            self._tok[slot] = t
            self._gen[slot].append(t)
            self.kv.advance(slot)
            if req.stream_cb:
                req.stream_cb(req, t)
            r = self._maybe_finish(slot, t)
            if r:
                done.append(r)
        self.steps += 1
        self.metrics.record_step(
            live=len(decoding), slots=B, queue_depth=len(self._queue),
            dt_s=dt, new_tokens=len(decoding), prefill_s=prefill_s,
            step=self.steps, requests=wave_reqs, end_perf=t0 + dt,
            moe=self._moe_record())
        return done

    # ------------------------------------------------------------- #
    # mixed-mode scheduler
    # ------------------------------------------------------------- #

    def _step_mixed(self):
        """One MIXED-MODE scheduler iteration: admissions, chunk
        continuations and plain decode pack into ONE ragged wave
        descriptor (per-slot ``q_len``/``first_row``) and run as ONE
        fused step — no prefill/decode phase barrier, so a decode slot
        never stalls behind another request's prompt chunks.  Every
        slot's writes, attention and generator draws are what its mode's
        phase-split path does, so the tokens are the same."""
        done = []
        if self.paged:
            self._admit_paged()
        else:
            self._admit_contiguous()
        live = self.kv.live()
        if not live:
            return done
        self.peak_live = max(self.peak_live, len(live))
        B = self.kv.n_slots
        pre = [s for s in live if self._gen[s] is None]
        decoding = [s for s in live if self._gen[s] is not None]
        wave_reqs = [self._reqs[s].request_id for s in live]
        t0 = time.perf_counter()
        # the speculative draft proposes ahead of the wave
        k_cur = 0
        if decoding and self.spec_k:
            k_cur = self._spec_kcur
            draft = self._propose(decoding, k_cur)
        entries = {}
        chunk_take = {}   # slot -> (take, final) for prefill q-blocks
        for s in pre:
            off, take, final = self._chunk_take(s)
            # only the final chunk samples — at its last row; mid-prompt
            # chunks pass first_row == q_len
            toks = [int(t) for t in self._prompt_arr[s][off:off + take]]
            entries[s] = (toks, off, take - 1 if final else take)
            chunk_take[s] = (take, final)
        qlen_v = {}       # slot -> q_len of its verify q-block
        for s in decoding:
            toks = [int(self._tok[s])]
            if k_cur:
                qlen_v[s] = self._verify_len(s, k_cur)
                toks += [int(t) for t in draft[s, :qlen_v[s] - 1]]
            entries[s] = (toks, int(self._pos[s]), 0)
        wave = assemble_mixed_wave(B, entries)
        st = self._moe_stats()
        sampled, after = _serve_mixed(
            self.params, self.cfg_tuple, self.kv.cache_k, self.kv.cache_v,
            self._put(wave["pos"], torch.int32),
            self._put(wave["tokens"], torch.int64),
            self._put(wave["q_len"], torch.int32), wave["first_row"],
            self._temp, self._topk, self._gens,
            block_tables=self._tables(), stats=st)
        self._moe_take(st, wave["q_len"].sum())
        dt = time.perf_counter() - t0
        # ---- prefill q-blocks ---- #
        q_pre = 0
        pre_credit = {}
        if pre:
            self.prefill_dispatches += 1
        for s in pre:
            req = self._reqs[s]
            take, final = chunk_take[s]
            q_pre += take
            if self.paged:
                # a contiguous slot's length was set at its claim
                self.kv.advance(s, take)
                self.prefill_chunks += 1
                telemetry.inc("serve.prefill_chunks")
            self._prefill_off[s] += take
            # the fused wave IS this request's prefill compute; credit
            # the wall since dispatch (topped up to the whole wave below)
            e = time.perf_counter() - t0
            self.metrics.lc_prefill(req.request_id, e)
            pre_credit[req.request_id] = e
            if final:
                r = self._finish_prefill(s, int(sampled[s, take - 1]))
                if r:
                    done.append(r)
        if pre:
            self.metrics.record_prefill(len(pre), wave["q"], dt,
                                        batched=True)
        # ---- verify / decode q-blocks ---- #
        n_dec = 0
        wave_emit = wave_acc = wave_prop = 0
        for s in decoding:
            req = self._reqs[s]
            if k_cur:
                emit, accepted, r = self._spec_commit(
                    s, sampled[s], entries[s][0], qlen_v[s], after[s])
                wave_emit += len(emit)
                wave_acc += accepted
                wave_prop += qlen_v[s] - 1
                if r:
                    done.append(r)
                continue
            t = int(sampled[s, 0])
            n_dec += 1
            self._pos[s] += 1
            self._tok[s] = t
            self._gen[s].append(t)
            self.kv.advance(s)
            if req.stream_cb:
                req.stream_cb(req, t)
            r = self._maybe_finish(s, t)
            if r:
                done.append(r)
        if pre_credit:
            t_wave = time.perf_counter() - t0
            for rid, e in pre_credit.items():
                if t_wave > e:
                    self.metrics.lc_prefill(rid, t_wave - e, count=False)
        self.steps += 1
        spec = (self._spec_record(k_cur, wave_acc, wave_prop, wave_emit)
                if k_cur else None)
        q_ver = sum(qlen_v.values())
        q_tot = max(q_pre + q_ver + n_dec, 1)
        self.metrics.record_step(
            live=len(live), slots=B, queue_depth=len(self._queue),
            dt_s=dt, new_tokens=wave_emit if k_cur else n_dec,
            prefill_s=dt * q_pre / q_tot, step=self.steps,
            requests=wave_reqs, end_perf=t0 + dt, spec=spec,
            mix={"q_prefill": q_pre, "q_verify": q_ver, "q_decode": n_dec},
            moe=self._moe_record())
        return done

    # ------------------------------------------------------------- #
    # speculative decoding (spec=/$HETU_SPEC_K)
    # ------------------------------------------------------------- #

    def _draft_prefill_slot(self, slot):
        """Prefill the draft's cache row of a slot whose prompt is written
        (one flash pass of the draft's depth; it samples nothing), and
        zero the slot's per-request speculation attribution: every
        admission passes here exactly once."""
        prompt = self._prompt_arr[slot]
        P = len(prompt)
        arr = np.zeros((1, self.kv.bucket_prompt(P)), np.int64)
        arr[0, :P] = prompt
        _prefill_into(self.params, self.cfg_tuple_draft, self._draft_ck,
                      self._draft_cv, np.array([slot]), arr,
                      np.array([P], np.int32))
        self.spec_draft_prefills += 1
        self._spec_acc[slot] = 0
        self._spec_prop[slot] = 0
        self._spec_bonus[slot] = 0

    def _adapt_k(self):
        """Sliding-window acceptance controller: raise the draft length
        through the pow2 ladder while acceptance stays high, back off
        while it stays low; the window clears on every move so the new k
        is judged on its own evidence."""
        if not self.spec_adapt or len(self._acc_window) < 8:
            return
        prop = sum(p for _, p in self._acc_window)
        if prop == 0:
            return
        rate = sum(a for a, _ in self._acc_window) / prop
        if rate >= 0.75 and self._spec_kcur < self.spec_k:
            self._spec_kcur = min(self._spec_kcur * 2, self.spec_k)
            self._acc_window.clear()
        elif rate <= 0.35 and self._spec_kcur > 1:
            self._spec_kcur = max(self._spec_kcur // 2, 1)
            self._acc_window.clear()

    def _propose(self, decoding, k):
        """The draft's ``k`` proposals for the slots ``decoding`` ([B, k]
        host array; other rows are meaningless)."""
        live = np.zeros(self.kv.n_slots, bool)
        live[decoding] = True
        return _spec_propose(self.params, self.cfg_tuple_draft,
                             self._draft_ck, self._draft_cv,
                             self._put(self._pos, torch.int32),
                             self._put(self._tok, torch.int64), k, live)

    def _verify_len(self, slot, k):
        """The slot's verify q-block: the carried token and up to ``k``
        proposals, no more than it may still emit or the cache holds."""
        rem = self._reqs[slot].max_new_tokens - len(self._gen[slot])
        return min(k + 1, rem, self.kv.s_max - int(self._pos[slot]))

    def _spec_commit(self, s, sampled, tokens, ql, after):
        """Accept slot ``s``'s verify block (``tokens`` fed, ``sampled``
        the target's token after each row, ``after`` its generator states
        or None): emit the accepted prefix and the bonus token, roll the
        cache back past them, and put the request's generator back at its
        state after the last emitted token's draw.  Returns (emitted
        tokens, accepted drafts, Result or None)."""
        req = self._reqs[s]
        emit, accepted = _accept_span(sampled, tokens, ql, req.eos_id)
        n_emit = len(emit)
        self._spec_acc[s] += accepted
        self._spec_prop[s] += ql - 1
        self._spec_bonus[s] += n_emit - accepted
        base = int(self._pos[s])
        # the verify wrote all ql positions: keep the emitted ones
        self.kv.advance(s, ql)
        self.kv.truncate(s, base + n_emit)
        self._pos[s] = base + n_emit
        self._tok[s] = emit[-1]
        if after is not None:
            self._gens[s].set_state(after[n_emit - 1])
        self._gen[s].extend(emit)
        if req.stream_cb:
            for t in emit:
                req.stream_cb(req, t)
        return emit, accepted, self._maybe_finish(s, emit[-1])

    def _spec_record(self, k_cur, wave_acc, wave_prop, wave_emit):
        """Count one speculative wave and adapt k; returns its step-event
        record."""
        self.spec_waves += 1
        self.spec_k_sum += k_cur
        self.spec_proposed += wave_prop
        self.spec_accepted += wave_acc
        self.spec_emitted += wave_emit
        self._acc_window.append((wave_acc, wave_prop))
        self._adapt_k()
        return {"k": k_cur, "proposed": wave_prop, "accepted": wave_acc}

    def _spec_wave(self, decoding, prefill_s):
        """One phase-split speculative wave over the slots ``decoding``:
        the draft proposes (k_cur + 1 decode-kernel steps), the target
        verifies every slot's carried token and proposals in ONE step
        (the verify kernel of the layout), and each slot emits 1..k_cur+1
        tokens.  Returns the Results that completed."""
        B = self.kv.n_slots
        k_cur = self._spec_kcur
        wave_reqs = [self._reqs[s].request_id for s in decoding]
        t0 = time.perf_counter()
        draft = self._propose(decoding, k_cur)
        tokens = np.zeros((B, k_cur + 1), np.int64)
        tokens[:, 0] = self._tok
        tokens[:, 1:] = draft
        qlen = np.zeros(B, np.int32)
        for s in decoding:
            qlen[s] = self._verify_len(s, k_cur)
        st = self._moe_stats()
        sampled, after = _serve_verify(
            self.params, self.cfg_tuple, self.kv.cache_k, self.kv.cache_v,
            self._put(self._pos, torch.int32),
            self._put(tokens, torch.int64), qlen, self._temp, self._topk,
            self._gens, block_tables=self._tables(), stats=st)
        self._moe_take(st, qlen.sum())
        dt = time.perf_counter() - t0
        done = []
        wave_emit = wave_acc = wave_prop = 0
        for s in decoding:
            emit, accepted, r = self._spec_commit(
                s, sampled[s], tokens[s], int(qlen[s]), after[s])
            wave_emit += len(emit)
            wave_acc += accepted
            wave_prop += int(qlen[s]) - 1
            if r:
                done.append(r)
        self.steps += 1
        spec = self._spec_record(k_cur, wave_acc, wave_prop, wave_emit)
        self.metrics.record_step(
            live=len(decoding), slots=B, queue_depth=len(self._queue),
            dt_s=dt, new_tokens=wave_emit, prefill_s=prefill_s,
            step=self.steps, requests=wave_reqs, end_perf=t0 + dt,
            spec=spec, moe=self._moe_record())
        return done

    @property
    def spec_acceptance(self):
        """Lifetime draft acceptance rate (None before any proposal)."""
        if not self.spec_k or not self.spec_proposed:
            return None
        return self.spec_accepted / self.spec_proposed

    @property
    def spec_mean_k(self):
        """Mean per-wave draft length (adaptation's observable)."""
        if not self.spec_k or not self.spec_waves:
            return None
        return self.spec_k_sum / self.spec_waves

    def run(self, requests=()):
        """Submit ``requests`` then step until everything (including
        already-pending work) drains; returns {request_id: Result}."""
        for r in requests:
            self.submit(r)
        out = {}
        while self.pending:
            for res in self.step():
                out[res.request_id] = res
        return out

    # ------------------------------------------------------------- #

    def _maybe_finish(self, slot, last_token):
        req = self._reqs[slot]
        n = len(self._gen[slot])
        if req.eos_id is not None and last_token == req.eos_id:
            reason = "eos"
        elif n >= req.max_new_tokens:
            reason = "length"
        else:
            return None
        now = time.perf_counter()
        tokens = np.concatenate([
            np.asarray(req.prompt, np.int32),
            np.asarray(self._gen[slot], np.int32)])
        spec = None
        if self.spec_k:
            # every generated token is the prefill sample, an accepted
            # draft or a bonus sample: accepted + bonus + 1 == n
            spec = {"accepted": int(self._spec_acc[slot]),
                    "proposed": int(self._spec_prop[slot]),
                    "bonus": int(self._spec_bonus[slot])}
        res = Result(
            request_id=req.request_id, tokens=tokens,
            prompt_len=len(req.prompt), finish_reason=reason,
            n_generated=n, ttft_s=req.first_token_at - req.submitted_at,
            latency_s=now - req.submitted_at, slot=slot,
            spec_accepted=spec["accepted"] if spec else 0,
            spec_proposed=spec["proposed"] if spec else 0,
            weight_version=self._slot_version[slot])
        self.metrics.record_finish(req.request_id, reason, n,
                                   res.latency_s, spec=spec)
        decode_s = now - req.first_token_at
        self.slo.observe(
            request_id=req.request_id, ttft_ms=res.ttft_s * 1e3,
            tok_s=((n - 1) / decode_s
                   if n > 1 and decode_s > 0 else None))
        if self.retire_hook is not None:
            self.retire_hook(req, slot)
        self._reqs[slot] = None
        self._gen[slot] = None
        self._gens[slot] = None
        self._slot_version[slot] = None
        self.kv.release(slot)
        return res

    def health(self):
        """The admission signal: the SLO monitor's worst-burn state —
        "ok" / "degraded" / "breach" (always "ok" with no SLOs
        declared)."""
        return self.slo.health()
