"""The continuous-batching serving engine of the PyTorch port: the JAX
package's ``ServingEngine`` with its production configuration — the
block-table paged KV pool and the MIXED-MODE scheduler, in which every
scheduler step packs arrivals, prompt-chunk continuations and decode
tokens into ONE ragged wave and runs ONE fused step (``_mixed_step``),
whose attention is the ragged paged kernel on each layer.

Division of labor: the DEVICE holds the weights and the KV pool; the
HOST owns every piece of scheduling state (queue, positions, current
tokens, per-request generators, sampling settings) as small numpy
arrays and Python objects.  Each request samples from its own
``torch.Generator`` seeded with ``request.seed``, drawn only at the rows
that emit its tokens, so outputs are a pure function of the request —
identical across arrival orders and slot assignments — and greedy
outputs equal offline ``generate_fast``.

Not ported yet, and refused with NotImplementedError whether asked for
by argument or environment variable: the slot-contiguous layout and the
phase-split schedulers (ROADMAP A3/A4), speculative decoding (A5), int8
KV (A2), MoE configs (A6), weight swaps and tiered KV (A7).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .. import envvars, telemetry
from ..device import resolve_device
from ..models.gpt_decode import (
    _infer_name, _model_params, _pow2, _serve_mixed_paged, refuse_moe, resolve_serve_ragged, resolve_spec_k,
)
from ..telemetry import flight
from ..telemetry import slo as slo_mod
from .kv_manager import (PagedKVManager, assemble_mixed_wave,
                         resolve_kv_block, resolve_kv_quant)
from .metrics import ServingMetrics
from .request import Result


class QueueFull(RuntimeError):
    """Admission backpressure: the bounded request queue is at capacity.
    Callers shed load or retry after draining (``engine.step()``)."""


# consecutive QueueFull rejections that count as a storm: the flight
# recorder dumps once per storm
_STORM_REJECTS = 8


def _refuse_unported(c, block, ragged, spec, kv_quant, tier_store):
    if block <= 0:
        raise NotImplementedError(
            "the slot-contiguous KV layout (paged=False, HETU_KV_BLOCK=0, "
            "or the auto setting without CUDA) is not ported yet "
            "(ROADMAP A3): pass paged=True or kv_block=")
    if not ragged:
        raise NotImplementedError(
            "the phase-split schedulers (ragged=False, "
            "HETU_SERVE_RAGGED=0, or the auto setting without CUDA) are "
            "not ported yet (ROADMAP A4): pass ragged=True")
    if spec:
        raise NotImplementedError(
            "speculative decoding (spec=, HETU_SPEC_K) is not ported yet "
            "(ROADMAP A5)")
    if kv_quant:
        raise NotImplementedError(
            "int8 KV (kv_quant=, HETU_KV_QUANT) is not ported yet "
            "(ROADMAP A2)")
    if tier_store is not None or envvars.get_int("HETU_KV_HOST_BYTES") \
            or envvars.get_bool("HETU_KV_PS_TIER"):
        raise NotImplementedError(
            "tiered KV (tier_store=, HETU_KV_HOST_BYTES, HETU_KV_PS_TIER) "
            "is not ported yet (ROADMAP A7)")
    refuse_moe(c)


class ServingEngine:
    """Continuous-batching engine over one model's weights.

    params: {name: array or tensor} (the JAX package's named params, as
    for ``generate_fast``); config: GPTConfig; slots: concurrent
    sequences (pow2-bucketed); queue_limit: bounded admission queue —
    ``submit`` raises QueueFull beyond it; max_seq_len: cap on
    prompt+generation (default max_position_embeddings); dtype: e.g.
    ``torch.bfloat16`` casts weights AND the KV pool, default FOLLOWS the
    params; device: CUDA unless ``"cpu"`` is passed.

    kv_block / paged / pool_blocks / prefix_share: the paged pool
    (``resolve_kv_block``: auto is block 16 when CUDA is available);
    prefill_chunk (``$HETU_KV_CHUNK``): prompts longer than this fill
    their blocks one chunk per step, interleaved with decode; ragged
    (``$HETU_SERVE_RAGGED``): must resolve to the mixed scheduler.
    Every wave attends through ``ragged_paged_attention`` (the kernel on
    CUDA, its plain version on CPU tensors); the JAX engine's
    ``fast_path`` / ``$HETU_SERVE_FAST`` choice of a masked reference
    has no counterpart here.

    Observability: lifecycle-traced requests (``metrics``), an
    ``SLOMonitor`` behind ``health()``, and the flight recorder dumped
    when an exception escapes ``step()`` or on QueueFull storms.
    """

    def __init__(self, params, config, *, slots=8, queue_limit=64,
                 max_seq_len=None, name=None, dtype=None, log_path=None,
                 paged=None, kv_block=None,
                 pool_blocks=None, prefix_share=None, prefill_chunk=None,
                 kv_quant=None, slo=None, tags=None, spec=None,
                 ragged=None, tier_store=None, device=None):
        c = config
        self.device = resolve_device(device)
        block = resolve_kv_block(paged, kv_block)
        _refuse_unported(c, block, resolve_serve_ragged(ragged),
                         resolve_spec_k(spec), resolve_kv_quant(kv_quant),
                         tier_store)
        self.paged = self.ragged = True
        self._name = _infer_name(params, name)
        self.params = _model_params(params, self._name, self.device, dtype)
        Dh = c.hidden_size // c.num_attention_heads
        want = int(max_seq_len or c.max_position_embeddings)
        cdtype = self.params[f"{self._name}_wte_table"].dtype
        self.kv = PagedKVManager(
            layers=c.num_hidden_layers, heads=c.num_attention_heads,
            head_dim=Dh, slots=slots, max_seq_len=want,
            pos_cap=c.max_position_embeddings, dtype=cdtype,
            device=self.device, block=block, pool_blocks=pool_blocks,
            prefix_share=prefix_share)
        chunk = (prefill_chunk if prefill_chunk is not None
                 else envvars.get_int("HETU_KV_CHUNK"))
        self.chunk = max(int(chunk or 0), 0)
        self.cfg_tuple = (self._name, c.num_hidden_layers,
                          c.num_attention_heads, Dh, self.kv.s_max)
        self.prefill_dispatches = 0   # waves that carried prompt rows
        self.prefill_chunks = 0       # prompt q-blocks scored
        self.peak_live = 0            # max concurrent admitted slots
        self.queue_limit = int(queue_limit)
        self._queue = collections.deque()
        self.metrics = ServingMetrics(log_path, tags=tags)
        # the wave IS the prefill: chunk_stall residue folds to 0
        self.metrics.mixed_mode = True
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
        self.steps = 0

    def swap_params(self, params, *, version=None):
        raise NotImplementedError(
            "live weight swaps are not ported yet (ROADMAP A7)")

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
        if self.kv.blocks_needed(total) > self.kv.capacity_blocks:
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
        """One scheduler iteration (see ``_step_mixed``).  Returns the
        Results that completed this iteration.  An exception escaping
        the scheduler dumps the flight recorder before propagating."""
        try:
            return self._step_mixed()
        except QueueFull:
            raise
        except Exception as e:   # noqa: BLE001 — dump-and-reraise
            flight.RECORDER.dump(
                "engine_exception",
                error=f"{type(e).__name__}: {e}"[:200],
                step=self.steps, live=len(self.kv.live()),
                queue_depth=len(self._queue))
            raise

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
                self._reqs[slot] = req
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
                admitted.append(slot)
        if admitted:
            telemetry.inc("serve.admission_waves")
        return admitted

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
        retires right here on max_new_tokens=1 / instant EOS).
        Registers the prompt's blocks for prefix sharing."""
        req = self._reqs[slot]
        now = time.perf_counter()
        req.first_token_at = now
        self._pos[slot] = len(self._prompt_arr[slot])
        self._tok[slot] = tok0
        self._gen[slot] = [tok0]
        self.kv.register_prefix(self._prompt_arr[slot], slot)
        self.metrics.record_admit(
            req.request_id, slot, now - req.submitted_at,
            now - req.submitted_at)
        if req.stream_cb:
            req.stream_cb(req, tok0)
        return self._maybe_finish(slot, tok0)

    def _wave_tensors(self, wave):
        dev = self.device

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype)

        return dict(
            tables=put(self.kv.tables, torch.int32),
            pos=put(wave["pos"], torch.int32),
            tokens=put(wave["tokens"], torch.int64),
            q_len=put(wave["q_len"], torch.int32))

    def _step_mixed(self):
        """One MIXED-MODE scheduler iteration: admissions, chunk
        continuations and plain decode pack into ONE ragged wave
        descriptor (per-slot ``q_len``/``first_row``) and run as ONE
        fused step — no prefill/decode phase barrier, so a decode slot
        never stalls behind another request's prompt chunks."""
        done = []
        self._admit_paged()
        live = self.kv.live()
        if not live:
            return done
        self.peak_live = max(self.peak_live, len(live))
        B = self.kv.n_slots
        pre = [s for s in live if self._gen[s] is None]
        decoding = [s for s in live if self._gen[s] is not None]
        wave_reqs = [self._reqs[s].request_id for s in live]
        t0 = time.perf_counter()
        entries = {}
        chunk_take = {}   # slot -> (take, final) for prefill q-blocks
        for s in pre:
            prompt = self._prompt_arr[s]
            P = len(prompt)
            off = int(self._prefill_off[s])
            if self.chunk > 0:
                C_b = min(_pow2(self.chunk, floor=8), self.kv.s_max)
                take = min(self.chunk, C_b, P - off)
            else:
                take = P - off
            final = off + take >= P
            # only the final chunk samples — at its last row; mid-prompt
            # chunks pass first_row == q_len
            entries[s] = ([int(t) for t in prompt[off:off + take]],
                          off, take - 1 if final else take)
            chunk_take[s] = (take, final)
        for s in decoding:
            entries[s] = ([int(self._tok[s])], int(self._pos[s]), 0)
        wave = assemble_mixed_wave(B, entries)
        dev = self._wave_tensors(wave)
        sampled = _serve_mixed_paged(
            self.params, self.cfg_tuple, self.kv.cache_k, self.kv.cache_v,
            dev["tables"], dev["pos"], dev["tokens"], dev["q_len"],
            wave["first_row"], self._temp, self._topk, self._gens)
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
        # ---- decode q-blocks ---- #
        n_dec = 0
        for s in decoding:
            req = self._reqs[s]
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
        q_tot = max(q_pre + n_dec, 1)
        self.metrics.record_step(
            live=len(live), slots=B, queue_depth=len(self._queue),
            dt_s=dt, new_tokens=n_dec, prefill_s=dt * q_pre / q_tot,
            step=self.steps, requests=wave_reqs, end_perf=t0 + dt,
            mix={"q_prefill": q_pre, "q_verify": 0, "q_decode": n_dec})
        return done

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
        res = Result(
            request_id=req.request_id, tokens=tokens,
            prompt_len=len(req.prompt), finish_reason=reason,
            n_generated=n, ttft_s=req.first_token_at - req.submitted_at,
            latency_s=now - req.submitted_at, slot=slot)
        self.metrics.record_finish(req.request_id, reason, n,
                                   res.latency_s)
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
        self.kv.release(slot)
        return res

    def health(self):
        """The admission signal: the SLO monitor's worst-burn state —
        "ok" / "degraded" / "breach" (always "ok" with no SLOs
        declared)."""
        return self.slo.health()
