"""KV-cache management for the port's serving engine: the slot-contiguous
cache, the block-table paged pool, and the mixed-wave descriptor.

``KVCacheManager`` preallocates one ``[L, B_slots, S_max, H, Dh]`` cache
pair on the device with one contiguous row per admitted sequence: every
sequence pays for ``S_max`` positions however short it is.

``PagedKVManager`` holds a fixed pool of ``[L, N_blocks, block, H, Dh]``
KV blocks on the device with a free list, a per-request BLOCK TABLE
mapping sequence positions to pool blocks, and refcounted copy-on-write
prefix sharing keyed by the prompt prefix — N requests with the same
system prompt reference its KV blocks once.  Block 0 is permanent
scratch: dead table entries point at it and inert writes land in it.

Either manager takes ``dtype="int8"`` (or ``torch.int8``): each cache
of the pair is then an ``(int8 payload, f32 scales)`` pair, the payload
of the float cache's shape and one scale per (position, head)
(``quant.kv_encode``), both planes zero at allocation as in the JAX
package.

The host logic is the JAX package's ``serving/kv_manager.py`` as it is;
where the JAX manager rebuilt a donated cache (``.at[].set``), these
write the tensors in place.

Replica-to-replica handoff (the serving fleet): ``export_blocks`` /
``export_prefix`` gather a span of the cache on the device through a
device index tensor and copy it to the host once per cache plane, as
the wire payload dict of the JAX package (``layout``, ``block``,
``length``, ``quant``, ``k``, ``v``, ``nbytes``, ``raw_nbytes``);
``import_blocks`` writes a payload into the resident tensors with one
indexed copy per plane, never a new pool.  An f32 wire is numpy f32, an
int8 wire an (int8, f32 scales) numpy pair, byte for byte the JAX
package's; a bf16 wire is a host ``torch.bfloat16`` tensor (numpy has no
bf16; the JAX package ships ``ml_dtypes`` arrays of the same bytes).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import envvars, quant, telemetry
from ..device import resolve_device


def round_up_pow2(n, floor=1):
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), int(floor))
    return 1 << (n - 1).bit_length()


def _bucket_prompt(p, s_max, pos_cap):
    """Prompt-length bucket: pow2, floor 8, capped at BOTH ``s_max`` and
    the model's position table ``pos_cap`` (a bucket past the wpe table
    would index positions that do not exist)."""
    b = min(round_up_pow2(p, floor=8), int(s_max))
    if pos_cap is not None:
        b = min(b, int(pos_cap))
    return b


def _bucket_shape(slots, max_seq_len, pos_cap, bucket):
    """(slots, S_max): both pow2-bucketed (S_max floor 16) when
    ``bucket``, S_max then capped at the position table ``pos_cap``;
    raises when ``max_seq_len`` cannot fit under the cap."""
    if bucket:
        slots = round_up_pow2(slots)
        s = round_up_pow2(max_seq_len, floor=16)
    else:
        s = int(max_seq_len)
    if pos_cap is not None:
        s = min(s, int(pos_cap))
    if s < max_seq_len:
        raise ValueError(
            f"max_seq_len={max_seq_len} exceeds the position-table "
            f"cap {pos_cap}")
    return int(slots), int(s)


def _is_int8(dtype):
    """True when ``dtype`` selects the int8 cache (the string "int8" or
    ``torch.int8``)."""
    if isinstance(dtype, str):
        return dtype.strip().lower() == "int8"
    return dtype == torch.int8


def _alloc_cache(shape, dtype, quant, device):
    """One cache: a float tensor of ``shape``, or for ``quant`` the
    (int8 payload of ``shape``, f32 scales of ``shape[:-1]``) pair."""
    if quant:
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return torch.zeros(shape, dtype=dtype, device=device)


def _planes(cache):
    """The tensors of one cache: (payload, scales) or (the cache,)."""
    return tuple(cache) if isinstance(cache, (tuple, list)) else (cache,)


def cache_nbytes(cache):
    """Bytes of a cache or wire value (a tensor or numpy array, or an
    (int8 payload, scales) pair of them), scale planes included."""
    if isinstance(cache, (tuple, list)):
        return sum(cache_nbytes(a) for a in cache)
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    return int(cache.nbytes)


def resolve_handoff_quant(mode=None):
    """Replica-to-replica KV handoff WIRE selection.  "auto" (default,
    ``$HETU_HANDOFF_QUANT``) ships the pool's native bytes — an int8
    pool's (payload, scales) pair already IS the cheap wire, an exact
    pool ships exact; "int8" forces an exact (f32/bf16) pool's export
    through the per-head codec (:func:`quant.kv_encode`, ~4x fewer
    bytes, small quantization error); "0"/"off" pins the exact wire.
    Returns "auto", "int8", or None."""
    if mode is None:
        mode = envvars.get_str("HETU_HANDOFF_QUANT")
    s = str(mode).strip().lower() if mode is not None else "auto"
    if s in ("", "auto"):
        return "auto"
    if s in ("0", "off", "none", "false"):
        return None
    if s == "int8":
        return "int8"
    raise ValueError(f"unknown handoff quant mode {mode!r} "
                     "(expected 'auto', 'int8', or 'off')")


def _to_host(t):
    """One device-to-host copy of a gathered plane: numpy for f32 and
    int8, a host tensor for bf16 (numpy has no bf16)."""
    t = t.cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _wire_repr(gathered, pool_quant, mode):
    """Resolve one cache value gathered ON THE DEVICE to its host wire
    form.  Returns (value, wire_quant) where ``value`` is an exact host
    array (a host bf16 tensor for a bf16 pool) or an (int8, scales)
    numpy pair and ``wire_quant`` is "int8" or None.  The int8 wire of
    an exact pool is encoded on the device (``quant.kv_encode``, the
    JAX codec bit for bit), so only the encoded bytes cross to the
    host."""
    if pool_quant:                      # native pair is already int8
        return tuple(_to_host(a) for a in gathered), "int8"
    if mode == "int8":
        q, s = quant.kv_encode(gathered.float())
        return (_to_host(q), _to_host(s)), "int8"
    return _to_host(gathered), None


def _to_device(a, device, dtype=None):
    """A wire array (numpy or host tensor) as a tensor on ``device``."""
    # a read-only array (a payload another process or package built)
    # is copied once on the host; torch cannot share its memory
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.require(a, requirements=["C", "W"]))
    return t.to(device=device, dtype=dtype)


def _wire_to_pool(wire, wire_quant, pool_cache):
    """Convert a wire value into the destination pool's representation
    on its device: (q, scales) for an int8 pool, a tensor of the pool
    dtype otherwise — requantizing an exact wire (on the device, so the
    bytes are JAX's) or dequantizing an int8 wire as needed, so
    handoffs compose across mixed-precision fleets."""
    if isinstance(pool_cache, (tuple, list)):           # int8 pool
        dev = pool_cache[0].device
        if wire_quant:
            return (_to_device(wire[0], dev, torch.int8),
                    _to_device(wire[1], dev, torch.float32))
        return quant.kv_encode(_to_device(wire, dev, torch.float32))
    dev = pool_cache.device
    if wire_quant:
        vals = quant.kv_decode(_to_device(wire[0], dev),
                               _to_device(wire[1], dev, torch.float32))
    else:
        vals = _to_device(wire, dev)
    return vals.to(pool_cache.dtype)


def _gather(cache, index):
    """Every plane of one cache indexed on axis 1 by the device tensor
    ``index`` (blocks or, for a slot row, (slot, positions)): a tensor
    or an (int8, scales) pair, still on the device."""
    if isinstance(cache, (tuple, list)):
        return tuple(a[index] for a in cache)
    return cache[index]


def _host_payload(cache_k, cache_v, index, pool_quant, quant_mode):
    """(k wire, v wire, wire quant, nbytes, raw_nbytes) of the span
    ``index`` selects in both caches."""
    mode = resolve_handoff_quant(quant_mode)
    k, kq = _wire_repr(_gather(cache_k, index), pool_quant, mode)
    v, _ = _wire_repr(_gather(cache_v, index), pool_quant, mode)
    nbytes = cache_nbytes(k) + cache_nbytes(v)
    shape = (k[0] if isinstance(k, tuple) else k).shape
    raw = 2 * 4 * int(np.prod(tuple(shape)))     # f32-equivalent bytes
    return k, v, kq, nbytes, raw


def assemble_mixed_wave(n_slots, entries, q_floor=1):
    """Pack per-slot ragged q-blocks into ONE padded mixed-wave
    descriptor.

    ``entries`` maps slot -> ``(tokens, pos, first_row)``:

    * ``tokens``     the slot's q-block this step — a full prompt, a
                     prompt chunk, or ``[cur]`` for plain decode
                     (len >= 1);
    * ``pos``        cache position of ``tokens[0]``;
    * ``first_row``  index of the first row whose rng stream is drawn
                     (== ``len(tokens)`` for mid-prompt chunks that
                     sample nothing).

    The JAX descriptor's ``self_fresh`` flag serves its masked reference
    path, which the port does not have.

    Width is bucketed to a power of two.  Slots absent from ``entries``
    ride along inactive (``q_len = 0``).
    """
    width = max((len(t) for t, *_ in entries.values()), default=1)
    q = round_up_pow2(width, floor=q_floor)
    tokens = np.zeros((n_slots, q), np.int32)
    pos = np.zeros(n_slots, np.int32)
    q_len = np.zeros(n_slots, np.int32)
    first_row = np.zeros(n_slots, np.int32)
    for s, (toks, p, fr) in entries.items():
        n = len(toks)
        tokens[s, :n] = toks
        pos[s] = p
        q_len[s] = n
        first_row[s] = fr
    return {
        "q": q,
        "tokens": tokens,
        "pos": pos,
        "q_len": q_len,
        "first_row": first_row,
    }


def resolve_kv_quant(kv_quant=None):
    """KV quantization selection: an explicit ``kv_quant`` wins ("int8"
    enables, None/""/"0"/"off" disables), else ``$HETU_KV_QUANT``.
    Returns "int8" or None."""
    mode = kv_quant
    if mode is None:
        mode = envvars.get_str("HETU_KV_QUANT")
    if mode is None:
        return None
    s = str(mode).strip().lower()
    if s in ("", "0", "off", "none", "false"):
        return None
    if s == "int8":
        return "int8"
    raise ValueError(f"unknown quantization mode {mode!r} (via "
                     f"HETU_KV_QUANT); supported: ('int8',)")


def resolve_kv_block(paged=None, block=None):
    """Paged-layout selection: returns the block size in tokens (0 =
    slot-contiguous layout).  An explicit ``block`` wins; else
    ``$HETU_KV_BLOCK`` ("0" pins contiguous, an integer enables paging
    at that block size, "auto" = paged with block 16 when
    ``torch.cuda.is_available()``, contiguous elsewhere).  ``paged=True``
    forces paging (default block 16), ``paged=False`` forces
    contiguous."""
    if paged is False:
        return 0
    if block is None:
        raw = str(envvars.get_str("HETU_KV_BLOCK") or "auto").strip().lower()
        if raw in ("auto", ""):
            block = 16 if (paged or torch.cuda.is_available()) else 0
        else:
            block = int(raw)
    block = int(block)
    if paged and block <= 0:
        block = 16
    return max(block, 0)


class KVCacheManager:
    """Free-slot allocator over one preallocated cache pair.

    layers/heads/head_dim: model shape; slots: requested concurrent
    sequences (bucketed up to a power of two); max_seq_len: longest
    prompt+generation to admit (bucketed, then capped at ``pos_cap`` —
    the model's max_position_embeddings, since the position table can't
    index past it); dtype: cache dtype — the engine passes its param
    dtype, so bf16 params mean a bf16 cache — or "int8" for the int8
    cache (``quant`` is then "int8", else None).  The cache pair is
    ``[L, B, S_max, H, Dh]`` tensors on ``device`` (int8: each an
    (int8 payload, f32 [L, B, S_max, H] scales) pair): the card unless
    the caller passes ``device="cpu"`` (``device.resolve_device``).
    """

    def __init__(self, *, layers, heads, head_dim, slots, max_seq_len,
                 pos_cap=None, dtype=torch.float32, device=None,
                 bucket=True):
        self.n_slots, self.s_max = _bucket_shape(slots, max_seq_len,
                                                 pos_cap, bucket)
        self.pos_cap = int(pos_cap) if pos_cap is not None else self.s_max
        self.quant = "int8" if _is_int8(dtype) else None
        device = resolve_device(device)
        shape = (layers, self.n_slots, self.s_max, heads, head_dim)
        self.cache_k = _alloc_cache(shape, dtype, self.quant, device)
        self.cache_v = _alloc_cache(shape, dtype, self.quant, device)
        self._free = list(range(self.n_slots))
        self.lengths = np.zeros(self.n_slots, np.int32)
        self.owner = [None] * self.n_slots
        self.total_allocs = 0

    @property
    def free_slots(self):
        return len(self._free)

    @property
    def occupancy(self):
        return 1.0 - len(self._free) / self.n_slots

    @property
    def cache_bytes(self):
        """Device bytes of the cache pair (scales included when int8)."""
        return cache_nbytes(self.cache_k) + cache_nbytes(self.cache_v)

    def live(self):
        """Slot indices currently holding a sequence (ascending)."""
        return [i for i in range(self.n_slots) if self.owner[i] is not None]

    def _gauges(self):
        telemetry.set_gauge("serve.occupancy", round(self.occupancy, 4))
        telemetry.set_gauge("serve.slots_free", self.free_slots)

    def bucket_prompt(self, p):
        return _bucket_prompt(p, self.s_max, self.pos_cap)

    def alloc(self, owner, length):
        """Claim a free slot for ``owner`` whose prompt fills ``length``
        positions; returns the slot index or None when full."""
        if length > self.s_max:
            raise ValueError(
                f"sequence length {length} exceeds S_max {self.s_max}")
        if not self._free:
            return None
        slot = self._free.pop()
        self.owner[slot] = owner
        self.lengths[slot] = length
        self.total_allocs += 1
        self._gauges()
        return slot

    def advance(self, slot, n=1):
        """Record ``n`` more filled positions in ``slot``."""
        self.lengths[slot] += n

    def truncate(self, slot, n):
        """Roll ``slot`` back to ``n`` filled positions: positions at or
        past ``n`` are never attended and are overwritten in place by
        the next writes there."""
        n = int(n)
        if self.owner[slot] is None:
            raise ValueError(f"slot {slot} is free")
        if not 0 <= n <= int(self.lengths[slot]):
            raise ValueError(
                f"cannot truncate slot {slot} to {n} "
                f"(filled {int(self.lengths[slot])})")
        self.lengths[slot] = n

    def release(self, slot):
        """Return a retired sequence's slot to the free list (its cache
        row is left as-is: recycled content is never attended before it
        is overwritten)."""
        if self.owner[slot] is None:
            raise ValueError(f"slot {slot} is already free")
        self.owner[slot] = None
        self.lengths[slot] = 0
        self._free.append(slot)
        self._gauges()

    # ------------------------------------------------------------- #
    # replica-to-replica handoff (span export — paged parity)
    # ------------------------------------------------------------- #

    def export_blocks(self, slot, quant_mode=None):
        """Serialize ``slot``'s filled KV span to a host-side payload
        (the contiguous parity of ``PagedKVManager.export_blocks``: one
        dense ``[L, length, H, Dh]`` span per cache instead of a block
        list).  A pure read."""
        if self.owner[slot] is None:
            raise ValueError(f"slot {slot} is free")
        length = int(self.lengths[slot])
        index = (slice(None), slot, slice(0, length))
        k, v, kq, nbytes, raw = _host_payload(
            self.cache_k, self.cache_v, index, self.quant, quant_mode)
        return {"layout": "contiguous", "length": length,
                "quant": kq, "k": k, "v": v,
                "nbytes": nbytes, "raw_nbytes": raw}

    def import_blocks(self, payload, owner, *, reserve=None):
        """Materialize an exported contiguous span into a fresh slot
        (dequantizing/requantizing the wire into this cache's layout as
        needed), written in place.  Returns the slot, or None when slots
        are short."""
        if payload.get("layout") != "contiguous":
            raise ValueError(
                f"cannot import a {payload.get('layout')!r} payload "
                "into a contiguous manager")
        length = int(payload["length"])
        reserve = length if reserve is None else int(reserve)
        if reserve < length:
            raise ValueError(
                f"reserve {reserve} below payload length {length}")
        slot = self.alloc(owner, reserve)
        if slot is None:
            return None
        self.lengths[slot] = length
        wq = payload["quant"]
        for name, key in (("cache_k", "k"), ("cache_v", "v")):
            cache = getattr(self, name)
            vals = _wire_to_pool(payload[key], wq, cache)
            for t, val in zip(_planes(cache), _planes(vals)):
                t[:, slot, :length] = val
        return slot


class _PrefixEntry:
    """One registered prompt prefix: the tokens (collision-proof key
    verification), the pool blocks holding its KV (each refcounted on
    behalf of the cache so they outlive the registering request), and
    an LRU stamp for eviction under pool pressure."""

    __slots__ = ("tokens", "blocks", "length", "used")

    def __init__(self, tokens, blocks, length, used):
        self.tokens = tokens
        self.blocks = blocks
        self.length = length
        self.used = used


class PagedKVManager:
    """Block-pool allocator with per-request block tables.

    The cache pair is ``[L, N_blocks, block, H, Dh]`` tensors on
    ``device`` (the card unless the caller passes ``device="cpu"``); a request holds ``ceil(tokens / block)`` blocks listed
    in its slot's block-table row, so pool bytes bound the TOKENS held,
    not slots * S_max.  Block id 0 is a permanent scratch block.

    Admission RESERVES the request's whole span (prompt +
    max_new_tokens, minus shared prefix blocks) up front, so waves never
    allocate and never preempt — the engine requeues an admission the
    pool cannot hold yet (backpressure).

    Prefix sharing (``prefix_share``): completed prompts register their
    blocks keyed by the prompt tokens; a later request whose prompt
    starts with a registered prefix attaches those blocks refcounted.  A
    shared block whose tail the new request must overwrite is
    COPY-ON-WRITE forked at admission.  Retirement decrements refcounts
    and frees a block only at zero; registered prefixes are LRU-evicted
    when the pool runs short.
    """

    def __init__(self, *, layers, heads, head_dim, slots, max_seq_len,
                 pos_cap=None, dtype=torch.float32, device=None,
                 bucket=True, block=16, pool_blocks=None,
                 prefix_share=None):
        self.n_slots, self.s_max = _bucket_shape(slots, max_seq_len,
                                                 pos_cap, bucket)
        self.pos_cap = int(pos_cap) if pos_cap is not None else self.s_max
        self.block = int(block)
        if self.block < 1:
            raise ValueError(f"block size must be >= 1, got {block}")
        # table width: blocks needed for a brim-full sequence
        self.table_width = -(-self.s_max // self.block)
        if pool_blocks is None:
            # contiguous-equivalent capacity (+1 for the scratch block)
            pool_blocks = self.n_slots * self.table_width + 1
        self.n_blocks = int(pool_blocks)
        if self.n_blocks < 2:
            raise ValueError("pool needs at least 2 blocks "
                             "(scratch + one allocatable)")
        if prefix_share is None:
            prefix_share = envvars.get_bool("HETU_KV_PREFIX_SHARE")
        self.prefix_share = bool(prefix_share)
        self.quant = "int8" if _is_int8(dtype) else None
        device = resolve_device(device)
        shape = (layers, self.n_blocks, self.block, heads, head_dim)
        self.cache_k = _alloc_cache(shape, dtype, self.quant, device)
        self.cache_v = _alloc_cache(shape, dtype, self.quant, device)
        self._free = list(range(1, self.n_blocks))   # 0 = scratch
        self.ref = np.zeros(self.n_blocks, np.int32)
        self.tables = np.zeros((self.n_slots, self.table_width), np.int32)
        self.n_table = np.zeros(self.n_slots, np.int32)
        self.lengths = np.zeros(self.n_slots, np.int32)
        self.owner = [None] * self.n_slots
        self._free_slots = list(range(self.n_slots))
        self._prefix = {}                            # tokens -> entry
        self._clock = 0
        self.total_allocs = 0
        self.cow_copies = 0
        self.prefix_hits = 0
        self.evictions = 0
        # fleet directory feed: the router's PrefixDirectory wires
        # these so registrations/evictions on THIS replica become
        # fleet-visible hints (None = standalone engine, no directory)
        self.on_prefix_register = None   # fn(tokens, entry)
        self.on_prefix_evict = None      # fn(tokens)
        # tiered KV (serving/kv_tiers.py): eviction-to-tier instead of
        # eviction-to-drop.  The spill hook gets the doomed prefix's
        # wire payload BEFORE its blocks are freed; tier_store is the
        # engine admission path's fetch handle.  Both None = drop on
        # evict
        self.on_prefix_spill = None      # fn(tokens, payload) -> bool
        self.tier_store = None
        self.spills = 0
        self.prefix_hit_tokens = 0       # recompute tokens saved
        # replica-to-replica handoff accounting
        self.exports = 0
        self.imports = 0
        self.export_bytes = 0
        self.import_bytes = 0

    # ------------------------------------------------------------- #

    @property
    def capacity_blocks(self):
        """Blocks a single request could ever hold (pool minus scratch)."""
        return self.n_blocks - 1

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def free_slots(self):
        return len(self._free_slots)

    @property
    def blocks_shared(self):
        """Blocks referenced by more than one holder (requests and/or
        the prefix cache)."""
        return int(np.sum(self.ref > 1))

    @property
    def cache_bytes(self):
        """Device bytes of the pool pair (scales included when int8)."""
        return cache_nbytes(self.cache_k) + cache_nbytes(self.cache_v)

    @property
    def occupancy(self):
        return 1.0 - len(self._free_slots) / self.n_slots

    def live(self):
        return [i for i in range(self.n_slots) if self.owner[i] is not None]

    def blocks_needed(self, tokens):
        return -(-int(tokens) // self.block)

    def bucket_prompt(self, p):
        return _bucket_prompt(p, self.s_max, self.pos_cap)

    def _gauges(self):
        telemetry.set_gauge("serve.occupancy", round(self.occupancy, 4))
        telemetry.set_gauge("serve.blocks_free", self.free_blocks)
        telemetry.set_gauge("serve.blocks_shared", self.blocks_shared)
        telemetry.set_gauge("serve.prefix_entries", len(self._prefix))

    # ------------------------------------------------------------- #
    # prefix cache
    # ------------------------------------------------------------- #

    def match_prefix(self, prompt):
        """Longest registered prefix of ``prompt`` (token-verified);
        returns (entry, usable_len) or (None, 0).  ``usable_len`` is
        capped at len(prompt) - 1: the LAST prompt position is always
        recomputed, because sampling the first token needs its
        logits."""
        if not self.prefix_share:
            return None, 0
        p = tuple(int(t) for t in prompt)
        best, best_len = None, 0
        for key, e in self._prefix.items():
            if e.length <= len(p) - 1 and e.length > best_len \
                    and key == p[:e.length]:
                best, best_len = e, e.length
        if best is not None:
            self._clock += 1
            best.used = self._clock
        return best, best_len

    def register_prefix(self, prompt, slot):
        """Register ``slot``'s prompt blocks for future sharing (called
        once the prompt's KV is fully written).  An entry is keyed at
        EVERY full-block boundary of the prompt plus its full length.
        The cache takes its own refcount on each block so the blocks
        survive the registering request's retirement."""
        if not self.prefix_share:
            return
        p = tuple(int(t) for t in prompt)
        cuts = {k * self.block
                for k in range(1, len(p) // self.block + 1)}
        cuts.add(len(p))
        for n in sorted(cuts):
            key = p[:n]
            if key in self._prefix:
                self._clock += 1
                self._prefix[key].used = self._clock
                if self.on_prefix_register is not None:
                    # re-registration refreshes the directory's
                    # last-use stamp (TTL staleness tracks real use)
                    self.on_prefix_register(key, self._prefix[key])
                continue
            blocks = [int(b)
                      for b in self.tables[slot, :self.blocks_needed(n)]]
            for b in blocks:
                self.ref[b] += 1
            self._clock += 1
            e = _PrefixEntry(key, blocks, n, self._clock)
            self._prefix[key] = e
            if self.on_prefix_register is not None:
                self.on_prefix_register(key, e)
        self._gauges()

    def _evict_for(self, need, keep=None):
        """LRU-drop registered prefixes until ``need`` blocks are free
        (blocks still referenced by live requests stay allocated)."""
        while len(self._free) < need and self._prefix:
            candidates = [(e.used, k) for k, e in self._prefix.items()
                          if e is not keep]
            if not candidates:
                break
            _, key = min(candidates)
            if self.on_prefix_spill is not None:
                # eviction-to-tier: serialize the doomed prefix while
                # its blocks are still resident (export_prefix is a
                # pure read) and offer it to the tier ladder; a
                # declined spill proceeds as a plain drop
                try:
                    payload = self.export_prefix(key, count=False)
                except ValueError:
                    payload = None
                if payload is not None \
                        and self.on_prefix_spill(key, payload):
                    self.spills += 1
                    telemetry.inc("serve.prefix_spills")
            e = self._prefix.pop(key)
            for b in e.blocks:
                self.ref[b] -= 1
                if self.ref[b] == 0:
                    self._free.append(b)
            self.evictions += 1
            telemetry.inc("serve.prefix_evictions")
            if self.on_prefix_evict is not None:
                self.on_prefix_evict(key)

    def clear_prefixes(self):
        """Drop every registered prefix, freeing the blocks only the
        prefix cache held (no spill: the caller says the KV is stale).
        The engine calls it on a weight swap, since a prefix's KV holds
        the keys and values of the weights that computed it.  Returns
        the count dropped."""
        keys = list(self._prefix)
        for key in keys:
            e = self._prefix.pop(key)
            for b in e.blocks:
                self.ref[b] -= 1
                if self.ref[b] == 0:
                    self._free.append(b)
            if self.on_prefix_evict is not None:
                self.on_prefix_evict(key)
        self._gauges()
        return len(keys)

    # ------------------------------------------------------------- #
    # alloc / fork / release
    # ------------------------------------------------------------- #

    def alloc(self, owner, prompt, reserve):
        """Claim a slot plus blocks for a request reserving ``reserve``
        total positions (prompt + max_new_tokens).  Attaches the longest
        registered prefix refcounted, COW-forks a mid-block prefix tail,
        and takes fresh blocks for the rest of the span.  Returns
        (slot, cached_len) or (None, 0) when slots or blocks are short
        (the engine requeues: backpressure, not failure)."""
        if reserve > self.s_max:
            raise ValueError(
                f"sequence length {reserve} exceeds S_max {self.s_max}")
        if not self._free_slots:
            return None, 0
        entry, cached = self.match_prefix(prompt)
        n_shared = cached // self.block          # full shared blocks
        straddle = cached % self.block != 0      # mid-block tail -> COW
        total = self.blocks_needed(reserve)
        need = total - n_shared                  # fork counts as fresh
        if len(self._free) < need:
            self._evict_for(need, keep=entry)
            if len(self._free) < need:
                return None, 0
        slot = self._free_slots.pop()
        row = []
        for j in range(n_shared):
            b = entry.blocks[j]
            self.ref[b] += 1
            row.append(b)
        if straddle:
            src = entry.blocks[n_shared]
            dst = self._free.pop()
            self.ref[dst] = 1
            # the forked block starts as an exact copy of the shared
            # one, then takes private writes
            self._block_copy(src, dst)
            row.append(dst)
            self.cow_copies += 1
            telemetry.inc("serve.cow_copies")
        for _ in range(total - len(row)):
            b = self._free.pop()
            self.ref[b] = 1
            row.append(b)
        self.tables[slot, :] = 0
        self.tables[slot, :len(row)] = row
        self.n_table[slot] = len(row)
        self.owner[slot] = owner
        self.lengths[slot] = cached
        self.total_allocs += 1
        if cached:
            self.prefix_hits += 1
            self.prefix_hit_tokens += cached
            telemetry.inc("serve.prefix_hits")
        self._gauges()
        return slot, cached

    def _block_copy(self, src, dst):
        """Copy pool block ``src`` onto ``dst`` in every layer, in place
        (the JAX manager rebuilds the donated pool here); an int8 pool
        copies payload and scales together, so a fork never mixes one
        block's payload with another's scales."""
        for t in _planes(self.cache_k) + _planes(self.cache_v):
            t[:, dst] = t[:, src]

    def advance(self, slot, n=1):
        """Record ``n`` more filled positions (blocks were reserved at
        admission — nothing to allocate)."""
        self.lengths[slot] += n

    def truncate(self, slot, n):
        """Roll ``slot`` back to ``n`` filled positions at refcount
        discipline.  The slot keeps its whole-span reservation, but any
        reserved block it will now REWRITE (covering positions at or past
        ``n``) that is still SHARED is detached: the boundary block still
        holding live positions below ``n`` is copy-on-write forked,
        wholly-dead trailing blocks are swapped for fresh blocks with no
        copy.  A shared block is never freed here."""
        if self.owner[slot] is None:
            raise ValueError(f"slot {slot} is free")
        old = int(self.lengths[slot])
        n = int(n)
        if not 0 <= n <= old:
            raise ValueError(
                f"cannot truncate slot {slot} to {n} (filled {old})")
        first_w = n // self.block   # first block future writes touch
        for j in range(first_w, int(self.n_table[slot])):
            b = int(self.tables[slot, j])
            if self.ref[b] <= 1:
                continue
            partial = j == first_w and n % self.block != 0
            if not self._free:
                self._evict_for(1)
            if not self._free:
                raise RuntimeError(
                    f"pool exhausted un-COWing rollback of slot {slot} "
                    f"(block {b} shared at ref {int(self.ref[b])})")
            dst = self._free.pop()
            self.ref[dst] = 1
            self.ref[b] -= 1
            if partial:
                self._block_copy(b, dst)
                self.cow_copies += 1
                telemetry.inc("serve.cow_copies")
            self.tables[slot, j] = dst
        self.lengths[slot] = n
        self._gauges()

    def release(self, slot):
        """Retire a sequence: decrement each held block's refcount and
        free it only at zero."""
        if self.owner[slot] is None:
            raise ValueError(f"slot {slot} is already free")
        for j in range(int(self.n_table[slot])):
            b = int(self.tables[slot, j])
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self._free.append(b)
        self.tables[slot, :] = 0
        self.n_table[slot] = 0
        self.owner[slot] = None
        self.lengths[slot] = 0
        self._free_slots.append(slot)
        self._gauges()

    # ------------------------------------------------------------- #
    # replica-to-replica handoff (block export / import)
    # ------------------------------------------------------------- #

    def export_blocks(self, slot, quant_mode=None):
        """Serialize ``slot``'s FILLED blocks to a host-side payload a
        peer replica can :meth:`import_blocks`.  Ships exactly
        ``blocks_needed(length)`` blocks (the filled span, not the whole
        reservation), as ``[L, n, block, H, Dh]`` host arrays — or the
        (int8, scales) pair when the pool is int8 or the wire mode
        forces int8 (:func:`resolve_handoff_quant`), ~4x fewer bytes
        with scale planes moving in lockstep.  A pure read: refcounts,
        tables and the prefix cache are untouched."""
        if self.owner[slot] is None:
            raise ValueError(f"slot {slot} is free")
        length = int(self.lengths[slot])
        n = self.blocks_needed(length)
        return self._export_span(self.tables[slot, :n], length, quant_mode)

    def export_prefix(self, tokens, quant_mode=None, *, count=True):
        """Serialize a REGISTERED prefix's blocks to the same wire payload
        as :meth:`export_blocks` — no live slot required (the prefix
        cache holds its own refcounts), which is how a fleet moves warmth
        without a resident request.  Returns None when the prefix is not
        registered here (or sharing is off).  A pure read."""
        if not self.prefix_share:
            return None
        e = self._prefix.get(tuple(int(t) for t in tokens))
        if e is None:
            return None
        return self._export_span(e.blocks, int(e.length), quant_mode,
                                 count=count)

    def _export_span(self, blocks, length, quant_mode, *, count=True):
        """Gather pool ``blocks`` into the wire payload: the block ids go
        to the device as ONE index tensor, each cache plane is gathered
        there and copied to the host once.  ``count=False`` keeps the
        gather out of the handoff ledger (the tier-spill path: the tier
        store keeps its own byte counters)."""
        dev = _planes(self.cache_k)[0].device
        idx = torch.as_tensor(np.asarray(blocks, np.int64), device=dev)
        k, v, kq, nbytes, raw = _host_payload(
            self.cache_k, self.cache_v, (slice(None), idx), self.quant,
            quant_mode)
        if count:
            self.exports += 1
            self.export_bytes += nbytes
            telemetry.inc("serve.kv_export_bytes", nbytes)
        return {"layout": "paged", "block": self.block, "length": length,
                "quant": kq, "k": k, "v": v,
                "nbytes": nbytes, "raw_nbytes": raw}

    def import_blocks(self, payload, owner, *, reserve=None, prompt=None):
        """Materialize an exported span into THIS pool: claims a slot
        plus fresh blocks for ``reserve`` positions (default: the
        payload's filled length), writes the wire blocks into the
        resident pool tensors with one ``index_copy_`` per plane
        (requantizing an exact wire into an int8 pool / dequantizing an
        int8 wire into an exact pool as needed), and — given ``prompt``
        — re-registers the prompt's prefix over the imported blocks so
        later admissions here attach them refcounted.  Returns the slot,
        or None when slots or blocks are short (backpressure, as
        ``alloc``).  Block size and layout must match; a mismatch
        raises."""
        if payload.get("layout") != "paged":
            raise ValueError(
                f"cannot import a {payload.get('layout')!r} payload "
                "into a paged manager")
        if int(payload["block"]) != self.block:
            raise ValueError(
                f"payload block size {payload['block']} != pool block "
                f"size {self.block}")
        length = int(payload["length"])
        reserve = length if reserve is None else int(reserve)
        if reserve < length:
            raise ValueError(
                f"reserve {reserve} below payload length {length}")
        if reserve > self.s_max:
            raise ValueError(
                f"sequence length {reserve} exceeds S_max {self.s_max}")
        if not self._free_slots:
            return None
        n_pay = self.blocks_needed(length)
        total = self.blocks_needed(reserve)
        if len(self._free) < total:
            self._evict_for(total)
            if len(self._free) < total:
                return None
        slot = self._free_slots.pop()
        row = []
        for _ in range(total):
            b = self._free.pop()
            self.ref[b] = 1
            row.append(b)
        wq = payload["quant"]
        dev = _planes(self.cache_k)[0].device
        dst = torch.as_tensor(np.asarray(row[:n_pay], np.int64), device=dev)
        for name, key in (("cache_k", "k"), ("cache_v", "v")):
            cache = getattr(self, name)
            vals = _wire_to_pool(payload[key], wq, cache)
            for t, val in zip(_planes(cache), _planes(vals)):
                t.index_copy_(1, dst, val)
        self.tables[slot, :] = 0
        self.tables[slot, :len(row)] = row
        self.n_table[slot] = len(row)
        self.owner[slot] = owner
        self.lengths[slot] = length
        self.total_allocs += 1
        self.imports += 1
        self.import_bytes += int(payload["nbytes"])
        telemetry.inc("serve.kv_import_bytes", int(payload["nbytes"]))
        if prompt is not None and len(prompt) <= length:
            self.register_prefix(prompt, slot)
        self._gauges()
        return slot

    # ------------------------------------------------------------- #

    def stats(self):
        """JSON-able pool view (bench/telemetry surface)."""
        return {
            "block": self.block,
            "n_blocks": self.n_blocks,
            "blocks_free": self.free_blocks,
            "blocks_shared": self.blocks_shared,
            "prefix_entries": len(self._prefix),
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "spills": self.spills,
            "exports": self.exports,
            "imports": self.imports,
            "export_bytes": self.export_bytes,
            "import_bytes": self.import_bytes,
            "quant": self.quant or "off",
            "cache_bytes": self.cache_bytes,
        }
