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
write the tensors in place.  The fleet's block export/import is a later
slice (ROADMAP A7).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import envvars, telemetry
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


def _nbytes(*caches):
    """Device bytes of the caches, scale planes included."""
    return sum(t.numel() * t.element_size() for c in caches
               for t in _planes(c))


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
        return _nbytes(self.cache_k, self.cache_v)

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

    def export_blocks(self, slot, quant_mode=None):
        raise NotImplementedError(
            "KV span export is not ported yet (ROADMAP A7)")

    def import_blocks(self, payload, owner, *, reserve=None):
        raise NotImplementedError(
            "KV span import is not ported yet (ROADMAP A7)")


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
        self.prefix_hit_tokens = 0       # recompute tokens saved

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
        return _nbytes(self.cache_k, self.cache_v)

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
                continue
            blocks = [int(b)
                      for b in self.tables[slot, :self.blocks_needed(n)]]
            for b in blocks:
                self.ref[b] += 1
            self._clock += 1
            self._prefix[key] = _PrefixEntry(key, blocks, n, self._clock)
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
            e = self._prefix.pop(key)
            for b in e.blocks:
                self.ref[b] -= 1
                if self.ref[b] == 0:
                    self._free.append(b)
            self.evictions += 1
            telemetry.inc("serve.prefix_evictions")

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

    def stats(self):
        """JSON-able pool view."""
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
            "quant": self.quant or "off",
            "cache_bytes": self.cache_bytes,
        }
