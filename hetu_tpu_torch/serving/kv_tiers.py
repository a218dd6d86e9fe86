"""Tiered KV: fleet-global prefix capacity behind the paged pool.

The prefix directory can only route to prefix blocks that happened to
survive their replica's LRU — a prefix evicted from the HBM pool is
simply GONE, and the next request holding that prompt pays a full cold
prefill.  This module turns eviction-to-drop into eviction-to-tier,
the HET discipline (PAPER.md: hot embeddings local, cold ones on the
PS) applied to the KV side, where it is strictly easier: KV is
immutable once written, so tiering is EXACT — no staleness budget, no
version fences, a fetched span is token-identical to the original
prefill by construction.

The ladder::

    HBM pool (PagedKVManager)        <- refcounted, token-verified
      | evict (LRU, pool pressure)      export_prefix: wire payload
      v
    host-RAM ring (this module)      <- LRU by bytes, HETU_KV_HOST_BYTES
      | overflow                        payload dicts, int8 wire form
      v
    sharded-PS cold store            <- HETU_KV_PS_TIER; kv_put/kv_get
                                        keyed by prefix hash, versioned

In the PyTorch port the PS cold rung waits for the port's parameter
server (ROADMAP A10): a store asked for it (``ps_tier=`` or
``HETU_KV_PS_TIER``) raises NotImplementedError at construction, and
the ladder is the host ring alone.

and the miss path escalates the other way: local pool (match_prefix)
-> peer-replica steal (the directory hint + handoff) -> host
ring -> PS fetch -> cold prefill.  Fetches re-admit through
``import_blocks`` with the prompt re-registered, so the engine's
admission attaches the blocks refcounted exactly as if the prefix had
never left.

Ledger discipline (``hetu_trace --check`` tier-balance): one
``kv_spill`` opens a residency when a prefix ENTERS the ladder; exactly
one terminal event closes it — ``kv_fetch`` (re-admitted to a pool;
the pool copy re-spills on its next eviction) or ``kv_tier_drop`` (ring
overflow with the PS rung off/dead, corruption, store close).
Re-spilling an already-resident prefix refreshes its LRU stamp without
a second ``kv_spill``; host->PS demotion moves the payload without
touching the ledger (the residency is one, wherever it lives).

Degradation contract (chaos role ``kvtier``): a drawn kill at the
``kvtier.ps_put``/``kvtier.ps_get`` seams takes the PS rung down —
resident cold entries get their terminal drop, future spills stop at
the host ring — and a drawn drop/reset at ``kvtier.ring_get`` corrupts
the ring entry (dropped, counted, the request admits cold).  Both
degrade to today's drop-on-evict with ZERO request loss: a tier miss
is a cold prefill, never an error.
"""

from __future__ import annotations

from .. import envvars, locks, telemetry
from ..ps import faults
from ..telemetry import flight
from .prefix_directory import prefix_hash

__all__ = ["TieredKVStore", "PS_NAMESPACE"]

# PS-side key namespace for cold prefix payloads: disjoint from every
# param/table key by prefix, so a cold store can share servers with a
# training job without collisions
PS_NAMESPACE = "__kvcold__"


class _RingEntry:
    """One host-ring resident: the prefix tokens (fetch needs them to
    re-register), its wire payload, and the payload's byte size."""

    __slots__ = ("tokens", "payload", "nbytes")

    def __init__(self, tokens, payload):
        self.tokens = tokens
        self.payload = payload
        self.nbytes = int(payload["nbytes"])


class TieredKVStore:
    """The spill/fetch ladder.  One store serves a whole fleet (the
    router builds it and :meth:`attach`-wires every replica incarnation)
    or a single standalone engine.  Knobs default to the registry
    (``HETU_KV_HOST_BYTES`` / ``HETU_KV_PS_TIER``); pass ``ps=`` any
    client with ``kv_put``/``kv_get``/``kv_del`` (PSClient,
    ShardedPSClient, or a test double) — unset, the first PS use
    resolves ``PSClient.get()``."""

    def __init__(self, *, host_bytes=None, ps_tier=None, ps=None,
                 directory=None):
        self.host_bytes = int(
            host_bytes if host_bytes is not None
            else envvars.get_int("HETU_KV_HOST_BYTES"))
        self.ps_tier = bool(
            ps_tier if ps_tier is not None
            else envvars.get_bool("HETU_KV_PS_TIER"))
        if self.ps_tier:
            raise NotImplementedError(
                "the parameter-server cold tier of tiered KV "
                "(ps_tier=, HETU_KV_PS_TIER) waits for the port's PS "
                "(ROADMAP A10); the host ring (HETU_KV_HOST_BYTES) runs")
        self.ps = ps
        self.directory = directory     # PrefixDirectory or None: gets
        self.block = None              # the tier column stamped
        self.ps_dead = False
        # one reentrant guard over the whole ladder: spill/fetch from
        # replica threads race each other on the ring dict and its
        # byte counter, and a transport death inside fetch/_ps_put
        # re-enters through kill_ps.  Reentrant, not plain: kill_ps is
        # both a public entry point and an under-lock internal.  (The
        # PS rung RPC runs under the lock; with an in-process server
        # that is a dict op, and with a real TCP transport lockdep's
        # held-across seam flags it — by design.)
        self._mu = locks.TracedRLock("kv.tiers")
        self._ring = {}                # hash -> _RingEntry (dict IS
        self._ring_bytes = 0           # the LRU: insertion-ordered,
        #                                re-insert on refresh)
        self._ps_index = {}            # hash -> (tokens, length,
        self._ps_version = 0           #          nbytes, version)
        # per-tier counters (stats surface; hetu_top tier panel reads
        # the event-stream twin)
        self.spills = {"host": 0, "ps": 0}
        self.fetches = {"host": 0, "ps": 0}
        self.drops = {"host": 0, "ps": 0}
        self.refreshes = 0             # re-spill of a resident prefix
        self.demotes = 0               # host-ring overflow -> PS
        self.corruptions = 0           # chaos-corrupted ring reads
        self.spill_rejects = 0         # ladder full/off: plain drop
        self.import_failed = 0         # fetched but the pool was full
        self.lookup_hits = 0
        self.lookup_misses = 0
        self.spill_bytes = 0
        self.fetch_bytes = 0

    @classmethod
    def from_env(cls, **kw):
        """The router's constructor hook: a store when either rung is
        enabled, else None (tiering off = byte-identical drop-on-evict
        — no hooks are wired anywhere)."""
        host = envvars.get_int("HETU_KV_HOST_BYTES")
        ps = envvars.get_bool("HETU_KV_PS_TIER")
        if host <= 0 and not ps:
            return None
        return cls(host_bytes=host, ps_tier=ps, **kw)

    @property
    def enabled(self):
        return self.host_bytes > 0 or self.ps_tier

    # ------------------------------------------------------------- #
    # wiring
    # ------------------------------------------------------------- #

    def attach(self, replica, kv):
        """Wire one ``PagedKVManager`` into the ladder: its LRU prefix
        evictions spill here (the manager exports BEFORE freeing), and
        its engine's admission path fetches through ``kv.tier_store``.
        Called per incarnation, like the directory attach; a
        non-sharing or block-mismatched pool attaches as a no-op."""
        if not self.enabled or not getattr(kv, "prefix_share", False):
            return
        block = getattr(kv, "block", None)
        if block is None:
            return
        if self.block is None:
            self.block = int(block)
        elif int(block) != self.block:
            return   # a payload cut at one block size cannot land in
            #          a pool cut at another
        kv.tier_store = self
        kv.on_prefix_spill = \
            lambda toks, payload, _r=replica: self.spill(
                toks, payload, replica=_r)

    # ------------------------------------------------------------- #
    # spill: HBM -> host ring -> PS
    # ------------------------------------------------------------- #

    def spill(self, tokens, payload, *, replica=None):
        """Accept an evicted prefix's wire payload into the ladder;
        True when it is now tier-resident (False = the caller's drop
        proceeds, exactly today's behavior).  An already-resident
        prefix refreshes its LRU stamp — one residency, one ledger
        entry."""
        if payload is None or not self.enabled:
            return False
        toks = tuple(int(t) for t in tokens)
        h = prefix_hash(toks)
        with self._mu:
            e = self._ring.pop(h, None)
            if e is not None:
                # refresh: newest payload (byte-identical for
                # immutable KV, but the re-export is authoritative),
                # MRU position
                self._ring_bytes -= e.nbytes
                ne = _RingEntry(toks, payload)
                self._ring[h] = ne
                self._ring_bytes += ne.nbytes
                self.refreshes += 1
                return True
            if h in self._ps_index:
                self.refreshes += 1   # already cold-resident: nothing
                return True           # to move (payload is identical)
            nbytes = int(payload["nbytes"])
            if self.host_bytes > 0 and nbytes <= self.host_bytes:
                self._ring[h] = _RingEntry(toks, payload)
                self._ring_bytes += nbytes
                self._note_spill(h, payload, "host", replica)
                if self.directory is not None:
                    self.directory.set_tier(toks, "host")
                self._shrink_ring()
                return True
            if self._ps_put(h, toks, payload):
                self._note_spill(h, payload, "ps", replica)
                if self.directory is not None:
                    self.directory.set_tier(toks, "ps")
                return True
            self.spill_rejects += 1
            return False

    def _note_spill(self, h, payload, tier, replica):
        self.spills[tier] += 1
        self.spill_bytes += int(payload["nbytes"])
        telemetry.inc(f"kvtier.spill_{tier}")
        self._event("kv_spill", prefix=h, tier=tier,
                    length=int(payload["length"]),
                    bytes=int(payload["nbytes"]),
                    **({"replica": replica} if replica is not None
                       else {}))

    def _shrink_ring(self):
        """LRU-evict the ring back under its byte budget: each victim
        demotes to the PS rung when it can, else takes its terminal
        drop (the ledger closes; drop-on-evict beyond the ring)."""
        while self._ring_bytes > self.host_bytes and self._ring:
            h = next(iter(self._ring))        # oldest insertion
            e = self._ring.pop(h)
            self._ring_bytes -= e.nbytes
            if self._ps_put(h, e.tokens, e.payload):
                self.demotes += 1
                telemetry.inc("kvtier.demotes")
                if self.directory is not None:
                    self.directory.set_tier(e.tokens, "ps")
            else:
                self._drop(h, e.tokens, "host", "ring_full")

    def _drop(self, h, tokens, tier, reason):
        """Terminal drop: the residency ends without a fetch (ring
        overflow past a dead/absent PS rung, corruption, close)."""
        self.drops[tier] += 1
        telemetry.inc(f"kvtier.drop_{tier}")
        self._event("kv_tier_drop", prefix=h, tier=tier, reason=reason)
        if self.directory is not None:
            self.directory.clear_tier(tokens)

    # ------------------------------------------------------------- #
    # lookup + fetch: host ring -> PS -> miss
    # ------------------------------------------------------------- #

    def lookup(self, prompt, block=None):
        """Longest block-aligned tier-resident prefix of ``prompt``:
        ``(tokens, length, tier)`` or None.  Token-verified (the hash
        only indexes), probing block cuts longest-first like the
        directory — the usable share is capped below the last prompt
        position, so the full prompt is never probed."""
        block = self.block if block is None else int(block)
        with self._mu:
            if not self.enabled or block is None \
                    or (not self._ring and not self._ps_index):
                return None
            p = [int(t) for t in prompt]
            if len(p) < 2:
                return None
            top = ((len(p) - 1) // block) * block
            for n in range(top, 0, -block):
                cut = p[:n]
                h = prefix_hash(cut)
                e = self._ring.get(h)
                if e is not None and list(e.tokens) == cut:
                    self.lookup_hits += 1
                    return tuple(cut), n, "host"
                cold = self._ps_index.get(h)
                if cold is not None and list(cold[0]) == cut:
                    self.lookup_hits += 1
                    return tuple(cut), n, "ps"
            self.lookup_misses += 1
            return None

    def fetch(self, tokens, *, replica=None):
        """Pop a resident prefix's payload back out of the ladder —
        host ring first, then the PS cold store — ending its residency
        (the re-admitted pool copy re-spills on its next eviction,
        which is what keeps the ledger exact).  Returns the wire
        payload or None: a miss, a chaos corruption, or a dead PS all
        degrade to a cold prefill at the caller."""
        toks = tuple(int(t) for t in tokens)
        h = prefix_hash(toks)
        with self._mu:
            e = self._ring.get(h)
            if e is not None:
                if self._chaos_corrupt("kvtier.ring_get"):
                    # corrupted host copy: never land garbage KV —
                    # drop the residency and admit cold (zero loss,
                    # warmth lost)
                    del self._ring[h]
                    self._ring_bytes -= e.nbytes
                    self.corruptions += 1
                    telemetry.inc("kvtier.corruptions")
                    self._drop(h, toks, "host", "corrupt")
                    return None
                del self._ring[h]
                self._ring_bytes -= e.nbytes
                self._note_fetch(h, e.payload, "host", replica)
                if self.directory is not None:
                    self.directory.clear_tier(toks)
                return e.payload
            cold = self._ps_index.get(h)
            if cold is None:
                return None
            _toks0, _length, _nbytes, version = cold
            if self._chaos_kill("kvtier.ps_get"):
                return None        # kill_ps just dropped every cold
                #                    residency, this one included
            try:
                got = self._ps_client().kv_get(PS_NAMESPACE + h)
            except Exception as err:  # noqa: BLE001 — transport death
                self.kill_ps(reason=f"kv_get: {type(err).__name__}")
                return None
            if got is None or int(got[1]) != version:
                # vanished or overwritten behind our back: a cold
                # entry we cannot vouch for must not land — drop the
                # residency
                del self._ps_index[h]
                self._drop(h, toks, "ps", "version_skew"
                           if got is not None else "missing")
                return None
            payload = got[0]
            del self._ps_index[h]
            try:
                self._ps_client().kv_del(PS_NAMESPACE + h)
            except Exception:  # noqa: BLE001 — the payload is in
                pass           # hand; a failed delete only leaks a
                #                cold blob
            self._note_fetch(h, payload, "ps", replica)
            if self.directory is not None:
                self.directory.clear_tier(toks)
            return payload

    def _note_fetch(self, h, payload, tier, replica):
        self.fetches[tier] += 1
        self.fetch_bytes += int(payload["nbytes"])
        telemetry.inc(f"kvtier.fetch_{tier}")
        self._event("kv_fetch", prefix=h, tier=tier,
                    length=int(payload["length"]),
                    bytes=int(payload["nbytes"]),
                    **({"replica": replica} if replica is not None
                       else {}))

    def note_import_failed(self):
        """The caller fetched but its pool could not hold the import:
        the residency already ended (honest — the warmth is gone), this
        only counts the degradation."""
        self.import_failed += 1
        telemetry.inc("kvtier.import_failed")

    # ------------------------------------------------------------- #
    # PS rung
    # ------------------------------------------------------------- #

    def _ps_client(self):
        if self.ps is None:
            from ..ps.client import PSClient
            self.ps = PSClient.get()
        return self.ps

    def _ps_put(self, h, tokens, payload):
        """Park a payload in the cold store (versioned, so a fetch can
        refuse an entry someone overwrote).  Any failure — chaos kill,
        transport death — takes the whole PS rung down rather than
        retrying into it: degrade once, degrade honestly."""
        if not self.ps_tier or self.ps_dead:
            return False
        if self._chaos_kill("kvtier.ps_put"):
            return False
        self._ps_version += 1
        version = self._ps_version
        try:
            self._ps_client().kv_put(PS_NAMESPACE + h, payload, version)
        except Exception as err:  # noqa: BLE001 — any transport death
            self.kill_ps(reason=f"kv_put: {type(err).__name__}")
            return False
        self._ps_index[h] = (tuple(tokens), int(payload["length"]),
                             int(payload["nbytes"]), version)
        return True

    def kill_ps(self, reason="killed"):
        """The PS rung is gone: every cold residency takes its terminal
        drop (unreachable warmth is not warmth) and future spills stop
        at the host ring — beyond it, today's drop-on-evict.  Zero
        request loss by construction: a tier miss is a cold prefill."""
        with self._mu:
            if self.ps_dead:
                return
            self.ps_dead = True
            for h, (toks, _l, _n, _v) in list(self._ps_index.items()):
                del self._ps_index[h]
                self._drop(h, toks, "ps", "ps_killed")
        telemetry.emit("kvtier_ps_killed", _stream="failure",
                       reason=reason)
        flight.RECORDER.dump("kvtier_ps_killed", detail=reason)

    # ------------------------------------------------------------- #
    # chaos seams (role "kvtier")
    # ------------------------------------------------------------- #

    def _chaos_kill(self, method):
        plan = faults.plan_from_env()
        if plan is None:
            return False
        f = plan.draw(method=method, kinds=("kill",), role="kvtier",
                      inline=True)
        if f is not None and f.kind == "kill":
            self.kill_ps(reason=f"chaos at {method}")
            return True
        return False

    def _chaos_corrupt(self, method):
        plan = faults.plan_from_env()
        if plan is None:
            return False
        f = plan.draw(method=method, kinds=("drop", "reset"),
                      role="kvtier", inline=True)
        return f is not None

    # ------------------------------------------------------------- #

    def close(self, reason="shutdown"):
        """Retire the store: every still-resident entry takes its
        terminal drop so a COMPLETED run's spill/fetch ledger balances
        (the tier-balance trace rule treats an open residency at end
        of stream as a violation).  PS blobs are best-effort deleted."""
        with self._mu:
            for h in list(self._ring):
                e = self._ring.pop(h)
                self._ring_bytes -= e.nbytes
                self._drop(h, e.tokens, "host", reason)
            for h, (toks, _l, _n, _v) in list(self._ps_index.items()):
                del self._ps_index[h]
                if not self.ps_dead:
                    try:
                        self._ps_client().kv_del(PS_NAMESPACE + h)
                    except Exception:  # noqa: BLE001
                        pass
                self._drop(h, toks, "ps", reason)

    def _event(self, kind, **fields):
        telemetry.emit(kind, _stream="serve", **fields)

    def stats(self):
        """JSON-able ladder view (router snapshot / bench rows)."""
        with self._mu:
            return self._stats()

    def _stats(self):
        return {
            "enabled": self.enabled,
            "host_bytes": self.host_bytes,
            "host_used_bytes": self._ring_bytes,
            "host_entries": len(self._ring),
            "ps_tier": self.ps_tier,
            "ps_dead": self.ps_dead,
            "ps_entries": len(self._ps_index),
            "spills": dict(self.spills),
            "fetches": dict(self.fetches),
            "drops": dict(self.drops),
            "refreshes": self.refreshes,
            "demotes": self.demotes,
            "corruptions": self.corruptions,
            "spill_rejects": self.spill_rejects,
            "import_failed": self.import_failed,
            "lookup_hits": self.lookup_hits,
            "lookup_misses": self.lookup_misses,
            "spill_bytes": self.spill_bytes,
            "fetch_bytes": self.fetch_bytes,
        }
