"""Fleet-wide prefix-cache directory: WHO holds WHICH prompt prefix.

A router that is only session-affine by hash — it keeps one session's warm
blocks on one replica but has no idea which replica actually holds
which prefix, so N tenants sharing a system prompt prefill it once PER
REPLICA.  ``PrefixDirectory`` closes that gap: a fleet-shared map of
prefix-hash → {replica: last-use} fed by each replica's refcounted
prefix table (``PagedKVManager.register_prefix`` fires
``on_prefix_register``/``on_prefix_evict`` callbacks the directory
wires at :meth:`attach`).  The router consults :meth:`lookup` BEFORE
the affinity hash — a request whose prompt prefix is resident on
replica R routes to R (a *directory hit*) and reuses the blocks
instead of recomputing them.

Entries are HINTS, never truth: the replica's own token-verified
``match_prefix`` is still the only thing that attaches KV, so a stale
hit (replica restarted, prefix LRU-evicted a microsecond ago, TTL
expired) degrades to a normal cold admission — never an error.
Killing the directory outright (chaos role "directory") degrades the
whole fleet to exact session-affinity behavior.  Counters:

- ``hits``    — placed on the replica the directory suggested
- ``misses``  — no entry covered the prompt
- ``stale``   — only TTL-expired entries covered it (skipped)
- ``steals``  — the directory knew a holder but placement landed
  elsewhere (holder dead/breaker-open/full); the prefix is recomputed
  and re-registered at the new home — "stolen"

Hit/steal are stamped by the router at placement time (only it knows
where the request actually landed); miss/stale are counted here.

The map is shared mutable state: replica callbacks (register/evict)
and the router's lookup can run on different threads once engines
step concurrently, and ``lookup``/``drop_replica`` iterate dicts the
callbacks mutate.  One ``locks.TracedLock`` guards every entry-table
touch; ``_drop_replica`` is the caller-holds-the-lock internal
(attach reuses it under the same acquisition).
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from .. import envvars, locks


def prefix_hash(tokens):
    """Stable 64-bit digest of a token prefix (hex).  Collisions are
    harmless — the replica's ``match_prefix`` verifies tokens before
    attaching anything — so 64 bits is plenty for a routing hint."""
    arr = np.asarray([int(t) for t in tokens], np.int64)
    return hashlib.blake2b(arr.tobytes(), digest_size=8).hexdigest()


class _DirEntry:
    """One known prefix: its length/block span (for introspection),
    the replicas holding it with per-replica last-use stamps, and the
    tier column — which rung of the tiered store (serving/kv_tiers.py)
    holds a spilled copy ("host"/"ps"; None = HBM-resident or gone)."""

    __slots__ = ("length", "blocks", "refs", "replicas", "tier")

    def __init__(self, length, blocks):
        self.length = length
        self.blocks = blocks
        self.refs = 0                    # lifetime registrations
        self.replicas = {}               # replica index -> last-use t
        self.tier = None                 # "host" / "ps" / None


class PrefixDirectory:
    """The fleet map.  ``ttl`` seconds bound how long an un-refreshed
    entry stays routable (``$HETU_DIRECTORY_TTL``; 0 = hints never
    expire — the token-verified degradation path still catches every
    lie, TTL just caps how often it has to)."""

    def __init__(self, *, ttl=None, now=None):
        if ttl is None:
            ttl = envvars.get_float("HETU_DIRECTORY_TTL")
        self.ttl = float(ttl or 0.0)
        self._now = now or time.perf_counter
        self._mu = locks.TracedLock("prefix.dir")
        self._entries = {}               # hash -> _DirEntry
        self._block = None               # fleet block size (from attach)
        self.hits = 0
        self.misses = 0
        self.stale = 0
        self.steals = 0
        self.registrations = 0
        self.evictions = 0
        # tiered KV: the router flips ``tiered`` when a
        # TieredKVStore is wired — evictions then DEMOTE entries whose
        # spilled copy is tier-resident instead of deleting them, so
        # lookup keeps answering "warm somewhere"; with tiering off the
        # delete semantics are exactly as before
        self.tiered = False
        self.demotions = 0
        self.tier_hits = 0

    # ------------------------------------------------------------- #
    # replica feed
    # ------------------------------------------------------------- #

    def attach(self, replica, kv):
        """Wire a replica's paged manager into the directory.  Called
        on every (re)start: a respawned replica's old entries are
        dropped first — its fresh pool holds nothing.  A contiguous or
        non-sharing manager attaches as a no-op (the fleet then simply
        never produces directory hits for that replica)."""
        with self._mu:
            self._drop_replica(replica)
        if not getattr(kv, "prefix_share", False):
            return
        block = getattr(kv, "block", None)
        if block is None:
            return
        self._block = int(block)
        kv.on_prefix_register = \
            lambda toks, e, _r=replica: self.register(_r, toks, e)
        kv.on_prefix_evict = \
            lambda toks, _r=replica: self.evict(_r, toks)

    def register(self, replica, tokens, entry=None):
        """Record that ``replica`` now holds the prefix ``tokens``
        (or refresh its last-use stamp)."""
        h = prefix_hash(tokens)
        with self._mu:
            e = self._entries.get(h)
            if e is None:
                blocks = len(entry.blocks) if entry is not None else 0
                e = self._entries[h] = _DirEntry(len(tokens), blocks)
            e.refs += 1
            e.replicas[replica] = self._now()
            self.registrations += 1

    def evict(self, replica, tokens):
        """Drop ``replica``'s claim on ``tokens`` (LRU eviction on the
        replica).  With tiering off the entry dies with its last holder
        (delete semantics, exactly as before); with tiering on, an
        entry whose spilled copy is tier-resident DEMOTES instead —
        the tier column keeps it routable until the tier fetch/drop
        clears it."""
        h = prefix_hash(tokens)
        with self._mu:
            e = self._entries.get(h)
            if e is None:
                return
            e.replicas.pop(replica, None)
            if not e.replicas:
                if self.tiered and e.tier is not None:
                    self.demotions += 1
                else:
                    del self._entries[h]
            self.evictions += 1

    def set_tier(self, tokens, tier):
        """Stamp the tier column: a spilled copy of this prefix now
        lives in ``tier``.  Creates the entry when eviction already
        deleted it — spill and evict race by a callback ordering the
        directory must not depend on."""
        h = prefix_hash(tokens)
        with self._mu:
            e = self._entries.get(h)
            if e is None:
                e = self._entries[h] = _DirEntry(len(tokens), 0)
            e.tier = tier

    def clear_tier(self, tokens):
        """Drop the tier stamp (the copy was fetched back up or tier-
        dropped); the entry dies when no replica claims it either —
        delete semantics resume once nothing holds the prefix
        anywhere."""
        h = prefix_hash(tokens)
        with self._mu:
            e = self._entries.get(h)
            if e is None:
                return
            e.tier = None
            if not e.replicas:
                del self._entries[h]

    def known(self, tokens):
        """True when ANY replica currently claims this exact prefix.
        The elastic-fleet warm/export paths use it to move only
        prefixes the directory can actually route — a prefix no entry
        names attracts no directed traffic, so its blocks are not
        worth the wire bytes."""
        with self._mu:
            return prefix_hash(tokens) in self._entries

    def drop_replica(self, replica):
        """Purge every entry naming ``replica`` (death/respawn) —
        except tier-demoted ones: a spilled copy outlives the replica
        that spilled it (that is the point of the tier ladder)."""
        with self._mu:
            self._drop_replica(replica)

    def _drop_replica(self, replica):
        # caller holds self._mu (attach purges under its acquisition)
        dead = []
        for h, e in self._entries.items():
            e.replicas.pop(replica, None)
            if not e.replicas and not (self.tiered
                                       and e.tier is not None):
                dead.append(h)
        for h in dead:
            del self._entries[h]

    # ------------------------------------------------------------- #
    # routing consult
    # ------------------------------------------------------------- #

    def _expired(self, stamp, now):
        return self.ttl > 0 and (now - stamp) > self.ttl

    def lookup(self, prompt, now=None):
        """Longest block-aligned registered prefix of ``prompt``.
        Probes block-boundary cuts longest-first (registrations are
        keyed there, and the usable share is capped below the last
        prompt position anyway); of several holders the most recently
        used wins.  Returns ``(hint, outcome)``: ``hint`` is
        ``(replica, cached_len)`` or None; ``outcome`` is None when a
        fresh holder was found (the router stamps hit/steal once it
        knows where placement landed), "tier" when NO replica holds the
        cut but a spilled copy is tier-resident (``hint`` is then
        ``(None, cached_len)`` — warm somewhere, fetched at engine
        admission), else "miss" (nothing known) or "stale" (only
        TTL-expired claims) — all but hit/steal counted here."""
        with self._mu:
            if self._block is None or len(prompt) < 2:
                self.misses += 1
                return None, "miss"
            now = self._now() if now is None else now
            p = [int(t) for t in prompt]
            top = ((len(p) - 1) // self._block) * self._block
            saw_stale = False
            for n in range(top, 0, -self._block):
                e = self._entries.get(prefix_hash(p[:n]))
                if e is None:
                    continue
                fresh = {r: ts for r, ts in e.replicas.items()
                         if not self._expired(ts, now)}
                if fresh:
                    return (max(fresh, key=fresh.get), n), None
                if e.tier is not None:
                    # no pool holds this cut but the tier ladder
                    # does: route normally — the landing replica's
                    # admission fetch re-imports the span (tier
                    # column = "warm somewhere", not "warm at")
                    self.tier_hits += 1
                    return (None, n), "tier"
                saw_stale = True
            if saw_stale:
                self.stale += 1
                return None, "stale"
            self.misses += 1
            return None, "miss"

    # ------------------------------------------------------------- #

    @property
    def lookups(self):
        return self.hits + self.misses + self.stale + self.steals

    @property
    def hit_rate(self):
        return self.hits / max(1, self.lookups)

    def snapshot(self):
        """JSON-able directory view (router snapshot / hetu_top)."""
        with self._mu:
            return self._snapshot()

    def _snapshot(self):
        return {
            "entries": len(self._entries),
            "ttl": self.ttl,
            "hits": self.hits,
            "misses": self.misses,
            "stale": self.stale,
            "steals": self.steals,
            "hit_rate": round(self.hit_rate, 4),
            "registrations": self.registrations,
            "evictions": self.evictions,
            "tiered": self.tiered,
            "tier_entries": sum(1 for e in self._entries.values()
                                if e.tier is not None),
            "tier_hits": self.tier_hits,
            "demotions": self.demotions,
        }
