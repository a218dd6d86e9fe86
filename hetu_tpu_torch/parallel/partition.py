"""Pipeline graph partitioner: split a built forward graph into stages,
the port of the JAX package's ``parallel/partition.py``.

Two levels, as there:

1. **Cut points.**  Walk the topo order of the loss graph tracking the set
   of live compute values (produced before, consumed after).  A position
   where exactly ONE value is live is a legal pipeline cut: one activation
   crosses the boundary.

2. **Uniform body detection.**  Blocks between consecutive cuts are
   fingerprinted (op types + op attrs + param shapes/trainability, in topo
   order).  The longest run of identical, *closed* blocks (no reads of
   another block's placeholders, no feed inputs) is the pipeline body,
   for a transformer the N identical layers.  Everything before is `pre`
   (embedding), everything after is `post` (head + loss): they run outside
   the pipeline's stages, once per microbatch.

The port's nodes carry torch functions, tensors and generators where the
JAX package's carry jax ones: the fingerprint reads them so that it tells
apart exactly what JAX's does (a torch tensor constant by its bytes, a
dtype by its name, a generator by its type).  The pipeline executor
(``pipeline_executor.py``) runs a plan with a uniform body on its stage
path; graphs without one take the microbatch path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import hashlib

import numpy as np
import torch

from ..graph.autodiff import find_topo_sort
from ..graph.node import Op
from ..graph.ops_misc import PlaceholderOp


# attributes that never affect a node's math
_SKIP_ATTRS = frozenset({
    "inputs", "name", "id", "raw_ctx", "dtype",
})


def _simple(v):
    return isinstance(v, (int, float, bool, str, type(None), torch.dtype))


def _array_digest(v):
    """Content digest for array-valued statics (closure constants like
    lookup tables or assignment masks): numpy arrays and torch tensors
    alike.  Without this, two layers that differ only in a constant
    array would fingerprint equal and the stage path would be handed a
    body that is not uniform."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu").contiguous()
        shape, dtype = tuple(t.shape), str(t.dtype)
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
    else:
        a = np.ascontiguousarray(np.asarray(v))
        shape, dtype, raw = a.shape, str(a.dtype), a.tobytes()
    return ("array", shape, dtype,
            hashlib.blake2b(raw, digest_size=8).hexdigest())


def _callable_fingerprint(f):
    """SimpleOp wraps a closure: its identity (which factory built it) and
    the closed-over statics (slice indices, reshape targets, axes) are the
    op's math.  Without this, Slice and Reshape nodes are
    indistinguishable and two different blocks would pass for one
    body."""
    items = [getattr(f, "__qualname__", repr(f))]
    for cell in (getattr(f, "__closure__", None) or ()):
        try:
            v = cell.cell_contents
        except ValueError:
            continue
        if _simple(v):
            items.append(v)
        elif isinstance(v, Op):
            items.append(("op", type(v).__name__))
        elif isinstance(v, (tuple, list)) and all(_simple(e) for e in v):
            items.append(tuple(v))
        elif hasattr(v, "shape") and hasattr(v, "dtype"):
            items.append(_array_digest(v))
        elif callable(v):
            items.append(getattr(v, "__qualname__", "fn"))
        else:
            # unknown static: include its type so at least differently-
            # typed closures never collide
            items.append(("opaque", type(v).__name__))
    return tuple(items)


def _attr_fingerprint(node):
    """Hashable digest of a node's math-relevant static attributes."""
    items = []
    for k in sorted(vars(node)):
        if k in _SKIP_ATTRS:
            continue
        v = vars(node)[k]
        if _simple(v):
            items.append((k, v))
        elif isinstance(v, Op):
            items.append((k, ("op", type(v).__name__)))
        elif isinstance(v, (tuple, list)):
            if all(_simple(e) for e in v):
                items.append((k, tuple(v)))
            else:
                items.append((k, len(v)))
        elif hasattr(v, "shape") and hasattr(v, "dtype"):
            items.append((k, _array_digest(v)))
        elif isinstance(v, torch.Generator):
            items.append((k, "generator"))
        elif callable(v):
            items.append((k, _callable_fingerprint(v)))
    return tuple(items)


@dataclass
class Block:
    """A contiguous topo slice between two cuts."""
    nodes: list                    # topo slice (placeholders included)
    boundary_out: object           # the single live node at the exit cut
    params: list = field(default_factory=list)    # variable placeholders
    feeds: list = field(default_factory=list)     # non-variable placeholders
    closed: bool = True            # no external non-boundary inputs

    def signature(self):
        sig = []
        for n in self.nodes:
            if isinstance(n, PlaceholderOp):
                sig.append(("var" if n.is_variable else "feed",
                            tuple(n.shape) if n.shape else None,
                            getattr(n, "trainable", False)))
            else:
                sig.append((type(n).__name__, _attr_fingerprint(n)))
        return tuple(sig)


@dataclass
class PipelinePlan:
    """Partition of a loss graph for pipelining.

    ``body_blocks`` is non-empty iff a uniform body was found:
    R = len(body_blocks) identical blocks, groupable into S stages of
    R/S blocks each.  ``pre_nodes``/``post_nodes`` run outside the loop.
    """
    loss: object
    blocks: list                       # every block, in order
    pre_nodes: list
    body_blocks: list                  # uniform run (possibly empty)
    post_nodes: list
    body_entry: object                 # node whose value enters block 0
    # per-block param placeholders, positionally aligned across blocks
    body_params: list
    pre_params: list
    post_params: list
    pre_feeds: list
    post_feeds: list

    @property
    def uniform(self):
        return len(self.body_blocks) > 0

    def num_body_blocks(self):
        return len(self.body_blocks)


def find_cuts(topo):
    """Positions i where exactly one compute value is live after topo[i].

    Returns [(i, boundary_node)], deduped to the EARLIEST position per
    boundary, so trailing placeholders (the next layer's weights in DFS
    order) land in the block that consumes them."""
    pos = {id(n): i for i, n in enumerate(topo)}
    last_use = {}
    for n in topo:
        for inp in n.inputs:
            last_use[id(inp)] = max(last_use.get(id(inp), -1), pos[id(n)])
    live = {}          # id -> node, compute values only
    cuts = []
    for i, n in enumerate(topo):
        for inp in n.inputs:
            if last_use.get(id(inp), -1) == i:
                live.pop(id(inp), None)
        if not isinstance(n, PlaceholderOp) and last_use.get(id(n), -1) > i:
            live[id(n)] = n
        if len(live) == 1 and i < len(topo) - 1:
            (b,) = live.values()
            if not (cuts and cuts[-1][1] is b):
                cuts.append((i, b))
    return cuts


def _make_blocks(topo, cuts):
    # Cross-block references to compute values other than the incoming
    # boundary are impossible (they would make the intervening cuts have
    # two live values), so `closed` only tracks references to OTHER
    # blocks' placeholders (shared weights / global feeds) — those break
    # positional param stacking.
    blocks = []
    start = 0
    bounds = cuts + [(len(topo) - 1, topo[-1])]
    for (end, boundary) in bounds:
        nodes = topo[start:end + 1]
        blk = Block(nodes=nodes, boundary_out=boundary)
        inner = {id(n) for n in nodes}
        for n in nodes:
            if isinstance(n, PlaceholderOp):
                (blk.params if n.is_variable else blk.feeds).append(n)
            else:
                for inp in n.inputs:
                    if isinstance(inp, PlaceholderOp) and \
                            id(inp) not in inner:
                        blk.closed = False
        blocks.append(blk)
        start = end + 1
    return blocks


def _merge_blocks(blocks):
    out = Block(nodes=[n for b in blocks for n in b.nodes],
                boundary_out=blocks[-1].boundary_out)
    for b in blocks:
        out.params.extend(b.params)
        out.feeds.extend(b.feeds)
        out.closed = out.closed and b.closed
    return out


def _find_periodic_body(blocks, min_units):
    """Longest periodic run of blocks: sig[j] == sig[j - p] over a
    stretch, every block closed and feed-free.  A period p > 1 is a layer
    that the cut detector split into several blocks (e.g. a transformer
    layer = attn-residual / LN / FFN-residual / LN).  Returns
    (start_block, units, period) for the best (max block coverage, then
    smallest period) run with >= min_units complete periods."""
    sigs = [b.signature() for b in blocks]
    ok = [b.closed and not b.feeds for b in blocks]
    n = len(blocks)
    best = None        # (coverage, -p, start, units, p)
    # block 0 can never be in the body (no entry boundary)
    for p in range(1, (n - 1) // max(min_units, 2) + 1):
        for i in range(1, n - p + 1):
            if not all(ok[i:i + p]):
                continue
            e = i + p
            while e < n and ok[e] and sigs[e] == sigs[e - p]:
                e += 1
            units = (e - i) // p
            if units >= min_units:
                cand = (units * p, -p, i, units, p)
                if best is None or cand > best:
                    best = cand
    if best is None:
        return None
    return best[2], best[3], best[4]


def partition(loss, num_stages):
    """Build a PipelinePlan for ``loss`` targeting ``num_stages`` stages.

    Always succeeds; ``plan.uniform`` says whether the stage path is
    available (R body blocks, R >= num_stages, R % S == 0 after trimming
    extra leading blocks into ``pre``)."""
    topo = find_topo_sort([loss])
    cuts = find_cuts(topo)
    blocks = _make_blocks(topo, cuts)

    body = dict(body_blocks=[], body_entry=None, body_params=[])
    run = _find_periodic_body(blocks, max(num_stages, 2)) \
        if num_stages > 1 else None
    if run is not None:
        start, units, p = run
        usable = (units // num_stages) * num_stages
        start += (units - usable) * p      # trim extra units into pre
        merged = [_merge_blocks(blocks[start + u * p:start + (u + 1) * p])
                  for u in range(usable)]
        # the blocks' params align positionally: the shared periodic
        # signature fixes their shapes in topo order within each unit
        body = dict(
            body_blocks=merged,
            body_entry=blocks[start - 1].boundary_out,
            body_params=[b.params for b in merged],
        )
        pre_blocks = blocks[:start]
        post_blocks = blocks[start + usable * p:]
    else:
        pre_blocks, post_blocks = blocks, []

    pre_nodes = [n for b in pre_blocks for n in b.nodes]
    post_nodes = [n for b in post_blocks for n in b.nodes]

    def vars_of(nodes):
        return [n for n in nodes
                if isinstance(n, PlaceholderOp) and n.is_variable]

    def feeds_of(nodes):
        return [n for n in nodes
                if isinstance(n, PlaceholderOp) and not n.is_variable]

    return PipelinePlan(
        loss=loss, blocks=blocks,
        pre_nodes=pre_nodes, post_nodes=post_nodes,
        pre_params=vars_of(pre_nodes), post_params=vars_of(post_nodes),
        pre_feeds=feeds_of(pre_nodes), post_feeds=feeds_of(post_nodes),
        **body)
