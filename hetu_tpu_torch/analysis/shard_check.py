"""Static parallelism checker: graph + mesh + plan, validated before any
device work, the port of the JAX package's ``analysis/shard_check.py``.

- :func:`check_mesh_axes`: every comm op (``graph/ops_comm.py``)
  references an axis of the mesh (either kind, ``parallel/mesh.py``).
- :func:`check_divisibility`: parameter sharding specs and batch feeds
  divide evenly over their mesh axes.
- :func:`check_pipeline_stages`: the pipeline partitioner's stage plan is
  sound for the requested stage count.
- :func:`check_stage_assignment`: explicit per-node stage maps are
  contiguous and monotone, with cross-stage edges only through the
  pipeline comm ops.
- :func:`check_collective_order_static`: per-group collective sequences
  agree.
- :func:`check_expert_mesh` / :func:`check_expert_alltoall`: MoE
  expert-parallel placement and dispatch/combine all-to-all pairing.
- :func:`check_tp_mesh`: a tensor-parallel serving placement's axis
  and head divisibility.
- :func:`check_quantized_collectives`: every quantized collective is a
  complete, axis-consistent quantize -> collective -> dequantize trio.

:func:`check_parallelism` runs every check that applies.  Hard
violations raise :class:`ShardCheckError` (``analysis.integration``'s);
advisory ones come back as findings dicts.  The verdicts, ``kind`` s and
messages are JAX's.
"""

from __future__ import annotations

from ..graph.node import Op
from ..graph.ops_comm import (CollectiveOp, DequantizeCommOp,
                              PipelineReceiveOp, PipelineSendOp,
                              QuantAllReduceCommunicateOp, QuantizeCommOp)
from ..graph.ops_misc import PlaceholderOp
from ..parallel.mesh import axis_names, mesh_shape
from .integration import ShardCheckError


# --------------------------------------------------------------------- #
# MoE expert-parallel placement (Synthesizing Optimal
# Parallelism Placement — PAPERS.md — grounds the layout choices)
# --------------------------------------------------------------------- #

def check_expert_mesh(mesh, num_experts, axis="ep"):
    """Validate an expert-parallel placement BEFORE any device_put or
    compile: the expert ``axis`` must exist in ``mesh`` and
    ``num_experts`` must divide evenly across it (each shard owns
    E/size whole experts — a ragged split would misalign every
    dispatch/combine all-to-all block).  Raises
    ShardCheckError(kind='expert_mesh'); returns the axis size."""
    if mesh is None:
        raise ShardCheckError(
            "expert-parallel placement needs a mesh (got None)",
            kind="expert_mesh")
    names = axis_names(mesh)
    if axis not in names:
        raise ShardCheckError(
            f"expert mesh axis {axis!r} absent from mesh axes {names} "
            f"— the expert stacks would silently replicate and the "
            f"dispatch all-to-all would no-op", kind="expert_mesh")
    size = mesh_shape(mesh)[axis]
    if num_experts % size != 0:
        raise ShardCheckError(
            f"num_experts={num_experts} is not divisible by expert "
            f"mesh axis {axis!r} (size {size}) — each shard must own "
            f"E/size whole experts for the a2a block layout to hold",
            kind="expert_mesh")
    return size


def check_tp_mesh(mesh, num_heads, axis="tp"):
    """Validate a tensor-parallel serving placement BEFORE any tensor
    is placed: the ``axis`` must exist in ``mesh`` and ``num_heads``
    must divide over it (the column split of q/k/v has to land on head
    boundaries, each rank attending with its H/size whole heads).
    Raises ValueError, as JAX's ``tp_shard_params``; returns the axis
    size."""
    names = axis_names(mesh)
    if axis not in names:
        raise ValueError(
            f"tensor-parallel mesh axis {axis!r} absent from mesh axes "
            f"{names}")
    size = mesh_shape(mesh)[axis]
    if num_heads % size:
        raise ValueError(
            f"num_attention_heads={num_heads} not divisible by "
            f"{axis}={size}: the column split must land on head "
            f"boundaries")
    return size


def check_expert_alltoall(eval_nodes):
    """Expert dispatch/combine all-to-all pairing — the quant-pair
    analog for MoE graphs (``layers/moe.py`` emits
    LayoutTransform → a2a → expert FFN → a2a → ReverseLayoutTransform):

    - every capacity dispatch (``LayoutTransformOp``) must reach a
      weighted combine (a ``ReverseLayoutTransform*`` descendant) —
      an uncombined dispatch leaves expert-major capacity buffers in
      the graph exactly like a quantize without its dequantize;
    - every combine must descend from a dispatch (its
      indices/locations are meaningless otherwise);
    - the exchanges BETWEEN a dispatch and its combine must come in
      matched pairs (dispatch-side + return-side) — an odd count ends
      the combine on the wrong device's rows;
    - all exchanges in one dispatch↔combine span agree on the axis.

    Raises ShardCheckError(kind='a2a_pair'); returns the
    (dispatch, [a2a...], combine) spans found."""
    from ..graph.ops_moe import (AllToAllOp, HAllToAllOp,
                                 LayoutTransformOp)
    topo = _topo_of(eval_nodes)
    anc = {}
    for n in topo:
        s = set()
        for i in n.inputs:
            s.add(id(i))
            s |= anc.get(id(i), set())
        anc[id(n)] = s

    def _axes(n):
        return (tuple(n.axes) if isinstance(n, HAllToAllOp)
                else (n.axis,))

    a2a = [n for n in topo if isinstance(n, (AllToAllOp, HAllToAllOp))]
    disp = [n for n in topo if isinstance(n, LayoutTransformOp)]
    comb = [n for n in topo
            if type(n).__name__.startswith("ReverseLayoutTransform")
            and "Gradient" not in type(n).__name__]
    spans = []
    for d in disp:
        outs = [c for c in comb if id(d) in anc[id(c)]]
        if not outs:
            raise ShardCheckError(
                f"expert dispatch {d.name} has no paired "
                f"ReverseLayoutTransform combine downstream — the "
                f"capacity buffers never return to token order (the "
                f"a2a analog of a quantize without its dequantize)",
                node=d, kind="a2a_pair")
        for c in outs:
            between = [a for a in a2a
                       if id(d) in anc[id(a)] and id(a) in anc[id(c)]]
            if len(between) % 2 != 0:
                raise ShardCheckError(
                    f"expert dispatch {d.name} -> combine {c.name} "
                    f"crosses {len(between)} all-to-all exchange(s) — "
                    f"exchanges must pair (dispatch-side + "
                    f"return-side); an odd chain combines another "
                    f"device's expert rows", node=c, kind="a2a_pair")
            ax = {_axes(a) for a in between}
            if len(ax) > 1:
                raise ShardCheckError(
                    f"expert dispatch {d.name} -> combine {c.name} "
                    f"mixes all-to-all axes {sorted(ax)} — the return "
                    f"exchange must undo the dispatch exchange on the "
                    f"SAME axis", node=c, kind="a2a_pair")
            spans.append((d, between, c))
    for c in comb:
        if not any(id(d) in anc[id(c)] for d in disp):
            raise ShardCheckError(
                f"expert combine {c.name} has no dispatch ancestor — "
                f"its indices/locations never routed these rows",
                node=c, kind="a2a_pair")
    return spans


# --------------------------------------------------------------------- #
# quantized-collective pairing ($HETU_COMM_QUANT trios)
# --------------------------------------------------------------------- #

def check_quantized_collectives(eval_nodes):
    """Every quantized collective must be a complete, axis-consistent
    quantize -> collective -> dequantize trio (``graph/ops_comm``):

    - a ``QuantizeCommOp``'s output feeds ONLY quantized collectives (its
      (int8, scales) pair means nothing to any other consumer, and a
      quantize whose pair never crosses a collective and a dequantize
      would hand int8 payloads downstream);
    - a ``QuantAllReduceCommunicateOp`` takes exactly a quantize and
      feeds only dequantizes;
    - a ``DequantizeCommOp`` decodes exactly a quantized collective;
    - all three agree on the mesh axis.

    Raises ShardCheckError(kind='quant_pair'); returns the trios found
    as [(quantize, collective, dequantize), ...]."""
    topo = _topo_of(eval_nodes)
    consumers = {}
    for n in topo:
        for i in n.inputs:
            consumers.setdefault(id(i), []).append(n)
    trios = []
    for n in topo:
        if isinstance(n, QuantizeCommOp):
            cons = consumers.get(id(n), [])
            bad = [c for c in cons
                   if not isinstance(c, QuantAllReduceCommunicateOp)]
            if bad or not cons:
                raise ShardCheckError(
                    f"quantize {n.name} has no paired dequantize across "
                    f"a quantized collective: consumed by "
                    f"{[c.name for c in bad] or 'nothing'} — emit the "
                    f"trio via quantized_allreduce_op (the (int8, "
                    f"scales) pair must cross a "
                    f"QuantAllReduceCommunicateOp into a "
                    f"DequantizeCommOp)", node=n, kind="quant_pair")
        elif isinstance(n, QuantAllReduceCommunicateOp):
            src = n.inputs[0]
            if not isinstance(src, QuantizeCommOp):
                raise ShardCheckError(
                    f"quantized collective {n.name} consumes "
                    f"{src.name} ({type(src).__name__}), not a "
                    f"QuantizeCommOp — all_gathering raw f32 through "
                    f"the quantized pair moves full-width bytes and "
                    f"breaks the dequantize contract", node=n,
                    kind="quant_pair")
            cons = consumers.get(id(n), [])
            deqs = [c for c in cons if isinstance(c, DequantizeCommOp)]
            if not deqs or len(deqs) != len(cons):
                others = [c.name for c in cons
                          if not isinstance(c, DequantizeCommOp)]
                raise ShardCheckError(
                    f"quantized collective {n.name} (axis {n.axis!r}) "
                    f"has no paired DequantizeCommOp"
                    + (f"; consumed by {others}" if others else "")
                    + " — a quantize without its dequantize across the "
                    "collective leaves int8 payloads in the graph",
                    node=n, kind="quant_pair")
            for d in deqs + [src]:
                if getattr(d, "axis", n.axis) != n.axis:
                    raise ShardCheckError(
                        f"quantized trio disagrees on the mesh axis: "
                        f"{src.name}/{n.name}/{[x.name for x in deqs]} "
                        f"mix {d.axis!r} and {n.axis!r}", node=n,
                        kind="quant_pair")
            for d in deqs:
                trios.append((src, n, d))
        elif isinstance(n, DequantizeCommOp):
            src = n.inputs[0]
            if not isinstance(src, QuantAllReduceCommunicateOp):
                raise ShardCheckError(
                    f"dequantize {n.name} consumes {src.name} "
                    f"({type(src).__name__}), not a quantized "
                    f"collective — the pair must cross the collective",
                    node=n, kind="quant_pair")
    return trios


def _comm_nodes(topo):
    return [n for n in topo
            if isinstance(n, (CollectiveOp, PipelineSendOp,
                              PipelineReceiveOp))]


def _topo_of(eval_nodes):
    from ..graph.autodiff import find_topo_sort
    return find_topo_sort([n for n in eval_nodes if n is not None])


# --------------------------------------------------------------------- #
# mesh-axis existence
# --------------------------------------------------------------------- #

def check_mesh_axes(eval_nodes, mesh):
    """Every comm op's axis must name a mesh axis.  In the per-rank view
    a missing axis fails deep in a run; in the whole-value view it makes
    the op silently a no-op — either way the plan is wrong.  Skipped
    when there is no mesh (pure single-device jit: comm ops are
    documented identities there)."""
    if mesh is None:
        return []
    axes = set(axis_names(mesh))
    comm = _comm_nodes(_topo_of(eval_nodes))
    for n in comm:
        axis = getattr(n, "axis", None)
        if axis is not None and axis not in axes:
            raise ShardCheckError(
                f"comm op {n.name} ({type(n).__name__}) references mesh "
                f"axis {axis!r} but the mesh has axes "
                f"{axis_names(mesh)} — the collective would "
                f"silently no-op in the whole-value view and fail in the "
                f"per-rank view", node=n, kind="mesh_axis")
    return comm


# --------------------------------------------------------------------- #
# divisibility (dp/tp splits)
# --------------------------------------------------------------------- #

def check_divisibility(eval_nodes, mesh, feed_shapes=None):
    """Sharding specs must divide their dims; returns advisory findings
    for feeds that will silently fall back to replication.

    Hard errors: a variable's ``sharding_spec`` names a missing mesh
    axis, or shards a dim the axis size does not divide (GSPMD would
    reject the NamedSharding at placement — on-chip).  Advisory: a
    batch feed whose dim 0 the 'dp' axis does not divide (the executor
    silently replicates it, usually a misconfigured global batch)."""
    findings = []
    if mesh is None:
        return findings
    topo = _topo_of(eval_nodes)
    shape_by_axis = mesh_shape(mesh)
    for n in topo:
        if not isinstance(n, PlaceholderOp):
            continue
        spec = getattr(n, "sharding_spec", None)
        if spec is None or n.shape is None:
            continue
        for dim, entry in enumerate(tuple(spec)):
            if entry is None:
                continue
            for axis in (entry if isinstance(entry, (tuple, list))
                         else (entry,)):
                size = shape_by_axis.get(axis)
                if size is None:
                    raise ShardCheckError(
                        f"variable {n.name!r} sharding_spec {spec} "
                        f"names axis {axis!r} absent from mesh axes "
                        f"{axis_names(mesh)}", node=n,
                        kind="divisibility")
                if dim >= len(n.shape) or n.shape[dim] % size != 0:
                    dim_sz = n.shape[dim] if dim < len(n.shape) else None
                    raise ShardCheckError(
                        f"variable {n.name!r} dim {dim} (size {dim_sz}) "
                        f"is not divisible by mesh axis {axis!r} "
                        f"(size {size}) — sharding_spec {spec} cannot "
                        f"be placed", node=n, kind="divisibility")
    dp = shape_by_axis.get("dp")
    if dp and dp > 1:
        for name, shape in (feed_shapes or {}).items():
            if shape and len(shape) >= 1 and shape[0] % dp != 0:
                findings.append({
                    "kind": "feed_not_dp_divisible", "node": name,
                    "detail": f"batch dim {shape[0]} % dp {dp} != 0; "
                              f"the feed will be replicated, not "
                              f"sharded"})
    return findings


# --------------------------------------------------------------------- #
# pipeline stage plans
# --------------------------------------------------------------------- #

def check_pipeline_stages(loss, num_stages, mesh=None, pipeline=None):
    """Validate the pipeline partition of ``loss`` for ``num_stages``.

    Hard error: the graph has a uniform repeated body of R units but
    R % num_stages != 0 (uneven stages: the trimmed units silently pile
    into the 'pre' stage, skewing the balance the schedule assumes).
    Advisory finding: no uniform body at all (the executor falls back to
    the trajectory-equivalent microbatch-scan path — correct, but the
    'pp' mesh axis buys nothing)."""
    findings = []
    S = int(num_stages or (mesh_shape(mesh).get("pp", 1)
                           if mesh is not None else 1))
    if S <= 1:
        return findings
    from ..parallel.partition import (find_cuts, _find_periodic_body,
                                      _make_blocks)
    from ..graph.autodiff import find_topo_sort
    topo = find_topo_sort([loss])
    blocks = _make_blocks(topo, find_cuts(topo))
    run = _find_periodic_body(blocks, 2)
    if run is None:
        findings.append({
            "kind": "pipeline_no_uniform_body", "node": loss.name,
            "detail": f"no uniform repeated body found for "
                      f"{S}-stage pipelining; the microbatch-scan "
                      f"fallback will run without stage parallelism"})
        return findings
    _, units, _ = run
    if units < S:
        raise ShardCheckError(
            f"pipeline plan for {loss.name!r}: only {units} uniform "
            f"body unit(s) for {S} stages — at least one stage would "
            f"be empty", node=loss, kind="pipeline")
    if units % S != 0:
        raise ShardCheckError(
            f"pipeline plan for {loss.name!r}: {units} uniform body "
            f"units do not split evenly over {S} stages "
            f"({units} % {S} = {units % S}) — the surplus layers would "
            f"silently fold into the pre-stage and unbalance the "
            f"schedule; use a layer count divisible by num_stages",
            node=loss, kind="pipeline")
    if pipeline not in (None, "gpipe", "1f1b", "pipedream", "hetpipe"):
        raise ShardCheckError(
            f"unknown pipeline mode {pipeline!r}", kind="pipeline")
    return findings


def check_stage_assignment(eval_nodes, stage_of, num_stages=None):
    """Validate an EXPLICIT node -> stage map (hand-written plans).

    - stage ids form a contiguous 0..S-1 range (no empty stages);
    - monotone: a consumer's stage >= every producer's stage
      (activations only flow forward);
    - cross-stage edges go ONLY through pipeline comm ops
      (PipelineSend/PipelineReceive) and advance exactly one stage —
      the reference's single-tensor boundary invariant.

    ``stage_of`` maps node or node-name -> int stage."""
    topo = _topo_of(eval_nodes)

    def stage(n):
        if n in stage_of:
            return stage_of[n]
        return stage_of.get(n.name)

    used = sorted({s for s in (stage(n) for n in topo) if s is not None})
    if not used:
        return []
    S = int(num_stages or (max(used) + 1))
    if used != list(range(S)):
        missing = sorted(set(range(S)) - set(used))
        raise ShardCheckError(
            f"stage assignment uses stages {used} of 0..{S - 1}: "
            f"stage(s) {missing} are empty — assignments must be "
            f"contiguous", kind="stage_assignment")
    for n in topo:
        s_n = stage(n)
        if s_n is None:
            continue
        for inp in n.inputs:
            s_i = stage(inp)
            if s_i is None or s_i == s_n:
                continue
            if s_i > s_n:
                raise ShardCheckError(
                    f"stage assignment is not monotone: {n.name} "
                    f"(stage {s_n}) consumes {inp.name} (stage {s_i}) "
                    f"— activations cannot flow backward",
                    node=n, kind="stage_assignment")
            is_comm = isinstance(n, (PipelineReceiveOp, PipelineSendOp)) \
                or isinstance(inp, (PipelineSendOp, PipelineReceiveOp))
            if not is_comm:
                raise ShardCheckError(
                    f"cross-stage edge {inp.name} (stage {s_i}) -> "
                    f"{n.name} (stage {s_n}) bypasses the pipeline comm "
                    f"ops — only PipelineSend/PipelineReceive may cross "
                    f"a stage boundary", node=n, kind="stage_assignment")
            if s_n - s_i != 1:
                raise ShardCheckError(
                    f"cross-stage edge {inp.name} -> {n.name} skips "
                    f"stages ({s_i} -> {s_n}) — pipeline transport is "
                    f"neighbor-to-neighbor", node=n,
                    kind="stage_assignment")
    return []


# --------------------------------------------------------------------- #
# static collective ordering
# --------------------------------------------------------------------- #

def collective_sequence(eval_nodes, axes=None):
    """The graph's comm-op sequence in topo order:
    [(op_class_name, axis), ...], optionally filtered to ``axes``.
    Under SPMD every device runs this same sequence — recording it makes
    divergence across separately-built per-stage/per-group programs
    checkable (:func:`check_collective_order_static`)."""
    seq = []
    for n in _comm_nodes(_topo_of(eval_nodes)):
        axis = getattr(n, "axis", None)
        if axes is None or axis in axes:
            seq.append((type(n).__name__, axis))
    return seq


def check_collective_order_static(group_sequences, axes=None):
    """Every mesh group must issue the SAME collective sequence, or the
    axis deadlocks (the static sibling of
    ``parallel.collective_check.check_collective_order``, for graphs
    built per group/stage rather than one per-rank program).

    ``group_sequences``: {group_name: sequence} where a sequence is
    either a node list (passed through :func:`collective_sequence`) or a
    pre-extracted [(op, axis), ...] list."""
    norm = {}
    for name, seq in group_sequences.items():
        if seq and isinstance(seq[0], Op):
            seq = collective_sequence(seq, axes=axes)
        elif axes is not None:
            seq = [(op, ax) for op, ax in seq if ax in axes]
        norm[name] = list(seq)
    names = list(norm)
    for other in names[1:]:
        if norm[other] != norm[names[0]]:
            raise ShardCheckError(
                f"collective sequences diverge across mesh groups: "
                f"{names[0]!r} issues {norm[names[0]] or 'none'} but "
                f"{other!r} issues {norm[other] or 'none'} — devices "
                f"disagreeing on the collective order deadlock the "
                f"axis", kind="collective_order")
    return norm[names[0]] if names else []


# --------------------------------------------------------------------- #
# umbrella
# --------------------------------------------------------------------- #

def check_parallelism(eval_nodes, mesh, config=None, feed_shapes=None):
    """Run every static parallelism check that applies to this graph +
    mesh + config.  Raises :class:`ShardCheckError` on hard violations;
    returns advisory findings."""
    eval_nodes = [n for n in eval_nodes if n is not None]
    findings = []
    check_mesh_axes(eval_nodes, mesh)
    check_quantized_collectives(eval_nodes)
    if mesh is not None:
        # the dispatch/combine pairing rule only bites under a parallel
        # mesh — a mesh-less executor may legitimately evaluate a bare
        # LayoutTransform (e.g. to inspect the capacity buffer directly)
        check_expert_alltoall(eval_nodes)
    findings += check_divisibility(eval_nodes, mesh,
                                   feed_shapes=feed_shapes)
    if config is not None and getattr(config, "pipeline", None):
        from ..graph.optim import OptimizerOp
        S = getattr(config, "num_stages", None) or (
            mesh_shape(mesh).get("pp", 1) if mesh is not None else 1)
        losses = [n for n in eval_nodes
                  if not isinstance(n, OptimizerOp)]
        has_opt = any(isinstance(n, OptimizerOp) for n in eval_nodes)
        if has_opt and len(losses) == 1 and S and S > 1:
            findings += check_pipeline_stages(
                losses[0], S, mesh=mesh,
                pipeline=getattr(config, "pipeline", None))
    return findings
