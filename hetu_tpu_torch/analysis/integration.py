"""The serving engine's build-time check (``HETU_VALIDATE=1``): params
against config before any cache allocation, as the JAX package's
``analysis/integration.py`` does, with the same error types, the same
``serving_verified`` / ``graph_verify_error`` records on the
``validate`` telemetry stream, and the same messages.  Default-on under
the repo's pytest configuration (``tests/conftest.py``)."""

from __future__ import annotations

from .. import envvars
from ..telemetry import events as _events


class GraphVerifyError(Exception):
    """A statically-detected defect.  ``node`` is the offending op (when
    one is attributable), ``kind`` the defect class: ``cycle``,
    ``duplicate_name``, ``shape``, ``rng_missing``."""

    def __init__(self, message, node=None, kind="shape"):
        super().__init__(message)
        self.node = node
        self.kind = kind


class ShardCheckError(Exception):
    """A statically-detected parallelism misconfiguration.  ``node`` is
    the offending op when attributable; ``kind`` one of ``mesh_axis``,
    ``divisibility``, ``pipeline``, ``stage_assignment``,
    ``collective_order``."""

    def __init__(self, message, node=None, kind="mesh_axis"):
        super().__init__(message)
        self.node = node
        self.kind = kind


def validation_enabled() -> bool:
    return envvars.get_bool("HETU_VALIDATE")


def make_record(event, **fields):
    """One contract-shaped record: {"t": ..., "event": event, **fields}."""
    return _events.make_record(event, **fields)


def emit_records(records, path=None):
    """Route records through the telemetry sink's ``validate`` stream.
    Best-effort: an unwritable log never takes down a build that
    validated fine."""
    if not records:
        return records
    return _events.get_sink().emit_prebuilt(records, stream="validate",
                                            path=path)


def validate_serving(params, config, name, mesh=None):
    """ServingEngine build hook: params/config consistency before any
    cache allocation or compile.  Uses the same error/record contract
    as the graph path."""
    if not validation_enabled():
        return None
    records = []
    try:
        H = int(config.hidden_size)
        heads = int(config.num_attention_heads)
        if H % heads != 0:
            raise ShardCheckError(
                f"serving config: hidden_size {H} is not divisible by "
                f"num_attention_heads {heads}", kind="divisibility")
        wte = params.get(f"{name}_wte_table")
        if wte is None:
            raise GraphVerifyError(
                f"serving params: missing {name}_wte_table (model "
                f"prefix {name!r}; params hold "
                f"{sorted(params)[:8]}...)", kind="shape")
        if tuple(wte.shape)[1] != H:
            raise GraphVerifyError(
                f"serving params: {name}_wte_table has embed dim "
                f"{tuple(wte.shape)[1]}, config.hidden_size is {H}",
                kind="shape")
        wpe = params.get(f"{name}_wpe")
        if wpe is not None:
            if tuple(wpe.shape)[1] != H:
                raise GraphVerifyError(
                    f"serving params: {name}_wpe embed dim "
                    f"{tuple(wpe.shape)[1]} != hidden_size {H}",
                    kind="shape")
            if tuple(wpe.shape)[0] < int(config.max_position_embeddings):
                raise GraphVerifyError(
                    f"serving params: {name}_wpe covers "
                    f"{tuple(wpe.shape)[0]} positions, config asks "
                    f"{int(config.max_position_embeddings)}",
                    kind="shape")
        # MoE serving configs (models/moe_decode.py): every MoE block
        # must carry the gate + stacked expert weights with the expert
        # count the config declares — a per-expert leaf with the wrong
        # leading dim is exactly the corrupt rolling-swap payload that
        # swap_params' shape check refuses, so catch it at build too
        from ..models.moe_decode import moe_spec_of
        from ..parallel.sharding import whole_shape
        spec = moe_spec_of(config)
        if spec is not None:
            E = spec.num_experts
            for i in range(int(config.num_hidden_layers)):
                if not spec.is_moe_layer(i):
                    continue
                us = f"{name}_h{i}"
                gate = params.get(f"{us}_moe_gate_weight")
                w1 = params.get(f"{us}_moe_expert_stack_w1")
                w2 = params.get(f"{us}_moe_expert_stack_w2")
                for leaf, v in (("moe_gate_weight", gate),
                                ("moe_expert_stack_w1", w1),
                                ("moe_expert_stack_w2", w2)):
                    if v is None:
                        raise GraphVerifyError(
                            f"serving params: MoE layer {i} is missing "
                            f"{us}_{leaf} (config routes every "
                            f"{spec.moe_every}th block through "
                            f"{E} experts)", kind="shape")
                if tuple(gate.shape) != (H, E):
                    raise GraphVerifyError(
                        f"serving params: {us}_moe_gate_weight has "
                        f"shape {tuple(gate.shape)}, config wants "
                        f"({H}, {E})", kind="shape")
                # an expert-parallel rank's piece counts as its whole
                # stack
                for leaf, v, dim, want in (
                        ("moe_expert_stack_w1", w1, 0, E),
                        ("moe_expert_stack_w2", w2, 0, E),
                        ("moe_expert_stack_w1", w1, 1, H),
                        ("moe_expert_stack_w2", w2, 2, H)):
                    shape = whole_shape(v)
                    if shape[dim] != want:
                        raise GraphVerifyError(
                            f"serving params: {us}_{leaf} dim {dim} is "
                            f"{shape[dim]}, config wants {want} (shape "
                            f"{shape})", kind="shape")
        # the attention projections' whole shapes: a tensor-parallel
        # rank's piece (tp_shard_params) counts as its whole value
        for i in range(int(config.num_hidden_layers)):
            for leaf in ("attn_q_weight", "attn_k_weight", "attn_v_weight",
                         "attn_proj_weight"):
                v = params.get(f"{name}_h{i}_{leaf}")
                if v is not None and whole_shape(v) != (H, H):
                    raise GraphVerifyError(
                        f"serving params: {name}_h{i}_{leaf} has shape "
                        f"{whole_shape(v)}, config wants ({H}, {H})",
                        kind="shape")
        dtypes = sorted({str(v.dtype) for v in params.values()
                         if hasattr(v, "dtype")})
        records.append(make_record(
            "serving_verified", model=name, params=len(params),
            hidden=H, heads=heads, dtypes=dtypes,
            moe=(None if spec is None else
                 {"experts": spec.num_experts, "top_k": spec.top_k,
                  "moe_every": spec.moe_every})))
    except (GraphVerifyError, ShardCheckError) as e:
        records.append(make_record(
            "graph_verify_error", model=name, phase="serving",
            kind=getattr(e, "kind", "unknown"), error=str(e)))
        emit_records(records)
        raise
    emit_records(records)
    return records
