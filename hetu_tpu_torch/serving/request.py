"""Request/Result contracts for the serving engines.

A Request carries everything that makes its output reproducible in
isolation: prompt, sampling settings, and a PER-REQUEST rng seed — so
the engine's outputs are a pure function of the request, independent of
arrival order, slot assignment, or what else shares the batch (the
scheduler-determinism tests pin this).

Two request kinds share one lifecycle core (:class:`RequestCore`):
the GPT :class:`Request` (token prompt + sampling payload) and the
recommendation :class:`EmbedRequest` (sparse-id + dense-feature
payload).  The core owns everything the serving substrate — queue
admission, SLO classes, the fleet router, deadline accounting —
needs, so ``ServingRouter`` can host either engine kind without
knowing the payload shape.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Sequence

import numpy as np

_ids = itertools.count()


class RequestCore:
    """Model-agnostic request lifecycle mixin: identity, SLO class,
    session affinity, deadline, and submit/first-result stamps.

    Payload dataclasses call :meth:`_init_core` from their
    ``__post_init__`` AFTER payload validation, so error ordering (and
    messages) stay exactly what each workload's tests pin.  The mixin
    is deliberately not a dataclass base: default-valued core fields
    would precede the payload's positional fields and break
    ``Request(prompt, max_new_tokens)`` construction.
    """

    #: stamped onto serving telemetry so hetu_top can tell workloads
    #: apart in one merged stream
    workload: str = "gpt"

    def _init_core(self):
        if self.slo_class not in ("latency", "throughput"):
            raise ValueError(
                f"slo_class must be 'latency' or 'throughput', "
                f"got {self.slo_class!r}")
        if self.request_id is None:
            self.request_id = f"req-{next(_ids)}"

    def capacity_tokens(self) -> Optional[int]:
        """Sequence capacity this request needs from its engine (prompt
        + budget for a GPT engine), or None when the workload has no
        per-request sequence bound (embedding waves size by rows, not
        tokens) — the router skips the s_max check for those."""
        return None


@dataclasses.dataclass
class Request(RequestCore):
    """One generation request.

    prompt: non-empty token ids; max_new_tokens: tokens to generate
    (the EOS, when hit, counts as the last one); temperature/top_k:
    per-request sampling settings (0/0 = greedy) — both traced in the
    fused step, so mixed settings share one compile; eos_id: stop
    sampling once this id is emitted past the prompt; seed: the
    request's own rng stream; stream_cb: called as cb(request, token)
    for every generated token as it lands (iteration-level streaming).

    Fleet fields (serving/router.py; a bare engine ignores them):
    slo_class "latency" or "throughput" — under overload the router
    sheds throughput-class traffic first; session_id keys session
    affinity (same session -> same replica, so its shared-prefix KV
    blocks stay hot); deadline_s bounds how long the router may hold
    the request across retries/requeues before expiring it.
    """

    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    eos_id: Optional[int] = None
    seed: int = 0
    stream_cb: Optional[Callable] = None
    request_id: Optional[str] = None
    # fleet routing (serving/router.py)
    slo_class: str = "throughput"
    session_id: Optional[str] = None
    deadline_s: Optional[float] = None
    # set by the engine
    submitted_at: Optional[float] = None
    first_token_at: Optional[float] = None

    def __post_init__(self):
        self.prompt = [int(t) for t in np.asarray(self.prompt).reshape(-1)]
        if not self.prompt:
            raise ValueError("prompt must hold at least one token")
        if int(self.max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        self.max_new_tokens = int(self.max_new_tokens)
        self._init_core()

    def capacity_tokens(self) -> Optional[int]:
        return len(self.prompt) + self.max_new_tokens


@dataclasses.dataclass
class Result:
    """A finished request: ``tokens`` is prompt + generated (numpy
    int32, EOS included when that's what stopped it — no padding, unlike
    the offline path's fixed span); ``finish_reason`` is "eos" or
    "length"."""

    request_id: str
    tokens: np.ndarray
    prompt_len: int
    finish_reason: str
    n_generated: int
    ttft_s: float
    latency_s: float
    slot: int
    # speculative-decoding attribution (0/0 on a non-speculative
    # engine): drafted tokens this request accepted vs was proposed —
    # accepted + bonus samples + the prefill token == n_generated
    spec_accepted: int = 0
    spec_proposed: int = 0
    # the weight version the request was ADMITTED under (None on an
    # unversioned engine) — a swap never lands mid-request, so every
    # generated token is this version's
    weight_version: Optional[int] = None

    @property
    def generated(self) -> List[int]:
        return [int(t) for t in self.tokens[self.prompt_len:]]


@dataclasses.dataclass
class EmbedRequest(RequestCore):
    """One recommendation-scoring request: ``item_ids`` is the sparse
    feature-id matrix ([n, n_fields] for the CTR towers, [n] item ids
    for NCF), ``user_ids`` the per-pair user ids (NCF only — CTR
    towers fold the user into the sparse fields), ``dense_features``
    the [n, n_dense] dense block (CTR only).  All n pairs in one
    request are scored in the same wave and retire together.

    The lifecycle fields mirror :class:`Request` exactly — the router
    and SLO monitor never see the payload.
    """

    user_ids: Optional[Sequence[int]] = None
    item_ids: Optional[Sequence[int]] = None
    dense_features: Optional[Sequence[float]] = None
    seed: int = 0
    request_id: Optional[str] = None
    # fleet routing (serving/router.py)
    slo_class: str = "throughput"
    session_id: Optional[str] = None
    deadline_s: Optional[float] = None
    # set by the engine
    submitted_at: Optional[float] = None
    first_token_at: Optional[float] = None

    workload = "embed"

    def __post_init__(self):
        if self.item_ids is None:
            raise ValueError("item_ids must hold at least one row")
        self.item_ids = np.asarray(self.item_ids, dtype=np.int64)
        if self.item_ids.size == 0:
            raise ValueError("item_ids must hold at least one row")
        if self.user_ids is not None:
            self.user_ids = np.asarray(self.user_ids,
                                       dtype=np.int64).reshape(-1)
            if len(self.user_ids) != self.n_pairs:
                raise ValueError(
                    f"user_ids has {len(self.user_ids)} rows, "
                    f"item_ids has {self.n_pairs}")
        if self.dense_features is not None:
            self.dense_features = np.asarray(self.dense_features,
                                             dtype=np.float32)
            if self.dense_features.ndim == 1:
                self.dense_features = self.dense_features[None, :]
            if len(self.dense_features) != self.n_pairs:
                raise ValueError(
                    f"dense_features has {len(self.dense_features)} "
                    f"rows, item_ids has {self.n_pairs}")
        self._init_core()

    @property
    def n_pairs(self) -> int:
        """Rows this request scores (its wave-capacity cost)."""
        return int(self.item_ids.shape[0])


@dataclasses.dataclass
class EmbedResult:
    """A scored request: ``scores`` is the [n_pairs] float32 CTR/rating
    vector, row-aligned with the request's pairs; ``finish_reason`` is
    "scored" (or "shed"/"expired" when the fleet dropped it)."""

    request_id: str
    scores: np.ndarray
    n_pairs: int
    finish_reason: str
    ttft_s: float
    latency_s: float
    slot: int
    cache_hit_rate: float = 0.0
    # the weight version the scoring wave ran under (None unversioned)
    weight_version: Optional[int] = None
