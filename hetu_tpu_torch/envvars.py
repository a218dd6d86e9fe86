"""Central typed registry for every ``HETU_*`` environment variable.

Before this module the repo had ~60 scattered ``os.environ`` reads with
per-site defaults and per-site parsing (``!= "0"`` here, ``bool(get())``
there, ``.lower() not in (...)`` elsewhere) — undocumented drift the
README could not keep up with.  Now every knob is REGISTERED once with a
type, default, and help string, and every read goes through a typed
getter; ``bin/hetu_lint.py`` (rule ``env-registry``) rejects any new raw
``os.environ['HETU_*']`` read outside this file, and ``--env-table``
regenerates the README's knob table from the registry.

Getters re-read ``os.environ`` on every call (no import-time caching):
tests and the chaos harness toggle vars at runtime and must observe the
change.  Reading an UNREGISTERED name raises — adding the registry row
(one line, with help text) is the price of a new knob.

Boolean parsing is uniform: unset → default; ``"" / 0 / false / no /
off`` (case-insensitive) → False; anything else → True.  This subsumes
the three ad-hoc spellings the call sites used to have.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

_FALSY = ("", "0", "false", "no", "off")
_MISSING = object()


@dataclass(frozen=True)
class EnvVar:
    name: str
    type: str          # 'str' | 'int' | 'float' | 'bool' | 'path' | 'list'
    default: object
    help: str
    section: str = "general"


REGISTRY: dict[str, EnvVar] = {}


def _reg(name, type_, default, help_, section):
    REGISTRY[name] = EnvVar(name, type_, default, help_, section)


# --------------------------------------------------------------------- #
# static checks (this PR's subsystem)
# --------------------------------------------------------------------- #
_reg("HETU_VALIDATE", "bool", False,
     "Run the pre-trace graph verifier + parallelism checker at executor/"
     "engine build and before each new feed-shape compile (analysis/). "
     "Default-on under pytest (tests/conftest.py).", "validate")
_reg("HETU_VALIDATE_LOG", "path", None,
     "JSONL sink for verifier/shard-check reports, in the launcher's "
     "failure-log record shape ({t, event, ...}).", "validate")

# --------------------------------------------------------------------- #
# concurrency sanitizer (hetu_tpu/locks.py + analysis/concurrency.py)
# --------------------------------------------------------------------- #
_reg("HETU_LOCKDEP", "bool", False,
     "Lock-order/deadlock sanitizer: every TracedLock acquisition "
     "records the per-thread held stack into a global lock-order "
     "graph; a cycle (potential deadlock), blocking work under a lock "
     "(note_blocking: PS RPC, big wire encodes), or an over-threshold "
     "hold is reported as a lockdep_violation event.  Also feeds the "
     "per-lock-class lock.hold_ms.* histograms.  0 = wrappers are "
     "plain pass-throughs (near-zero overhead).", "concurrency")
_reg("HETU_SCHED_FUZZ", "int", None,
     "Deterministic interleaving fuzz seed (the HETU_CHAOS analog for "
     "thread schedules): analysis/concurrency.run_interleaved drives "
     "registered threads through a seeded cooperative scheduler, so a "
     "race found on seed N reproduces on seed N.  Unset = threads run "
     "free (byte-identical no-op).", "concurrency")
_reg("HETU_LOCKDEP_HOLD_MS", "float", 0.0,
     "> 0 with HETU_LOCKDEP=1: any single lock hold longer than this "
     "many milliseconds is reported as a long_hold lockdep_violation "
     "(0 = histogram only, no per-hold threshold).", "concurrency")

# --------------------------------------------------------------------- #
# telemetry (hetu_tpu/telemetry/)
# --------------------------------------------------------------------- #
_reg("HETU_TELEMETRY", "bool", True,
     "Master switch for telemetry spans + metric instrumentation "
     "(executor step phases, PS RPC, cache, dataloader ring, serving). "
     "0 = no-op spans and no metric recording; the explicit event "
     "streams (failure/serve/validate) still flow.", "telemetry")
_reg("HETU_TELEMETRY_LOG", "path", None,
     "Merged run-wide JSONL sink: EVERY stream's records (failure/"
     "serve/validate + telemetry spans) also append here — the one "
     "file bin/hetu_trace.py merges, tails, and exports to a "
     "Chrome/Perfetto trace.", "telemetry")
_reg("HETU_TELEMETRY_BUFFER", "int", 4096,
     "In-memory event-ring capacity behind telemetry.snapshot(); also "
     "bounds ServingMetrics' in-memory event list when no serve log "
     "path is configured.", "telemetry")
_reg("HETU_FLIGHT_LOG", "path", None,
     "JSONL sink the flight recorder dumps to on engine exception, "
     "QueueFull storm, PS retry exhaustion, launcher terminal failure, "
     "or a HETU_CHAOS kill (telemetry/flight.py: a flight_dump header "
     "record + the last HETU_FLIGHT_DEPTH records leading up to the "
     "fault).  Unset = recording still on, dumps disabled.", "telemetry")
_reg("HETU_FLIGHT_DEPTH", "int", 512,
     "Flight-recorder ring capacity: how many recent telemetry records "
     "each dump carries.", "telemetry")

# --------------------------------------------------------------------- #
# serving SLOs (telemetry/slo.py)
# --------------------------------------------------------------------- #
_reg("HETU_SLO_TTFT_MS", "float", None,
     "Latency-bound SLO: finished requests must reach their first "
     "token within this many milliseconds (submit to first token, "
     "queue wait included).  Unset = no latency SLO.", "slo")
_reg("HETU_SLO_TPS", "float", None,
     "Throughput-bound SLO: each finished request's per-stream decode "
     "rate (tokens/second after the first token) must be at least "
     "this.  Unset = no throughput SLO.", "slo")
_reg("HETU_SLO_OBJECTIVE", "float", 0.99,
     "Fraction of requests that must meet each SLO target (the error "
     "budget is 1 - objective).", "slo")
_reg("HETU_SLO_WINDOW", "int", 256,
     "Sliding-window size (finished requests) for SLO burn-rate "
     "tracking.", "slo")

# --------------------------------------------------------------------- #
# multi-process / TPU bring-up
# --------------------------------------------------------------------- #
_reg("HETU_TPU_COORDINATOR", "str", None,
     "jax.distributed coordinator address for multi-host TPU bring-up "
     "(ht.init() calls jax.distributed.initialize when set).", "cluster")
_reg("HETU_TPU_NUM_PROCS", "int", 1,
     "Process count for jax.distributed.initialize.", "cluster")
_reg("HETU_TPU_PROC_ID", "int", 0,
     "This process's index for jax.distributed.initialize.", "cluster")
_reg("HETU_NUM_PROCESSES", "int", 1,
     "Launcher-stamped world size for jax.distributed bring-up in "
     "spawned workers.", "cluster")
_reg("HETU_PROCESS_ID", "int", None,
     "Launcher-stamped process index (required in launcher-spawned "
     "multi-process workers).", "cluster")

# --------------------------------------------------------------------- #
# parameter server: addressing + transport
# --------------------------------------------------------------------- #
_reg("HETU_PS_ADDR", "str", None,
     "host:port of a single PS server; unset = in-process local "
     "transport.", "ps")
_reg("HETU_PS_ADDRS", "list", (),
     "Comma-separated server-group addresses; >1 activates the sharded "
     "client.", "ps")
_reg("HETU_PS_PORT", "int", 23455,
     "Port a PS server binds (serve_from_env) / the launcher's base "
     "port for sequential server slots.", "ps")
_reg("HETU_PS_RANK", "int", 0, "This worker's rank for PS traffic.", "ps")
_reg("HETU_PS_NRANK", "int", 1, "Worker count for PS barriers/SSP.", "ps")
_reg("HETU_PS_TIMEOUT", "float", 60.0,
     "Per-RPC timeout (seconds).", "ps")
_reg("HETU_PS_CONNECT_TIMEOUT", "float", 10.0,
     "TCP connect timeout (seconds).", "ps")
_reg("HETU_PS_RETRIES", "int", 3,
     "Resend attempts before PSConnectionError surfaces.", "ps")
_reg("HETU_PS_BACKLOG_STEPS", "int", 32,
     "Max training steps of push traffic buffered through a PS outage "
     "(direct hybrid path) before the run fails.", "ps")
_reg("HETU_PS_REPLICATE", "bool", False,
     "Ring-replicate every key to its backup server ((s+1) % N) and "
     "fail over on primary loss (sharded client, N > 1).", "ps")
_reg("HETU_PS_USE_VAN", "bool", True,
     "Allow the native-van fast tier when the server offers it; 0 pins "
     "the python wire.", "ps")
_reg("HETU_PS_VAN", "bool", False,
     "serve_from_env: start the native van and auto-register "
     "qualifying tables.", "ps")
_reg("HETU_PS_VAN_PORT", "int", 0,
     "Port for the native van listener (0 = ephemeral).", "ps")
_reg("HETU_PS_VAN_BIND_ALL", "bool", False,
     "Expose the (authentication-free) van beyond loopback for real "
     "multi-host deployments.", "ps")

# --------------------------------------------------------------------- #
# scheduler rendezvous + liveness
# --------------------------------------------------------------------- #
_reg("HETU_SCHEDULER_ADDR", "str", None,
     "host:port of the rendezvous scheduler; servers register, workers "
     "resolve the group.", "scheduler")
_reg("HETU_SCHEDULER_PORT", "int", 23454,
     "Port the scheduler binds (serve_from_env).", "scheduler")
_reg("HETU_PS_NSERVERS", "int", None,
     "Expected server-group size for scheduler rendezvous (required "
     "with HETU_SCHEDULER_ADDR and no static addresses).", "scheduler")
_reg("HETU_PS_INDEX", "int", 0,
     "This server's index when registering with the scheduler.",
     "scheduler")
_reg("HETU_PS_ADVERTISE", "str", None,
     "Address a server advertises to the scheduler (default "
     "hostname:port).", "scheduler")
_reg("HETU_HEARTBEAT_INTERVAL", "float", 5.0,
     "Seconds between liveness beats to the scheduler.", "scheduler")

# --------------------------------------------------------------------- #
# launcher / supervisor
# --------------------------------------------------------------------- #
_reg("HETU_SUPERVISE", "bool", True,
     "heturun supervisor: respawn dead PS servers/workers; 0 restores "
     "fire-and-wait.", "launcher")
_reg("HETU_RESTART_LIMIT", "int", 3,
     "Per-slot restart budget under the supervisor.", "launcher")
_reg("HETU_RESTART_BACKOFF", "float", 0.5,
     "Base seconds of exponential restart backoff.", "launcher")
_reg("HETU_RESTART_COUNT", "int", 0,
     "Stamped into respawned children (0 = first incarnation); gates "
     "one-shot chaos kills.", "launcher")
_reg("HETU_LIVENESS_STALE", "float", 0.0,
     "> 0: supervisor kills a server whose scheduler heartbeat is "
     "staler than this many seconds (wedge detection).", "launcher")
_reg("HETU_FAILURE_LOG", "path", None,
     "JSONL sink for launcher failure/restart events ({t, event, ...} "
     "records).", "launcher")

# --------------------------------------------------------------------- #
# chaos harness
# --------------------------------------------------------------------- #
_reg("HETU_CHAOS", "str", None,
     "Deterministic fault-injection spec for the PS transports "
     "(ps/faults.py grammar: seed=/drop=/dup=/reset=/delay=/slow=/"
     "kill=/role=).", "chaos")
_reg("HETU_CHAOS_ROLE", "str", "",
     "This process's role tag (server:<idx> / worker:<rank>) for "
     "role-scoped chaos plans.", "chaos")

# --------------------------------------------------------------------- #
# embedding cache
# --------------------------------------------------------------------- #
_reg("HETU_CACHE_MAX_STALE", "int", 100,
     "Consecutive failed sync RPCs a cache tolerates before raising.",
     "cache")
_reg("HETU_CACHE_BACKLOG_ROWS", "int", 100000,
     "Max dirty rows buffered through a PS outage before raising.",
     "cache")

# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
_reg("HETU_SERVE_FAST", "str", "auto",
     "Serving fast path: 1 forces flash-prefill + ragged decode "
     "kernels, 0 the masked/scan reference, auto = fast on TPU.",
     "serving")
_reg("HETU_SERVE_RAGGED", "str", "auto",
     "Mixed-mode ragged dispatch: 1 packs arrivals, chunk "
     "continuations, spec-verify, and decode streams into ONE ragged "
     "wave per engine step (per-slot q_len; no prefill/decode phase "
     "barrier, chunk_stall ~ 0), 0 keeps the phase-split scheduler, "
     "auto = mixed on TPU.  Greedy outputs are token-identical either "
     "way.", "serving")
_reg("HETU_SERVE_LOG", "path", None,
     "JSONL sink for serving engine events (same record shape as "
     "HETU_FAILURE_LOG).", "serving")
_reg("HETU_KV_BLOCK", "str", "auto",
     "Paged KV cache: an integer enables the block-table paged "
     "allocator at that block size (tokens per block), 0 pins the "
     "slot-contiguous layout, auto = paged with block 16 on TPU, "
     "contiguous elsewhere.", "serving")
_reg("HETU_KV_PREFIX_SHARE", "bool", True,
     "Paged KV: refcounted copy-on-write sharing of common prompt "
     "prefixes — N requests with the same system prompt store its KV "
     "blocks once (registered prefixes are LRU-evicted under pool "
     "pressure).", "serving")
_reg("HETU_SPEC_K", "int", 0,
     "Speculative decoding: a truncated-layer draft proposes up to this "
     "many tokens per slot per wave and the target verifies all k+1 "
     "positions in ONE batched step (longest-prefix acceptance + bonus "
     "token; outputs token-identical to plain decoding).  0 = off; "
     "ServingEngine(spec=)/generate_fast(spec=) override.", "serving")
_reg("HETU_SPEC_ADAPT", "bool", True,
     "Adaptive speculation depth: a sliding acceptance-rate window "
     "moves the per-wave draft length through the pow2 ladder "
     "1..HETU_SPEC_K (raise on sustained high acceptance, back off on "
     "low).  0 pins the configured k.", "serving")
_reg("HETU_SPEC_DRAFT_LAYERS", "int", 0,
     "Truncated-layer draft depth: the draft model is the target's "
     "first N blocks plus the shared final LN and tied embedding head "
     "(no separate weights or tokenizer).  0 = auto: max(1, L // 4).",
     "serving")
_reg("HETU_KV_CHUNK", "int", 0,
     "Paged KV chunked prefill: prompts fill their blocks in chunks of "
     "this many tokens interleaved with decode waves, so a long prompt "
     "does not stall running generations (0 = whole prompt in one "
     "pass).", "serving")
_reg("HETU_KV_HOST_BYTES", "int", 0,
     "Tiered KV: host-RAM ring capacity in bytes for refcount-zero "
     "prefix blocks spilled out of the HBM pool (LRU; oldest entries "
     "demote to the PS cold store when enabled, else tier-drop).  "
     "0 = tier off — eviction drops blocks exactly as before.",
     "serving")
_reg("HETU_KV_PS_TIER", "bool", False,
     "Tiered KV: enable the sharded-PS cold-store rung below the host "
     "ring (prefix payloads keyed by prefix hash, versioned put/get).  "
     "A dead/killed PS degrades the ladder to drop-on-evict with zero "
     "request loss — never an error.", "serving")
_reg("HETU_MOE_CAPACITY", "float", 0.0,
     "MoE serving: capacity-factor override for routed expert "
     "dispatch — per-expert slots per wave are top_k * ceil(tokens / "
     "num_experts * cf).  Tokens past capacity take the residual path "
     "(dropped, counted in serve.expert_drops) — never a wrong token.  "
     "0 = use the model config's own capacity_factor.", "serving")
_reg("HETU_MOE_QUANT", "str", None,
     "MoE expert-parallel dispatch/combine all-to-all wire format "
     "('int8' = symmetric per-row int8 payload + f32 scales over the "
     "expert exchange, the HETU_COMM_QUANT codec; empty/0/off = full "
     "precision).  Applies to the explicit shard_map EP reference "
     "path.", "serving")
_reg("HETU_EMBED_WAVE", "int", 8,
     "Embedding serving: max requests the engine claims per scoring "
     "wave (one embedding gather + one jitted tower forward per wave; "
     "EmbedServingEngine(wave=) overrides).", "serving")
_reg("HETU_EMBED_QUEUE", "int", 64,
     "Embedding serving: bounded admission-queue depth — submit "
     "raises QueueFull past it (EmbedServingEngine(queue_limit=) "
     "overrides).", "serving")

# --------------------------------------------------------------------- #
# serving fleet router (serving/router.py)
# --------------------------------------------------------------------- #
_reg("HETU_REPLICAS", "int", 2,
     "Default fleet size for ServingRouter: how many supervised "
     "ServingEngine replicas the router builds from its factory "
     "(constructor replicas= overrides).", "router")
_reg("HETU_ROUTER_AFFINITY", "bool", True,
     "Session affinity: hash Request.session_id to a stable home "
     "replica so a returning session's shared-prefix KV blocks stay "
     "hot (remapped with a prefix_misses count when the home replica "
     "is unroutable).", "router")
_reg("HETU_ROUTER_STALE", "float", 0.0,
     "> 0: the router kills, drains, and requeues a replica whose "
     "step heartbeat is staler than this many seconds — wedged-replica "
     "detection, the serving analog of HETU_LIVENESS_STALE.", "router")
_reg("HETU_ROUTER_BREAKER", "int", 3,
     "Per-replica circuit breaker: consecutive failures "
     "(deaths/wedge kills) that eject the replica from routing; a "
     "half-open probe request readmits it after the cooldown.",
     "router")
_reg("HETU_ROUTER_BREAKER_COOLDOWN", "float", 0.5,
     "Base seconds an open circuit breaker holds before the half-open "
     "probe (doubles per failure past the threshold).", "router")
_reg("HETU_ROUTER_RETRY_LIMIT", "int", 5,
     "Placement retries the router grants a request it holds "
     "(requeued off a dead replica / fleet full) before declaring it "
     "lost — a terminal failure with a flight dump.", "router")
_reg("HETU_ROUTER_RETRY_BACKOFF", "float", 0.02,
     "Base seconds of exponential backoff between a held request's "
     "placement retries.", "router")
_reg("HETU_ROUTER_SHED_QUEUE", "float", 0.75,
     "Fleet queue-fill fraction at which SLO-class load shedding "
     "starts: throughput-class submissions are shed (RouterShed) while "
     "latency-class requests keep admitting until hard-full.", "router")
_reg("HETU_ROUTER_SHED_ON_SLO", "bool", True,
     "Also shed throughput-class traffic while any replica's SLO "
     "health is at breach (frees capacity to pull latency-class TTFT "
     "back inside budget).", "router")
_reg("HETU_ROUTER_DIRECTORY", "bool", True,
     "Fleet prefix-cache directory: route a request whose prompt "
     "prefix is resident on replica R to R (a directory hit) before "
     "falling back to the session-affinity hash.  Entries are hints — "
     "a stale hit degrades to a cold admission, and disabling (or "
     "chaos-killing) the directory degrades the fleet to exact "
     "affinity-only routing.", "router")
_reg("HETU_ROUTER_ROLES", "str", None,
     "Prefill/decode disaggregation: comma-separated role per replica "
     "index ('prefill', 'decode', or 'mixed'; unlisted replicas are "
     "mixed).  With both roles present, long prompts prefill on a "
     "prefill-heavy replica and their KV blocks are handed off to a "
     "decode-heavy one (export_blocks/import_blocks).  Unset = every "
     "replica mixed, no handoffs.", "router")
_reg("HETU_DIRECTORY_TTL", "float", 0.0,
     "> 0: seconds an un-refreshed directory entry stays routable; "
     "expired entries are skipped (counted stale) until re-registered. "
     "0 = hints never expire (the replica's token-verified match still "
     "catches every lie).", "router")

# --------------------------------------------------------------------- #
# live weight sync (serving/weight_sync.py — rolling zero-downtime swaps)
# --------------------------------------------------------------------- #
_reg("HETU_SWAP_PROBE_TOKENS", "int", 4,
     "Greedy probe-decode length (tokens) a freshly swapped replica "
     "must retire on the NEW weight version before the rollout "
     "readmits it — the half-open check of a rolling swap.", "swap")
_reg("HETU_SWAP_DRAIN_STEPS", "int", 2000,
     "Max router steps a quiesced replica may take to drain its "
     "in-flight requests before the rollout is marked failed (and the "
     "fleet auto-rolls back).", "swap")
_reg("HETU_SWAP_ROLLBACK", "bool", True,
     "Auto-roll already-swapped replicas back to the last COMMITTED "
     "version when a rollout fails mid-swap.  0 leaves them on the new "
     "version (the rollout is still marked failed); dead replicas "
     "respawn on the committed version either way.", "swap")

# --------------------------------------------------------------------- #
# elastic fleet (serving/autoscaler.py — SLO-burn-driven autoscaling)
# --------------------------------------------------------------------- #
_reg("HETU_FLEET_MIN", "int", 1,
     "Fewest replicas the autoscaler may run: scale-down never drops "
     "the fleet below this floor (and never retires the last UP "
     "replica regardless).", "fleet")
_reg("HETU_FLEET_MAX", "int", 4,
     "Most replicas the autoscaler may run: scale-up stops at this "
     "ceiling (the equal-peak-capacity bound the autoscale_ab bench "
     "sizes its static arm to).", "fleet")
_reg("HETU_AUTOSCALE_UP_BURN", "float", 1.0,
     "Worst-replica SLO burn rate at or above which a tick counts as "
     "hot (burn >= 1 = an error budget spending faster than it "
     "refills); HETU_AUTOSCALE_UP_TICKS consecutive hot ticks trigger "
     "a scale-up.", "fleet")
_reg("HETU_AUTOSCALE_UP_PRESSURE", "float", 0.75,
     "Aggregate queue-fill fraction at or above which a tick counts "
     "as hot even without an SLO burn signal — queue pressure leads "
     "latency, so the fleet grows before the breach.", "fleet")
_reg("HETU_AUTOSCALE_UP_TICKS", "int", 3,
     "Consecutive hot ticks (one tick per router step) required to "
     "scale up — the hysteresis that keeps a one-step spike from "
     "spawning a replica.", "fleet")
_reg("HETU_AUTOSCALE_DOWN_PRESSURE", "float", 0.15,
     "Aggregate queue-fill fraction at or below which a tick counts "
     "as idle (with burn < 1 and nothing router-held); "
     "HETU_AUTOSCALE_DOWN_TICKS consecutive idle ticks trigger a "
     "scale-down.", "fleet")
_reg("HETU_AUTOSCALE_DOWN_TICKS", "int", 50,
     "Consecutive idle ticks required to scale down — deliberately "
     "much slower than scale-up (growing late sheds traffic; "
     "shrinking late only burns replica-seconds).", "fleet")
_reg("HETU_AUTOSCALE_COOLDOWN", "int", 20,
     "Refractory ticks after ANY scale action during which the "
     "autoscaler only observes — a bursty signal cannot flap the "
     "fleet.", "fleet")
_reg("HETU_AUTOSCALE_WARM_PREFIXES", "int", 4,
     "Hottest directory-known prefixes moved per membership change: "
     "imported into a joining replica before it takes traffic "
     "(scale-up warming) and exported from a retiring replica to its "
     "best peer (scale-down).  0 disables prefix movement.", "fleet")

# --------------------------------------------------------------------- #
# quantization (hetu_tpu/quant.py — one layer, three seams)
# --------------------------------------------------------------------- #
_reg("HETU_PS_QUANT", "str", None,
     "PS transport quantization: 'int8' ships push/pull payloads as "
     "symmetric per-chunk int8 + f32 scales over the wire (~3.7x fewer "
     "bytes; dequantized server-side before the optimizer step, "
     "symmetrically on pull).  Unset/0 = exact f32 wire (default).",
     "quant")
_reg("HETU_COMM_QUANT", "str", None,
     "Collective quantization: 'int8' makes DataParallel emit the "
     "quantize→all_gather→dequantize comm-op pair for dp gradient "
     "aggregation (int8 payload on the interconnect under shard_map "
     "execution; fake-quant annotation under pjit, where XLA owns the "
     "collective).  Unset/0 = plain f32 collectives (default).",
     "quant")
_reg("HETU_KV_QUANT", "str", None,
     "Serving KV-cache quantization: 'int8' stores the KV pool as int8 "
     "with per-(position, head) f32 scales (~3.7x more tokens per HBM "
     "byte; dequantized inside the decode kernels' online-softmax "
     "loop).  Unset/0 = the cache follows the weight dtype (default).",
     "quant")
_reg("HETU_QUANT_CHUNK", "int", 256,
     "Elements per f32 scale for the flat (PS wire / comm pair) int8 "
     "codec; the KV cache always scales per (position, head).", "quant")
_reg("HETU_HANDOFF_QUANT", "str", "auto",
     "Replica-to-replica KV handoff wire (export_blocks/import_blocks): "
     "'auto' ships the pool's native bytes (an int8 pool's payload + "
     "scales already are the cheap wire), 'int8' forces quantizing an "
     "exact pool's export through the per-head codec (~4x fewer "
     "bytes), '0'/'off' pins the exact wire.", "quant")

# --------------------------------------------------------------------- #
# graph/ops knobs
# --------------------------------------------------------------------- #
_reg("HETU_MOE_SCATTER_DISPATCH", "bool", False,
     "MoE dispatch formulation: row scatter-add instead of the GShard "
     "one-hot matmul (read ONCE at op construction).", "ops")

# --------------------------------------------------------------------- #
# data / planner
# --------------------------------------------------------------------- #
_reg("HETU_DATA_HOME", "path", "~/.hetu_data",
     "Dataset download/cache directory.", "data")
_reg("HETU_CALIB_SMALL", "bool", False,
     "Chip-calibration: reduced ladder for smoke runs.", "planner")
_reg("HETU_COMPILE_CACHE_DIR", "path", "/tmp/hetu_xla_cache",
     "Persistent XLA compilation-cache directory for bench runs.",
     "planner")

# --------------------------------------------------------------------- #
# bench.py
# --------------------------------------------------------------------- #
_reg("HETU_BENCH_SMALL", "bool", False,
     "Force the reduced (CPU-scale) bench configs.", "bench")
_reg("HETU_BENCH_CONFIGS", "str", None,
     "Comma-separated subset of bench matrix configs to run.", "bench")
_reg("HETU_BENCH_SWEEP", "bool", False,
     "Run the (batch x attention x head) ablation sweep.", "bench")
_reg("HETU_BENCH_DECODE", "bool", False,
     "Run the KV-cached decode benchmark.", "bench")
_reg("HETU_BENCH_SERVE", "bool", False,
     "Run the continuous-batching serving benchmark.", "bench")
_reg("HETU_BENCH_EMBED_SERVE", "bool", False,
     "Run the embedding-cache recommendation-serving benchmark "
     "(zipf cache-limit ladder, int8-pull A/B, PS-kill chaos).",
     "bench")
_reg("HETU_BENCH_CTR_ROWS", "bool", False,
     "Run the max-embedding-rows-per-chip ladder.", "bench")
_reg("HETU_BENCH_CTR_FP32", "bool", False,
     "CTR hybrid: pin full-width fp32 host-link transfers (default "
     "ships bf16).", "bench")
_reg("HETU_BENCH_FORCE_FLASH", "str", None,
     "Pin the attention impl for sweeps: 1 = flash kernel, 0 = XLA "
     "batched attention (unset = size-based crossover).", "bench")
_reg("HETU_BENCH_FUSED_HEAD", "bool", False,
     "A/B the chunked fused LM head (memory tool) against the "
     "materialized-logits default.", "bench")
_reg("HETU_BENCH_BERT_BATCH", "int", None,
     "Pin the BERT-base per-chip batch instead of probing.", "bench")
_reg("HETU_BENCH_MOE_BATCH", "int", None,
     "Override the MoE bench batch (chip-fill tuning).", "bench")
_reg("HETU_BENCH_MOE_TOKENS", "int", None,
     "Override the MoE bench tokens-per-sample.", "bench")
_reg("HETU_BENCH_LC_BLOCKS", "str", None,
     "Long-context flash tile override, 'bq,bk'.", "bench")
_reg("HETU_BENCH_NO_COMPILE_CACHE", "bool", False,
     "Opt out of the persistent XLA compile cache.", "bench")


# --------------------------------------------------------------------- #
# typed getters
# --------------------------------------------------------------------- #

def _spec(name) -> EnvVar:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unregistered env var {name!r}: every HETU_* knob must be "
            f"declared in hetu_tpu/envvars.py (one _reg line with type, "
            f"default, and help text)") from None


def _raw(name, default):
    spec = _spec(name)
    v = os.environ.get(name)
    if v is None:
        return spec.default if default is _MISSING else default
    return v


def is_set(name) -> bool:
    """True when the var is present AND non-empty in the environment."""
    _spec(name)
    return bool(os.environ.get(name))


def get_str(name, default=_MISSING):
    v = _raw(name, default)
    return v if v is None else str(v)


def get_int(name, default=_MISSING):
    v = _raw(name, default)
    return v if v is None else int(v)


def get_float(name, default=_MISSING):
    v = _raw(name, default)
    return v if v is None else float(v)


def get_bool(name, default=_MISSING) -> bool:
    v = _raw(name, default)
    if isinstance(v, bool) or v is None:
        return bool(v)
    return str(v).strip().lower() not in _FALSY


def get_path(name, default=_MISSING):
    v = _raw(name, default)
    return v if v is None else os.path.expanduser(str(v))


def get_list(name, default=_MISSING) -> list:
    """Comma-separated list; empty items dropped."""
    v = _raw(name, default)
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return list(v)
    return [a.strip() for a in str(v).split(",") if a.strip()]


def get_raw(name):
    """The raw environment string (or None), no typing or defaulting —
    for save/restore of env state around A/B sweeps, where "unset" and
    "set to the default" must stay distinguishable."""
    _spec(name)
    return os.environ.get(name)


def require_int(name) -> int:
    """get_int that raises when the var is unset (launcher contracts)."""
    _spec(name)
    if os.environ.get(name) is None:
        raise EnvironmentError(f"required env var {name} is not set")
    return int(os.environ[name])


# --------------------------------------------------------------------- #
# documentation table (bin/hetu_lint.py --env-table; README section)
# --------------------------------------------------------------------- #

def env_table() -> str:
    """Markdown table of the full registry, grouped by section."""
    lines = ["| Variable | Type | Default | Description |",
             "|---|---|---|---|"]
    by_sec = {}
    for var in REGISTRY.values():
        by_sec.setdefault(var.section, []).append(var)
    for sec in sorted(by_sec):
        for var in sorted(by_sec[sec], key=lambda v: v.name):
            d = var.default
            if d is None:
                d = "unset"
            elif isinstance(d, bool):
                d = "1" if d else "0"
            elif isinstance(d, (tuple, list)):
                d = ",".join(d) or "unset"
            lines.append(f"| `{var.name}` | {var.type} | `{d}` | "
                         f"{var.help} |")
    return "\n".join(lines)
