#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile DIR]

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit.  Phases (any failed check raises; the script exits
non-zero and prints no result line):

1. The card's name and power limit (``nvidia-smi``); every kernel
   library built by ``nvcc`` from ``hetu_tpu_torch/kernels/csrc``, all
   sources at once (seconds printed); one line per instance of the
   kernels on the tensor cores (f32 K2 and K2-carry, f32 K3's two and
   the f32 wide ragged kernel of f32 K1/K8 and of their f32-q int8
   twins (Q > 16, csrc/ragged_tf32.cuh) on mma.sync TF32, three passes;
   bf16 K2 and K2-carry on wgmma fed by TMA from a producer warp, bf16
   K3's two on mma.sync, K1/K8's wide kernel on wgmma and split kernel
   on mma.sync, each over a bf16 and an int8 cache, and K4-K7's split
   kernel on mma.sync, also over an int8 cache), and of the f32 split
   kernel on the CUDA cores (f32 K1 over the pool, f32 K8 over slot
   rows, f32-q K1-int8 over an int8 pool, f32-q K8-int8 over int8 slot
   rows, f32-q K4-int8/K5-int8 over either): registers and spills
   (``ptxas -v``), dynamic shared
   memory, and the HGMMA / HMMA (TF32 among them) / FFMA / UTMALDG
   instructions of its SASS where the toolkit has ``cuobjdump`` (a
   tensor-core instance with no HGMMA or HMMA, an f32 flash or f32 wide
   ragged kernel with no TF32 one, bf16 K2 with no TMA load, the f32
   split kernel with any tensor-core instruction or no FFMA, or an
   instance with a spill, fails); the host time of bf16 K2's three TMA
   tensor maps, encoded on each call.
2. Each kernel against its plain PyTorch version on the card at the main
   path's shapes, f32 and bf16, with the max abs error beside a stated
   tolerance, and CUDA-event times (median of several warm runs) of the
   kernel, its plain version and one PyTorch library call as a
   yardstick (never called by the port), beside the least time the
   card could take for the same work (the flash kernels also timed over
   ten back-to-back calls, the device time once the host runs ahead):
   K1 ragged_paged_attention on a mixed pool wave (Q 256), K2
   flash_attention on 8 prompts, K4/K5 decode over 8 slot rows / pool
   slots, K6/K7 verify over the same slot rows / pool slots (Q 5, q_lens
   {5, 5, 3, 0, 1, 5, 2, 5}), K8 ragged_attention on a contiguous wave
   with a 1024-row prompt q-block; then K1 and K8 on a decode wave (Q 1)
   and a verify wave (Q 8, K6's q_lens) over the same slots (K1 and K8
   also timed ten back to back; the narrow waves of f32 K1, f32 K8 and,
   in phase 7, f32-q K1-int8 and K8-int8 run the split-K CUDA-core
   body, csrc/split_kv_f32.cuh, their mixed waves the TF32 body,
   csrc/ragged_tf32.cuh, whose bound counts 3 x the flops at TF32's
   rate, all held to 1e-5); then f32 K8 equal to f32
   K1 bit for bit on the same decode wave (Q 1) over the pool's slot
   rows and the pool, and f32-q K8-int8 equal to f32-q K1-int8 the same
   way over the pool's int8 encoding; bf16-q K6-int8 equal to
   bf16-q K8-int8 bit for
   bit on the same Q 5 verify wave over the same int8 slot rows; last,
   in both q dtypes at head dims 32, 64 and 128, K5-int8 equal to
   K1-int8 over an int8 pool and K4-int8 to K8-int8 over its slot rows
   on the Q 1 decode wave, bit for bit, each on its split body, and a
   misaligned int8 payload refused with nothing launched.  bf16
   K1 and K8 (csrc/ragged_paged_bf16.cu) round P to bf16 before P V as
   the Pallas body does and their plain
   versions do not: they are held to TOL plus
   ``ragged_attention.ragged_rounding_bound`` (2^-8 sum(p |v_d|) / l of
   the row, one rounding of P), and the largest err / bound is logged;
   so are bf16 K4-K7 (csrc/decode_attention_bf16.cu, the split-K body
   of K1/K8's narrow waves), here and K6/K7 at Q 17 in phase 6.  K4-K7
   are also timed ten back to back and on the device.  f32 K2 (here,
   at phase 8's training shape and as K2-carry in phase 9) runs three
   TF32 passes on the tensor cores and keeps f32's 1e-5; its bound
   counts 3 x its flops at TF32's 495 TFLOP/s (``TF32X3``), and so do
   f32 K3's (phase 8), which runs the same way.
   bf16 K2 (here, at phase 8's training shape and as K2-carry in phase
   9) is held element by element to 2^-7 sum(p |v_d|) / l of its row
   (``bf16_rounding_bound``) + 1e-5, and 2^-7 rel: it rounds P to bf16
   against its running max at each key tile, the plain version against
   the row's final max, so the two P differ by up to 2^-7 p.
3. Offline ``generate_fast`` on GPT-2-small at full width and depth
   (vocab 50257, hidden 768, 12 layers, 12 heads, 1024 positions),
   weights drawn from ``--seed``: 4 prompts x 128 tokens, 32 new tokens,
   greedy, f32 then bf16; the flash kernel launched layers x 1 times,
   the contiguous decode kernel (K4) layers x 31 decode positions.
4. ``ServingEngine`` on the same model, f32 then bf16, with its auto
   settings (paged block 16, mixed ragged waves), slots 8,
   prefix sharing, prefill chunks of 256: 16 requests of 32-600 prompt
   tokens (four share a 128-token prefix; four are phase 3's prompts),
   64 new tokens each, greedy except four sampled at temperature 0.8,
   top_k 40.  The ragged kernel is launched layers x steps times; the
   f32 engine's greedy tokens for phase 3's prompts equal offline
   ``generate_fast``'s (two different kernels, one answer).
5. The same request set, f32 then bf16, through the three other engine
   configurations: contiguous + phase-split; paged 16 + phase-split +
   prefill chunks of 256 + prefix sharing; contiguous + mixed.  Each
   launches exactly layers x decode waves of K4 or K5, layers x flash
   groups of K2, layers x chunk passes of K1, or layers x steps of K8;
   in f32 every greedy request's tokens equal phase 4's.
6. Speculation (``spec=4``, the auto draft of 3 of 12 layers, adaptive k)
   on the same request set through all four configurations, f32 then
   bf16: the phase-split verify waves launch K6 (contiguous) or K7
   (paged) layers x waves times, the mixed waves carry verify rows on
   K8/K1, and the draft launches K4 3 x (k + 1) per wave and K2 3 x per
   admission; in f32 every greedy request's tokens equal phase 4's and
   every sampled request's equal its configuration's phase 4/5 run.
   Then the high-acceptance arm: layers 3-11 output-zeroed, all requests
   greedy, paged phase-split and paged mixed in f32 — tokens equal a
   non-speculative run on those weights, acceptance >= 0.9, fewer waves
   than generated tokens.  Then offline ``generate_fast(spec=4)`` on
   phase 3's prompts equals phase 3's f32 tokens.  Last, speculation
   deeper than the verify kernels' 16 rows: K6/K7 at Q 17 (two 16-row
   groups, two launches) against their plain versions, f32 and bf16;
   GPT-2-small cut to 4 layers, f32, phase-split
   ``ServingEngine(spec=16, spec_adapt=False)`` on the slot rows and on
   the pool, and ``generate_fast(spec=16)``: greedy tokens equal
   ``spec=0``'s, two verify launches per layer per wave.
7. The int8 KV cache (``kv_quant="int8"``).  First the six int8 twins
   (K1-int8, K4-int8 ... K8-int8) at phase 2's shapes, over phase 2's
   f32 K/V encoded by ``quant.kv_encode`` on the card (equal to the CPU
   encoding, payload and scales), q f32 and bf16, held to their plain
   versions with phase 2's tolerances (both sides form the same f32
   product payload x scale; every bf16-q twin, on the tensor cores,
   splits p times the V scale into a bf16 pair before
   P V_int, two products, and hold TOL alone as the Pallas int8 body,
   which never rounds P, does), timed
   beside an SDPA yardstick over the pre-dequantized K/V (the
   dequantization not timed) and a bound from the int8 bytes; K1-int8
   and K8-int8 at their mixed, decode and verify waves, also timed ten
   back to back and on the device.  Then the request set through all
   four engine configurations with an int8 cache, f32 then bf16: each
   int8 twin launched exactly where its float twin was, the float twin
   never; the footprint what the shapes give; every f32 greedy request
   equal to phase 4's or first differing where the exact top-2 logit
   margin is at most twice the int8 logit error
   (``teacher_forced_logits``, the JAX package's gate).  Last
   ``spec=4`` with int8 in all four, whose f32 tokens, greedy and
   sampled, equal the non-speculative int8 run's.

8. Training (``Executor`` over ``GPTForCausalLMModule``).  8a: K3, the flash
   backward's dK/dV and dQ kernels, against their plain versions on the
   card: f32 and bf16, head dims 32/64/128, causal and not, kv_lens with
   a 0, Sk > S, S not a multiple of the tile; then at the training
   shape (8 x 1024 tokens, 12 heads of 64, causal), timed beside their
   bounds, their plain versions and the backward of
   ``scaled_dot_product_attention(is_causal=True)`` as a yardstick (its
   backend named), with K2 at the same shape.  8b: GPT-2-small at full
   width and depth, B 8, S 1024, AdamW 3e-4 (weight decay 0.01, clip
   1.0), the synthetic task.  First, in f32 from one set of weights on
   one batch, the loss and every gradient through the flash path (K2
   forward, K3 backward) against the unfused path, which runs no kernel:
   the loss within 1e-5 relative, each gradient within 1e-4 of its
   tensor's max |g|.  Then 8 steps, f32 then the bf16 policy: every
   loss finite, the eval loss of the first step's batch lower after the
   steps than before (the optimizer moves), launches exact (K2 12 per
   step and per eval forward, each K3 kernel 12 per step); step ms,
   tokens/s, peak memory.  8c: the
   trained f32 weights through the serving ``teacher_forced_logits`` on
   one 1024-token sequence equal the training model's eval logits of it
   within 1e-4.

9. Context parallelism (``hetu_tpu_torch.parallel``) on a virtual mesh
   of the card.  9a: K2-carry (``flash_attention_carry``, the carried
   flash forward) against its plain version: f32 and bf16, head dims
   32/64/128, causal and not, a carry that is empty, live or mixed row
   by row, S 100 and 40 (1e-5 + 1e-5 rel: the output is f32 for both
   dtypes; bf16 adds K2's rounding bound of P); then at the ring's
   block shape [1, 2048, 12, 64] with a live
   carry, timed beside its bound and its plain version (no single
   PyTorch call computes a carried forward).  9b: ``ring_attention``
   (``impl=None``: the flash path) at cp 4 over B 1, S 8192, 12 heads of
   64, f32 and bf16, causal and not: the forward equal to K2 over the
   whole sequence (f32 2e-5 + 2e-4 rel, bf16 2e-5 + K2's rounding
   bound + one ulp:
   the ring's carry and K2 round P against different maxima), the
   gradients of
   sum(o * g) through K2-carry + K3 equal to autograd through K2 + K3
   over the whole sequence (f32 1e-4 of each tensor's max, bf16 cp
   ulps), exactly cp + cp(cp - 1)/2 = 10 (causal) or cp^2 = 16
   K2-carry launches and as many of each K3 kernel (a rotation above
   the diagonal launches nothing); the ring's forward and forward +
   backward times beside whole-sequence K2 (+ K3) and SDPA, peak
   memory.  9c: ``ulysses_attention`` at cp 4 with the port's
   ``flash_attention`` as ``attn_fn``: within 1e-6 of K2 over the whole
   sequence, with cp K2 launches.

10. MoE serving: the MoE GPT at GPT-2-small width (``MOE``: the
   dense widths, 4 experts of 1536, top-2, capacity factor 2.0, every
   second block routed; random weights from ``--seed`` through
   ``moe_decode.init_moe_params``), on phase 4's request set.
   Offline ``generate_fast`` (f32, launches as phase 3's); the four
   engine configurations in f32 (launches as phases 4-5, every greedy
   request equal to paged-mixed's, phase 3's prompts to
   ``generate_fast``'s); paged-mixed in bf16 under the bf16 margin
   gate (``margin_gate(low="bf16")``: the bf16 teacher-forced pass in
   the place of int8's); ``spec=4`` on paged phase-split (all tokens
   equal the non-speculative run's, ``moe_ffn`` called MoE blocks x
   target calls times: the draft routes nothing); an int8 cache on
   paged-mixed under phase 7's gate through the MoE
   ``teacher_forced_logits``; capacity factor 0.25 (drops > 0); every
   engine's load + drop == routed positions x top_k x MoE blocks on
   every step record; the dense oracle (phase 3's weights through
   ``convert_dense_to_moe``, k = E = 4: teacher-forced logits of 1024
   tokens within 1e-4 of the dense model's).  Then two windows of the
   paged mixed engine, f32 and bf16, under torch.profiler: the device
   ms of the kernels ``moe_ffn`` launches against attention's, and the
   host share; tok/s and TTFT beside phase 4-5's dense runs.

11. The serving fleet (``ServingRouter``): two replicas of phase 4's
   f32 engine (paged 16, mixed waves, 8 slots each, phase 3's weights
   copied onto the card per replica), phase 4's 16 requests.  First a
   plain fleet run: every token equal to phase 4's, each replica's
   launches exactly layers x steps of K1, ``trace --check`` clean; fleet
   tok/s and TTFT p50/p99 beside phase 4's one engine.  11a: a seeded
   ``HETU_CHAOS`` kill of replica 0 mid-run (``FLEET_CHAOS``): every
   request retires exactly once, its tokens (greedy and sampled) equal
   phase 4's, the peer logs ``router_hop`` records, replica 0 restarts,
   ``trace --check`` passes on the run's log.  11b: roles prefill,decode:
   each request prefills on A, its blocks leave at retirement
   (``export_blocks``) and land on B (``import_blocks``), which decodes;
   the exact wire's tokens equal phase 4's, the int8 wire's
   (``HETU_HANDOFF_QUANT=int8``) pass phase 7's margin gate; B's own
   launches (K1, layers x steps) run over the imported blocks; export
   and import ms and bytes for each wire.  11c: ``WeightSyncCoordinator``
   rolls v2 (the weights of ``--seed`` + 1) over both replicas under
   live traffic: each result equals its stamped version's engine, after
   the commit every replica is at v2 and its tokens equal a fresh v2
   engine's, no resident tensor's ``data_ptr()`` changed, swap ms; a
   push with one wrong shape is refused and leaves every replica's
   params' checksum as it was.  11d: pools of ``TIER_POOL_BLOCKS``
   blocks and ``HETU_KV_HOST_BYTES``: the shared 128-token prefix is
   evicted into the host ring (spills >= 1) and fetched back at a later
   admission (a counted fetch), the tokens equal phase 4's.

12. The graph surface (``hetu_tpu_torch.graph``): the causal LM of
   ``hetu_tpu_torch.train_long_context`` (``build_causal_lm``, the JAX
   example's graph) at the example's full width: S 4096, B 1, hidden
   768, 12 heads of 64, 4 layers, vocab 32000 (~81 M parameters), random
   weights from ``--seed``, the example's fixed token stream.  First,
   bf16 K2 and K3 at the shape the graph gives them ([1, 4096, 12, 64],
   causal), through ``FlashAttention`` as the graph calls it, against
   their plain versions (phase 8's bounds).  12a: the
   bf16 policy, flash attention, Adam 3e-4: one warm-up step and
   ``LC_STEPS`` timed steps (step ms, tokens/s, the graph's peak memory
   above what was live before its executor, the first
   and last loss: finite, the last below the first); every training
   step launches K2, K3 dK/dV and K3 dQ exactly once a layer (the
   executor runs each forward node once and answers its VJPOps from one
   autograd call); three more steps under torch.profiler give the
   device's busy share and its time by kernel kind.  12c: the subgraph ``[loss]`` without the optimizer
   on the same executor: ``training`` off, K2 once a layer, no K3,
   ``step`` unchanged.  12b: f32, one SGD step from 12a's weights
   through the flash graph (K2 + K3) and through the same graph built
   with ``--no-flash`` (the unfused chain, no kernel): the loss within
   1e-5 relative, each variable's update (lr 1: its gradient) within
   1e-4 of its largest, plus one f32 rounding of the new weight
   (phase 8's gradient bounds, from K2's 1e-5 and K3's 1e-4 + 1e-4 rel;
   k's bias, whose gradient is 0, to 1e-5 of the largest update).

13. BERT and the model zoo on the graph surface (``hetu_tpu_torch.models``).
   13-pre: f32 and bf16 K2, K3 dK/dV and K3 dQ at BERT-base's shape
   [8, 512, 12, 64], non-causal, kv_lens ``BERT_LENS`` (no tile divides
   them but the full one; a sequence of one live key), through
   ``FlashAttention`` and ``torch.autograd.grad`` as the graph calls
   them, against their plain versions (phase 12's bounds), dk and dv
   zero past kv_lens; each timed beside its bound over the live (q, k)
   pairs and SDPA with the boolean key-padding mask.  13a:
   ``BertForPreTraining`` at ``BertConfig.base`` (12 layers, hidden 768,
   12 heads, FFN 3072, vocab 30522, ~110 M parameters), B 8, S 512,
   hidden dropout 0.1, attention dropout 0, flash with kv_lens from the
   seed (S/4 to S, one full), the bf16 policy, AdamW 1e-4 (weight decay
   0.01): a warm-up step and ``BERT_STEPS`` timed ones on one synthetic
   MLM/NSP batch (step ms, tokens/s, the graph's peak memory, launches
   exactly 12 K2, 12 K3 dK/dV, 12 K3 dQ a step, the loss falling), then
   three profiled.  13b: f32, 4 layers, dropout 0, one SGD step from
   13a's weights, flash with kv_lens against the unfused graph under
   the additive attention mask (12b's bounds).  13c:
   ``BertMoEForPreTraining`` at ``examples/nlp/train_bert_moe.py``'s
   defaults (8 experts, top-1, capacity 1.0, MoE every 2nd of 12 blocks,
   B 8, S 128), flash with kv_lens, bf16 AdamW, ``MOE_STEPS`` steps:
   step ms, the summed balance loss, every MoE block's expert load
   summing to its tokens x k (kept min(load, capacity)), the loss
   falling.  13d: three f32 steps of ResNet-18 (B 128, 32 x 32),
   ``wdl_criteo`` (100000 features, embedding 128, B 128),
   ``neural_mf``, ``transformer_mt`` and ``moe_mlp`` with the top-k and
   the balanced-assignment gates, each at its example's defaults
   (``ZOO``): the loss finite and falling, the wall of each step.

14. Data, schedules, metrics and checkpoints.  14a: GPT-2-small at its
   published widths (12 x 768, 12 heads, vocab 50257), B 8, S 1024, f32,
   AdamW 3e-4 (weight decay 0.01, clip 1.0) under
   ``CosineScheduler(3e-4, total_steps=8, warmup_steps=2)`` set through
   the API, trained through ``train_gpt``'s ``--data-path`` route on a
   nanoGPT uint16 stream of 2^20 tokens written from ``--seed`` (runs of
   next = (3 t + 7) % 1009 from seeded starts): 8 steps uninterrupted
   (exactly 12 K2, 12 K3 dK/dV, 12 K3 dQ a step; the lr each step
   applied bit-equal to the scheduler's value; step ms, tokens/s, peak
   memory), then 4 steps, ``save``, a fresh executor, ``load``, 4 more:
   steps 5-8's losses and the final weights equal the uninterrupted
   run's bit for bit (a difference within 1e-6 relative is logged and
   passes; more fails); then ``--demo-generate 16``: greedy full
   forwards equal ``generate_fast``'s tokens (K2 for the prefill, K4 a
   layer a decode step, counted exactly).  14b: ``train_bert`` on
   ``tests/fixtures/tiny_corpus.txt`` with the GLUE fixtures' vocab at
   BERT-base widths, S 128, B 8, 10 steps, ``save``; then
   ``finetune_bert_glue`` on SST-2 at the same widths from that
   checkpoint (every backbone tensor loaded, counted against the
   backbone's variables; the loss falling; dev metrics from
   ``compute_metrics``) and ``finetune_bert_squad`` on
   ``train-tiny.json`` at S 384, doc stride 128 (the loss falling;
   exact match and F1 from ``squad_evaluate``), both at BERT's
   published fine-tuning rate ``BERT14["finetune_lr"]``.  14c:
   ``wdl_criteo`` at phase 13d's cell fed by three ``dataloader_op`` s
   over ``data.load_criteo`` of a Criteo-format ``train.txt`` written
   from ``--seed``: with ``prefetch`` on the batches arrive on the card
   through the ring; the losses with prefetch on and off are equal bit
   for bit; a mid-epoch save, a fresh build and ``load`` continue the
   batch stream exactly; step ms with prefetch on and off.

15. Pipeline and sharded training on the graph surface, BERT-base
   classifier (f32, S 512, B 16, SGD).  15-pre: f32 K2/K3 at 15a's
   microbatch shape against their plain versions.  15a: the plain
   executor against ``pipeline="gpipe"`` and ``"1f1b"`` over four stages
   of a virtual mesh (exact launches, losses and final tensors within
   rtol 2e-4, 1f1b's peak memory below gpipe's).  15b: ``FSDP`` dp 4 and
   a dp 2 x tp 2 ``ShardingPlan`` on virtual ranks, the graph built at
   the global batch (one evaluation a step; the plan's Megatron segments
   per tp rank, K2 and K3 launched on each rank's 6 heads, no gather),
   against plain; then f32 K2/K3 at the plan's per-rank shape [16, 512,
   6, 64] against their plain versions.  15c:
   ``DataParallel`` over a one-rank NCCL world bit-equal to plain; the
   int8 trio's all-gather through NCCL (int8 in its recorded collective
   sequence, bit-equal to the whole-value round trip).  15d: a BatchNorm
   MLP under a virtual ``DataParallel(2)`` equal to plain (1e-6), and
   BERT-base's SGD step under ``DataParallel(aggregate="int8")`` equal
   to plain within the codec's bound.  Step ms: medians after a warm-up
   step.

16. GPT on the graph surface: ``models.GPTForCausalLM`` at GPT-2-small's
   widths, B 8, S 1024, flash, phase 8's weights and first three
   batches: three AdamW steps in f32 (losses within 1e-5 relative of
   phase 8's ``nn.Module`` trainer's) and under ``mixed_precision=
   "bf16"``, each launching exactly 12 K2, 12 K3 dK/dV and 12 K3 dQ;
   step ms (median after the first) beside phase 8's; ``greedy_generate``
   on the graph equal to ``generate_fast`` (K2 + K4) on the trained
   weights; ``ServingEngine(ex.var_values, cfg)`` equal to
   ``generate_fast`` on four requests; ``serve_gpt``'s tiny model trained
   on the graph and served with and without ``spec=3``, the tokens
   equal.
17. Expert parallelism.  17a: phase 10's MoE GPT placed by
   ``ep_shard_params`` over ``make_mesh({"ep": 4})`` (a virtual mesh on
   the card; each rank's view holds a quarter of every expert stack)
   through the paged mixed engine on phase 4's requests, f32: exactly
   layers x steps K1 launches, every expert product run on one expert
   of four; greedy tokens equal phase 10's unsharded engine's, or first
   differ where the exact top-2 margin is at most 2 delta (delta the
   largest |placed - whole| teacher-forced logit over the sequence);
   expert load and drop equal phase 10's when the tokens are; the
   placed ``moe_ffn`` within 1e-6 relative of the whole on the run's
   first prompt wave; tok/s.  Then a one-rank NCCL ``DeviceMesh``:
   ``ProcessComm.all_to_all`` (f32 and int8), the placed ``moe_ffn`` and
   ``moe_ffn_ep_reference`` bit-equal to the virtual mesh's.  17b:
   ``moe_ffn_ep_reference`` at phase 10's widths, T 1024 tokens, virtual
   ep 4, capacity 8.0: f32 within 1e-4 of ``moe_ffn`` (JAX's bound); the
   int8 wire's bytes beside f32's, its error within ``EP_INT8_BOUND``
   of the output's largest |y|.  17c: ``train_gcn`` at Cora's published
   widths (2708 nodes, 1433 features, hidden 16, 7 classes) on an
   ``sbm_graph`` from the seed: 60 Adam epochs, the loss falling; the
   per-rank 1.5-D layer over a virtual dp 2 x tp 2 (on the trained
   first-layer weight) within 1e-5 + 1e-5 |z| of the whole-value
   executor's; three SGD steps over the mesh equal to the plain
   executor's.
18. Tensor parallelism.  18a: GPT-2-small placed by ``tp_shard_params``
   over ``make_mesh({"tp": 4})`` (a virtual mesh on the card, 3 heads of
   64 a rank) through the four engine configurations, paged mixed with
   ``spec=4`` and with an int8 cache, f32, on phase 4's requests: exact
   launches (each layer's kernel once per rank, every launch on [.., 3,
   64] heads), greedy tokens equal to the unplaced engine's of the same
   configuration (int8: phase 7's margin gate against phase 4), a
   rank's ``cache_bytes`` a quarter of the unplaced, tok/s and TTFT
   beside the unplaced; the placed and whole teacher-forced logits of
   the first prompt within 1e-5 relative; then a one-rank NCCL
   ``DeviceMesh``: the paged mixed engine and the logits bit-equal to
   the unplaced (or the reason printed and 1e-6).  18b: phase 16's graph
   GPT-2-small (B 8, S 1024, three AdamW steps, f32 and bf16) under
   ``ModelParallel4LM(tp=4)`` with JAX's GPT_TP_SPECS pattern over all
   12 layers: 48 K2, 48 K3 dK/dV and 48 K3 dQ a step, each K2 on [.., 3,
   64] heads, no gather of a split value; f32 losses within 2e-4
   relative of phase 16's plain executor and final tensors within 1e-6
   + 2e-4 |plain|; bf16's largest relative loss difference logged; step
   ms beside plain.  Each kernel 18a's engines launch (K1 on its mixed,
   decode and verify waves, K8 on its mixed and decode waves, K4, K5,
   K2, K1-int8 on its mixed and decode waves; f32 q) and 18b's K2/K3
   (f32 and bf16, [8, 1024, 3, 64]) against their plain versions at a
   rank's 3 heads, as phases 2, 7 and 8 hold them at 12; the kernels
   line's 18a, 18b and 15b rows carry these numbers.

With ``--profile DIR`` three more training steps of each dtype run under
torch.profiler in phase 8 (``train_gpt.profile_steps``), and after the
checks each serving configuration is run again under it (without and
with speculation, and with an int8 cache); device time by kernel goes
into DIR.

The line before the last is one JSON object with every kernel's
numbers (``dev_ms`` its device time per call under torch.profiler,
without the wrapper's host time, held to half the CUDA-event time of
the call queued behind a sleep kernel at least, or "not measured"); the
last line is the device record.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# flop/s by operand type (f32 on the CUDA cores, bf16 on tensor cores)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# the f32 flash kernels (K2, K2-carry and K3's two) run each f32 product
# as three TF32 products on the tensor cores (495 TFLOP/s): their least
# time for the same work counts 3 x the flops at that rate
TF32X3 = (3, 495e12)
# kernel vs plain version, element by element: |got - want| <= atol +
# rtol * |want|.  Both sides accumulate in f32; in bf16 both round their
# f32 result to bf16, which may land one bf16 ulp (<= 2^-7 of the value)
# apart.  The outputs here are ~0.05-4 in magnitude.
TOL = {"float32": (1e-5, 0.0), "bfloat16": (2.0 ** -12, 2.0 ** -7)}
LSE_TOL = 1e-4          # the f32 logsumexp, both dtypes
# The bf16 flash forward (K2, K2-carry) against its plain version: the
# kernel rounds P = exp(s - m) to bf16 against its running max at each
# key tile, the plain version against the row's final max, so each
# element of o may differ by fa.bf16_rounding_bound (2^-7 sum(p |v_d|) /
# l of its row: each rounding is within 2^-8 of p) plus TOL's f32 atol
# (the sums and exp in another order) before its own rounding to bf16,
# one more ulp (rtol 2^-7).  Masks show in the lse (LSE_TOL).  f32 keeps
# TOL.


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------- #
# timing
# ---------------------------------------------------------------- #


def time_ms(torch, fn, reps=20, warm=3):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after ``warm``
    warm-up calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_run_ms(torch, fn, n=10, reps=5, warm=2):
    """Median over ``reps`` of the CUDA-event time of ``n`` back-to-back
    calls of ``fn()``, divided by ``n``: the device time of one call
    once the host runs ahead of the card (time_ms, one call between its
    events, also counts the host's launch work when the card waits for
    it)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def queued_ms(torch, fn, n=10):
    """The CUDA-event time of one call of ``fn()`` with the host ahead of
    the card: a sleep kernel holds the stream while ``n`` calls are
    queued, each between two events, so each pair times the call's
    kernels and the gaps between them, not the host's launch work;
    the median over the calls."""
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(int(2e7))
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


def device_ms(torch, fn, n=10):
    """The device time of one call of ``fn()``: under torch.profiler over
    ``n`` calls, each kernel's mean time times its launches per call
    (its count over ``n``, at least one), summed over the kernels (host
    time and the gaps between kernels excluded).  A kernel whose count
    is not a multiple of ``n`` lost events in the profiler: the mean of
    the events it kept stands for it, and the loss is logged.  The sum is
    held to the call's CUDA-event time with the host ahead (``queued_ms``,
    the kernels plus their gaps): a window that reads under half of it
    lost events (or recorded no device time at all), is logged with each
    kernel's profiled time per call beside the event time, and is
    profiled again, up to three windows; after three such windows the
    device time is not measured: None, logged, and printed as "not
    measured" (the profiler loses events in long runs on this card; the
    kernel's other times and its checks stand)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    event_ms = queued_ms(torch, fn, n)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kinds = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or not e.count:
                continue
            if e.count % n:
                log(f"    (the profiler kept {e.count} events of "
                    f"{e.key[:60]} over {n} calls)")
            kinds[e.key] = (e.self_device_time_total / e.count
                            * max(1, round(e.count / n)) / 1e3)
        total = sum(kinds.values())
        if total >= 0.5 * event_ms:
            return total
        log(f"    (the profiler read {total:.4f} ms a call, under half the "
            f"call's CUDA-event time {event_ms:.4f} ms: "
            + ("; ".join(f"{k[:60]} {v:.4f} ms" for k, v in kinds.items())
               or "no device time")
            + "; profiling again)")
    log(f"    (the profiler read under half the CUDA-event time "
        f"{event_ms:.4f} ms in three windows: the device time is not "
        f"measured)")
    return None


def ms_text(x):
    """A time in ms as the logs print it, or "not measured" (None)."""
    return "not measured" if x is None else f"{x:.4f}"


def compare(got, want, dtype):
    """(max abs error, True when every element is within TOL[dtype])."""
    err, _, ok = close(got, want, *TOL[dtype])
    return err, ok


def flash_compare(got, want, q, k, v, dtype, *, causal, kv_lens=None,
                  lse_c=None, rtol=None):
    """compare() for the flash forward (with ``lse_c``, the carried one):
    atol TOL's f32 atol in both dtypes, plus fa.bf16_rounding_bound of
    (q, k, v) in bf16; rtol TOL's (or the given one).  Returns (max abs
    error, the largest error over its bound, ok)."""
    from hetu_tpu_torch.kernels import flash_attention as fa
    atol, rt = TOL["float32"][0], TOL[dtype][1]
    if dtype == "bfloat16":
        atol = atol + fa.bf16_rounding_bound(q, k, v, causal=causal,
                                             kv_lens=kv_lens, lse_c=lse_c)
    return close(got, want, atol, rt if rtol is None else rtol)


def close(got, want, atol, rtol):
    """(max abs error, the largest |got - want| / (atol + rtol * |want|),
    True when every element is finite and within its bound); atol may
    be a tensor of want's shape."""
    got, want = got.detach().float(), want.detach().float()
    diff = (got - want).abs()
    lim = atol + rtol * want.abs()
    ok = bool(got.isfinite().all() and (diff <= lim).all())
    return float(diff.max()), float((diff / lim).max()), ok


def bound(nbytes, flops, dtype, method=None):
    """(least ms, "bytes" or "operations"): the larger of the bytes at
    HBM_BYTES_S and the flops at the dtype's peak, or with ``method`` =
    (passes, rate) passes x the flops at that rate (the f32 flash
    kernels: ``TF32X3``)."""
    passes, rate = method or (1, PEAK_FLOPS[dtype])
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = passes * flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tf32_method(dtype):
    """The bound's method of the flash kernels (K2, K2-carry, K3) in
    ``dtype``: f32 runs each product as three TF32 products."""
    return TF32X3 if dtype == "float32" else None


# ---------------------------------------------------------------- #
# phase 1: the tensor-core kernels' build report
# ---------------------------------------------------------------- #

# the tensor-core libraries and their kernels (symbol substring, entry
# of the dynamic shared memory query and its arguments after Dh, and a
# regular expression the instances' mangled names must match, one at
# least; the bf16 ragged, decode and verify kernels' query also takes
# the cache, 1 for int8): the f32 flash forward, the f32 wide ragged
# kernel (f32 K1 over the pool, f32 K8 over slot rows, and the f32-q
# int8 twins of both, its own library) and K3's two f32 kernels on TF32,
# then the bf16 kernels (K2 and K2-carry fed by TMA); the split kernel of
# decode_attention_bf16 once for K4/K5 and K4-int8/K5-int8 (DecodeLim),
# once more for K4-int8/K5-int8 alone (int8, "a"), once for K6/K7,
# K6-int8 and K7-int8 (VerifyLim) and once more for K6-int8 alone (int8
# over SlotRows); last the f32 split kernel of the narrow waves, which
# runs on the CUDA cores, once for f32 K1 (TableRows), once for f32 K8
# (SlotRows), once each for f32-q K1-int8 and K8-int8 (its own library),
# once each for f32 K4/K5 (DecodeLim) and K6/K7 (VerifyLim,
# decode_attention) and once each for f32-q K4-int8/K5-int8 (DecodeLim)
# and K6-int8/K7-int8 (VerifyLim, decode_attention_int8): its SASS must
# show FFMA and no HMMA or HGMMA (``FFMA_KERNELS``)
TC_KERNELS = (("flash_fwd", "flash_fwd_f32_kernel",
               "hetu_flash_fwd_smem", (), ""),
              ("ragged_paged", "ragged_tf32_kernel",
               "hetu_ragged_tf32_smem", (), "TableRows"),
              ("ragged_paged", "ragged_tf32_kernel",
               "hetu_ragged_tf32_smem", (), "SlotRows"),
              ("ragged_paged_int8", "ragged_tf32_kernel",
               "hetu_ragged_tf32_smem", (), r"ILi\d+Ea.*TableRows"),
              ("ragged_paged_int8", "ragged_tf32_kernel",
               "hetu_ragged_tf32_smem", (), r"ILi\d+Ea.*SlotRows"),
              ("flash_bwd", "flash_bwd_dkv_kernel",
               "hetu_flash_bwd_smem", (1,), ""),
              ("flash_bwd", "flash_bwd_dq_kernel",
               "hetu_flash_bwd_smem", (0,), ""),
              ("flash_fwd_bf16", "flash_fwd_bf16_kernel",
               "hetu_flash_fwd_bf16_smem", (), ""),
              ("flash_bwd_bf16", "flash_bwd_dkv_bf16_kernel",
               "hetu_flash_bwd_bf16_smem", (1,), ""),
              ("flash_bwd_bf16", "flash_bwd_dq_bf16_kernel",
               "hetu_flash_bwd_bf16_smem", (0,), ""),
              ("ragged_paged_bf16", "ragged_wide_kernel",
               "hetu_ragged_bf16_smem", (0,), ""),
              ("ragged_paged_bf16", "split_kv_kernel",
               "hetu_ragged_bf16_smem", (1,), ""),
              ("decode_attention_bf16", "split_kv_kernel",
               "hetu_verify_bf16_smem", (), "DecodeLim"),
              ("decode_attention_bf16", "split_kv_kernel",
               "hetu_verify_bf16_smem", (), r"ILi\d+Ea.*DecodeLim"),
              ("decode_attention_bf16", "split_kv_kernel",
               "hetu_verify_bf16_smem", (), "VerifyLim"),
              ("decode_attention_bf16", "split_kv_kernel",
               "hetu_verify_bf16_smem", (),
               r"ILi\d+EaNS_8SlotRows.*VerifyLim"),
              ("ragged_paged", "split_kv_f32_kernel",
               "hetu_ragged_f32_smem", (), "TableRows"),
              ("ragged_paged", "split_kv_f32_kernel",
               "hetu_ragged_f32_smem", (), "SlotRows"),
              ("ragged_paged_int8", "split_kv_f32_kernel",
               "hetu_ragged_f32_smem", (), r"ILi\d+Ea.*TableRows"),
              ("ragged_paged_int8", "split_kv_f32_kernel",
               "hetu_ragged_f32_smem", (), r"ILi\d+Ea.*SlotRows"),
              ("decode_attention", "split_kv_f32_kernel",
               "hetu_decode_f32_smem", (), "DecodeLim"),
              ("decode_attention", "split_kv_f32_kernel",
               "hetu_decode_f32_smem", (), "VerifyLim"),
              ("decode_attention_int8", "split_kv_f32_kernel",
               "hetu_decode_f32_smem", (), "DecodeLim"),
              ("decode_attention_int8", "split_kv_f32_kernel",
               "hetu_decode_f32_smem", (), "VerifyLim"))
# the kernels of TC_KERNELS that run on the CUDA cores, by symbol
FFMA_KERNELS = ("split_kv_f32_kernel",)
# the kernels that must show TF32 HMMA: the f32 flash forward and
# backward, and the f32 wide ragged kernel (f32 K1/K8 and their f32-q
# int8 twins at Q > 16)
TF32_KERNELS = ("flash_fwd_f32_kernel", "flash_bwd_dkv_kernel",
                "flash_bwd_dq_kernel", "ragged_tf32_kernel")
# the kernels that must load by TMA (UTMALDG): bf16 K2 and K2-carry
TMA_KERNELS = ("flash_fwd_bf16_kernel",)


def ptxas_entries(log):
    """{mangled kernel name: (registers, spill stores, spill loads)} from
    an ``nvcc -Xptxas -v`` log."""
    out, name, spills = {}, None, (None, None)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)),) + spills
            name = None
    return out


def sass_mma_counts(lib_path):
    """{mangled kernel name: (HMMA, HGMMA, TF32 HMMA, FFMA, UTMALDG
    instruction count)} from ``cuobjdump -sass``, or None where the
    toolkit has no cuobjdump."""
    import os
    import shutil
    cands = [shutil.which("cuobjdump")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(str(Path(os.environ[env]) / "bin" / "cuobjdump"))
    cands.append("/usr/local/cuda/bin/cuobjdump")
    tool = next((c for c in cands if c and Path(c).is_file()), None)
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0, 0, 0, 0]
        elif name and re.search(r"\bUTMALDG\b", line):
            out[name][4] += 1
        elif name and re.search(r"\bHGMMA\b", line):
            out[name][1] += 1
        elif name and re.search(r"\bHMMA\b", line):
            out[name][0] += 1
            out[name][2] += "TF32" in line
        elif name and re.search(r"\bFFMA\b", line):
            out[name][3] += 1
    return {k: tuple(v) for k, v in out.items()}


def tc_report(_build, paths):
    """One line per instance of a tensor-core kernel (f32 K2 and
    K2-carry, the f32 wide ragged kernel of f32 K1/K8 and of their f32-q
    int8 twins and f32 K3's two on TF32, bf16 K2 and K2-carry, bf16 K3's
    two, the wide and split ragged kernels of K1/K8 and of their int8
    twins, the split kernel of K4-K7 and of their int8 twins) and of the
    f32 split kernel of f32 K1, f32 K8, f32 K4-K7 and f32-q K1-int8,
    K8-int8 and K4-int8 to K7-int8 on the CUDA cores: registers and
    spills (ptxas, from this process's build), dynamic shared memory,
    and the HMMA (TF32
    among them) / HGMMA / FFMA / UTMALDG instructions of its SASS; fails
    when a tensor-core instance has no tensor-core instruction, when a
    ``TF32_KERNELS`` instance has no TF32 one, when a ``TMA_KERNELS``
    instance has no TMA load, when a CUDA-core instance
    (``FFMA_KERNELS``) has a tensor-core instruction or no FFMA, when it
    spills, or when a row of ``TC_KERNELS`` has no instance in the
    SASS; then ``no_decode_body`` over every library's SASS."""
    sass = {}
    for lib_name, sym, smem_fn, extra, kind in TC_KERNELS:
        if lib_name not in sass:
            sass[lib_name] = sass_mma_counts(paths[lib_name])
        regs = ptxas_entries(_build.BUILD_LOG.get(lib_name, ""))
        lib = _build.library(lib_name)
        names = sorted(n for n in (sass[lib_name] or regs)
                       if sym in n and re.search(kind, n))
        if sass[lib_name] is not None and not names:
            fail(f"{lib_name}: no {sym} instance {kind} in its SASS")
        for name in names:
            m = re.search(sym + r"ILi(\d+)E(?:Lb([01])E)?", name)
            D = int(m.group(1))
            carry = m.group(2) == "1"
            # the cache element type follows D in the ragged kernels'
            # template arguments: signed char (mangled "a") for int8
            int8 = bool(re.search(sym + r"ILi\d+Ea", name))
            by_cache = lib_name in ("ragged_paged_bf16",
                                    "decode_attention_bf16")
            smem = getattr(lib, smem_fn)(D, *extra,
                                         *((int(int8),) if by_cache else ()))
            what = "".join((", carry" if carry else "",
                            ", decode" if "DecodeLim" in name else "",
                            ", verify" if "VerifyLim" in name else "",
                            ", int8" if int8 else "",
                            ", pool" if "TableRows" in name else "",
                            ", slots" if "SlotRows" in name else ""))
            r = regs.get(name)
            ptx = (f"{r[0]} registers, spill stores {r[1]} B, loads {r[2]} B"
                   if r else "not rebuilt in this process")
            mma = sass[lib_name]
            count = (f"HMMA {mma[name][0]} (TF32 {mma[name][2]}), HGMMA "
                     f"{mma[name][1]}, FFMA {mma[name][3]}, UTMALDG "
                     f"{mma[name][4]}"
                     if mma is not None else "no cuobjdump")
            ffma = sym in FFMA_KERNELS
            log(f"  {'CUDA' if ffma else 'tensor'} cores: {sym}<D {D}"
                f"{what}>: {ptx}, dynamic shared {smem} B; SASS {count}")
            if mma is not None and ffma and (mma[name][0] + mma[name][1]
                                             or not mma[name][3]):
                fail(f"{name} is not FFMA-only: {count}")
            if mma is not None and not ffma and mma[name][0] + mma[name][1] \
                    == 0:
                fail(f"{name} has no HMMA or HGMMA instruction")
            if mma is not None and sym in TF32_KERNELS \
                    and mma[name][2] == 0:
                fail(f"{name} has no TF32 HMMA instruction")
            if mma is not None and sym in TMA_KERNELS and mma[name][4] == 0:
                fail(f"{name} has no TMA load (UTMALDG)")
            if r and (r[1] or r[2]):
                fail(f"{name} spills: {r[1]} B stores, {r[2]} B loads")
    for lib_name in paths:
        if lib_name not in sass:
            sass[lib_name] = sass_mma_counts(paths[lib_name])
    no_decode_body(sass)


def no_decode_body(sass):
    """Every decode and verify kernel runs a split-K body: fails if the
    SASS of any library (``sass``: library -> ``sass_mma_counts``) holds
    an instance of the retired one-block-per-slot body,
    ``decode_kernel``."""
    if any(v is None for v in sass.values()):
        log("  decode_kernel instances: no cuobjdump")
        return
    found = sorted(f"{lib}: {n}" for lib, names in sass.items()
                   for n in names if "decode_kernel" in n)
    if found:
        fail(f"decode_kernel instances in the SASS: {found}")
    log(f"  decode_kernel instances: none in the {len(sass)} libraries")


def tma_map_us(_build, n=1000):
    """The host time of the three tensor maps bf16 K2 and K2-carry build
    on each call (``hetu_flash_fwd_bf16_map_us``: cuTensorMapEncodeTiled
    at the training shape over a device buffer, which it does not read;
    mean of ``n``), in microseconds; fails if the driver refuses them."""
    import ctypes

    import torch
    fn = _build.library("flash_fwd_bf16").hetu_flash_fwd_bf16_map_us
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_double
    buf = torch.empty(16, dtype=torch.bfloat16, device="cuda")
    us = fn(buf.data_ptr(), n)
    if us < 0:
        fail("cuTensorMapEncodeTiled refused bf16 K2's tensor maps")
    return us


# ---------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------- #

# main-path head shapes (GPT-2-small), pool block and table width, and
# the slot lengths of the 8-slot waves below: a full row, a long prompt,
# short ones, a length-0 slot and a single position
H, DH, BS, T_WIDTH = 12, 64, 16, 64
LENGTHS = np.array([1024, 600, 37, 0, 1, 300, 512, 129], np.int32)
# the 8 slots of a decode wave at short lengths, each within one
# 128-position split (the split body's fixed cost and its merge's
# launch weigh most there), slot 3 again of length 0
SHORT_LENGTHS = np.array([127, 64, 37, 0, 1, 100, 128, 16], np.int32)


def pool_case(torch, dtype, seed, Dh=DH, lengths=LENGTHS, heads=H):
    """The 8 slots of ``lengths`` in a permuted block pool [N, 16,
    heads, Dh], slots 1 and 6 sharing their first blocks, up to 8 (a prefix of
    up to 128 positions); dead table entries at scratch block 0.
    Returns the pools, the host tables and the count of distinct pool
    rows some slot's length reaches (each read once: a shared row
    once)."""
    B = len(lengths)
    rng = np.random.default_rng(seed)
    need = [-(-int(n) // BS) for n in lengths]
    n_blocks = 1 + sum(need)
    free = list(rng.permutation(np.arange(1, n_blocks)))
    tables = np.zeros((B, T_WIDTH), np.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = free.pop()
    shared = min(8, need[1], need[6])
    tables[6, :shared] = tables[1, :shared]    # a shared prefix
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    pool_k, pool_v = (torch.randn((n_blocks, BS, heads, Dh), generator=g,
                                  device="cuda").to(dt) for _ in range(2))
    rows = {(int(tables[b, p // BS]), p % BS) for b in range(B)
            for p in range(int(lengths[b]))}
    return pool_k, pool_v, tables, len(rows)


def slot_rows_case(torch, dtype, seed, heads=H):
    """Slot-contiguous caches [8, 1024, heads, 64] of random K/V."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn((len(LENGTHS), 1024, heads, DH), generator=g,
                             device="cuda").to(dt) for _ in range(2))


def ragged_flops(lengths, q_lens, Q, heads=H):
    """Score and PV flops of a ragged wave: every row of every slot with
    a length, dead rows at their clipped positions."""
    flops = 0
    for n, ql in zip(lengths, q_lens):
        if n == 0:
            continue
        posq = np.clip(n - ql + np.arange(Q), 0, n - 1)
        flops += int(4 * (posq + 1).sum() * heads * DH)
    return flops


def length_mask(torch, lengths, q_lens, Q, span):
    """[B, 1, Q, span] bool: the ragged kernels' live keys per row (a
    length-0 slot keeps position 0, so the yardstick's softmax has a
    key), for the SDPA yardstick."""
    L = torch.from_numpy(lengths).cuda().long()
    ql = torch.from_numpy(q_lens).cuda().long()
    posq = torch.minimum(torch.clamp(
        (L - ql)[:, None] + torch.arange(Q, device="cuda")[None], min=0),
        torch.clamp(L - 1, min=0)[:, None])
    return (torch.arange(span, device="cuda")[None, None, :]
            <= posq[:, :, None])[:, None]


def int8_kv(torch, k, v):
    """Phase 2's f32 K/V encoded on the card by ``quant.kv_encode``, held
    to the CPU encoding exactly (payload and scales): ((k payload, k
    scales), (v payload, v scales))."""
    from hetu_tpu_torch.quant import kv_encode
    out = []
    for x in (k, v):
        q, s = kv_encode(x)
        qc, sc = kv_encode(x.cpu())
        if not (torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)):
            fail("kv_encode on the card differs from the CPU encoding")
        out.append((q, s))
    return out


def kv_operands(torch, k, v, dtype, int8):
    """A float K/V pair of ``dtype`` or, with ``int8``, its encoding:
    (k, v), the wrapper's keyword scales, the plain version's trailing
    scale arguments, the dense (dequantized) K/V for the SDPA yardstick
    (the dequantization not timed), and the bytes one (position, head)
    row of K and V takes."""
    dt = getattr(torch, dtype)
    if not int8:
        k, v = k.to(dt), v.to(dt)
        return (k, v), {}, (), (k, v), 2 * DH * k.element_size()
    from hetu_tpu_torch.quant import kv_decode
    (kq, ks), (vq, vs) = int8_kv(torch, k, v)
    dense = (kv_decode(kq, ks).to(dt), kv_decode(vq, vs).to(dt))
    return ((kq, vq), dict(k_scale=ks, v_scale=vs), (ks, vs), dense,
            2 * (DH + 4))


def heads_label(heads):
    """A check's label suffix for a head count other than the model's
    (a tensor-parallel rank's)."""
    return "" if heads == H else f" [{heads} heads]"


def measure(torch, label, dtype, run, plain, library, nbytes, flops,
            dead=3, rounding=None, b2b=False, method=None):
    """Hold ``run()`` (the kernel) to ``plain()`` element by element,
    check that slot ``dead`` (length 0) is zero, and time the kernel,
    its plain version and the ``library()`` yardstick beside the
    bound.  ``rounding()`` (bf16 only) adds the per-element bound of a
    rounding of P the plain version does not make to TOL's atol, and
    the largest err / (atol + rtol*|want|) is logged; ``b2b`` also
    times ten back-to-back kernel calls (``run_ms``) and the kernels'
    device time per call (``dev_ms``, ``device_ms``); ``method`` is the
    bound's (``bound``: ``TF32X3`` for a kernel on three TF32 passes)."""
    got = run()
    torch.cuda.synchronize()
    want = plain().to(got.dtype)
    atol, rtol = TOL[dtype]
    with_bound = rounding is not None and dtype == "bfloat16"
    if with_bound:
        atol = atol + rounding()
    err, ratio, ok = close(got, want, atol, rtol)
    tol = (f"atol + rtol*|want|, (atol, rtol) = {TOL[dtype]}"
           + (" + ragged_rounding_bound" if with_bound else ""))
    if not ok:
        fail(f"{label} {dtype}: max abs err {err}, largest err / bound "
             f"{ratio}, past {tol}")
    if got[dead].abs().max() != 0:
        fail(f"{label}: zero-length slot not zero")
    ms = time_ms(torch, run)
    run_ms = time_run_ms(torch, run) if b2b else None
    dev = device_ms(torch, run) if b2b else None
    plain_ms = time_ms(torch, plain, reps=5)
    lib_ms = time_ms(torch, library)
    b_ms, b_by = bound(nbytes, flops, dtype, method)
    log(f"  {label} {dtype}: max_abs_err {err:.3e}, largest err / bound "
        f"{ratio:.4f} (within {tol}); kernel {ms:.4f} ms"
        + (f" ({run_ms:.4f} back to back, {ms_text(dev)} on the device)"
           if b2b else "")
        + f", plain {plain_ms:.4f} ms, SDPA yardstick {lib_ms:.4f} ms; "
        f"bound {b_ms:.4f} ms by {b_by} ({nbytes} B, {flops} flop"
        f"{', 3 TF32 passes' if method == TF32X3 else ''})")
    return dict(err=err, ratio=ratio, ms=ms, run_ms=run_ms, dev_ms=dev,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


# the verify wave of phase 2: Q = spec 4 + 1, each slot's live rows
VERIFY_QLENS = np.array([5, 5, 3, 0, 1, 5, 2, 5], np.int32)
# K1's and K8's waves over the 8 slots of LENGTHS, (Q, q_lens): their
# mixed waves (K1: prompt chunks of 256 beside decode and verify rows;
# K8: a 600-token prompt at its pow2 bucket 1024), and for both a
# decode wave (Q 1, q_len 1 on every slot with a length: most of a
# serving run's waves) and a verify wave (Q 8, the pow2 bucket of
# VERIFY_QLENS, spec 4)
MIXED_WAVES = {"K1": (256, np.array([256, 1, 5, 0, 1, 256, 1, 5], np.int32)),
               "K8": (1024, np.array([1, 600, 1, 0, 1, 300, 1, 1], np.int32))}
NARROW_WAVES = {"decode": (1, (LENGTHS > 0).astype(np.int32)),
                "verify": (8, VERIFY_QLENS)}


# bf16 q over an int8 cache rounds p times the V scale to bf16 once
# (the kernels before the split of that product, as kernel_times.py
# meets them in an older checkout): bf16 K1-int8/K8-int8 are then held
# to TOL plus ragged_rounding_bound of the dequantized cache; this
# checkout's kernels hold TOL alone
INT8_ROUNDS_P = False


def int8_rounding(int8, bound):
    """The ``rounding`` of ``measure`` for bf16 K1/K8 and their int8
    twins: ``bound`` over a bf16 cache, none over an int8 one (unless
    ``INT8_ROUNDS_P``)."""
    return bound if not int8 or INT8_ROUNDS_P else None


def ragged_method(dtype, wave):
    """The bound's method of K1/K8 and their int8 twins on ``wave``: f32
    q's mixed waves (Q > 16) run three TF32 passes (``TF32X3``), the
    narrow ones and bf16 q one pass."""
    return TF32X3 if dtype == "float32" and wave == "mixed" else None


def wave_of(kernel, wave):
    """(Q, q_lens, label suffix) of ``kernel``'s wave ``wave``: "mixed",
    or one of ``NARROW_WAVES``."""
    if wave == "mixed":
        return (*MIXED_WAVES[kernel], "")
    Q, q_lens = NARROW_WAVES[wave]
    return Q, q_lens, f" {wave} Q {Q}"


def check_k1(torch, F, dtype, seed, int8=False, wave="mixed", heads=H):
    """K1 on a wave of the 8 pool slots (``wave_of``: the mixed
    wave has q_len in {0, 1, 5, 256}, Q 256); with ``int8`` K1-int8 over
    the f32 pool's encoding, q of ``dtype``; ``heads`` per position (a
    tensor-parallel rank's H/tp).  bf16 over a bf16 pool adds
    ``ragged_rounding_bound`` to TOL (the kernel rounds P, as the Pallas
    body does there); over an int8 pool TOL alone (neither rounds P).  Yardstick: SDPA over the pre-gathered dense (with ``int8``,
    dequantized) view with the equivalent mask (the gather itself
    excluded)."""
    from hetu_tpu_torch.kernels import ragged_attention as ra
    pool_k, pool_v, tables, n_rows = pool_case(
        torch, "float32" if int8 else dtype, seed, heads=heads)
    (pool_k, pool_v), sc, sc_plain, dense, row_bytes = kv_operands(
        torch, pool_k, pool_v, dtype, int8)
    Q, q_lens, suffix = wave_of("K1", wave)
    B = len(LENGTHS)
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    q = torch.randn((B, Q, heads, DH), generator=g,
                    device="cuda").to(getattr(torch, dtype))
    args = (q, pool_k, pool_v, torch.from_numpy(LENGTHS).cuda(),
            torch.from_numpy(q_lens).cuda(), torch.from_numpy(tables).cuda())
    idx = args[5].long()
    span = T_WIDTH * BS
    kd, vd = (x[idx].reshape(B, span, heads, DH).transpose(1, 2)
              for x in dense)
    qd = q.transpose(1, 2)
    mask = length_mask(torch, LENGTHS, q_lens, Q, span)
    # bytes the function must move: q of the slots with a length (a
    # length-0 slot outputs zeros unread), o in full, each pool row some
    # slot's length reaches once (with int8 its scales too), the table
    # entries of those blocks, lengths and q_lens
    es = q.element_size()
    n_tab = int(sum(-(-int(n) // BS) for n in LENGTHS))
    nbytes = (int((LENGTHS > 0).sum()) * Q * heads * DH * es
              + q.numel() * es + n_rows * heads * row_bytes + 4 * n_tab
              + LENGTHS.nbytes
              + q_lens.nbytes)
    return measure(
        torch, f"K1{'-int8' if int8 else ''} ragged_paged_attention{suffix}"
        + heads_label(heads),
        dtype, lambda: ra.ragged_paged_attention(*args, **sc),
        lambda: ra.ragged_paged_reference(*args, *sc_plain),
        lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
        nbytes, ragged_flops(LENGTHS, q_lens, Q, heads)
        + (2 * n_rows * heads * DH if int8 else 0),
        rounding=int8_rounding(
            int8, lambda: ra.ragged_rounding_bound(*args, **sc)),
        b2b=True, method=ragged_method(dtype, wave))


def check_k8(torch, F, dtype, seed, int8=False, wave="mixed", heads=H):
    """K8 on a wave of the 8 slot rows (``wave_of``: the mixed wave
    has a wide prompt q-block, a 600-token prompt at Q 1024, its pow2
    bucket, a 300-token prompt, decode tokens, a length-0 slot); with
    ``int8`` K8-int8 over the f32 rows' encoding; bf16 over bf16 rows
    within TOL plus ``ragged_rounding_bound``, over int8 rows within TOL
    alone, as ``check_k1``; ``heads`` per position.  Yardstick: SDPA over
    the (dequantized) slot rows with the equivalent mask."""
    from hetu_tpu_torch.kernels import ragged_attention as ra
    k, v = slot_rows_case(torch, "float32" if int8 else dtype, seed + 7,
                          heads)
    (k, v), sc, sc_plain, dense, row_bytes = kv_operands(torch, k, v,
                                                         dtype, int8)
    Q, q_lens, suffix = wave_of("K8", wave)
    B = len(LENGTHS)
    g = torch.Generator(device="cuda").manual_seed(seed + 8)
    q = torch.randn((B, Q, heads, DH), generator=g,
                    device="cuda").to(getattr(torch, dtype))
    args = (q, k, v, torch.from_numpy(LENGTHS).cuda(),
            torch.from_numpy(q_lens).cuda())
    qd, kd, vd = (x.transpose(1, 2) for x in (q, *dense))
    mask = length_mask(torch, LENGTHS, q_lens, Q, k.shape[1])
    es = q.element_size()
    nbytes = (int((LENGTHS > 0).sum()) * Q * heads * DH * es
              + q.numel() * es + int(LENGTHS.sum()) * heads * row_bytes
              + LENGTHS.nbytes
              + q_lens.nbytes)
    r = measure(
        torch, f"K8{'-int8' if int8 else ''} ragged_attention{suffix}"
        + heads_label(heads),
        dtype, lambda: ra.ragged_attention(*args, **sc),
        lambda: ra.ragged_masked_reference(*args, *sc_plain),
        lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
        nbytes, ragged_flops(LENGTHS, q_lens, Q, heads)
        + (2 * int(LENGTHS.sum()) * heads * DH if int8 else 0),
        rounding=int8_rounding(
            int8, lambda: ra.ragged_rounding_bound(*args, **sc)),
        b2b=True, method=ragged_method(dtype, wave))
    if int8 or wave != "mixed" or heads != H:
        return r
    # the dead-row cost: the same slots with no dead row, each prompt
    # slot launched at Q = its q_len and the decode slots at Q = 1
    waves = []
    for rows, width in (([1], 600), ([5], 300), ([0, 2, 4, 6, 7], 1)):
        idx = torch.tensor(rows, device="cuda")
        waves.append((q[idx, :width].contiguous(), k[idx].contiguous(),
                      v[idx].contiguous(), args[3][idx].contiguous(),
                      args[4][idx].contiguous()))
    live_ms = device_ms(torch, lambda: [ra.ragged_attention(*w)
                                        for w in waves])
    if live_ms is not None and r["dev_ms"] is not None:
        log(f"  K8 {dtype}: the same slots without dead rows (three "
            f"launches at Q = 600, 300, 1) {live_ms:.4f} ms on the device "
            f"against {r['dev_ms']:.4f} ms for the Q 1024 wave: dead rows "
            f"take {1 - live_ms / r['dev_ms']:.1%} of the wave's device "
            f"time")
    return r


def check_decode(torch, F, dtype, seed, paged, verify=False, int8=False,
                 lengths=None, heads=H):
    """The 8 slots of ``LENGTHS`` (or ``lengths``, a decode wave's:
    ``SHORT_LENGTHS``) through the tables of the pool (K5, or with
    ``verify`` K7), else over slot rows (K4, or K6): one query per slot,
    or with ``verify`` a Q-5 verify block of q_lens ``VERIFY_QLENS``
    (dead rows included in the comparison); with ``int8`` the int8 twin
    over the f32 K/V's encoding, q of ``dtype``; ``heads`` per position.
    bf16 K4-K7 over a bf16 cache add ``ragged_rounding_bound`` to TOL
    (they round P as bf16 K1/K8 do); every kernel is also timed back to
    back and on the device.  Yardstick: SDPA with a per-query length
    mask over the pre-gathered (dequantized) view (the gather excluded)
    or the slot rows."""
    from hetu_tpu_torch.kernels import decode_attention as da
    short = lengths is not None
    L = lengths if short else LENGTHS
    B = len(L)
    q_lens = VERIFY_QLENS if verify else np.ones(B, np.int32)
    Q = int(q_lens.max())
    seed += 3 if verify else 0
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Q, heads, DH), generator=g,
                    device="cuda").to(dt)
    if not verify:
        q = q[:, 0]
    lens = torch.from_numpy(L).cuda()
    extra = (torch.from_numpy(q_lens).cuda(),) if verify else ()
    es = q.element_size()
    kv_dtype = "float32" if int8 else dtype
    if paged:
        pool_k, pool_v, tables, n_rows = pool_case(torch, kv_dtype,
                                                   seed + 10, lengths=L,
                                                   heads=heads)
        (pool_k, pool_v), sc, sc_plain, dense, row_bytes = kv_operands(
            torch, pool_k, pool_v, dtype, int8)
        tab = torch.from_numpy(tables).cuda()
        args = (q, pool_k, pool_v, lens) + extra + (tab,)
        kd, vd = (x[tab.long()].reshape(B, T_WIDTH * BS, heads, DH)
                  for x in dense)
        n_tab = int(sum(-(-int(n) // BS) for n in L))
        kv_bytes = n_rows * heads * row_bytes + 4 * n_tab
        label, run, plain = (
            ("K7 paged_block_verify_attention",
             da.paged_block_verify_attention,
             da.paged_block_verify_reference) if verify else
            ("K5 paged_block_decode_attention",
             da.paged_block_decode_attention,
             da.paged_block_decode_reference))
    else:
        n_rows = int(L.sum())
        k, v = slot_rows_case(torch, kv_dtype, seed + 11, heads)
        (k, v), sc, sc_plain, (kd, vd), row_bytes = kv_operands(
            torch, k, v, dtype, int8)
        args = (q, k, v, lens) + extra
        kv_bytes = n_rows * heads * row_bytes
        label, run, plain = (
            ("K6 paged_verify_attention", da.paged_verify_attention,
             da.masked_verify_reference) if verify else
            ("K4 paged_decode_attention", da.paged_decode_attention,
             da.masked_decode_reference))
    qd = (q if verify else q[:, None]).transpose(1, 2)
    kt, vt = kd.transpose(1, 2), vd.transpose(1, 2)
    mask = length_mask(torch, L, q_lens, Q, kd.shape[1])
    # q of the slots with a length (a length-0 slot outputs zeros
    # unread), o in full, the K/V rows up to each slot's length once (a
    # shared pool row once, plus the table entries of those blocks),
    # lengths and the verify block's q_lens
    nbytes = (int((L > 0).sum()) * Q * heads * DH * es + q.numel() * es
              + kv_bytes + L.nbytes + (q_lens.nbytes if verify else 0))
    if int8:
        label = label.replace(" ", "-int8 ", 1)
    if short:
        label += " short"
    label += heads_label(heads)
    from hetu_tpu_torch.kernels import ragged_attention as ra

    def rounding():
        """``ragged_rounding_bound`` of the call (a decode call as a
        ragged wave of one row)."""
        if verify:
            return ra.ragged_rounding_bound(*args)
        return ra.ragged_rounding_bound(q[:, None], *args[1:4],
                                        torch.ones_like(lens),
                                        *args[4:])[:, 0]
    return measure(
        torch, label, dtype, lambda: run(*args, **sc),
        lambda: plain(*args, *sc_plain),
        lambda: F.scaled_dot_product_attention(qd, kt, vt, attn_mask=mask),
        nbytes, ragged_flops(L, q_lens, Q, heads)
        + (2 * n_rows * heads * DH if int8 else 0),
        rounding=None if int8 else rounding, b2b=True)


def check_k8_equals_k1(torch, seed, int8=False):
    """f32 K8 (``ragged_attention`` over slot rows) and f32 K1
    (``ragged_paged_attention`` through the tables) on phase 2's decode
    wave (Q 1) over the same K/V: the pool of ``pool_case`` and its slot
    rows gathered through the tables; with ``int8`` f32-q K8-int8 and
    f32-q K1-int8 over the pool's encoding on the card (payload and
    scales gathered alike).  One split body, one row limit, one split
    order (the span of both is 1024 positions), only the row addresses
    differ, so the outputs are equal bit for bit."""
    from hetu_tpu_torch.kernels import ragged_attention as ra
    pool_k, pool_v, tables, _ = pool_case(torch, "float32", seed + 13)
    Q, q_lens = NARROW_WAVES["decode"]
    B, span = len(LENGTHS), T_WIDTH * BS
    lens, ql, tab = (torch.from_numpy(x).cuda()
                     for x in (LENGTHS, q_lens, tables))
    pools, sc = (pool_k, pool_v), {}
    if int8:
        (kq, ks), (vq, vs) = int8_kv(torch, pool_k, pool_v)
        pools, sc = (kq, vq), dict(k_scale=ks, v_scale=vs)

    def rows(x):
        """The slot rows of pool ``x`` (or of its scale plane)."""
        return x[tab.long()].reshape(B, span, *x.shape[2:]).contiguous()
    g = torch.Generator(device="cuda").manual_seed(seed + 14)
    q = torch.randn((B, Q, H, DH), generator=g, device="cuda")
    k1 = ra.ragged_paged_attention(q, *pools, lens, ql, tab, **sc)
    k8 = ra.ragged_attention(q, *(rows(x) for x in pools), lens, ql,
                             **{n: rows(x) for n, x in sc.items()})
    torch.cuda.synchronize()
    what = "-int8" if int8 else ""
    if not torch.equal(k1, k8):
        fail(f"f32 K8{what} differs from f32 K1{what} on the same decode "
             f"wave: max abs diff {float((k1 - k8).abs().max())}")
    log(f"  K8{what} ragged_attention float32 == K1{what} "
        f"ragged_paged_attention float32 on the Q 1 decode wave over the "
        f"same {'int8 ' if int8 else ''}K/V (slot rows, pool), bit for bit")


def off16(torch, t, nbytes=8):
    """A copy of ``t`` on the card whose data starts ``nbytes`` past a
    16-byte boundary (contiguous)."""
    n = nbytes // t.element_size()
    out = torch.zeros(t.numel() + n, dtype=t.dtype,
                      device="cuda")[n:].view(t.shape)
    out.copy_(t)
    return out


def check_decode_equals_ragged(torch, seed):
    """K4/K5 on their split bodies wherever they take f32 q or an int8
    cache, head dim 32, 64 and 128: f32 K4/K5 (f32 q over an f32 cache)
    and K4-int8/K5-int8 (f32 and bf16 q over an int8 cache), over the 8
    slots of ``LENGTHS`` in the f32 pool of ``pool_case`` (or its
    encoding on the card) and its slot rows gathered through the tables.
    K5 (``paged_block_decode_attention``) equals K1
    (``ragged_paged_attention``) on phase 2's decode wave (Q 1) over the
    pool, and K4 (``paged_decode_attention``) equals K8
    (``ragged_attention``) over the slot rows, bit for bit, and so do
    their int8 twins: one split body, row limits that agree at q_len 1
    (DecodeLim is RaggedLim there), one split order.  Each decode call
    counts one launch under its name (``_int8``); a cache or payload 8
    bytes off a 16-byte boundary is refused with nothing launched."""
    from hetu_tpu_torch.kernels import decode_attention as da
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.kernels import ragged_attention as ra
    Q, q_lens = NARROW_WAVES["decode"]
    B, span = len(LENGTHS), T_WIDTH * BS
    lens, ql = (torch.from_numpy(x).cuda() for x in (LENGTHS, q_lens))
    for dtype, cache in (("float32", "float"), ("float32", "int8"),
                         ("bfloat16", "int8")):
        what = "-int8" if cache == "int8" else ""
        sfx = what.replace("-", "_")
        for Dh in (32, 64, 128):
            pool_k, pool_v, tables, _ = pool_case(torch, "float32",
                                                  seed + 15 + Dh, Dh=Dh)
            tab = torch.from_numpy(tables).cuda()
            pools, sc = (pool_k, pool_v), {}
            if cache == "int8":
                (kq, ks), (vq, vs) = int8_kv(torch, pool_k, pool_v)
                pools, sc = (kq, vq), dict(k_scale=ks, v_scale=vs)

            def rows(x):
                """The slot rows of pool ``x`` (or of its scale plane)."""
                return x[tab.long()].reshape(B, span, *x.shape[2:]) \
                    .contiguous()
            slots = tuple(rows(x) for x in pools)
            g = torch.Generator(device="cuda").manual_seed(seed + 16 + Dh)
            q = torch.randn((B, Q, H, Dh), generator=g, device="cuda").to(
                getattr(torch, dtype))
            rsc = {n: rows(x) for n, x in sc.items()}
            reset_launches()
            k5 = da.paged_block_decode_attention(q[:, 0], *pools, lens, tab,
                                                 **sc)
            k4 = da.paged_decode_attention(q[:, 0], *slots, lens, **rsc)
            torch.cuda.synchronize()
            counts = {k: n for k, n in launch_counts().items() if n}
            want = {f"paged_block_decode_attention{sfx}": 1,
                    f"paged_decode_attention{sfx}": 1}
            if counts != want:
                fail(f"{dtype} K4{what}/K5{what} launches {counts}, not "
                     f"{want}")
            k1 = ra.ragged_paged_attention(q, *pools, lens, ql, tab, **sc)
            k8 = ra.ragged_attention(q, *slots, lens, ql, **rsc)
            torch.cuda.synchronize()
            for got, ref, pair in ((k5, k1[:, 0], f"K5{what} vs K1{what}"),
                                   (k4, k8[:, 0], f"K4{what} vs K8{what}")):
                if not torch.equal(got, ref):
                    diff = float((got.float() - ref.float()).abs().max())
                    fail(f"{dtype} {pair} at Dh {Dh} on the Q 1 decode "
                         f"wave: max abs diff {diff}")
            reset_launches()
            for label, call in (
                    (f"K5{what}", lambda: da.paged_block_decode_attention(
                        q[:, 0], off16(torch, pools[0]), pools[1], lens,
                        tab, **sc)),
                    (f"K4{what}", lambda: da.paged_decode_attention(
                        q[:, 0], slots[0], off16(torch, slots[1]), lens,
                        **rsc))):
                try:
                    call()
                except ValueError as e:
                    if "16-byte" not in str(e):
                        raise
                else:
                    fail(f"{dtype} {label} took a cache 8 bytes off a "
                         f"16-byte boundary")
            if any(launch_counts().values()):
                fail(f"{dtype} K4{what}/K5{what} launched on a refused "
                     f"cache")
        log(f"  K5{what} paged_block_decode_attention {dtype} == "
            f"K1{what} ragged_paged_attention, K4{what} "
            f"paged_decode_attention == K8{what} ragged_attention, on the "
            f"Q 1 decode wave over the same {cache} pool / slot rows at "
            f"Dh 32, 64 and 128, bit for bit; a misaligned cache refused")


def check_f32_verify_equals_ragged(torch, seed):
    """f32 K6/K7 and f32-q K6-int8/K7-int8 on the split-K CUDA-core body,
    on phase 2's verify wave (Q 5, ``VERIFY_QLENS``): the 8 slots of
    ``LENGTHS`` in the f32 pool of ``pool_case`` and its slot rows
    gathered through the tables, then in the pool's encoding on the card
    (payload and scales gathered alike).  K7
    (``paged_block_verify_attention``) equals K1
    (``ragged_paged_attention``) over the pool and K6
    (``paged_verify_attention``) equals K8 (``ragged_attention``) over
    the slot rows, bit for bit, and so do their f32-q int8 twins:
    one split body, row limits that agree (VerifyLim is RaggedLim's
    clip), one split order.  Each verify call counts one launch under
    its name (``_int8``); an f32 pool, f32 slot rows or an int8 payload
    8 bytes off a 16-byte boundary is refused with nothing launched."""
    from hetu_tpu_torch.kernels import decode_attention as da
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.kernels import ragged_attention as ra
    pool_k, pool_v, tables, _ = pool_case(torch, "float32", seed + 17)
    B, span, Q = len(LENGTHS), T_WIDTH * BS, int(VERIFY_QLENS.max())
    lens, ql, tab = (torch.from_numpy(x).cuda()
                     for x in (LENGTHS, VERIFY_QLENS, tables))
    g = torch.Generator(device="cuda").manual_seed(seed + 18)
    q = torch.randn((B, Q, H, DH), generator=g, device="cuda")

    def rows(x):
        """The slot rows of pool ``x`` (or of its scale plane)."""
        return x[tab.long()].reshape(B, span, *x.shape[2:]).contiguous()
    (kq, ks), (vq, vs) = int8_kv(torch, pool_k, pool_v)
    for what, pools, sc in (("", (pool_k, pool_v), {}),
                            ("-int8", (kq, vq), dict(k_scale=ks,
                                                     v_scale=vs))):
        slots = tuple(rows(x) for x in pools)
        rsc = {n: rows(x) for n, x in sc.items()}
        sfx = what.replace("-", "_")
        reset_launches()
        k7 = da.paged_block_verify_attention(q, *pools, lens, ql, tab, **sc)
        k6 = da.paged_verify_attention(q, *slots, lens, ql, **rsc)
        torch.cuda.synchronize()
        counts = {k: n for k, n in launch_counts().items() if n}
        want = {f"paged_block_verify_attention{sfx}": 1,
                f"paged_verify_attention{sfx}": 1}
        if counts != want:
            fail(f"f32 K6{what}/K7{what} launches {counts}, not {want}")
        k1 = ra.ragged_paged_attention(q, *pools, lens, ql, tab, **sc)
        k8 = ra.ragged_attention(q, *slots, lens, ql, **rsc)
        torch.cuda.synchronize()
        for got, ref, pair in ((k7, k1, f"K7{what} vs K1{what}"),
                               (k6, k8, f"K6{what} vs K8{what}")):
            if not torch.equal(got, ref):
                fail(f"f32 {pair} on the Q {Q} verify wave: max abs diff "
                     f"{float((got - ref).abs().max())}")
    slots8 = dict(k_scale=rows(ks), v_scale=rows(vs))
    refused = (
        ("f32 K7: a pool", lambda: da.paged_block_verify_attention(
            q, off16(torch, pool_k), pool_v, lens, ql, tab)),
        ("f32 K6: slot rows", lambda: da.paged_verify_attention(
            q, rows(pool_k), off16(torch, rows(pool_v)), lens, ql)),
        ("f32-q K7-int8: a payload", lambda: da.paged_block_verify_attention(
            q, off16(torch, kq), vq, lens, ql, tab, k_scale=ks,
            v_scale=vs)),
        ("f32-q K6-int8: a payload", lambda: da.paged_verify_attention(
            q, rows(kq), off16(torch, rows(vq)), lens, ql, **slots8)))
    reset_launches()
    for label, call in refused:
        try:
            call()
        except ValueError as e:
            if "16-byte" not in str(e):
                raise
        else:
            fail(f"{label} 8 bytes off a 16-byte boundary was taken")
    if any(launch_counts().values()):
        fail(f"f32 K6/K7 launched on refused data: {launch_counts()}")
    log(f"  K7 paged_block_verify_attention float32 == K1 "
        f"ragged_paged_attention, K6 paged_verify_attention == K8 "
        f"ragged_attention, and their f32-q int8 twins alike, on the Q {Q} "
        f"verify wave over the same pool / slot rows, bit for bit; an f32 "
        f"cache and an int8 payload 8 bytes off 16 refused, nothing "
        f"launched")


def check_k6_int8_equals_k8_int8(torch, seed):
    """bf16-q K6-int8 (``paged_verify_attention`` over an int8 cache) and
    bf16-q K8-int8 (``ragged_attention``) on phase 2's verify wave (Q 5,
    ``VERIFY_QLENS``) over the same int8 slot rows (phase 2's K/V
    encoded on the card): one split body, one layout, the same row
    limits, so the two outputs are equal bit for bit."""
    from hetu_tpu_torch.kernels import decode_attention as da
    from hetu_tpu_torch.kernels import ragged_attention as ra
    k, v = slot_rows_case(torch, "float32", seed + 11)
    (kq, ks), (vq, vs) = int8_kv(torch, k, v)
    g = torch.Generator(device="cuda").manual_seed(seed + 12)
    q = torch.randn((len(LENGTHS), int(VERIFY_QLENS.max()), H, DH),
                    generator=g, device="cuda").bfloat16()
    args = (q, kq, vq, torch.from_numpy(LENGTHS).cuda(),
            torch.from_numpy(VERIFY_QLENS).cuda())
    k6 = da.paged_verify_attention(*args, k_scale=ks, v_scale=vs)
    k8 = ra.ragged_attention(*args, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    if not torch.equal(k6, k8):
        fail(f"bf16-q K6-int8 differs from bf16-q K8-int8 on the same "
             f"verify wave: max abs diff "
             f"{float((k6.float() - k8.float()).abs().max())}")
    log("  K6-int8 paged_verify_attention bfloat16 == K8-int8 "
        "ragged_attention bfloat16 on the Q 5 verify wave over the same "
        "int8 slot rows, bit for bit")


def check_k2(torch, F, dtype, seed, heads=H):
    from hetu_tpu_torch.kernels import flash_attention as fa
    N, P, Hn, D = 8, 512, heads, 64
    kv = np.array([512, 300, 0, 77, 512, 1, 250, 450], np.int32)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((N, P, Hn, D), generator=g,
                           device="cuda").to(dt) for _ in range(3))
    kv_d = torch.from_numpy(kv).cuda()
    o, lse = fa.flash_fwd(q, k, v, causal=True, kv_lens=kv_d)
    torch.cuda.synchronize()
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, causal=True, kv_lens=kv_d)
    err, ratio, ok = flash_compare(o, o_r, q, k, v, dtype, causal=True,
                                   kv_lens=kv_d)
    live = lse_r < 1e29
    lse_err = float((lse - lse_r)[live].abs().max())
    if not ok or lse_err > LSE_TOL \
            or not torch.equal(lse[~live], lse_r[~live]):
        fail(f"flash_attention {dtype}: max abs err {err}, largest err / "
             f"bound {ratio}, lse err {lse_err} (lse {LSE_TOL})")
    ms = time_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True,
                                            kv_lens=kv_d))
    run_ms = time_run_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True,
                                                     kv_lens=kv_d))
    dev = device_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True,
                                                kv_lens=kv_d))
    plain_ms = time_ms(torch, lambda: fa.flash_fwd_reference(
        q, k, v, causal=True, kv_lens=kv_d), reps=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    # bytes the function must move: q of the prompts with a live key
    # (a kv_lens-0 prompt outputs zeros unread), the kv_lens[b] live K
    # and V rows of each prompt, o and lse in full, kv_lens
    es = q.element_size()
    nbytes = (int((kv > 0).sum()) * P * Hn * D * es
              + 2 * int(kv.sum()) * Hn * D * es + q.numel() * es
              + N * Hn * P * 4 + kv.nbytes)
    rows = np.arange(P)
    flops = int(sum(4 * np.minimum(rows + 1, n).sum() * Hn * D
                    for n in kv))
    b_ms, b_by = bound(nbytes, flops, dtype, tf32_method(dtype))
    log(f"  K2 flash_attention{heads_label(heads)} {dtype}: max_abs_err {err:.3e}, largest "
        f"err / bound {ratio:.4f} (flash_compare); lse {lse_err:.3e}, tol "
        f"{LSE_TOL:g}; kernel "
        f"{ms:.4f} ms ({run_ms:.4f} back to back, {ms_text(dev)} on the "
        f"device), plain {plain_ms:.4f} ms, SDPA is_causal on "
        f"[8,{Hn},512,64] without the kv_lens mask {lib_ms:.4f} ms; bound "
        f"{b_ms:.4f} ms by {b_by} ({nbytes} B, {flops} flop"
        f"{', 3 TF32 passes' if dtype == 'float32' else ''})")
    return dict(err=err, ratio=ratio, ms=ms, run_ms=run_ms, dev_ms=dev,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


# ---------------------------------------------------------------- #
# phases 3 and 4: the main path
# ---------------------------------------------------------------- #


def gpt2_small_params(cfg, seed, name="gpt"):
    """GPT-2-small weights drawn from ``seed`` (numpy, f32): N(0, 0.02)
    matrices and embeddings, unit LN scales, zero biases."""
    rng = np.random.default_rng(seed)
    hd, V, S = cfg.hidden_size, cfg.vocab_size, cfg.max_position_embeddings

    def w(*shape, std=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    p = {f"{name}_wte_table": w(V, hd), f"{name}_wpe": w(S, hd, std=0.01),
         f"{name}_ln_f_scale": np.ones(hd, np.float32),
         f"{name}_ln_f_bias": np.zeros(hd, np.float32)}
    for i in range(cfg.num_hidden_layers):
        us = f"{name}_h{i}"
        for wn, shp in [("attn_q", (hd, hd)), ("attn_k", (hd, hd)),
                        ("attn_v", (hd, hd)), ("attn_proj", (hd, hd)),
                        ("ffn_wi", (hd, 4 * hd)), ("ffn_wo", (4 * hd, hd))]:
            p[f"{us}_{wn}_weight"] = w(*shp)
            p[f"{us}_{wn}_bias"] = np.zeros(shp[1], np.float32)
        for ln in ("ln1", "ln2"):
            p[f"{us}_{ln}_scale"] = np.ones(hd, np.float32)
            p[f"{us}_{ln}_bias"] = np.zeros(hd, np.float32)
    return p


def offline(torch, htt, params, cfg, prompts, dtype):
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    dt = getattr(torch, dtype)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = htt.generate_fast(params, cfg, prompts, 32, dtype=dt)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = launch_counts()
    L = cfg.num_hidden_layers
    P, n_new = prompts.shape[1], 32
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=L, paged_decode_attention=L * (n_new - 1))
    if counts != want:
        fail(f"offline {dtype}: launches {counts}, want {want} (layers x "
             f"1 prefill call, layers x {n_new - 1} decode positions)")
    if out.shape != (len(prompts), P + n_new) \
            or not ((out >= 0) & (out < cfg.vocab_size)).all() \
            or not (out[:, :P] == prompts).all():
        fail(f"offline {dtype}: malformed output {out.shape}")
    log(f"  generate_fast {dtype}: {len(prompts)} x ({P} + {n_new}) tokens "
        f"in {sec:.3f} s; launches {counts}")
    return out, counts


# the engine configurations: phase 4 is the auto settings on CUDA (the
# paged pool, block 16, mixed waves); phase 5 the three others
CONFIGS = {
    "paged-mixed": dict(prefix_share=True, prefill_chunk=256),
    "contiguous-split": dict(paged=False, ragged=False),
    "paged-split": dict(paged=True, ragged=False, prefix_share=True,
                        prefill_chunk=256),
    "contiguous-mixed": dict(paged=False, ragged=True),
}
LAYOUT = {"paged-mixed": (True, True), "contiguous-split": (False, False),
          "paged-split": (True, False), "contiguous-mixed": (False, True)}


def verify_launches(eng):
    """Launches of the verify kernel per layer per phase-split wave: one
    per 16-row group of the k + 1 row block (k fixed when the engine does
    not adapt it; an adaptive k stays within one group up to spec 15)."""
    if not eng.spec_k:
        return 1
    if eng.spec_adapt and eng.spec_k >= 16:
        fail("an adaptive k past 15 has no fixed count of verify groups")
    return -(-(eng.spec_k + 1) // 16)


def want_launches(eng, L):
    """The exact launches of one engine run: mixed, the ragged kernel of
    the layout per layer per step (verify rows ride the wave);
    phase-split, the flash kernel per layer per flash group, the ragged
    paged kernel per layer per chunk pass, and per layer per wave the
    decode kernel of the layout, or with speculation its verify kernel
    (once per 16-row group of the block, ``verify_launches``).  With an
    int8 cache each of those but flash (which attends to the fresh K/V)
    is the int8 twin, and its float twin launches never.  A
    speculative engine's draft (never quantized) adds the contiguous
    decode kernel per draft layer per draft step (k + 1 a wave) and the
    flash kernel per draft layer per admission.  A tensor-parallel
    engine (``tp_shard_params``) launches each of those once per local
    rank."""
    from hetu_tpu_torch.kernels import KERNELS
    R = 1 if eng.kv.tp is None else len(eng.kv.tp.ranks)
    L = L * R
    want = dict.fromkeys(KERNELS, 0)
    q = "_int8" if eng.kv_quant else ""
    if eng.ragged:
        want[("ragged_paged_attention" if eng.paged
              else "ragged_attention") + q] = L * eng.steps
    else:
        want["flash_attention"] = L * (eng.prefill_dispatches
                                       - eng.prefill_chunks)
        want["ragged_paged_attention" + q] = L * eng.prefill_chunks
        wave = (("paged_block_verify_attention", "paged_verify_attention")
                if eng.spec_k else
                ("paged_block_decode_attention", "paged_decode_attention"))
        want[(wave[0] if eng.paged else wave[1]) + q] = \
            L * eng.steps * verify_launches(eng)
    if eng.spec_k:
        Ld = eng.spec_draft_layers * R
        want["paged_decode_attention"] += Ld * (eng.spec_k_sum
                                                + eng.spec_waves)
        want["flash_attention"] += Ld * eng.spec_draft_prefills
    return want


def serve(torch, htt, params, cfg, reqs_spec, dtype, config, prof=None,
          **engine_kw):
    """One engine run of ``config`` (plus ``engine_kw``) over the request
    set, its launches held to ``want_launches``; ``prof`` (a
    torch.profiler.profile) wraps the run alone when given."""
    from hetu_tpu_torch.kernels import (launch_counts, regime_counts,
                                        reset_launches)
    from hetu_tpu_torch.serving import Request
    dt = getattr(torch, dtype)
    eng = htt.ServingEngine(params, cfg, slots=8, dtype=dt,
                            **CONFIGS[config], **engine_kw)
    if (eng.paged, eng.ragged) != LAYOUT[config] \
            or (eng.paged and eng.kv.block != 16):
        fail(f"{config}: the engine runs paged={eng.paged} "
             f"ragged={eng.ragged} block {getattr(eng.kv, 'block', 0)}")
    reqs = [Request(prompt=pr, max_new_tokens=64, temperature=t, top_k=k,
                    seed=i, request_id=f"r{i}")
            for i, (pr, t, k) in enumerate(reqs_spec)]
    torch.cuda.synchronize()
    reset_launches()
    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        res = eng.run(reqs)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    counts, regimes = launch_counts(), regime_counts()
    L = cfg.num_hidden_layers
    want = want_launches(eng, L)
    if counts != want or not eng.steps:
        fail(f"{config} {dtype}: launches {counts}, want {want} ({L} "
             f"layers, {eng.steps} steps, {eng.prefill_dispatches} "
             f"prefill dispatches, {eng.prefill_chunks} chunk passes, "
             f"spec {eng.spec_k}, kv_quant {eng.kv_quant})")
    if len(res) != len(reqs):
        fail(f"{config} {dtype}: {len(res)} of {len(reqs)} requests done")
    hits = eng.kv.prefix_hits if eng.paged else 0
    if eng.paged and hits < 3:
        fail(f"{config} {dtype}: {hits} prefix hits; the three later "
             f"requests of the shared 128-token prefix should hit")
    for i, (pr, _, _) in enumerate(reqs_spec):
        toks = res[f"r{i}"].tokens
        if len(toks) != len(pr) + 64 or list(toks[:len(pr)]) != list(pr) \
                or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            fail(f"{config} {dtype}: request r{i} malformed")
    gen = sum(r.n_generated for r in res.values())
    ttft = np.array([r.ttft_s for r in res.values()]) * 1e3
    stats = dict(tokens_per_s=gen / sec, seconds=sec, steps=eng.steps,
                 generated=gen, ttft_p50_ms=float(np.percentile(ttft, 50)),
                 ttft_p99_ms=float(np.percentile(ttft, 99)),
                 prefix_hits=hits,
                 prefill_dispatches=eng.prefill_dispatches,
                 prefill_chunks=eng.prefill_chunks,
                 cache_bytes=eng.kv.cache_bytes,
                 cache_rows=(eng.kv.n_blocks * eng.kv.block if eng.paged
                             else eng.kv.n_slots * eng.kv.s_max))
    tag = " int8 KV;" if eng.kv_quant else ""
    if eng.moe is not None:
        stats.update(moe_accounting(eng, L))
        tag += (f" MoE load {stats['expert_load']} drops "
                f"{stats['expert_drops']} over {stats['moe_tokens']} "
                f"routed positions, imbalance "
                f"{stats['expert_imbalance']:.4f}, drop rate "
                f"{stats['expert_drop_rate']:.4f};")
    if eng.spec_k:
        stats.update(spec_waves=eng.spec_waves,
                     acceptance=eng.spec_acceptance,
                     mean_k=eng.spec_mean_k,
                     tokens_per_wave=eng.spec_emitted / eng.spec_waves,
                     draft_prefills=eng.spec_draft_prefills)
        tag += (f" spec {eng.spec_k} (draft {eng.spec_draft_layers} "
               f"layers): acceptance {eng.spec_acceptance:.4f}, mean k "
               f"{eng.spec_mean_k:.3f}, {stats['tokens_per_wave']:.3f} "
               f"tokens per wave (all slots) over {eng.spec_waves} "
               f"waves;")
    log(f"  {config} {dtype}:{tag} {gen} tokens in {sec:.3f} s = "
        f"{stats['tokens_per_s']:.1f} tok/s, TTFT p50 "
        f"{stats['ttft_p50_ms']:.1f} ms p99 {stats['ttft_p99_ms']:.1f} "
        f"ms, {eng.steps} steps, {eng.prefill_dispatches} prefill "
        f"dispatches ({eng.prefill_chunks} chunk passes), prefix hits "
        f"{hits}, launches {counts}")
    return res, {**counts, **regimes}, stats


def moe_accounting(eng, L):
    """An MoE engine's routing record after a run, each step's and the
    lifetime's load + drop == routed positions x top_k x MoE layers (or
    a failure)."""
    n = eng.moe.top_k * eng.moe.moe_layers(L)
    recs = [e for e in eng.metrics.events if "moe_tokens" in e]
    bad = [e.get("step") for e in recs
           if e["moe_routed"] + e["moe_dropped"] != e["moe_tokens"] * n]
    total = int(eng.expert_load.sum() + eng.expert_drops.sum())
    if bad or not recs or total != eng.moe_tokens * n \
            or sum(e["moe_tokens"] for e in recs) != eng.moe_tokens:
        fail(f"MoE accounting: load + drop {total} over "
             f"{eng.moe_tokens} positions x {n}; steps breaking it {bad}")
    return dict(expert_load=eng.expert_load.tolist(),
                expert_drops=eng.expert_drops.tolist(),
                moe_tokens=eng.moe_tokens, moe_steps=len(recs),
                expert_imbalance=eng.expert_imbalance,
                expert_drop_rate=eng.expert_drop_rate)


# kernel kinds of the profile, by name, first match wins.  K4-K7 in
# either q dtype and their int8 twins (an int8 twin's element type,
# signed char, makes it the twin in kind_of) are split and merge kernels
# of their own row-limit types (DecodeLim<layout>, VerifyLim<layout>),
# ahead of K1/K8's and their twins'; K1/K8 are the
# f32 TF32 ragged kernel (f32 q, Q > 16), the f32 split kernel and its
# merge (f32 q, Q <= 16: f32 K1 and K8, and f32-q K1-int8 and K8-int8,
# whose signed char makes them the twins; the merge's template names the
# cache type and layout too) and the bf16 wide, split and merge kernels
# (bf16 q, either cache), told apart by their layout
RAGGED = ("(ragged_tf32_kernel|ragged_wide_kernel|"
          "split_kv_kernel|split_kv_f32_kernel|split_merge_kernel)")
KINDS = (("K4 paged_decode_attention",
          re.compile("DecodeLim<hetu::SlotRows")),
         ("K5 paged_block_decode_attention",
          re.compile("DecodeLim<hetu::TableRows")),
         ("K6 paged_verify_attention",
          re.compile("VerifyLim<hetu::SlotRows")),
         ("K7 paged_block_verify_attention",
          re.compile("VerifyLim<hetu::TableRows")),
         ("K1 ragged_paged_attention", re.compile(RAGGED + ".*TableRows")),
         ("K8 ragged_attention", re.compile(RAGGED + ".*SlotRows")),
         ("K2 flash_attention", re.compile("flash_fwd")),
         ("matmul", re.compile("gemm|nvjet|splitK")),
         ("KV writes (index_put)", re.compile("index_elementwise")),
         ("reductions", re.compile("reduce_kernel")),
         ("elementwise", re.compile("elementwise")))


def kind_of(name):
    """The kind of a profiled kernel; an attention kernel over an int8
    cache (element type int8_t, which demangles as signed char, never
    the last template argument: the bf16 ragged kernels and their merge
    take it second, after D) is its int8 twin, K1-int8 ... K8-int8."""
    kind = next((k for k, rx in KINDS if rx.search(name)), "other")
    if re.match(r"K\d ", kind) and ", signed char," in name:
        kind = kind.replace(" ", "-int8 ", 1)
    return kind


# every profiled serving run: (configuration, spec, kv_quant, dtype)
PROFILE_RUNS = tuple((config, spec_k, quant, dtype)
                     for config, (spec_k, quant), dtype in itertools.product(
                         CONFIGS, ((0, None), (4, None), (0, "int8")),
                         ("float32", "bfloat16")))


def profile_serve(torch, htt, params, cfg, spec, out_dir,
                  runs=PROFILE_RUNS):
    """Where each serving configuration's device time goes, without and
    with speculation (``spec=4``) and with an int8 cache (no
    speculation), or in the given ``runs``: its engine run again, f32
    and bf16, under torch.profiler; device time by kind and by kernel
    (top 15, and the table in ``out_dir``) and the device's busy share
    of the run's wall time (host tracing overhead inflates the wall, so
    the busy share is a lower bound).  Returns {(label, dtype): the
    engine's stats plus ``busy_s`` and ``kinds``, {kind: [device ms,
    launches]}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for config, spec_k, quant, dtype in runs:
        label = (f"{config}{'-spec' if spec_k else ''}"
                 f"{'-int8' if quant else ''}")
        t_prof = time.perf_counter()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        _, _, st = serve(torch, htt, params, cfg, spec, dtype, config,
                         prof=prof, spec=spec_k, kv_quant=quant)
        # kernel rows only: an operator row repeats its kernels' time
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if not rows:
            fail("the profiler recorded no device time")
        rows.sort(key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in rows) / 1e6
        lines = [f"{'kernel':64s} {'calls':>7s} {'device ms':>11s} "
                 f"share"]
        lines += [f"{e.key[:64]:64s} {e.count:7d} "
                  f"{e.self_device_time_total / 1e3:11.3f} "
                  f"{e.self_device_time_total / 1e6 / busy:6.1%}"
                  for e in rows]
        (out_dir / f"profile_{label}_{dtype}.txt").write_text(
            "\n".join(lines) + "\n")
        log(f"  profile {label} {dtype}: device busy {busy:.4f} s of "
            f"{st['seconds']:.4f} s wall "
            f"({busy / st['seconds']:.1%}) under the profiler; "
            f"{time.perf_counter() - t_prof:.1f} s with the profile's "
            f"analysis")
        kinds = collections.Counter()
        calls = collections.Counter()
        for e in rows:
            kinds[kind_of(e.key)] += e.self_device_time_total / 1e3
            calls[kind_of(e.key)] += e.count
        for k, ms in kinds.most_common():
            log(f"    {k}: {ms:.3f} ms ({ms / 1e3 / busy:.1%}, "
                f"{calls[k]} launches)")
        log("  top kernels:")
        for line in lines[:16]:
            log("    " + line)
        out[label, dtype] = dict(st, busy_s=busy, kinds={
            k: [ms, calls[k]] for k, ms in kinds.items()})
    return out


def zero_late_layers(torch, params, cfg, first, name="gpt"):
    """Output-zero the blocks from ``first`` on (their attention and FFN
    output projections): a draft of ``first`` layers then computes the
    target's logits, so greedy drafts are accepted."""
    hp = dict(params)
    for i in range(first, cfg.num_hidden_layers):
        for wn in ("attn_proj_weight", "attn_proj_bias", "ffn_wo_weight",
                   "ffn_wo_bias"):
            k = f"{name}_h{i}_{wn}"
            hp[k] = torch.zeros_like(params[k])
    return hp


def phase6(torch, htt, params, cfg, spec, runs, res32, prompts, off_f32,
           card, seed):
    """Speculation through all four engine configurations, the
    high-acceptance arm and offline ``generate_fast(spec=4)``.  Returns
    {(config, dtype): (results, launches, stats)} of the speculative runs
    on the random weights."""
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    K = 4
    greedy = [i for i, (_, t, _) in enumerate(spec) if t == 0]
    sampled = [i for i, (_, t, _) in enumerate(spec) if t > 0]
    spec_runs = {}
    for config in CONFIGS:
        for dt in ("float32", "bfloat16"):
            spec_runs[config, dt] = serve(torch, htt, params, cfg, spec, dt,
                                          config, spec=K)
        res = spec_runs[config, "float32"][0]
        bad = [i for i in greedy
               if list(res[f"r{i}"].tokens) != list(res32[f"r{i}"].tokens)]
        if bad:
            fail(f"spec {config} f32 greedy tokens differ from phase 4's "
                 f"for requests {bad}")
        plain = runs[config, "float32"][0]
        bad = [i for i in sampled
               if list(res[f"r{i}"].tokens) != list(plain[f"r{i}"].tokens)]
        if bad:
            fail(f"spec {config} f32 sampled tokens differ from the "
                 f"non-speculative run for requests {bad}")
        log(f"  spec {config} f32: greedy tokens == phase 4's "
            f"({len(greedy)}), sampled == non-speculative ({len(sampled)})")
    for (config, dt), (_, _, st) in spec_runs.items():
        log(f"  spec serving on {card}: {config} {dt} "
            f"{st['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{st['ttft_p50_ms']:.1f} p99 {st['ttft_p99_ms']:.1f} ms, "
            f"acceptance {st['acceptance']:.4f}, mean k {st['mean_k']:.3f}, "
            f"{st['tokens_per_wave']:.3f} tokens per wave")

    log("  high-acceptance arm: layers 3-11 output-zeroed, all greedy")
    hp = zero_late_layers(torch, params, cfg, 3)
    hspec = [(pr, 0.0, 0) for pr, _, _ in spec]
    plain, _, _ = serve(torch, htt, hp, cfg, hspec, "float32", "paged-mixed")
    for config in ("paged-split", "paged-mixed"):
        res, _, st = serve(torch, htt, hp, cfg, hspec, "float32", config,
                           spec=K)
        bad = [r for r in res if list(res[r].tokens)
               != list(plain[r].tokens)]
        if bad:
            fail(f"high-acceptance {config}: tokens differ from the "
                 f"non-speculative run for {bad}")
        if st["acceptance"] < 0.9 or st["spec_waves"] >= st["generated"]:
            fail(f"high-acceptance {config}: acceptance "
                 f"{st['acceptance']:.4f} (want >= 0.9), "
                 f"{st['spec_waves']} waves for {st['generated']} tokens")
        log(f"  high-acceptance {config} f32 on {card}: tokens == "
            f"non-speculative; acceptance {st['acceptance']:.4f}, mean k "
            f"{st['mean_k']:.3f}, {st['tokens_per_wave']:.3f} tokens per "
            f"wave ({st['spec_waves']} waves, {st['generated']} tokens), "
            f"{st['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{st['ttft_p50_ms']:.1f} p99 {st['ttft_p99_ms']:.1f} ms")

    # offline: flash prefill of the target (12 layers) and the draft (3),
    # then per wave K4 3 x (K + 1) and K6 12 x 1
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = htt.generate_fast(params, cfg, prompts, 32, spec=K,
                            dtype=torch.float32)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = launch_counts()
    L, Ld = cfg.num_hidden_layers, cfg.num_hidden_layers // 4
    waves = counts["paged_verify_attention"] // L
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=L + Ld, paged_verify_attention=L * waves,
                paged_decode_attention=Ld * (K + 1) * waves)
    if counts != want or not waves:
        fail(f"offline spec: launches {counts}, want {want}")
    if out.tolist() != off_f32.tolist():
        fail("offline generate_fast(spec=4) f32 tokens differ from "
             "phase 3's")
    log(f"  generate_fast spec {K} f32: tokens == phase 3's; {waves} "
        f"verify waves for {out.shape[0]} x 32 tokens in {sec:.3f} s; "
        f"launches {counts}")
    deep_spec(torch, htt, params, cfg, spec, prompts, seed)
    return spec_runs


# the long verify wave: Q = spec 16 + 1 over phase 2's slots, q_lens of
# a full block, one ending on the 16-row edge, shorter ones, an inert
# slot and a length-0 one
LONG_QLENS = np.minimum(np.array([17, 16, 9, 0, 1, 17, 2, 17], np.int32),
                        LENGTHS)


def check_long_verify(torch, dtype, seed, paged):
    """K7 (``paged``) or K6 on a 17-row verify block: two launches (the
    16-row groups), every live row within TOL of the plain version over
    the whole block (bf16 plus ``ragged_rounding_bound``, whose largest
    err / bound is logged).  Returns the max abs error."""
    from hetu_tpu_torch.kernels import decode_attention as da
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.kernels import ragged_attention as ra
    B, Q = len(LENGTHS), 17
    g = torch.Generator(device="cuda").manual_seed(seed + 31)
    q = torch.randn((B, Q, H, DH), generator=g,
                    device="cuda").to(getattr(torch, dtype))
    lens, ql = (torch.from_numpy(a).cuda() for a in (LENGTHS, LONG_QLENS))
    if paged:
        pool_k, pool_v, tables, _ = pool_case(torch, dtype, seed + 32)
        args = (q, pool_k, pool_v, lens, ql, torch.from_numpy(tables).cuda())
        run, plain = (da.paged_block_verify_attention,
                      da.paged_block_verify_reference)
    else:
        k, v = slot_rows_case(torch, dtype, seed + 33)
        args = (q, k, v, lens, ql)
        run, plain = da.paged_verify_attention, da.masked_verify_reference
    reset_launches()
    got = run(*args)
    torch.cuda.synchronize()
    n = launch_counts()[run.__name__]
    want = plain(*args).to(q.dtype)
    if n != 2:
        fail(f"{run.__name__} {dtype} Q {Q}: {n} launches (want 2)")
    atol, rtol = TOL[dtype]
    bf16 = dtype == "bfloat16"
    if bf16:
        atol = atol + ra.ragged_rounding_bound(*args)
    worst = ratio = 0.0
    for b, m in enumerate(LONG_QLENS):
        if m == 0:
            continue
        err, r, ok = close(got[b, :m], want[b, :m],
                           atol[b, :m] if bf16 else atol, rtol)
        worst, ratio = max(worst, err), max(ratio, r)
        if not ok:
            fail(f"{run.__name__} {dtype} Q {Q}: slot {b} max abs err "
                 f"{err}, largest err / bound {r} (TOL {TOL[dtype]}"
                 f"{' + ragged_rounding_bound' if bf16 else ''})")
    log(f"  {run.__name__} {dtype} at Q {Q} (two 16-row groups, 2 "
        f"launches): live rows == plain version, max abs err {worst:.3e}, "
        f"largest err / bound {ratio:.4f}"
        f"{' (TOL + ragged_rounding_bound)' if bf16 else ''}")
    return worst


def deep_spec(torch, htt, params, cfg, spec, prompts, seed):
    """Speculation deeper than the verify kernels' 16 rows: K6/K7 at Q 17
    against their plain versions; then GPT-2-small cut to 4 layers, f32:
    phase-split ``ServingEngine(spec=16, spec_adapt=False)`` on the slot
    rows and on the pool, and ``generate_fast(spec=16)``, each with the
    greedy tokens of its ``spec=0`` run and two verify launches per layer
    per wave."""
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    for paged in (False, True):
        for dt in ("float32", "bfloat16"):
            check_long_verify(torch, dt, seed, paged)
    L, K = 4, 16
    cfg4 = htt.GPTConfig(num_hidden_layers=L)
    layer = re.compile(r"gpt_h(\d+)_")
    p4 = {k: v for k, v in params.items()
          if not layer.match(k) or int(layer.match(k).group(1)) < L}
    greedy = [i for i, (_, t, _) in enumerate(spec) if t == 0]
    for config in ("contiguous-split", "paged-split"):
        plain, _, _ = serve(torch, htt, p4, cfg4, spec, "float32", config)
        res, _, st = serve(torch, htt, p4, cfg4, spec, "float32", config,
                           spec=K, spec_adapt=False)
        bad = [i for i in greedy
               if list(res[f"r{i}"].tokens) != list(plain[f"r{i}"].tokens)]
        if bad:
            fail(f"spec {K} {config} ({L} layers): greedy tokens differ "
                 f"from spec 0's for requests {bad}")
        log(f"  spec {K} {config} f32, {L} layers: greedy tokens == spec "
            f"0's ({len(greedy)} requests), {st['spec_waves']} waves")
    want_tok = htt.generate_fast(p4, cfg4, prompts, 32, dtype=torch.float32)
    torch.cuda.synchronize()
    reset_launches()
    out = htt.generate_fast(p4, cfg4, prompts, 32, spec=K,
                            dtype=torch.float32)
    torch.cuda.synchronize()
    counts = launch_counts()
    Ld = L // 4
    waves = counts["paged_verify_attention"] // (2 * L)
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=L + Ld,
                paged_verify_attention=2 * L * waves,
                paged_decode_attention=Ld * (K + 1) * waves)
    if counts != want or not waves:
        fail(f"offline spec {K}: launches {counts}, want {want}")
    if out.tolist() != want_tok.tolist():
        fail(f"offline generate_fast(spec={K}) f32 tokens differ from "
             f"spec 0's ({L} layers)")
    log(f"  generate_fast spec {K} f32, {L} layers: tokens == spec 0's; "
        f"{waves} verify waves, launches {counts}")


def margin_gate(torch, params, cfg, want, got, prompt_len, oracle,
                low="int8"):
    """The JAX package's int8 criterion (``teacher_forced_logits``): the
    int8 run's greedy tokens ``got`` equal the f32 run's ``want``, or
    they first differ at a position whose exact top-2 margin is at most
    2 delta, delta the largest |fake-quant - exact| logit gap over the
    f32 sequence.  ``low="bf16"`` is the same gate for a bf16 run, with
    the bf16 teacher-forced pass in the place of the fake-quantized one.
    ``oracle`` caches the two teacher-forced passes per sequence.
    Returns None when identical, else (position, margin, delta); fails
    past the gate."""
    from hetu_tpu_torch.models.gpt_decode import teacher_forced_logits
    want, got = list(want), list(got)
    if want == got:
        return None
    t = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    key = tuple(want)
    if key not in oracle:
        seq = np.asarray(want[:-1], np.int64)
        exact = teacher_forced_logits(params, cfg, seq, dtype=torch.float32)
        fake = teacher_forced_logits(
            params, cfg, seq, kv_fake_quant=low == "int8",
            dtype=torch.float32 if low == "int8" else torch.bfloat16)
        oracle[key] = (exact, float((fake - exact).abs().max()))
    exact, delta = oracle[key]
    top2 = torch.topk(exact[t - 1], 2).values
    margin = float(top2[0] - top2[1])
    if t < prompt_len or margin > 2 * delta:
        fail(f"{low} greedy tokens first differ from f32 at position {t} "
             f"(prompt {prompt_len}), exact top-2 margin {margin:.4e} > "
             f"2 delta = {2 * delta:.4e}")
    return t, margin, delta


def phase7(torch, htt, params, cfg, spec, res32, card):
    """The int8 KV cache (``kv_quant="int8"``) through all four engine
    configurations, f32 then bf16: exact launches of the int8 twins (and
    none of their float twins), the footprint from the shapes, and the
    margin gate of every f32 greedy request against phase 4; then
    ``spec=4`` in all four, f32 then bf16, whose f32 tokens (greedy and
    sampled) equal the non-speculative int8 run's.  Returns
    ({(config, dtype): (results, launches, stats)} without speculation,
    the same with)."""
    L = cfg.num_hidden_layers
    Dh = cfg.hidden_size // cfg.num_attention_heads
    greedy = [i for i, (_, t, _) in enumerate(spec) if t == 0]
    runs, spec_runs, oracle = {}, {}, {}
    for config in CONFIGS:
        for dt in ("float32", "bfloat16"):
            runs[config, dt] = serve(torch, htt, params, cfg, spec, dt,
                                     config, kv_quant="int8")
        st = runs[config, "float32"][2]
        want = 2 * L * st["cache_rows"] * cfg.num_attention_heads * (Dh + 4)
        f32 = 2 * L * st["cache_rows"] * cfg.num_attention_heads * Dh * 4
        if st["cache_bytes"] != want:
            fail(f"int8 {config}: cache_bytes {st['cache_bytes']}, the "
                 f"shapes give {want}")
        res = runs[config, "float32"][0]
        gates = [margin_gate(torch, params, cfg, res32[f"r{i}"].tokens,
                             res[f"r{i}"].tokens, len(spec[i][0]), oracle)
                 for i in greedy]
        same = sum(g is None for g in gates)
        log(f"  int8 {config}: KV {st['cache_bytes']} B = "
            f"{st['cache_bytes'] / f32:.4f} of f32's {f32} B; f32 greedy "
            f"tokens identical to phase 4's for {same} of {len(greedy)} "
            f"requests, the rest first differ within the margin gate "
            f"(position, exact top-2 margin, delta): "
            f"{[g for g in gates if g is not None]}")
    for config in CONFIGS:
        for dt in ("float32", "bfloat16"):
            spec_runs[config, dt] = serve(torch, htt, params, cfg, spec, dt,
                                          config, kv_quant="int8", spec=4)
        res = spec_runs[config, "float32"][0]
        plain = runs[config, "float32"][0]
        bad = [i for i in range(len(spec))
               if list(res[f"r{i}"].tokens) != list(plain[f"r{i}"].tokens)]
        if bad:
            fail(f"int8 spec {config} f32 tokens differ from the "
                 f"non-speculative int8 run for requests {bad}")
        log(f"  int8 spec {config} f32: all {len(spec)} requests' tokens "
            f"(greedy and sampled) == the non-speculative int8 run's")
    for tag, rs in (("", runs), (" spec 4", spec_runs)):
        for (config, dt), (_, _, st) in rs.items():
            log(f"  int8 serving on {card}: {config}{tag} {dt} "
                f"{st['tokens_per_s']:.1f} tok/s, TTFT p50 "
                f"{st['ttft_p50_ms']:.1f} p99 {st['ttft_p99_ms']:.1f} ms")
    return runs, spec_runs


# ---------------------------------------------------------------- #
# phase 8: training
# ---------------------------------------------------------------- #

# K3 vs its plain version.  f32: atol 1e-4 + rtol 1e-4, the sums over up
# to 1024 rows run in another order.  bf16: both sides round P and dS to
# bf16 before the sums, and a value one f32 ulp apart may round to the
# neighbouring bf16 value, moving a sum by one bf16 ulp of one term; so
# atol is one bf16 ulp (2^-7) of the tensor's largest |want| and rtol
# one ulp.
K3_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -7, 2.0 ** -7)}
# the training shape: GPT-2-small at B 8, S 1024
TB, TS = 8, 1024


def k3_compare(got, want, dtype):
    """(max abs error, True when every element is within K3_TOL)."""
    atol, rtol = K3_TOL[dtype]
    got, want = got.float(), want.float()
    if dtype == "bfloat16":
        atol = atol * float(want.abs().max())
    diff = (got - want).abs()
    ok = bool(got.isfinite().all()
              and (diff <= atol + rtol * want.abs()).all())
    return float(diff.max()), ok


def k3_inputs(torch, B, S, Sk, D, dtype, seed, Hn=H):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q, do = (torch.randn((B, S, Hn, D), generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, Sk, Hn, D), generator=g, device="cuda").to(dt)
            for _ in range(2))
    return q, k, v, do


def check_k3_cases(torch, dtype, seed):
    """K3's two kernels against their plain versions on small cases: head
    dims 32/64/128; causal and not; kv_lens with a 0 and a full length;
    Sk > S (causal and not); S not a multiple of the 64-row tile.  The
    lse comes from the plain forward; sequence 1 (kv_lens 0) must get
    zero gradients."""
    from hetu_tpu_torch.kernels import flash_attention as fa
    cases = [(True, 100, 100, True), (False, 100, 100, True),
             (False, 40, 72, True), (True, 40, 72, False),
             (True, 128, 128, False)]
    worst = 0.0
    for D in (32, 64, 128):
        for causal, S, Sk, with_lens in cases:
            q, k, v, do = k3_inputs(torch, 3, S, Sk, D, dtype, seed + D, 4)
            lens = (torch.tensor([Sk - 3, 0, Sk], dtype=torch.int32,
                                 device="cuda") if with_lens else None)
            o, lse = fa.flash_fwd_reference(q, k, v, causal=causal,
                                            kv_lens=lens)
            delta = fa.bwd_delta(o, do)
            args = (q, k, v, lens, lse, delta, do)
            dk, dv = fa.flash_bwd_dkv(*args, causal=causal)
            dq = fa.flash_bwd_dq(*args, causal=causal)
            torch.cuda.synchronize()
            wk, wv = fa.flash_bwd_dkv_reference(*args, causal=causal)
            wq = fa.flash_bwd_dq_reference(*args, causal=causal)
            for name, got, want in (("dq", dq, wq), ("dk", dk, wk),
                                    ("dv", dv, wv)):
                err, ok = k3_compare(got, want, dtype)
                worst = max(worst, err)
                if not ok or (with_lens and got[1].abs().max() != 0):
                    fail(f"K3 {name} {dtype} D {D} causal {causal} S {S} "
                         f"Sk {Sk} kv_lens {with_lens}: max abs err {err} "
                         f"((atol, rtol) {K3_TOL[dtype]}, bf16 atol "
                         f"scaled by max |want|)")
    log(f"  K3 {dtype}: {3 * len(cases)} cases (D 32/64/128; causal and "
        f"not; kv_lens with 0; Sk > S; S 100/40) match the plain version, "
        f"max abs err {worst:.3e}")


def sdpa_backend(torch, q, k, v):
    """The name of the backend SDPA picks for causal attention on these
    inputs (torch._fused_sdp_choice)."""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True)).name


def check_k3(torch, F, dtype, seed, Hn=H):
    """K3's kernels and K2 at the training shape (B 8, S 1024, ``Hn``
    heads (12, or a tensor-parallel rank's 12/tp), D 64, causal, no
    kv_lens): each against its plain version, timed beside
    its bound; the yardsticks are SDPA's backward (autograd.grad through
    ``scaled_dot_product_attention(is_causal=True)``, the backward alone
    timed) and SDPA's forward.  Returns {"dkv", "dq", "fwd": result}."""
    from hetu_tpu_torch.kernels import flash_attention as fa
    q, k, v, do = k3_inputs(torch, TB, TS, TS, DH, dtype, seed + 21, Hn)
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, causal=True)
    err_o, ratio_o, ok = flash_compare(o, o_r, q, k, v, dtype, causal=True)
    lse_err = float((lse - lse_r).abs().max())
    if not ok or lse_err > LSE_TOL:
        fail(f"K2 at the training shape {dtype}: max abs err {err_o}, "
             f"largest err / bound {ratio_o}, lse {lse_err} (lse "
             f"{LSE_TOL})")
    delta = fa.bwd_delta(o, do)
    args = (q, k, v, None, lse, delta, do)
    es = q.element_size()
    n = TB * TS * Hn * DH * es                   # one [B, S, H, D] tensor
    stats = 2 * TB * Hn * TS * 4                 # lse and delta, f32
    pairs = TB * Hn * TS * (TS + 1) // 2         # live (q, k) pairs
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    backend = sdpa_backend(torch, qt, kt, vt)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), dot, retain_graph=True))
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    lib_bwd_run = time_run_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), dot, retain_graph=True))
    lib_fwd_run = time_run_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    res = {}
    # (kernel, plain, products, bytes: inputs read once, outputs written)
    for name, run, plain, prods, nbytes in (
            ("dkv", lambda: fa.flash_bwd_dkv(*args, causal=True),
             lambda: fa.flash_bwd_dkv_reference(*args, causal=True),
             4, 6 * n + stats),
            ("dq", lambda: fa.flash_bwd_dq(*args, causal=True),
             lambda: fa.flash_bwd_dq_reference(*args, causal=True),
             3, 5 * n + stats)):
        got = run()
        torch.cuda.synchronize()
        want = plain()
        errs = [k3_compare(g, w, dtype) for g, w in
                zip(got if name == "dkv" else (got,),
                    want if name == "dkv" else (want,))]
        err = max(e for e, _ in errs)
        if not all(ok for _, ok in errs):
            fail(f"K3 {name} {dtype} at the training shape: max abs err "
                 f"{err} ((atol, rtol) {K3_TOL[dtype]})")
        ms = time_ms(torch, run)
        run_ms = time_run_ms(torch, run)
        dev = device_ms(torch, run)
        plain_ms = time_ms(torch, plain, reps=5)
        flops = prods * 2 * DH * pairs
        b_ms, b_by = bound(nbytes, flops, dtype, tf32_method(dtype))
        res[name] = dict(err=err, ms=ms, run_ms=run_ms, dev_ms=dev,
                         plain_ms=plain_ms, library_ms=lib_bwd,
                         bound_ms=b_ms, bound_by=b_by)
        log(f"  K3 flash_attention_bwd_{name} {dtype} [{TB},{TS},{Hn},{DH}] "
            f"causal: "
            f"max_abs_err {err:.3e} (atol, rtol) {K3_TOL[dtype]}; kernel "
            f"{ms:.4f} ms ({run_ms:.4f} back to back, {ms_text(dev)} on the "
            f"device), plain "
            f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms by "
            f"{b_by} ({nbytes} B, {flops} flop, {prods} products"
            f"{', 3 TF32 passes' if dtype == 'float32' else ''})")
    # the whole backward: five products; q, k, v, o, dO, lse in, dq, dk,
    # dv out
    whole = time_ms(torch, lambda: fa.flash_bwd(q, k, v, None, o, lse, do,
                                                causal=True))
    whole_run = time_run_ms(torch, lambda: fa.flash_bwd(
        q, k, v, None, o, lse, do, causal=True))
    b_ms, b_by = bound(8 * n + TB * Hn * TS * 4, 5 * 2 * DH * pairs, dtype,
                       tf32_method(dtype))
    log(f"  K3 flash_bwd {dtype} (delta + both kernels): {whole:.4f} ms "
        f"({whole_run:.4f} back to back); "
        f"bound of the function {b_ms:.4f} ms by {b_by}; SDPA backward "
        f"({backend}) {lib_bwd:.4f} ms ({lib_bwd_run:.4f} back to back)")
    ms = time_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True))
    run_ms = time_run_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True))
    dev = device_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True))
    plain_ms = time_ms(torch, lambda: fa.flash_fwd_reference(
        q, k, v, causal=True), reps=5)
    b_ms, b_by = bound(4 * n + TB * Hn * TS * 4, 2 * 2 * DH * pairs, dtype,
                       tf32_method(dtype))
    res["fwd"] = dict(err=err_o, ratio=ratio_o, ms=ms, run_ms=run_ms,
                      dev_ms=dev, plain_ms=plain_ms,
                      library_ms=lib_fwd, bound_ms=b_ms, bound_by=b_by)
    log(f"  K2 flash_attention {dtype} at the training shape"
        f"{heads_label(Hn)}: max_abs_err "
        f"{err_o:.3e}, largest err / bound {ratio_o:.4f} (flash_compare), "
        f"lse {lse_err:.3e}; kernel {ms:.4f} ms "
        f"({run_ms:.4f} back to back, {ms_text(dev)} on the device), plain "
        f"{plain_ms:.4f} ms, SDPA forward ({backend}) {lib_fwd:.4f} ms "
        f"({lib_fwd_run:.4f} back to back); "
        f"bound {b_ms:.4f} ms by {b_by}"
        f"{' (3 TF32 passes)' if dtype == 'float32' else ''}")
    return res


def check_train_grads(torch, htt, cfg, seed, device="cuda"):
    """The loss and every gradient of ``GPTForCausalLMModule`` in f32 on
    one batch of the synthetic task, through the flash path (K2 forward, K3
    backward, with the model's q/k/v layout and K2's lse) and through the
    unfused path (no kernel), from the same weights: the loss within 1e-5
    relative, each gradient within 1e-4 of its tensor's max |g| (the
    paths sum softmax terms in another order).  k's bias gets an exact 0
    (it shifts a row of scores by a constant, which softmax ignores), so
    both paths' readings of it are held to 1e-5 of the largest |g|."""
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.train_gpt import synthetic
    x, y = next(synthetic(cfg, np.random.RandomState(seed)))
    feed = [torch.from_numpy(a).to(device) for a in (x, y)]
    L = cfg.num_hidden_layers
    res, values = {}, None
    for flash in (True, False):
        c = copy.copy(cfg)
        c.use_flash = flash
        model = htt.GPTForCausalLMModule(c, seed=seed).to(device)
        if values is None:
            values = {k: v.detach().clone()
                      for k, v in model.named_vars().items()}
        model.load_var_values(values)
        model.train()
        reset_launches()
        loss = model(*feed)
        names, params = zip(*model.named_vars().items())
        grads = torch.autograd.grad(loss, params)
        if device == "cuda":
            torch.cuda.synchronize()
        counts = launch_counts()
        want = dict.fromkeys(counts, 0)
        if flash and device == "cuda":
            want.update(flash_attention=L, flash_attention_bwd_dkv=L,
                        flash_attention_bwd_dq=L)
        if counts != want:
            fail(f"gradient check, flash={flash}: launches {counts}, want "
                 f"{want}")
        res[flash] = (float(loss.detach()), dict(zip(names, grads)))
        del model, loss, params, grads
    (lf, gf), (lu, gu) = res[True], res[False]
    if not abs(lf - lu) <= 1e-5 * abs(lu):
        fail(f"gradient check: flash loss {lf} vs unfused {lu} (rel 1e-5)")
    g_max = max(float(g.abs().max()) for g in gu.values())
    worst, worst_name = 0.0, None
    for n, want in gu.items():
        got = gf[n]
        if n.endswith("_attn_k_bias"):
            top = max(float(got.abs().max()), float(want.abs().max()))
            if not top <= 1e-5 * g_max:
                fail(f"gradient check: {n} should be 0, reads {top} "
                     f"(largest |g| {g_max})")
            continue
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if not err <= 1e-4 * scale:
            fail(f"gradient check: {n} flash vs unfused max abs err {err}, "
                 f"tol 1e-4 x {scale}")
        if err / scale > worst:
            worst, worst_name = err / scale, n
    log(f"  gradients f32, flash (K2 + K3) vs unfused, {len(gu)} tensors: "
        f"loss {lf:.6f} vs {lu:.6f}; worst error {worst:.3e} of its "
        f"tensor's max |g| ({worst_name}), tol 1e-4")
    return worst


def train(torch, htt, cfg, dtype, seed, steps=8, warm=2, prof_dir=None):
    """GPT-2-small training through ``Executor``: an eval forward of the
    first step's batch, ``steps`` AdamW + clip steps on the synthetic
    task, the eval forward again; launches counted over that whole run and held to
    the exact count.  Returns (executor, stats, launches)."""
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.optimizer import AdamWOptimizer
    from hetu_tpu_torch.train_gpt import profile_steps, synthetic
    t0 = time.perf_counter()
    model = htt.GPTForCausalLMModule(cfg, seed=seed)
    opt = AdamWOptimizer(learning_rate=3e-4, weight_decay=0.01)
    opt.clip_grad_norm = 1.0
    ex = htt.Executor(model, opt, seed=seed,
                      mixed_precision="bf16" if dtype == "bfloat16" else None)
    init_s = time.perf_counter() - t0
    data = synthetic(cfg, np.random.RandomState(seed))
    batches = [next(data) for _ in range(steps)]
    # the fixed batch is the first step's: eight steps at lr 3e-4 cannot
    # learn the 50257-token map (a token is seen ~1.3 times a batch), so
    # a fresh batch's loss stays at ln(V) within noise; the check is that
    # the model learns what it was shown
    held = {"input_ids": batches[0][0], "labels": batches[0][1]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    before = float(ex.evaluate(held)[0])
    losses, step_s = [], []
    for x, y in batches:
        t0 = time.perf_counter()
        loss = ex.run({"input_ids": x, "labels": y})[0]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    after = float(ex.evaluate(held)[0])
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_hidden_layers
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=L * (steps + 2),
                flash_attention_bwd_dkv=L * steps,
                flash_attention_bwd_dq=L * steps)
    if counts != want:
        fail(f"training {dtype}: launches {counts}, want {want} ({L} "
             f"layers, {steps} steps, 2 eval forwards)")
    if not all(np.isfinite(losses + [before, after])):
        fail(f"training {dtype}: a loss is not finite: {losses}, eval "
             f"{before} -> {after}")
    if not after < before:
        fail(f"training {dtype}: the first batch's eval loss did not fall: "
             f"{before} -> {after}")
    med = float(np.median(step_s[warm:]))
    stats = dict(step_ms=med * 1e3, tokens_per_s=TB * TS / med,
                 peak_bytes=peak, losses=losses, eval_before=before,
                 eval_after=after, init_s=init_s)
    log(f"  train {dtype}: losses {[round(v, 4) for v in losses]}; eval "
        f"loss of the first step's batch {before:.4f} -> {after:.4f}; step "
        f"{stats['step_ms']:.1f} ms (median of steps {warm + 1}-{steps}; "
        f"first {step_s[0] * 1e3:.1f} ms), {stats['tokens_per_s']:.1f} "
        f"tokens/s, peak memory {peak} B; model built in {init_s:.2f} s; "
        f"launches {counts}")
    if prof_dir is not None:
        for line in profile_steps(ex, iter(batches), 3,
                                  Path(prof_dir) / f"train_{dtype}"):
            log(f"  {dtype} {line}")
    return ex, stats, counts


def phase8(torch, F, htt, seed, card, prof_dir=None):
    """Training: 8a K3 (and K2 at the training shape), 8b GPT-2-small f32
    and bf16, 8c trained weights through the serving forward.  Returns
    ({kernel key: {dtype: result}}, {dtype: (stats, launches)})."""
    from hetu_tpu_torch.models.gpt_decode import teacher_forced_logits
    kres = {}
    for dt in ("float32", "bfloat16"):
        check_k3_cases(torch, dt, seed)
        for key, r in check_k3(torch, F, dt, seed).items():
            kres.setdefault(key, {})[dt] = r
    cfg = htt.GPTConfig(batch_size=TB, seq_len=TS, dropout_rate=0.0)
    if not cfg.use_flash:
        fail("GPT-2-small at seq 1024 with dropout 0 should take the flash "
             "path")
    check_train_grads(torch, htt, cfg, seed)
    runs = {}
    ex, st, counts = train(torch, htt, cfg, "float32", seed,
                           prof_dir=prof_dir)
    runs["float32"] = (st, counts)
    # 8c: the trained f32 weights through the serving forward
    seq = np.random.RandomState(seed + 2).randint(0, cfg.vocab_size, TS)
    want = ex.evaluate({"input_ids": seq[None].astype(np.int32)})[0]
    got = teacher_forced_logits(htt.params_from_numpy(ex.model.var_values()),
                                cfg, seq, dtype=torch.float32)
    err = float((got - want).abs().max())
    if got.shape != want.shape or not err <= 1e-4:
        fail(f"serving logits of the trained weights differ from the "
             f"training model's eval logits: max abs err {err} (tol 1e-4), "
             f"shapes {tuple(got.shape)} / {tuple(want.shape)}")
    log(f"  trained f32 weights -> teacher_forced_logits on one {TS}-token "
        f"sequence == the training model's eval logits (max abs err "
        f"{err:.3e}, tol 1e-4)")
    del ex, want, got
    ex, st, counts = train(torch, htt, cfg, "bfloat16", seed,
                           prof_dir=prof_dir)
    runs["bfloat16"] = (st, counts)
    del ex
    for dt, (st, _) in runs.items():
        log(f"  training on {card}: GPT-2-small {dt} B {TB} S {TS}: step "
            f"{st['step_ms']:.1f} ms, {st['tokens_per_s']:.1f} tokens/s, "
            f"peak {st['peak_bytes'] / 2 ** 30:.2f} GiB")
    return kres, runs


# ---------------------------------------------------------------- #
# phase 9: context parallelism
# ---------------------------------------------------------------- #

# K2-carry vs its plain version: the output is f32 for both input dtypes
# and both sides accumulate in f32 over the same inputs (atol, rtol
# 1e-5); in bf16 the kernel also rounds P against its running max
# (flash_compare adds fa.bf16_rounding_bound of the rounded terms), and
# the f32 output adds no rounding (rtol stays 1e-5)
CARRY_TOL = (1e-5, 1e-5)
# the ring at full width: GPT-2-small's attention (12 heads of 64) over
# twice the 4096 tokens of examples/nlp/train_long_context.py, cp 4
RB, RS, CP = 1, 8192, 4
# ring forward vs whole-sequence K2: f32 the JAX tests' bound; bf16 the
# same atol plus fa.bf16_rounding_bound (the two round P against
# different running maxima: the ring's carry seeds each rotation with
# the last one's lse, whole-sequence K2 with nothing), and one ulp of
# rtol (both round an f32 result to bf16 once)
RING_TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-5, 2.0 ** -7)}


def carry_inputs(torch, B, S, Sk, Hn, D, dtype, kind, seed):
    """q, k, v of ``dtype`` and a carry (o_c f32, lse_c f32): ``empty``
    (lse -1e30 everywhere), ``live``, or ``mixed`` (every third row
    empty)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((B, S, Hn, D), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((B, Sk, Hn, D), generator=g, device="cuda").to(dt)
            for _ in range(2))
    o_c = torch.randn((B, S, Hn, D), generator=g, device="cuda")
    lse_c = 2.0 * torch.randn((B, Hn, S), generator=g, device="cuda") + 3.0
    if kind == "empty":
        o_c.zero_()
        lse_c.fill_(-1e30)
    elif kind == "mixed":
        lse_c[..., ::3] = -1e30
    return q, k, v, o_c, lse_c


def carry_compare(torch, fa, args, causal):
    """(max abs error of o, the largest error of o over its bound, max
    abs error of the live lse, True when o is within CARRY_TOL (bf16:
    plus fa.bf16_rounding_bound), the lse within LSE_TOL and the dead
    rows agree)."""
    o, lse = fa.flash_fwd_carry(*args, causal=causal)
    o_r, lse_r = fa.flash_fwd_carry_reference(*args, causal=causal)
    q, k, v, _, lse_c = args
    atol = CARRY_TOL[0]
    if q.dtype == torch.bfloat16:
        atol = atol + fa.bf16_rounding_bound(q, k, v, causal=causal,
                                             lse_c=lse_c)
    err, ratio, o_ok = close(o, o_r, atol, CARRY_TOL[1])
    live = lse_r < 1e29
    lse_err = float((lse - lse_r)[live].abs().max()) if live.any() else 0.0
    ok = bool(o.dtype == torch.float32 and o_ok and lse_err <= LSE_TOL
              and (lse[~live] >= 1e29).all())
    return err, ratio, lse_err, ok


def check_carry(torch, dtype, seed):
    """9a: K2-carry against its plain version in small cases (head dims
    32/64/128; causal and not; an empty, live and mixed carry; S 100 and
    40, not multiples of the 32-row tile), then at the ring's block shape
    [1, 2048, 12, 64] with a live carry (a full rotation), timed beside
    its bound and its plain version."""
    from hetu_tpu_torch.kernels import flash_attention as fa
    worst = worst_ratio = 0.0
    n = 0
    for D in (32, 64, 128):
        for causal, S, Sk in ((True, 100, 100), (False, 40, 72)):
            for kind in ("empty", "live", "mixed"):
                args = carry_inputs(torch, 3, S, Sk, 4, D, dtype, kind,
                                    seed + D + S)
                err, ratio, lse_err, ok = carry_compare(torch, fa, args,
                                                        causal)
                torch.cuda.synchronize()
                worst = max(worst, err)
                worst_ratio = max(worst_ratio, ratio)
                n += 1
                if not ok:
                    fail(f"K2-carry {dtype} D {D} causal {causal} S {S} Sk "
                         f"{Sk} carry {kind}: max abs err {err}, largest "
                         f"err / bound {ratio}, lse {lse_err} ((atol, "
                         f"rtol) {CARRY_TOL}, bf16 plus the rounding "
                         f"bound; lse {LSE_TOL})")
    log(f"  K2-carry {dtype}: {n} cases (D 32/64/128; causal and not; "
        f"carry empty, live, mixed; S 100/40) match the plain version, "
        f"max abs err {worst:.3e}, largest err / bound {worst_ratio:.4f} "
        f"((atol, rtol) {CARRY_TOL}, bf16 plus the rounding bound)")
    blk = RS // CP
    args = carry_inputs(torch, RB, blk, blk, H, DH, dtype, "live",
                        seed + 40)
    err, ratio, lse_err, ok = carry_compare(torch, fa, args, False)
    if not ok:
        fail(f"K2-carry {dtype} at the ring's block shape: max abs err "
             f"{err}, largest err / bound {ratio}, lse {lse_err}")
    ms = time_ms(torch, lambda: fa.flash_fwd_carry(*args))
    run_ms = time_run_ms(torch, lambda: fa.flash_fwd_carry(*args))
    dev = device_ms(torch, lambda: fa.flash_fwd_carry(*args))
    plain_ms = time_ms(torch, lambda: fa.flash_fwd_carry_reference(*args),
                       reps=5)
    # q, k, v read once, o_c and lse_c read once, o (f32) and lse
    # written once; every (q, k) pair of the full block is live
    es = args[0].element_size()
    n_el = RB * blk * H * DH
    nbytes = 3 * n_el * es + 2 * n_el * 4 + 2 * RB * H * blk * 4
    flops = 4 * RB * H * blk * blk * DH
    b_ms, b_by = bound(nbytes, flops, dtype, tf32_method(dtype))
    log(f"  K2-carry flash_attention_carry {dtype} [{RB},{blk},{H},{DH}] "
        f"full rotation, live carry: max_abs_err {err:.3e}, largest err "
        f"/ bound {ratio:.4f}, lse "
        f"{lse_err:.3e}; kernel {ms:.4f} ms ({run_ms:.4f} back to back, "
        f"{ms_text(dev)} on the device), plain {plain_ms:.4f} ms, no "
        f"single PyTorch call computes a carried forward; bound "
        f"{b_ms:.4f} ms by {b_by} ({nbytes} B, {flops} flop"
        f"{', 3 TF32 passes' if dtype == 'float32' else ''})")
    return dict(err=max(worst, err), ratio=ratio, ms=ms, run_ms=run_ms,
                dev_ms=dev, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def check_ring(torch, F, htt, dtype, causal, seed):
    """9b: the cp-4 ring (``impl=None``, so the flash path on the card) on
    a virtual mesh of the card at B 1, S 8192, 12 heads of 64, against
    K2 (forward) and K2 + K3 (gradients of sum(o * g)) over the whole
    sequence, with exact launch counts; times of both and of SDPA, peak
    memory.  Returns the forward's launch counts and the numbers."""
    from hetu_tpu_torch.kernels import flash_attention as fa
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.parallel import make_mesh, ring_attention
    mesh = make_mesh({"cp": CP})
    g = torch.Generator(device="cuda").manual_seed(seed + 50)
    dt = getattr(torch, dtype)
    q, k, v, go = (torch.randn((RB, RS, H, DH), generator=g,
                               device="cuda").to(dt) for _ in range(4))
    live = CP + CP * (CP - 1) // 2 if causal else CP * CP

    def ring(*a):
        return ring_attention(*a, mesh=mesh, causal=causal)

    def whole(*a):
        return fa.flash_attention(*a, causal=causal)

    tag = f"ring {dtype} {'causal' if causal else 'full'}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_launches()
    o = ring(*xs)
    torch.cuda.synchronize()
    fwd_counts = launch_counts()
    reset_launches()
    grads = torch.autograd.grad(o, xs, go)
    torch.cuda.synchronize()
    bwd_counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want_f = dict.fromkeys(fwd_counts, 0)
    want_f["flash_attention_carry"] = live
    want_b = dict.fromkeys(bwd_counts, 0)
    want_b.update(flash_attention_bwd_dkv=live, flash_attention_bwd_dq=live)
    if fwd_counts != want_f or bwd_counts != want_b:
        fail(f"{tag}: forward launches {fwd_counts} (want {want_f}), "
             f"backward {bwd_counts} (want {want_b})")
    ys = [t.clone().requires_grad_() for t in (q, k, v)]
    o_w = whole(*ys)
    want = torch.autograd.grad(o_w, ys, go)
    f_atol, f_rtol = RING_TOL[dtype]
    if dtype == "bfloat16":
        f_atol = f_atol + fa.bf16_rounding_bound(q, k, v, causal=causal)
    err, ratio, ok = close(o, o_w, f_atol, f_rtol)
    if not ok:
        fail(f"{tag}: forward max abs err {err}, largest err / bound "
             f"{ratio}, vs whole-sequence K2 ((atol, rtol) "
             f"{RING_TOL[dtype]}, bf16 plus the rounding bound)")
    g_errs = []
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        m = float(b.float().abs().max())
        atol = (1e-4 if dtype == "float32" else CP * 2.0 ** -7) * m
        e, _, ok = close(a, b, atol, 0.0)
        g_errs.append(e / m)
        if not ok:
            fail(f"{tag}: {name} max abs err {e} vs K2 + K3 over the "
                 f"whole sequence (atol {atol}: "
                 f"{'1e-4' if dtype == 'float32' else f'{CP} bf16 ulps'} "
                 f"of the max {m})")

    def ring_fb():
        zs = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(ring(*zs), zs, go)

    def whole_fb():
        zs = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(whole(*zs), zs, go)

    qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, go))

    def sdpa_fb():
        zs = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        torch.autograd.grad(F.scaled_dot_product_attention(
            *zs, is_causal=causal), zs, gt)

    with torch.no_grad():
        t_ring = time_ms(torch, lambda: ring(q, k, v), reps=5, warm=1)
        t_whole = time_ms(torch, lambda: whole(q, k, v), reps=5, warm=1)
        t_sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), reps=5, warm=1)
    tb_ring = time_ms(torch, ring_fb, reps=3, warm=1)
    tb_whole = time_ms(torch, whole_fb, reps=3, warm=1)
    tb_sdpa = time_ms(torch, sdpa_fb, reps=3, warm=1)
    log(f"  {tag} cp {CP} [{RB},{RS},{H},{DH}]: forward max abs err "
        f"{err:.3e} vs whole-sequence K2, largest err / bound "
        f"{ratio:.4f} ((atol, rtol) {RING_TOL[dtype]}, bf16 plus the "
        f"rounding bound); gradients' max err / max |g| "
        f"{max(g_errs):.3e}; launches forward {live} K2-carry, backward "
        f"{live} of each K3 kernel; forward {t_ring:.4f} ms (whole K2 "
        f"{t_whole:.4f}, SDPA {t_sdpa:.4f}); forward + backward "
        f"{tb_ring:.4f} ms (whole K2 + K3 {tb_whole:.4f}, SDPA "
        f"{tb_sdpa:.4f}); peak {peak / 2 ** 20:.1f} MiB")
    return fwd_counts, dict(err=err, ring_ms=t_ring, whole_ms=t_whole,
                            sdpa_ms=t_sdpa, ring_fb_ms=tb_ring,
                            whole_fb_ms=tb_whole, sdpa_fb_ms=tb_sdpa,
                            peak_bytes=peak)


def check_ulysses(torch, dtype, seed):
    """9c: Ulysses (cp 4) on a virtual mesh of the card with the port's
    flash_attention as attn_fn: within 1e-6 of K2 over the whole
    sequence (each head group runs the same per-head arithmetic), with
    cp K2 launches; its forward and forward + backward times."""
    from hetu_tpu_torch.kernels import flash_attention as fa
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.parallel import make_mesh, ulysses_attention
    mesh = make_mesh({"cp": CP})
    g = torch.Generator(device="cuda").manual_seed(seed + 60)
    q, k, v, go = (torch.randn((RB, RS, H, DH), generator=g,
                               device="cuda").to(getattr(torch, dtype))
                   for _ in range(4))

    def uly(*a):
        return ulysses_attention(*a, mesh=mesh, causal=True,
                                 attn_fn=lambda q, k, v, c:
                                 fa.flash_attention(q, k, v, causal=c))

    reset_launches()
    got = uly(q, k, v)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = fa.flash_attention(q, k, v, causal=True)
    err = float((got.float() - want.float()).abs().max())
    n = counts["flash_attention"]
    if not err <= 1e-6 or n != CP or sum(counts.values()) != CP:
        fail(f"ulysses {dtype}: max abs err {err} vs whole-sequence K2 "
             f"(tol 1e-6), launches {counts} (want {CP} flash_attention)")

    def uly_fb():
        zs = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(uly(*zs), zs, go)

    with torch.no_grad():
        t_fwd = time_ms(torch, lambda: uly(q, k, v), reps=5, warm=1)
    t_fb = time_ms(torch, uly_fb, reps=3, warm=1)
    log(f"  ulysses {dtype} cp {CP} [{RB},{RS},{H},{DH}] causal, K2 as "
        f"attn_fn: max abs err {err:.3e} vs whole-sequence K2 (tol 1e-6), "
        f"{n} K2 launches; forward {t_fwd:.4f} ms, forward + backward "
        f"{t_fb:.4f} ms")


def phase9(torch, F, htt, seed):
    """Context parallelism: 9a K2-carry, 9b the ring, 9c Ulysses.
    Returns ({dtype: K2-carry result}, {dtype: the causal ring's forward
    launches})."""
    kres, counts = {}, {}
    for dt in ("float32", "bfloat16"):
        kres[dt] = check_carry(torch, dt, seed)
    for dt in ("float32", "bfloat16"):
        for causal in (True, False):
            c, _ = check_ring(torch, F, htt, dt, causal, seed)
            if causal:
                counts[dt] = c
    for dt in ("float32", "bfloat16"):
        check_ulysses(torch, dt, seed)
    return kres, counts

# ---------------------------------------------------------------- #
# phase 10: MoE serving
# ---------------------------------------------------------------- #

# the flagship MoE GPT at GPT-2-small width (the JAX package's
# bench.py MoE cell): 4 experts, top-2, capacity factor 2.0, every
# second block routed (six MoE blocks), experts of ffn_size / top_k =
# 1536 wide, so that the active FFN parameters equal the dense model's
MOE = dict(num_experts=4, top_k=2, capacity_factor=2.0, moe_every=2,
           expert_size=1536)


@contextlib.contextmanager
def moe_calls(torch, annotate=False):
    """Count the serving cores' ``moe_ffn`` calls while the block runs;
    with ``annotate`` each call also runs under
    ``torch.profiler.record_function("moe_ffn")``, so that a profile
    gives the device time of its kernels (gate, dispatch, the two bmm,
    combine)."""
    from hetu_tpu_torch.models import gpt_decode as gd
    inner = gd.moe_ffn
    seen = collections.Counter()

    def counted(*a, **kw):
        seen["calls"] += 1
        if not annotate:
            return inner(*a, **kw)
        with torch.profiler.record_function("moe_ffn"):
            return inner(*a, **kw)

    gd.moe_ffn = counted
    try:
        yield seen
    finally:
        gd.moe_ffn = inner


def moe_profile(torch, htt, params, cfg, spec, dtype, windows=((0, 6),
                                                                (40, 46))):
    """The paged mixed MoE engine on the request set, ``windows`` of its
    steps (the prompt-chunk waves first, then decode waves) under
    torch.profiler: device ms of the MoE FFN (the kernels launched
    inside ``moe_ffn``) and of attention (K1), the device's busy ms and
    the window's wall.  Returns [{window, wall_ms, busy_ms, moe_ms,
    attn_ms, matmul_ms, moe_calls}]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hetu_tpu_torch.serving import Request
    eng = htt.ServingEngine(params, cfg, slots=8, dtype=getattr(torch, dtype),
                            **CONFIGS["paged-mixed"])
    for i, (pr, t, k) in enumerate(spec):
        eng.submit(Request(prompt=pr, max_new_tokens=64, temperature=t,
                           top_k=k, seed=i, request_id=f"r{i}"))
    out = []
    for a, b in windows:
        while eng.steps < a:
            eng.step()
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with prof, moe_calls(torch, annotate=True) as seen:
            t0 = time.perf_counter()
            while eng.steps < b:
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = prof.key_averages()
        kern = [e for e in rows if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0 and e.key != "moe_ffn"]
        if not kern:
            fail("the profiler recorded no device time")
        ms = {"busy": 0.0, "attn": 0.0, "matmul": 0.0}
        for e in kern:
            t_ms = e.self_device_time_total / 1e3
            ms["busy"] += t_ms
            kind = kind_of(e.key)
            if re.match(r"K\d", kind):
                ms["attn"] += t_ms
            elif kind == "matmul":
                ms["matmul"] += t_ms
        # the kernels launched under the annotation, and the span the
        # annotation covers on the device's timeline (gaps included)
        moe = [e for e in rows if e.key == "moe_ffn"]
        moe_ms = sum(e.device_time_total for e in moe
                     if e.device_type == DeviceType.CPU) / 1e3
        span_ms = sum(e.self_device_time_total for e in moe
                      if e.device_type == DeviceType.CUDA) / 1e3
        if moe_ms <= 0 and span_ms <= 0:
            fail("the profiler attributed no device time to moe_ffn")
        out.append(dict(window=(a, b), wall_ms=wall * 1e3,
                        busy_ms=ms["busy"], moe_ms=moe_ms,
                        moe_span_ms=span_ms, attn_ms=ms["attn"],
                        matmul_ms=ms["matmul"], moe_calls=seen["calls"]))
    eng.run()
    return out


def phase10(torch, htt, seed, spec, prompts, dense, card):
    """MoE serving at GPT-2-small width (``MOE``): offline
    ``generate_fast``, the four engine configurations, speculation, an
    int8 cache, a binding capacity and the dense oracle, each held to
    the checks the docstring lists.  ``dense``: phases 4-5's
    {(config, dtype): (results, launches, stats)} of the dense model on
    the same requests.  Returns (params, config, the paged mixed f32
    run) for phase 17."""
    from hetu_tpu_torch.models import moe_decode as md
    from hetu_tpu_torch.models.gpt_decode import teacher_forced_logits
    t10 = time.perf_counter()
    cfg = md.MoEDecodeConfig(**MOE)
    L, E, k = cfg.num_hidden_layers, cfg.num_experts, cfg.top_k
    n_moe = md.moe_spec_of(cfg).moe_layers(L)
    t0 = time.perf_counter()
    npp = md.init_moe_params(cfg, name="gpt", seed=seed)
    n_par = sum(v.size for v in npp.values())
    per_expert = sum(v[0].size for n, v in npp.items()
                     if "_moe_expert_stack_" in n) // n_moe
    params = htt.params_from_numpy(npp)
    del npp
    log(f"  MoE GPT-2-small ({E} experts, top-{k}, capacity factor "
        f"{cfg.capacity_factor}, {n_moe} MoE blocks, experts "
        f"{cfg.expert_size} wide): {n_par} parameters, "
        f"{n_par - n_moe * (E - k) * per_expert} active per token; "
        f"weights from seed {seed} in {time.perf_counter() - t0:.2f} s")

    # offline, then the four configurations in f32
    off, _ = offline(torch, htt, params, cfg, prompts, "float32")
    runs = {}
    for config in CONFIGS:
        runs[config, "float32"] = serve(torch, htt, params, cfg, spec,
                                        "float32", config)
    res32 = runs["paged-mixed", "float32"][0]
    for i in range(len(prompts)):
        got = res32[f"r{i}"].tokens[128:128 + 32]
        if list(got) != list(off[i, 128:]):
            fail(f"MoE f32 engine greedy tokens of r{i} differ from "
                 f"generate_fast")
    greedy = [i for i, (_, t, _) in enumerate(spec) if t == 0]
    for config in CONFIGS:
        res = runs[config, "float32"][0]
        bad = [i for i in greedy
               if list(res[f"r{i}"].tokens) != list(res32[f"r{i}"].tokens)]
        if bad:
            fail(f"MoE {config} f32 greedy tokens differ from paged-mixed "
                 f"for requests {bad}")
    log(f"  MoE f32: paged-mixed greedy == generate_fast ({len(prompts)} "
        f"prompts); every layout's greedy tokens == paged-mixed's "
        f"({len(greedy)} requests)")

    # bf16 under the dense bf16 engine's margin gate
    runs["paged-mixed", "bfloat16"] = serve(torch, htt, params, cfg, spec,
                                            "bfloat16", "paged-mixed")
    res16 = runs["paged-mixed", "bfloat16"][0]
    oracle = {}
    gates = [margin_gate(torch, params, cfg, res32[f"r{i}"].tokens,
                         res16[f"r{i}"].tokens, len(spec[i][0]), oracle,
                         low="bf16") for i in greedy]
    log(f"  MoE bf16 paged-mixed: greedy tokens == f32's for "
        f"{sum(g is None for g in gates)} of {len(greedy)} requests, the "
        f"rest first differ within the bf16 margin gate (position, exact "
        f"top-2 margin, delta): {[g for g in gates if g is not None]}")

    # speculation: the draft routes nothing
    with moe_calls(torch) as seen:
        sres, _, sst = serve(torch, htt, params, cfg, spec, "float32",
                             "paged-split", spec=4)
    plain = runs["paged-split", "float32"][0]
    bad = [i for i in range(len(spec))
           if list(sres[f"r{i}"].tokens) != list(plain[f"r{i}"].tokens)]
    if bad:
        fail(f"MoE spec 4 paged-split f32 tokens differ from the "
             f"non-speculative run for requests {bad}")
    target_calls = sst["prefill_dispatches"] + sst["steps"]
    if seen["calls"] != n_moe * target_calls:
        fail(f"MoE spec: {seen['calls']} moe_ffn calls, want {n_moe} x "
             f"{target_calls} target calls (the draft routes nothing)")
    log(f"  MoE spec 4 paged-split f32: all {len(spec)} requests' tokens "
        f"== non-speculative; moe_ffn calls {seen['calls']} = {n_moe} x "
        f"{target_calls} target calls, none from the draft "
        f"({sst['draft_prefills']} draft prefills, {sst['spec_waves']} "
        f"waves)")

    # int8 cache under phase 7's margin gate
    ires = serve(torch, htt, params, cfg, spec, "float32", "paged-mixed",
                 kv_quant="int8")[0]
    oracle = {}
    gates = [margin_gate(torch, params, cfg, res32[f"r{i}"].tokens,
                         ires[f"r{i}"].tokens, len(spec[i][0]), oracle)
             for i in greedy]
    log(f"  MoE int8 paged-mixed f32: greedy tokens == f32's for "
        f"{sum(g is None for g in gates)} of {len(greedy)} requests, the "
        f"rest first differ within the int8 margin gate: "
        f"{[g for g in gates if g is not None]}")

    # a capacity that binds
    bcfg = md.MoEDecodeConfig(**dict(MOE, capacity_factor=0.25))
    _, _, bst = serve(torch, htt, params, bcfg, spec, "float32",
                      "paged-mixed")
    if not sum(bst["expert_drops"]):
        fail("MoE capacity factor 0.25: no token was dropped")
    log(f"  MoE capacity factor 0.25 paged-mixed f32: drops "
        f"{bst['expert_drops']} (rate {bst['expert_drop_rate']:.4f}), "
        f"load + drop == positions x {k} x {n_moe} on all "
        f"{bst['moe_steps']} step records")

    # the dense oracle: phase 3's weights, experts replicated, k = E
    dcfg = htt.GPTConfig()
    dnp = gpt2_small_params(dcfg, seed)
    ocfg = md.MoEDecodeConfig(num_experts=4, top_k=4, capacity_factor=2.0,
                              moe_every=2)
    mp = md.convert_dense_to_moe(dnp, dcfg, ocfg, name="gpt")
    seq = np.random.default_rng(seed + 10).integers(0, dcfg.vocab_size,
                                                    1024)
    want = teacher_forced_logits(dnp, dcfg, seq, dtype=torch.float32)
    got = teacher_forced_logits(mp, ocfg, seq, dtype=torch.float32)
    err = float((got - want).abs().max())
    if not err <= 1e-4:
        fail(f"dense oracle: max |MoE - dense| logit {err:.3e} > 1e-4")
    log(f"  dense oracle (phase 3's weights, 4 replicated experts, top-4, "
        f"1024 tokens): max |MoE - dense| teacher-forced logit {err:.3e} "
        f"<= 1e-4 (logits up to {float(want.abs().max()):.3f})")
    del dnp, mp

    # device time of the MoE FFN against attention, and the host share
    for dt in ("float32", "bfloat16"):
        for w in moe_profile(torch, htt, params, cfg, spec, dt):
            a, b = w["window"]
            log(f"  MoE profile paged-mixed {dt} steps {a}-{b - 1} on "
                f"{card}: MoE FFN {w['moe_ms']:.3f} ms of kernels "
                f"({w['moe_span_ms']:.3f} ms annotated span, "
                f"{w['moe_calls']} calls) vs attention (K1) "
                f"{w['attn_ms']:.3f} ms; all "
                f"matmuls {w['matmul_ms']:.3f} ms; device busy "
                f"{w['busy_ms']:.3f} of {w['wall_ms']:.3f} ms wall, host "
                f"share {1 - w['busy_ms'] / w['wall_ms']:.1%}")
    for (config, dt), (_, _, st) in runs.items():
        d = dense[config, dt][2]
        log(f"  MoE serving on {card}: {config} {dt} "
            f"{st['tokens_per_s']:.1f} tok/s (dense {d['tokens_per_s']:.1f}),"
            f" TTFT p50 {st['ttft_p50_ms']:.1f} (dense "
            f"{d['ttft_p50_ms']:.1f}) p99 {st['ttft_p99_ms']:.1f} (dense "
            f"{d['ttft_p99_ms']:.1f}) ms; expert load {st['expert_load']}, "
            f"imbalance {st['expert_imbalance']:.4f}, drop rate "
            f"{st['expert_drop_rate']:.4f}")
    log(f"  phase 10 in {time.perf_counter() - t10:.1f} s")
    return params, cfg, runs["paged-mixed", "float32"]


# ---------------------------------------------------------------- #
# phase 11: the serving fleet
# ---------------------------------------------------------------- #

# replica 0 dies at its 12th step of the fleet's run (mid-run: its
# slots full, its queue not empty)
FLEET_CHAOS = "seed=11,kill=12,role=replica0"
# the host tier's fleet: a pool of 44 blocks (43 usable), which the
# longest request (600 + 64 positions, 42 blocks) fits, but not beside
# the 11 blocks the shared prefix's registration holds
TIER_POOL_BLOCKS = 44
# the host ring: large enough to hold every prefix the 11d run evicts
# (~2.6 GB of f32 payloads: each cut of each evicted prompt spills), so
# the shared prefix is still there when its second user arrives
TIER_HOST_BYTES = 4 << 30


def fleet_requests(Request, spec, ids=None):
    """Phase 4's requests (ids r0..r15, seeds 0..15), all or ``ids``."""
    return [Request(prompt=pr, max_new_tokens=64, temperature=t, top_k=k,
                    seed=i, request_id=f"r{i}")
            for i, (pr, t, k) in enumerate(spec)
            if ids is None or i in ids]


def fleet_engine(torch, htt, params, cfg, **kw):
    """One replica: phase 4's engine (paged 16, mixed waves: the auto
    settings on CUDA), f32, 8 slots, its own copy of ``params`` (host
    numpy: each replica copies them onto the card, so a rolling swap
    reaches one replica at a time).  ``eng.launches`` counts the
    launches of its own steps (``launch_counts`` deltas)."""
    from hetu_tpu_torch.kernels import launch_counts
    eng = htt.ServingEngine(params, cfg, slots=8, dtype=torch.float32,
                            **CONFIGS["paged-mixed"], **kw)
    if (eng.paged, eng.ragged, eng.kv.block) != (True, True, 16):
        fail(f"fleet replica: paged={eng.paged} ragged={eng.ragged} "
             f"block {eng.kv.block}, want the auto paged mixed engine")
    eng.launches = collections.Counter()
    step = eng.step

    def counted_step():
        before = launch_counts()
        out = step()
        for k, v in launch_counts().items():
            eng.launches[k] += v - before[k]
        return out

    eng.step = counted_step
    return eng


def timed(torch, obj, name, log_to):
    """Wrap ``obj.name`` so each call appends (ms, result) to ``log_to``,
    the card synchronised before and after."""
    fn = getattr(obj, name)

    def call(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        log_to.append(((time.perf_counter() - t0) * 1e3, out))
        return out

    setattr(obj, name, call)


def fleet_tokens_equal(res, ref, ids, what):
    bad = [i for i in ids
           if list(res[f"r{i}"].tokens) != list(ref[f"r{i}"].tokens)]
    if bad:
        fail(f"{what}: tokens of requests {bad} differ")


def exact_engine_launches(eng, L, what):
    want = {k: v for k, v in want_launches(eng, L).items() if v}
    got = {k: v for k, v in eng.launches.items() if v}
    if got != want:
        fail(f"{what}: launches {got}, want {want}")
    return got


def fleet_stats(res, sec, snap):
    gen = sum(r.n_generated for r in res.values())
    return dict(tokens_per_s=gen / sec, seconds=sec, generated=gen,
                ttft_p50_ms=snap["ttft_p50_s"] * 1e3,
                ttft_p99_ms=snap["ttft_p99_s"] * 1e3)


def checksum(torch, params):
    return torch.stack([t.double().sum() for t in params.values()]).cpu()


def phase11(torch, htt, cfg, seed, spec, res32, st4, card):
    """The serving fleet: two replicas of phase 4's engine behind
    ``ServingRouter``; phase 4's requests; every gate below fails the
    run."""
    import os
    import tempfile

    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.ps import faults
    from hetu_tpu_torch.serving import (Request, ServingRouter,
                                        WeightSyncCoordinator)
    from hetu_tpu_torch.telemetry import trace
    L = cfg.num_hidden_layers
    t_phase = time.perf_counter()
    p1 = gpt2_small_params(cfg, seed)
    n = len(spec)
    everyone = range(n)
    greedy = [i for i, (_, t, _) in enumerate(spec) if t == 0]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    env0 = {k: os.environ.get(k) for k in (
        "HETU_CHAOS", "HETU_SERVE_LOG", "HETU_HANDOFF_QUANT",
        "HETU_KV_HOST_BYTES", "HETU_TELEMETRY")}

    def setenv(**kw):
        for k, v in kw.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reset_plans()
        telemetry.reset()

    try:
        setenv(HETU_TELEMETRY="1")
        # ---- the fleet, then 11a: a seeded chaos kill ---- #
        for label, chaos in (("fleet", None), ("11a chaos kill",
                                                FLEET_CHAOS)):
            slog = os.path.join(tmp, f"{label.split()[0]}.jsonl")
            setenv(HETU_CHAOS=chaos, HETU_SERVE_LOG=slog)
            router = ServingRouter(
                lambda i: fleet_engine(torch, htt, p1, cfg), replicas=2,
                restart_backoff=0.0)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            res = router.run(fleet_requests(Request, spec))
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            # supervision goes on past the run: a killed replica's
            # respawn lands within a few router steps
            deadline = time.perf_counter() + 60
            while any(r.state != "up" for r in router.replicas) \
                    and time.perf_counter() < deadline:
                router.step()
            snap = router.snapshot()
            if len(res) != n or snap["finished"] != n or snap["lost"] \
                    or snap["duplicates"]:
                fail(f"{label}: {len(res)} results, finished "
                     f"{snap['finished']}, lost {snap['lost']}, duplicates "
                     f"{snap['duplicates']} of {n} requests")
            fleet_tokens_equal(res, res32, everyone,
                               f"{label} vs phase 4 (f32, greedy and "
                               f"sampled)")
            events, bad = trace.read_events([slog])
            finishes = collections.Counter(
                e["request"] for e in events
                if e["event"] == "serve_finish")
            hops = [e for e in events if e["event"] == "router_hop"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = trace.main([slog, "--check"])
            if bad or rc:
                fail(f"{label}: trace --check rc {rc} ({bad} bad "
                     f"records): {buf.getvalue()[-800:]}")
            st = fleet_stats(res, sec, snap)
            routed = [row["routed"] for row in snap["replicas"]]
            if chaos is None:
                counts = launch_counts()
                per = [exact_engine_launches(r.engine, L,
                                             f"fleet replica {r.index}")
                       for r in router.replicas]
                k1 = sum(p.get("ragged_paged_attention", 0) for p in per)
                if counts["ragged_paged_attention"] != k1 or min(routed) < 1:
                    fail(f"fleet: K1 launches {counts}, the replicas' "
                         f"{per}; routed {routed}")
                st_fleet = st
                log(f"  fleet of 2 on {card}: {n} requests routed {routed}, "
                    f"all tokens == phase 4's; K1 launched {k1} times "
                    f"(layers x steps of each replica); "
                    f"{st['generated']} tokens in {st['seconds']:.3f} s = "
                    f"{st['tokens_per_s']:.1f} tok/s, fleet TTFT p50 "
                    f"{st['ttft_p50_ms']:.1f} ms p99 "
                    f"{st['ttft_p99_ms']:.1f} ms (phase 4's one engine "
                    f"{st4['tokens_per_s']:.1f} tok/s, TTFT p50 "
                    f"{st4['ttft_p50_ms']:.1f} p99 {st4['ttft_p99_ms']:.1f} "
                    f"ms); trace --check clean")
            else:
                peer = [e for e in hops if e.get("from_replica") == 0
                        and e.get("to_replica") == 1]
                if not peer or snap["requeued"] < 1 \
                        or snap["replicas"][0]["restarts"] != 1 \
                        or any(v != 1 for v in finishes.values()) \
                        or len(finishes) != n:
                    fail(f"11a: hops {len(hops)} (to the peer "
                         f"{len(peer)}), requeued {snap['requeued']}, "
                         f"restarts {snap['replicas'][0]['restarts']}, "
                         f"serve_finish per request {dict(finishes)}")
                log(f"  11a: {FLEET_CHAOS} killed replica 0; "
                    f"{snap['requeued']} requests requeued, "
                    f"{len(peer)} router_hop events to replica 1, replica 0 "
                    f"restarted once; every request retired once, routed "
                    f"{routed}; all tokens == phase 4's; trace --check "
                    f"clean; {st['tokens_per_s']:.1f} tok/s, TTFT p50 "
                    f"{st['ttft_p50_ms']:.1f} ms p99 "
                    f"{st['ttft_p99_ms']:.1f} ms")
            del router
            torch.cuda.empty_cache()
        setenv(HETU_CHAOS=None, HETU_SERVE_LOG=None)

        # ---- 11b: prefill on A, decode on B, over both wires ---- #
        oracle, wires = {}, {}
        for wire in ("auto", "int8"):
            setenv(HETU_HANDOFF_QUANT=wire)
            exports, imports = [], []
            router = ServingRouter(
                lambda i: fleet_engine(torch, htt, p1, cfg), replicas=2,
                roles="prefill,decode")
            a, b = (r.engine for r in router.replicas)
            timed(torch, a.kv, "export_blocks", exports)
            timed(torch, b.kv, "import_blocks", imports)
            reset_launches()
            res = router.run(fleet_requests(Request, spec))
            torch.cuda.synchronize()
            snap = router.snapshot()
            # a handoff B's pool cannot take yet (no free slot to write
            # through) degrades to a cold prefill there, as in the JAX
            # package: counted, never lost
            moved = snap["handoffs"]
            if len(res) != n or snap["lost"] or moved < 1 or moved \
                    + snap["handoff_failed"] + snap["handoffs_skipped"] != n:
                fail(f"11b {wire}: {len(res)} results, lost "
                     f"{snap['lost']}, {moved} handoffs, "
                     f"{snap['handoff_failed']} failed, "
                     f"{snap['handoffs_skipped']} skipped of {n}")
            la = exact_engine_launches(a, L, "11b replica A")
            lb = exact_engine_launches(b, L, "11b replica B")
            if lb.get("ragged_paged_attention", 0) < L or \
                    b.kv.imports < moved or b.kv.prefix_hits < moved:
                fail(f"11b {wire}: replica B launched {lb}, imported "
                     f"{b.kv.imports} spans, {b.kv.prefix_hits} prefix "
                     f"hits on them")
            if wire == "auto":
                fleet_tokens_equal(res, res32, everyone,
                                   "11b exact wire vs phase 4")
                gates = []
            else:
                gates = [margin_gate(torch, p1, cfg, res32[f"r{i}"].tokens,
                                     res[f"r{i}"].tokens, len(spec[i][0]),
                                     oracle) for i in greedy]
            ex_ms = [ms for ms, _ in exports]
            im_ms = [ms for ms, slot in imports if slot is not None]
            nbytes = [p["nbytes"] for _, p in exports]
            raw = [p["raw_nbytes"] for _, p in exports]
            wires[wire] = dict(
                exports=len(exports), export_ms=float(np.median(ex_ms)),
                import_ms=float(np.median(im_ms)), bytes=int(sum(nbytes)),
                raw_bytes=int(sum(raw)), quant=exports[0][1]["quant"])
            w = wires[wire]
            log(f"  11b {wire} wire on {card}: {moved} of {n} requests' "
                f"KV moved A -> B, {snap['handoff_failed']} admitted cold "
                f"on B (no free slot to import through) "
                f"({w['quant'] or 'exact'} payloads), {w['bytes']} B "
                f"on the wire for {w['raw_bytes']} f32-equivalent B "
                f"({w['bytes'] / w['raw_bytes']:.4f}); export median "
                f"{w['export_ms']:.3f} ms (max {max(ex_ms):.3f}), import "
                f"median {w['import_ms']:.3f} ms (max {max(im_ms):.3f}) a "
                f"request; B launched {lb} over {b.kv.imports} imported "
                f"spans, A {la}; "
                + ("all tokens == phase 4's" if wire == "auto" else
                   f"f32 greedy tokens identical to phase 4's for "
                   f"{sum(g is None for g in gates)} of {len(greedy)}, "
                   f"the rest within the margin gate: "
                   f"{[g for g in gates if g is not None]}"))
            del router, a, b
            torch.cuda.empty_cache()
        setenv(HETU_HANDOFF_QUANT=None)

        # ---- 11c: a rolling swap to v2 ---- #
        p2 = gpt2_small_params(cfg, seed + 1)
        swaps = []

        def swap_engine(i):
            eng = fleet_engine(torch, htt, p1, cfg)
            timed(torch, eng, "swap_params", swaps)
            return eng

        router = ServingRouter(swap_engine, replicas=2)
        coord = WeightSyncCoordinator(router, p1, version=1)
        engines = [r.engine for r in router.replicas]
        ptrs = [{k: t.data_ptr() for k, t in e.params.items()}
                for e in engines]
        if not coord.begin(p2, 2):
            fail("11c: the coordinator refused the v2 push")
        live = router.run(fleet_requests(Request, spec))
        coord.drain()
        if coord.state != "done" or coord.committed_version != 2 \
                or coord.fleet_versions() != {0: 2, 1: 2} \
                or [r.engine for r in router.replicas] != engines:
            fail(f"11c: rollout {coord.state}, committed "
                 f"{coord.committed_version}, versions "
                 f"{coord.fleet_versions()}: {coord.last}")
        fresh = fleet_engine(torch, htt, p2, cfg)
        want2 = fresh.run(fleet_requests(Request, spec))
        del fresh
        v1 = [i for i in everyone if live[f"r{i}"].weight_version == 1]
        v2 = [i for i in everyone if live[f"r{i}"].weight_version == 2]
        if len(v1) + len(v2) != n:
            fail("11c: results stamped neither v1 nor v2")
        fleet_tokens_equal(live, res32, v1, "11c v1-stamped vs phase 4")
        fleet_tokens_equal(live, want2, v2, "11c v2-stamped vs a fresh v2 "
                           "engine")
        after = router.run([Request(prompt=r.prompt,
                                    max_new_tokens=64,
                                    temperature=r.temperature,
                                    top_k=r.top_k, seed=r.seed,
                                    request_id=r.request_id + "v2")
                            for r in fleet_requests(Request, spec)])
        if any(r.weight_version != 2 for r in after.values()):
            fail("11c: a request after the commit is not stamped v2")
        fleet_tokens_equal({k[:-2]: v for k, v in after.items()}, want2,
                           everyone, "11c after the commit vs a fresh v2 "
                           "engine")
        if [{k: t.data_ptr() for k, t in e.params.items()}
                for e in engines] != ptrs:
            fail("11c: a resident tensor moved during the swap")
        sums = [checksum(torch, e.params) for e in engines]
        bad = dict(p2)
        key = f"gpt_h{L - 1}_ffn_wo_weight"
        bad[key] = np.zeros((3, 3), np.float32)
        coord.begin(bad, 3)
        coord.drain()
        if coord.committed_version != 2 or coord.last["state"] == "done" \
                or any(not torch.equal(s, checksum(torch, e.params))
                       for s, e in zip(sums, engines)):
            fail(f"11c: a push with a wrong shape ({key}) was not refused "
                 f"cleanly: {coord.last}, committed "
                 f"{coord.committed_version}")
        swap_ms = [ms for ms, _ in swaps]
        param_bytes = sum(t.numel() * t.element_size()
                          for t in engines[0].params.values())
        log(f"  11c on {card}: v1 -> v2 rolled over both replicas under "
            f"live traffic ({len(v1)} requests retired on v1, {len(v2)} on "
            f"v2, each equal to its version's engine); after the commit "
            f"every replica at v2 and all {n} requests stamped v2 == a "
            f"fresh v2 engine's tokens; no resident tensor moved; "
            f"swap_params median {np.median(swap_ms):.1f} ms (max "
            f"{max(swap_ms):.1f}, {len(swap_ms)} swaps of {param_bytes} "
            f"B); a push with {key} of shape (3, 3) refused "
            f"({coord.last['state']}), params unchanged")
        del router, coord, engines
        torch.cuda.empty_cache()

        # ---- 11d: the host tier ---- #
        setenv(HETU_KV_HOST_BYTES=str(TIER_HOST_BYTES))
        router = ServingRouter(
            lambda i: fleet_engine(torch, htt, p1, cfg,
                                   pool_blocks=TIER_POOL_BLOCKS),
            replicas=2)
        if router.kv_tiers is None:
            fail("11d: HETU_KV_HOST_BYTES built no tier store")
        waves = ([4], list(range(8, n)), [5, 6, 7])
        res = {}
        for ids in waves:
            res.update(router.run(fleet_requests(Request, spec, ids)))
        spills = sum(r.engine.kv.spills for r in router.replicas)
        st = router.kv_tiers.stats()
        fetched = router.kv_tiers.fetches["host"]
        if spills < 1 or fetched < 1:
            fail(f"11d: {spills} spills, {fetched} host fetches: {st}")
        ids = [i for w in waves for i in w]
        fleet_tokens_equal(res, res32, ids, "11d vs phase 4")
        log(f"  11d on {card}: pools of {TIER_POOL_BLOCKS} blocks, "
            f"HETU_KV_HOST_BYTES {TIER_HOST_BYTES}: {spills} prefix spills "
            f"into the host ring, {fetched} fetched back at admission "
            f"({router.kv_tiers.fetch_bytes} B), "
            f"{sum(r.engine.kv.prefix_hits for r in router.replicas)} "
            f"prefix hits; the {len(ids)} requests' tokens == phase 4's")
        del router
        torch.cuda.empty_cache()
    finally:
        setenv(**env0)
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 11 in {time.perf_counter() - t_phase:.1f} s")
    return st_fleet, wires, swap_ms


# ---------------------------------------------------------------- #
# phase 12: the graph surface
# ---------------------------------------------------------------- #

# the JAX example's width (examples/nlp/train_long_context.py defaults)
LC = dict(batch=1, seq=4096, hidden=768, heads=12, layers_n=4, vocab=32000)
LC_STEPS = 10
LC_SGD_LR = 1.0


class GraphTrainSteps:
    """``train_gpt.profile_steps``' view of a graph executor's "train"
    subgraph on one fixed feed: ``run`` ignores the batch it is given."""

    def __init__(self, ex, feed):
        self.ex, self.feed, self.device = ex, feed, ex.device

    def run(self, _batch):
        return self.ex.run("train", feed_dict=self.feed)


def lc_executor(torch, ht, flash, mp, opt, seed):
    """(executor, ids, labels) over ``build_causal_lm`` at LC with the
    subgraphs "train" ([loss, opt.minimize(loss)]) and "eval" ([loss])."""
    from hetu_tpu_torch.train_long_context import build_causal_lm
    ids, labels, loss = build_causal_lm(use_flash=flash, **LC)
    ex = ht.Executor({"train": [loss, opt.minimize(loss)], "eval": [loss]},
                     mixed_precision=mp, seed=seed)
    return ex, ids, labels


def check_flash_autograd(torch, dtype, seed, shape, causal, lens, what):
    """K2 and K3's two kernels at ``shape`` [B, S, H, D] (``lens``: a
    kv_lens int32 tensor or None), through the call the graph makes
    (``flash_attention``'s autograd Function: (o, lse) forward,
    ``torch.autograd.grad`` of o), each against its plain version on the
    same inputs: o by flash_compare and the lse of every row within
    LSE_TOL, dq, dk and dv by k3_compare from the kernel's (lse, delta),
    as phase 8's training-shape check holds them; with ``lens``, dk and
    dv zero past each sequence's length.  Returns (the log line's
    fields, (q, k, v, do), the K3 arguments (q, k, v, lens, lse, delta,
    do))."""
    from hetu_tpu_torch.kernels import flash_attention as fa
    B, S, Hn, D = shape
    q, k, v, do = k3_inputs(torch, B, S, S, D, dtype, seed, Hn)
    if lens is not None:
        lens = lens.to(q.device)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    o, lse = fa.FlashAttention.apply(qg, kg, vg, lens, causal)
    dq, dk, dv = torch.autograd.grad(o, (qg, kg, vg), do)
    torch.cuda.synchronize()
    o, lse = o.detach(), lse.detach()
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, causal=causal,
                                        kv_lens=lens)
    err_o, ratio_o, ok = flash_compare(o, o_r, q, k, v, dtype, causal=causal,
                                       kv_lens=lens)
    lse_err = float((lse - lse_r).abs().max())
    where = f"{what} [{B},{S},{Hn},{D}]"
    if not ok or lse_err > LSE_TOL:
        fail(f"K2 {dtype} at {where}: max abs err {err_o}, largest err / "
             f"bound {ratio_o}, lse {lse_err} (lse {LSE_TOL})")
    args = (q, k, v, lens, lse, fa.bwd_delta(o, do), do)
    wk, wv = fa.flash_bwd_dkv_reference(*args, causal=causal)
    wq = fa.flash_bwd_dq_reference(*args, causal=causal)
    errs = {}
    for name, got, want in (("dq", dq, wq), ("dk", dk, wk), ("dv", dv, wv)):
        errs[name], ok = k3_compare(got, want, dtype)
        if not ok:
            fail(f"K3 {name} {dtype} at {where}: max abs err {errs[name]} "
                 f"((atol, rtol) {K3_TOL[dtype]}, atol scaled by max "
                 f"|want|)")
    for b, n in enumerate([] if lens is None else lens.tolist()):
        if (dk[b, n:] != 0).any() or (dv[b, n:] != 0).any():
            fail(f"K3 {dtype} at {where}: dk/dv of sequence {b} nonzero "
                 f"past its kv_lens {n}")
    log(f"  K2 and K3 {dtype} at {where}, "
        f"{'causal' if causal else 'non-causal'}"
        + ("" if lens is None else f", kv_lens {lens.tolist()}")
        + f", through flash_attention's autograd Function, match their "
        f"plain versions: o max abs err {err_o:.3e} (largest err / bound "
        f"{ratio_o:.4f}, flash_compare), lse {lse_err:.3e}; dq "
        f"{errs['dq']:.3e}, dk {errs['dk']:.3e}, dv {errs['dv']:.3e} "
        f"((atol, rtol) {K3_TOL[dtype]}, atol scaled by max |want|)"
        + ("" if lens is None else "; dk, dv zero past kv_lens"))
    return dict(o=err_o, ratio_o=ratio_o, lse=lse_err, **errs), \
        (q, k, v, do), args


def check_lc_kernels(torch, seed):
    """bf16 K2 and K3's two kernels at the shape phase 12a gives them
    ([1, 4096, 12, 64], causal, no kv_lens) against their plain versions
    (``check_flash_autograd``).  Returns the log line's fields."""
    Hn = LC["heads"]
    shape = (LC["batch"], LC["seq"], Hn, LC["hidden"] // Hn)
    return check_flash_autograd(torch, "bfloat16", seed + 22, shape, True,
                                None, "phase 12's shape")[0]


def flash_launches(counts, layers, steps=1):
    """``counts`` (launch_counts' keys) all 0 but K2, K3 dK/dV and K3 dQ,
    ``layers`` x ``steps`` each."""
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=layers * steps,
                flash_attention_bwd_dkv=layers * steps,
                flash_attention_bwd_dq=layers * steps)
    return want


def graph_steps(torch, ex, feed, steps, want, tag):
    """A warm-up run and ``steps`` more of the executor's "train"
    subgraph on one feed, each launching exactly ``want``; the peak
    memory counter is reset after the warm-up.  The loss (output 0) must
    stay finite and end below where it started.  Returns (outputs of
    each run, seconds of each run, bytes allocated at the reset, the
    launches of all the runs)."""
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    outs, secs = [], []
    total = collections.Counter()
    for i in range(steps + 1):
        reset_launches()
        t0 = time.perf_counter()
        out = ex.run("train", feed_dict=feed)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(out)
        counts = launch_counts()
        if counts != want:
            fail(f"{tag} step {i}: launches {counts}, want {want}")
        total.update(counts)
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
            at_reset = torch.cuda.memory_allocated()
    losses = [float(o[0]) for o in outs]
    if not all(np.isfinite(losses)):
        fail(f"{tag}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{tag}: the last loss {losses[-1]} is not below the first "
             f"{losses[0]}")
    return outs, secs, at_reset, total

def compare_sgd_updates(torch, weights, res, lr, tag):
    """Hold the flash graph's one SGD step to the unfused graph's:
    ``res`` {True: flash, False: unfused} of (loss, {name: f64 variable
    after the step}), both from ``weights``.  The losses within 1e-5
    relative; each variable's update (weights - after) / lr within 1e-4
    of that variable's largest update plus one f32 rounding of its
    largest |w| (each side rounds w - lr g once); the attention k bias,
    whose gradient is 0, within 1e-5 of the largest update of any
    variable.  Logs the worst error over its tolerance."""
    (lf, vf), (lu, vu) = res[True], res[False]
    if not abs(lf - lu) <= 1e-5 * abs(lu):
        fail(f"{tag}: flash loss {lf} vs unfused {lu} (rel 1e-5)")
    upd = {k: (torch.from_numpy(weights[k]).to(v.device).double() - v)
           / lr for k, v in vu.items()}
    g_max = max(float(u.abs().max()) for u in upd.values())
    worst, worst_name = 0.0, None
    for k, u in upd.items():
        err = float((vf[k] - vu[k]).abs().max()) / lr
        # each side rounds w - lr g to f32 once: half an ulp of the
        # largest |w| each
        ulp = 2.0 ** -23 * float(vu[k].abs().max()) / lr
        if k.endswith("_attn_k_bias"):
            if not err <= 1e-5 * g_max + ulp:
                fail(f"{tag}: {k} flash vs unfused {err} (its gradient is "
                     f"0; tol 1e-5 x {g_max} + {ulp})")
            continue
        scale = float(u.abs().max())
        if not err <= 1e-4 * scale + ulp:
            fail(f"{tag}: {k} flash vs unfused max abs err {err}, tol 1e-4 "
                 f"x {scale} + {ulp}")
        if err / (1e-4 * scale + ulp) > worst:
            worst, worst_name = err / (1e-4 * scale + ulp), k
    log(f"  {tag}: f32 one SGD step, flash (K2 + K3) vs unfused, {len(upd)} "
        f"variables: loss {lf:.6f} vs {lu:.6f}; largest update error "
        f"{worst:.3f} of its tolerance ({worst_name}; 1e-4 of the "
        f"variable's largest update + one f32 rounding)")
    return worst


def phase12(torch, htt, seed, card):
    """bf16 K2 and K3 at the graph's shape against their plain versions,
    12a bf16 Adam steps with exact launches, 12c the eval subgraph, 12b
    the f32 flash graph against the unfused one.  Returns the 12a
    stats."""
    from hetu_tpu_torch import graph as ht
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.train_long_context import fixed_stream
    t_phase = time.perf_counter()
    L = LC["layers_n"]
    x, y = fixed_stream(LC["batch"], LC["seq"], LC["vocab"])
    want_train = flash_launches(launch_counts(), L)
    want_eval = dict.fromkeys(launch_counts(), 0)
    want_eval.update(flash_attention=L)

    check_lc_kernels(torch, seed)
    torch.cuda.empty_cache()

    # ---- 12a ---- #
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ex, ids, labels = lc_executor(
        torch, ht, True, "bf16", ht.optim.AdamOptimizer(learning_rate=3e-4),
        seed)
    n_params = sum(v.numel() for v in ex.var_values.values())
    log(f"  12a: causal LM S {LC['seq']} B {LC['batch']} hidden "
        f"{LC['hidden']} {LC['heads']} heads {L} layers vocab "
        f"{LC['vocab']}: {n_params} parameters, built in "
        f"{time.perf_counter() - t0:.2f} s")
    feed = {ids: x, labels: y}
    outs, step_s, at_reset, _ = graph_steps(torch, ex, feed, LC_STEPS,
                                            want_train, "12a")
    losses = [float(o[0]) for o in outs]
    # the graph's own memory: what the steps held at their peak above
    # the allocation before the executor was built (weights, Adam's
    # state and the step's transients), and the steps' transients alone
    peak = torch.cuda.max_memory_allocated() - base
    transient = torch.cuda.max_memory_allocated() - at_reset
    step_ms = float(np.mean(step_s[1:])) * 1e3
    toks = LC["batch"] * LC["seq"] / (step_ms / 1e3)
    log(f"  12a on {card}: bf16 flash Adam, step {step_ms:.2f} ms (mean of "
        f"{LC_STEPS} after a warm-up step of {step_s[0] * 1e3:.1f} ms; "
        f"min {min(step_s[1:]) * 1e3:.2f}, max {max(step_s[1:]) * 1e3:.2f}), "
        f"{toks:.1f} tokens/s, peak memory of the graph {peak} B "
        f"({peak / 2 ** 30:.2f} GiB above the {base} B allocated before "
        f"the executor was built; the steps' transients {transient} B, "
        f"{transient / 2 ** 30:.2f} GiB); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; launches a step {want_train['flash_attention']} "
        f"K2, {L} K3 dK/dV, {L} K3 dQ")
    # three more steps under torch.profiler: the device's busy share and
    # its time by kernel kind
    from hetu_tpu_torch.train_gpt import profile_steps
    with tempfile.TemporaryDirectory() as prof_dir:
        for line in profile_steps(GraphTrainSteps(ex, feed),
                                  itertools.repeat((None, None)), 3,
                                  prof_dir):
            log(f"  12a {line}")

    # ---- 12c ---- #
    step_before = ex.step
    reset_launches()
    ev = float(ex.run("eval", feed_dict=feed)[0])
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != want_eval:
        fail(f"12c: eval launches {counts}, want {want_eval}")
    if ex.step != step_before or not np.isfinite(ev):
        fail(f"12c: step {step_before} -> {ex.step}, eval loss {ev}")
    log(f"  12c: eval subgraph loss {ev:.4f}, launches {L} K2 and no K3, "
        f"step stays {ex.step}")
    weights = ex.return_tensor_values()
    del ex
    torch.cuda.empty_cache()

    # ---- 12b ---- #
    res = {}
    for flash in (True, False):
        reset_launches()
        ex, ids, labels = lc_executor(
            torch, ht, flash, None,
            ht.optim.SGDOptimizer(learning_rate=LC_SGD_LR), seed)
        ex.load_dict(weights)
        loss = float(ex.run("train", feed_dict={ids: x, labels: y})[0])
        torch.cuda.synchronize()
        counts = launch_counts()
        want = want_train if flash else dict.fromkeys(counts, 0)
        if counts != want:
            fail(f"12b flash={flash}: launches {counts}, want {want}")
        res[flash] = (loss, {k: v.double() for k, v in ex.var_values.items()})
        del ex
        torch.cuda.empty_cache()
    compare_sgd_updates(torch, weights, res, LC_SGD_LR, "12b")
    log(f"  phase 12 in {time.perf_counter() - t_phase:.1f} s")
    return dict(step_ms=step_ms, tokens_per_s=toks, peak_bytes=peak,
                transient_bytes=transient, losses=losses, params=n_params)


# ---------------------------------------------------------------- #
# phase 13: BERT and the model zoo on the graph surface
# ---------------------------------------------------------------- #

# BERT-base pretraining at its 512 positions (BertConfig.base: 12 layers,
# hidden 768, 12 heads of 64, FFN 3072, vocab 30522)
BERT = dict(batch_size=8, seq_len=512)
BERT_STEPS = 10
BERT_SGD_LR = 1.0
BERT_SGD_LAYERS = 4
# 13-pre: K2/K3 at BERT's [8, 512, 12, 64], non-causal, kv_lens that no
# tile divides but the full one, down to a single live key (CLS alone)
BERT_SHAPE = (8, 512, 12, 64)
BERT_LENS = np.array([512, 384, 257, 130, 64, 17, 2, 1], np.int32)
# BertMoE-base: examples/nlp/train_bert_moe.py's defaults
BERT_MOE = dict(num_experts=8, top_k=1, capacity_factor=1.0, moe_every=2,
                num_hidden_layers=12, hidden_size=768, num_attention_heads=12,
                intermediate_size=3072, vocab_size=30522, batch_size=8,
                seq_len=128)
MOE_STEPS = 3
# 13d: each family at its example's defaults (examples/cnn/main.py,
# examples/ctr/run_hetu.py, examples/rec/run_hetu.py,
# examples/nlp/train_transformer.py, examples/moe/train_moe.py), but
# NCF's learning rate
ZOO = dict(
    resnet=dict(batch=128, lr=0.1),
    ctr=dict(batch=128, feature_dimension=100000, embedding_size=128),
    # NCF at the JAX test's lr (tests/test_models.py): at the example's
    # 0.01 its f32 loss stays 0.6931467652320862 for three steps
    ncf=dict(batch=1024, num_users=6040, num_items=3706, lr=0.5),
    mt=dict(vocab=64, hidden=64, layers=2, heads=4, ffn=128, batch=32,
            seq=12, lr=1e-3),
    moe=dict(batch_size=16, num_tokens=1024, model_dim=2048,
             hidden_size=2048, num_local_experts=2, top_k=2, lr=0.01))
ZOO_STEPS = 3


def check_bert_kernels(torch, F, dtype, seed, shape=BERT_SHAPE,
                       lens_np=BERT_LENS, tag="13-pre",
                       what="13-pre, BERT's shape"):
    """K2 and K3's two kernels at BERT-base's shape (``BERT_SHAPE``),
    non-causal with ``BERT_LENS`` (or ``shape`` with ``lens_np``, None
    for no kv_lens), against their plain versions
    (``check_flash_autograd``: rows past kv_lens attend to the live keys
    too; dk and dv zero past it).  Then each kernel timed beside its
    plain version, its bound over the live (q, k) pairs (live K and V
    rows read, every output written) and SDPA with the boolean
    key-padding mask (its forward for K2, its backward for K3).
    Returns {"fwd", "dkv", "dq": result}."""
    from hetu_tpu_torch.kernels import flash_attention as fa
    B, S, Hn, D = shape
    errs, (q, k, v, do), args = check_flash_autograd(
        torch, dtype, seed + 23, shape, False,
        None if lens_np is None else torch.from_numpy(lens_np), what)
    lens = args[3]
    live = np.full(B, S) if lens_np is None else lens_np
    shape = f"[{B},{S},{Hn},{D}]"
    es = q.element_size()
    nq = B * S * Hn * D * es                # one [B, S, H, D] tensor
    nkv = int(live.sum()) * Hn * D * es     # the live K (or V) rows
    stats = B * Hn * S * 4                  # lse or delta, f32
    pairs = S * int(live.sum()) * Hn        # every row sees its live keys
    key_live = None if lens is None else \
        (torch.arange(S, device=q.device)[None, :]
         < lens[:, None])[:, None, None, :]
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=key_live))
    qs, ks, vs = (x.clone().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=key_live)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (qs, ks, vs), dot, retain_graph=True))
    res = {}
    # (kernel, plain, products, bytes: inputs read once, outputs
    # written once, error)
    for key, run, plain, prods, nbytes, err in (
            ("fwd", lambda: fa.flash_fwd(q, k, v, causal=False, kv_lens=lens),
             lambda: fa.flash_fwd_reference(q, k, v, causal=False,
                                            kv_lens=lens),
             2, 2 * nq + 2 * nkv + stats
             + (0 if lens is None else lens.numel() * 4), errs["o"]),
            ("dkv", lambda: fa.flash_bwd_dkv(*args, causal=False),
             lambda: fa.flash_bwd_dkv_reference(*args, causal=False),
             4, 4 * nq + 2 * nkv + 2 * stats, max(errs["dk"], errs["dv"])),
            ("dq", lambda: fa.flash_bwd_dq(*args, causal=False),
             lambda: fa.flash_bwd_dq_reference(*args, causal=False),
             3, 3 * nq + 2 * nkv + 2 * stats, errs["dq"])):
        ms = time_ms(torch, run)
        run_ms = time_run_ms(torch, run)
        dev = device_ms(torch, run)
        plain_ms = time_ms(torch, plain, reps=5)
        flops = prods * 2 * D * pairs
        b_ms, b_by = bound(nbytes, flops, dtype, tf32_method(dtype))
        lib = lib_fwd if key == "fwd" else lib_bwd
        res[key] = dict(err=err, ms=ms, run_ms=run_ms, dev_ms=dev,
                        plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                        bound_by=b_by)
        log(f"  {tag}: {'K2' if key == 'fwd' else 'K3 ' + key} {dtype} "
            f"{shape}{'' if lens is None else ' kv_lens'}: kernel "
            f"{ms:.4f} ms ({run_ms:.4f} back to "
            f"back, {ms_text(dev)} on the device), plain {plain_ms:.4f} ms, "
            f"SDPA {'forward' if key == 'fwd' else 'backward'}"
            f"{'' if lens is None else ' with the key-padding mask'} "
            f"{lib:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
            f"({nbytes} B, {flops} flop over {pairs} live pairs"
            f"{', 3 TF32 passes' if dtype == 'float32' else ''})")
    return res


def bert_batch(cfg, seed):
    """One synthetic MLM/NSP batch in ``train_bert.synthetic_mlm_batch``'s
    form, with kv_lens from the seed between S/4 and S (sequence 0 full)
    and no MLM label past a sequence's length; ``mask`` is the same
    padding as the (B, S) 0/1 attention mask."""
    from hetu_tpu_torch.train_bert import synthetic_mlm_batch
    rng = np.random.RandomState(seed)
    ids, tok, _, mlm, nsp = synthetic_mlm_batch(rng, cfg)
    S = cfg.seq_len
    lens = rng.randint(S // 4, S + 1, cfg.batch_size).astype(np.int32)
    lens[0] = S
    live = np.arange(S)[None, :] < lens[:, None]
    mlm[~live] = -1
    return dict(ids=ids, tok=tok, mlm=mlm, nsp=nsp, lens=lens,
                mask=live.astype(np.float32))


def bert_graph(ht, model, flash):
    """(placeholders by name, loss) of a BERT pretraining model fed
    ``kv_lens`` (``flash``) or the (B, S) attention mask."""
    phs = {n: ht.placeholder_op(n) for n in ("ids", "tok", "mlm", "nsp")}
    if flash:
        phs["lens"] = ht.placeholder_op("lens")
        loss, _, _ = model(phs["ids"], phs["tok"], None, phs["mlm"],
                           phs["nsp"], kv_lens=phs["lens"])
    else:
        phs["mask"] = ht.placeholder_op("mask")
        loss, _, _ = model(phs["ids"], phs["tok"], phs["mask"], phs["mlm"],
                           phs["nsp"])
    return phs, loss


class RecordedGate:
    """An MoE gate that keeps what it returns (l_aux, indices_s,
    location_s, gates_s, capacity) in ``log``."""

    def __init__(self, gate, log):
        self.gate, self.log = gate, log

    def __call__(self, x):
        out = self.gate(x)
        self.log.append(out)
        return out


def phase13_bert(torch, seed, card):
    """13a: BERT-base bf16 AdamW steps on K2/K3 with kv_lens, exact
    launches, the graph's peak memory and a profile; 13b: f32 flash +
    kv_lens vs unfused + attention mask after one SGD step.  Returns
    ({dtype: K2/K3 launches of its main-path run}, 13a's stats)."""
    from hetu_tpu_torch import graph as ht
    from hetu_tpu_torch import models
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.train_gpt import profile_steps
    cfg = models.BertConfig.base(attention_probs_dropout_prob=0.0,
                                 use_flash_attention=True, **BERT)
    L, B, S = cfg.num_hidden_layers, cfg.batch_size, cfg.seq_len
    batch = bert_batch(cfg, seed + 13)
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    phs, loss = bert_graph(ht, models.BertForPreTraining(cfg), True)
    opt = ht.optim.AdamWOptimizer(learning_rate=1e-4, weight_decay=0.01)
    ex = ht.Executor({"train": [loss, opt.minimize(loss)]},
                     mixed_precision="bf16", seed=seed)
    n_params = sum(v.numel() for v in ex.var_values.values())
    log(f"  13a: BERT-base pretraining (MLM + NSP), {L} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, vocab "
        f"{cfg.vocab_size}, B {B} S {S}, kv_lens {batch['lens'].tolist()}: "
        f"{n_params} parameters, built in {time.perf_counter() - t0:.2f} s")
    feed = {p: batch[n] for n, p in phs.items()}
    want = flash_launches(launch_counts(), L)
    outs, secs, at_reset, launched = graph_steps(torch, ex, feed,
                                                 BERT_STEPS, want, "13a")
    peak = torch.cuda.max_memory_allocated() - base
    transient = torch.cuda.max_memory_allocated() - at_reset
    losses = [float(o[0]) for o in outs]
    step_ms = float(np.mean(secs[1:])) * 1e3
    toks = B * S / (step_ms / 1e3)
    live_toks = int(batch["lens"].sum()) / (step_ms / 1e3)
    log(f"  13a on {card}: bf16 flash AdamW, hidden dropout "
        f"{cfg.hidden_dropout_prob}, attention dropout 0; step "
        f"{step_ms:.2f} ms (mean of {BERT_STEPS} after a warm-up step of "
        f"{secs[0] * 1e3:.1f} ms; min {min(secs[1:]) * 1e3:.2f}, max "
        f"{max(secs[1:]) * 1e3:.2f}), {toks:.1f} tokens/s ({live_toks:.1f} "
        f"live), peak memory of the graph {peak} B ({peak / 2 ** 30:.2f} "
        f"GiB above the {base} B allocated before it was built; the steps' "
        f"transients {transient} B, {transient / 2 ** 30:.2f} GiB); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches a step {L} K2, {L} "
        f"K3 dK/dV, {L} K3 dQ")
    counts = {"bfloat16": launched}
    with tempfile.TemporaryDirectory() as prof_dir:
        for line in profile_steps(GraphTrainSteps(ex, feed),
                                  itertools.repeat((None, None)), 3,
                                  prof_dir):
            log(f"  13a {line}")
    weights = ex.return_tensor_values()
    del ex, outs
    torch.cuda.empty_cache()

    # ---- 13b ---- #
    res = {}
    for flash in (True, False):
        cfg_b = models.BertConfig.base(
            num_hidden_layers=BERT_SGD_LAYERS, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, use_flash_attention=flash,
            **BERT)
        phs, loss = bert_graph(ht, models.BertForPreTraining(cfg_b), flash)
        ex = ht.Executor({"train": [
            loss, ht.optim.SGDOptimizer(learning_rate=BERT_SGD_LR)
            .minimize(loss)]}, seed=seed)
        ex.load_dict(weights)
        reset_launches()
        lv = float(ex.run("train", feed_dict={p: batch[n]
                                              for n, p in phs.items()})[0])
        torch.cuda.synchronize()
        got = launch_counts()
        want = flash_launches(got, BERT_SGD_LAYERS if flash else 0)
        if got != want:
            fail(f"13b flash={flash}: launches {got}, want {want}")
        if flash:
            counts["float32"] = got
        res[flash] = (lv, {k: v.double() for k, v in ex.var_values.items()})
        del ex
        torch.cuda.empty_cache()
    log(f"  13b: BERT-base widths, {BERT_SGD_LAYERS} layers, f32, dropout "
        f"0, from 13a's weights: flash with kv_lens vs unfused with the "
        f"additive attention mask")
    worst = compare_sgd_updates(torch, weights, res, BERT_SGD_LR, "13b")
    return counts, dict(step_ms=step_ms, tokens_per_s=toks, peak_bytes=peak,
                        transient_bytes=transient, losses=losses,
                        params=n_params, worst_13b=worst)


def phase13_bert_moe(torch, seed, card):
    """13c: BertMoE-base bf16 AdamW steps with kv_lens on K2/K3: step
    time, the summed balance loss, and each MoE block's expert load,
    which sums to its routed tokens (B S k), kept rows min(load,
    capacity)."""
    from hetu_tpu_torch import graph as ht
    from hetu_tpu_torch import models
    from hetu_tpu_torch.kernels import launch_counts
    cfg = models.BertMoEConfig(attention_probs_dropout_prob=0.0,
                               use_flash_attention=True, **BERT_MOE)
    model = models.BertMoEForPreTraining(cfg)
    routes = []
    for layer in model.bert.encoder_layers:
        if hasattr(layer, "moe"):
            layer.moe.gate = RecordedGate(layer.moe.gate, routes)
    phs, loss = bert_graph(ht, model, True)
    opt = ht.optim.AdamWOptimizer(learning_rate=1e-4, weight_decay=0.01)
    extra = [r[0] for r in routes] + [r[1][0] for r in routes] \
        + [r[2][0] for r in routes]
    ex = ht.Executor({"train": [loss, opt.minimize(loss)] + extra},
                     mixed_precision="bf16", seed=seed)
    batch = bert_batch(cfg, seed + 14)
    feed = {p: batch[n] for n, p in phs.items()}
    L, n_moe = cfg.num_hidden_layers, len(routes)
    outs, secs, _, _ = graph_steps(torch, ex, feed, MOE_STEPS,
                                   flash_launches(launch_counts(), L), "13c")
    tokens = cfg.batch_size * cfg.seq_len
    cap = routes[0][4]
    loads = []
    for out in outs:
        aux = sum(float(a) for a in out[2:2 + n_moe])
        step_loads = []
        for j in range(n_moe):
            idx = out[2 + n_moe + j].reshape(-1).long()
            loc = out[2 + 2 * n_moe + j].reshape(-1)
            load = torch.bincount(idx, minlength=cfg.num_experts)
            kept = torch.bincount(idx[loc < cap], minlength=cfg.num_experts)
            if int(load.sum()) != tokens * cfg.top_k or not torch.equal(
                    kept, load.clamp(max=cap)):
                fail(f"13c block {j}: expert load {load.tolist()} (sum, "
                     f"want {tokens * cfg.top_k}), kept {kept.tolist()} "
                     f"(want min(load, {cap}))")
            step_loads.append(load.tolist())
        loads.append((aux, step_loads))
    losses = [float(o[0]) for o in outs]
    step_ms = float(np.mean(secs[1:])) * 1e3
    log(f"  13c on {card}: BertMoE-base ({cfg.num_experts} experts top-"
        f"{cfg.top_k}, capacity {cap} rows, MoE every {cfg.moe_every} "
        f"blocks: {n_moe} of {L}), B {cfg.batch_size} S {cfg.seq_len}, "
        f"bf16 flash AdamW: step {step_ms:.2f} ms (mean of {MOE_STEPS} "
        f"after a warm-up step of {secs[0] * 1e3:.1f} ms); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; balance loss (summed over "
        f"the MoE blocks) {loads[0][0]:.4f} -> {loads[-1][0]:.4f}; launches "
        f"a step {L} K2, {L} K3 dK/dV, {L} K3 dQ")
    for j, load in enumerate(loads[-1][1]):
        log(f"  13c: MoE block {j} expert load {load} (sum "
            f"{sum(load)} = {tokens} tokens x top-{cfg.top_k}; "
            f"{sum(max(0, n - cap) for n in load)} dropped)")
    return dict(step_ms=step_ms, losses=losses, aux=[a for a, _ in loads])


def zoo_steps(torch, ht, tag, loss, train, feed, card, steps=ZOO_STEPS):
    """``steps`` f32 steps of [loss, train] on one feed: the loss finite
    and falling; logs each step's wall time."""
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    t0 = time.perf_counter()
    ex = ht.Executor({"train": [loss, train]})
    build_s = time.perf_counter() - t0
    losses, secs = [], []
    reset_launches()
    for _ in range(steps):
        t0 = time.perf_counter()
        lv = float(ex.run("train", feed_dict=feed)[0])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(lv)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"13d {tag}: losses {losses} not finite and falling")
    launched = {k: v for k, v in launch_counts().items() if v}
    log(f"  13d {tag} on {card}: {steps} f32 steps, loss {losses[0]:.6f} "
        f"-> {losses[-1]:.6f}; wall a step "
        f"{', '.join(f'{s * 1e3:.1f}' for s in secs)} ms (executor built in "
        f"{build_s:.2f} s); kernel launches {launched or 'none'}")
    del ex
    torch.cuda.empty_cache()
    return secs


def phase13_zoo(torch, seed, card):
    """13d: three steps of each remaining zoo family at its example's
    defaults, on one fixed batch drawn from the seed."""
    from hetu_tpu_torch import graph as ht
    from hetu_tpu_torch import models
    rng = np.random.RandomState(seed + 15)
    out = {}

    c = ZOO["resnet"]
    x, y = ht.placeholder_op("x"), ht.placeholder_op("y_")
    loss, _ = models.resnet18(x, y)
    train = ht.optim.SGDOptimizer(learning_rate=c["lr"]).minimize(loss)
    feed = {x: rng.randn(c["batch"], 3, 32, 32).astype(np.float32),
            y: np.eye(10, dtype=np.float32)[rng.randint(0, 10, c["batch"])]}
    out["resnet18"] = zoo_steps(torch, ht, f"ResNet-18 B {c['batch']} "
                                f"3x32x32, SGD {c['lr']}", loss, train, feed,
                                card)

    c = ZOO["ctr"]
    dense, sparse, y = (ht.placeholder_op(n) for n in ("dense", "sparse",
                                                       "y_"))
    loss, _, _, train = models.wdl_criteo(
        dense, sparse, y, feature_dimension=c["feature_dimension"],
        embedding_size=c["embedding_size"])
    feed = {dense: rng.randn(c["batch"], 13).astype(np.float32),
            sparse: rng.randint(0, c["feature_dimension"],
                                (c["batch"], 26)).astype(np.int32),
            y: rng.randint(0, 2, (c["batch"], 1)).astype(np.float32)}
    out["wdl_criteo"] = zoo_steps(
        torch, ht, f"wdl_criteo features {c['feature_dimension']} embedding "
        f"{c['embedding_size']} B {c['batch']}", loss, train, feed, card)

    c = ZOO["ncf"]
    user, item, y = (ht.placeholder_op(n) for n in ("user", "item", "y_"))
    loss, _, train = models.neural_mf(user, item, y,
                                      num_users=c["num_users"],
                                      num_items=c["num_items"], lr=c["lr"])
    feed = {user: rng.randint(0, c["num_users"], c["batch"]).astype(np.int32),
            item: rng.randint(0, c["num_items"], c["batch"]).astype(np.int32),
            y: (rng.rand(c["batch"], 1) < 0.2).astype(np.float32)}
    out["neural_mf"] = zoo_steps(
        torch, ht, f"neural_mf users {c['num_users']} items "
        f"{c['num_items']} B {c['batch']}", loss, train, feed, card)

    c = ZOO["mt"]
    cfg = models.TransformerConfig(
        src_vocab_size=c["vocab"], tgt_vocab_size=c["vocab"],
        hidden_size=c["hidden"], num_layers=c["layers"],
        num_heads=c["heads"], ffn_size=c["ffn"], dropout_rate=0.0,
        batch_size=c["batch"], src_len=c["seq"], tgt_len=c["seq"])
    src, tgt, lbl = (ht.placeholder_op(n) for n in ("src", "tgt", "labels"))
    loss, _ = models.transformer_mt(src, tgt, lbl, config=cfg)
    train = ht.optim.AdamOptimizer(learning_rate=c["lr"]).minimize(loss)
    toks = rng.randint(1, c["vocab"], (3, c["batch"], c["seq"])).astype(
        np.int32)
    toks[2, :, -2:] = 0                      # padded labels: ignored
    feed = {src: toks[0], tgt: toks[1], lbl: toks[2]}
    out["transformer_mt"] = zoo_steps(
        torch, ht, f"transformer_mt hidden {c['hidden']} {c['layers']} "
        f"layers B {c['batch']} len {c['seq']}, Adam {c['lr']}", loss, train,
        feed, card)

    c = ZOO["moe"]
    X = rng.randn(c["batch_size"], c["num_tokens"], c["model_dim"]).astype(
        np.float32)
    Y = rng.randint(0, c["model_dim"], c["batch_size"] * c["num_tokens"]
                    ).astype(np.int32)
    for gate in ("top", "balance"):
        x, y = ht.placeholder_op("x"), ht.placeholder_op("y_")
        kw = {k: v for k, v in c.items() if k != "lr"}
        loss, _ = models.moe_mlp(x, y, gate_type=gate, sparse_labels=True,
                                 **kw)
        train = ht.optim.SGDOptimizer(learning_rate=c["lr"]).minimize(loss)
        out[f"moe_mlp {gate}"] = zoo_steps(
            torch, ht, f"moe_mlp --gate {gate}: {c['batch_size']} x "
            f"{c['num_tokens']} tokens of {c['model_dim']}, "
            f"{c['num_local_experts']} experts of {c['hidden_size']}"
            f"{', top-' + str(c['top_k']) if gate == 'top' else ''}", loss,
            train, {x: X, y: Y}, card)
    return out


def phase13(torch, F, seed, card):
    """Phase 13: 13-pre (K2/K3 at BERT's shape with kv_lens, both dtypes),
    13a/13b BERT-base, 13c BertMoE-base, 13d the rest of the zoo.
    Returns ({"fwd", "dkv", "dq": {dtype: result}}, {dtype: launches})."""
    t_phase = time.perf_counter()
    kres = collections.defaultdict(dict)
    for dt in ("float32", "bfloat16"):
        for key, r in check_bert_kernels(torch, F, dt, seed).items():
            kres[key][dt] = r
    torch.cuda.empty_cache()
    counts, _ = phase13_bert(torch, seed, card)
    phase13_bert_moe(torch, seed, card)
    phase13_zoo(torch, seed, card)
    log(f"  phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return kres, counts


# ---------------------------------------------------------------- #
# phase 14: data, schedules, metrics and checkpoints
# ---------------------------------------------------------------- #

FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures"
# 14a: GPT-2-small from a token file; 2^20 tokens in runs of ``run``
# over the first ``data_vocab`` ids (eight steps cannot learn a map over
# all 50257: the loss stays at ln V, as phase 8 found; over 1009 ids the
# model learns which ids occur)
GPT14 = dict(tokens=1 << 20, run=256, vocab=50257, data_vocab=1009,
             batch=8, seq=1024, steps=8, save_at=4, warmup=2, lr=3e-4,
             generate=16)
RESUME_RTOL = 1e-6
# 14b: the fine-tunes at BERT's published fine-tuning rate (the scripts'
# defaults, 5e-4 and 2e-3, are sized for their tiny default models)
BERT14 = dict(pretrain_steps=10, finetune_lr=5e-5, layers=12, hidden=768,
              heads=12, seq=128, squad_seq=384, doc_stride=128)
# 14c: wdl_criteo at 13d's cell (``ZOO["ctr"]``) over a Criteo file of
# ``rows`` rows, each categorical column drawing from ``cardinality``
# values (26 x 2000 ids < the table's 100000 rows)
CRITEO14 = dict(rows=8192, cardinality=2000, steps=12, save_at=6)


def token_file(path, seed, n, run, V):
    """A nanoGPT-format uint16 stream of ``n`` tokens: runs of ``run``
    tokens following next = (3 t + 7) % V from seeded starts."""
    rng = np.random.RandomState(seed)
    x = np.empty((n // run, run), np.int64)
    x[:, 0] = rng.randint(0, V, n // run)
    for k in range(1, run):
        x[:, k] = (3 * x[:, k - 1] + 7) % V
    x.astype(np.uint16).tofile(path)


def falling(losses, n=10):
    """The mean of the last ``n`` losses below the mean of the first."""
    n = min(n, len(losses) // 2)
    return float(np.mean(losses[-n:])) < float(np.mean(losses[:n]))


def gpt14_executor(torch, args, c):
    """``train_gpt.build`` with the warmup-cosine schedule set on its
    optimizer, and a record of the lr each optimizer step applied."""
    from hetu_tpu_torch import train_gpt
    from hetu_tpu_torch.lr_scheduler import CosineScheduler
    cfg, ex, stream = train_gpt.build(args)
    sched = CosineScheduler(c["lr"], total_steps=c["steps"],
                            warmup_steps=c["warmup"])
    opt = ex.optimizer
    opt.learning_rate = sched
    applied = []
    lr_value = opt.lr_value

    def recorded(step, device=None):
        lr = lr_value(step, device)
        applied.append((int(step), lr))
        return lr

    opt.lr_value = recorded
    return cfg, ex, stream, sched, applied


def check_applied(sched, applied, steps, tag):
    got = [(s, lr.cpu().numpy().tobytes()) for s, lr in applied]
    want = [(s, sched.value(s).tobytes()) for s in steps]
    if got != want:
        fail(f"{tag}: the lr applied at steps {[s for s, _ in applied]} "
             f"is not the scheduler's value")


def phase14_gpt(torch, seed, card, tmp):
    """14a.  Returns (the uninterrupted run's launches, the demo's)."""
    from hetu_tpu_torch import train_gpt
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    c = GPT14
    path = os.path.join(tmp, "train.bin")
    t0 = time.perf_counter()
    token_file(path, seed + 14, c["tokens"], c["run"], c["data_vocab"])
    args = train_gpt.parse_args([
        "--data-path", path, "--vocab-size", str(c["vocab"]), "--seq-len",
        str(c["seq"]), "--batch-size", str(c["batch"]), "--num-steps",
        str(c["steps"]), "--learning-rate", str(c["lr"])])
    cfg, ex, stream, sched, applied = gpt14_executor(torch, args, c)
    batches = [next(stream) for _ in range(c["steps"])]
    L, S = cfg.num_hidden_layers, cfg.seq_len
    log(f"  14a: {c['tokens']} tokens written and read through "
        f"--data-path in {time.perf_counter() - t0:.2f} s; GPT-2-small "
        f"{L} x {cfg.hidden_size}, vocab {cfg.vocab_size}, B "
        f"{cfg.batch_size} S {S}, flash {cfg.use_flash}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, secs = [], []
    for x, y in batches:
        t0 = time.perf_counter()
        loss = ex.run({"input_ids": x, "labels": y})[0]
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = c["steps"]
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=L * steps, flash_attention_bwd_dkv=L * steps,
                flash_attention_bwd_dq=L * steps)
    if counts != want:
        fail(f"14a: launches {counts}, want {want}")
    check_applied(sched, applied, range(steps), "14a")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"14a: losses {losses} not finite and falling")
    med = float(np.median(secs[2:]))
    log(f"  14a on {card}: losses {[round(v, 4) for v in losses]}; lr "
        f"applied {[float(lr) for _, lr in applied]}; step {med * 1e3:.1f} "
        f"ms (median of steps 3-{steps}; first {secs[0] * 1e3:.1f} ms), "
        f"{cfg.batch_size * S / med:.1f} tokens/s, peak memory {peak} B; "
        f"launches a step {L} K2, {L} K3 dK/dV, {L} K3 dQ")
    final = {k: v.clone() for k, v in ex.var_values.items()}
    del ex
    torch.cuda.empty_cache()

    # save after save_at steps, a fresh executor, load, the rest
    k = c["save_at"]
    _, ex, _, _, _ = gpt14_executor(torch, args, c)
    first = [float(ex.run({"input_ids": x, "labels": y})[0])
             for x, y in batches[:k]]
    ckpt = os.path.join(tmp, "gpt")
    t0 = time.perf_counter()
    ex.save(ckpt)
    save_s = time.perf_counter() - t0
    del ex
    torch.cuda.empty_cache()
    _, ex, _, sched, applied = gpt14_executor(torch, args, c)
    t0 = time.perf_counter()
    ex.load(ckpt)
    load_s = time.perf_counter() - t0
    if ex.step != k:
        fail(f"14a: the loaded executor is at step {ex.step}, want {k}")
    rest = [float(ex.run({"input_ids": x, "labels": y})[0])
            for x, y in batches[k:]]
    check_applied(sched, applied, range(k, steps), "14a resumed")
    resumed = first + rest
    w_rel = max(float((ex.var_values[n] - v).abs().max()
                      / v.abs().max().clamp_min(1e-30))
                for n, v in final.items())
    l_rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses))
    exact = resumed == losses and all(
        torch.equal(ex.var_values[n], v) for n, v in final.items())
    size = os.path.getsize(os.path.join(ckpt, "checkpoint.pkl"))
    if exact:
        log(f"  14a resume: steps {k + 1}-{steps} and the final weights "
            f"equal the uninterrupted run's bit for bit; checkpoint "
            f"{size} B, saved in {save_s:.2f} s, loaded in {load_s:.2f} s")
    elif max(l_rel, w_rel) <= RESUME_RTOL:
        log(f"  14a resume: NOT bit-equal, within {RESUME_RTOL} relative: "
            f"losses {resumed} vs {losses} (largest {l_rel:.3e}), weights "
            f"largest {w_rel:.3e}; checkpoint {size} B, saved in "
            f"{save_s:.2f} s, loaded in {load_s:.2f} s")
    else:
        fail(f"14a resume: losses {resumed} vs {losses} (largest relative "
             f"{l_rel:.3e}), weights largest relative {w_rel:.3e}")
    del final
    shutil.rmtree(ckpt)

    # --demo-generate: greedy full forwards vs generate_fast
    reset_launches()
    t0 = time.perf_counter()
    seq, fast = train_gpt.demo_generate(ex, cfg, c["generate"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    demo = launch_counts()
    P, n = 3, c["generate"]
    want = dict.fromkeys(demo, 0)
    want.update(flash_attention=L * (n + 1),
                paged_decode_attention=L * (n - 1))
    if demo != want:
        fail(f"14a demo-generate: launches {demo}, want {want}")
    if seq != fast:
        fail(f"14a demo-generate: greedy {seq} != generate_fast {fast}")
    log(f"  14a demo-generate {n}: greedy continuation of {seq[:P]} "
        f"{seq[P:]} == generate_fast's (match=True) in {gen_s:.2f} s; "
        f"launches {L} K2 a forward ({n} greedy forwards + the prefill), "
        f"{L} K4 a decode step ({n - 1} steps)")
    del ex
    torch.cuda.empty_cache()
    return counts, demo


def phase14_bert(torch, seed, card, tmp):
    """14b."""
    from hetu_tpu_torch import finetune_bert_glue, finetune_bert_squad
    from hetu_tpu_torch import train_bert
    corpus = str(FIXTURES / "tiny_corpus.txt")
    vocab = str(FIXTURES / "glue" / "vocab.txt")
    b = BERT14
    run = train_bert.build(train_bert.parse_args([
        "--data-path", corpus, "--vocab-path", vocab, "--seq-len",
        str(b["seq"]), "--batch-size", "8", "--num-steps",
        str(b["pretrain_steps"])]))
    cfg = run.cfg
    losses, secs = [], []
    for _ in range(BERT14["pretrain_steps"]):
        feed = dict(zip(run.feeds, run.next_batch()))
        t0 = time.perf_counter()
        losses.append(float(run.executor.run("train", feed_dict=feed)[0]))
        secs.append(time.perf_counter() - t0)
    if not all(np.isfinite(losses)):
        fail(f"14b pretraining: losses {losses} not finite")
    ckpt = os.path.join(tmp, "bert")
    run.executor.save(ckpt)
    n_vars = len(run.executor.variables)
    log(f"  14b pretraining on {card}: BERT-base {cfg.num_hidden_layers} x "
        f"{cfg.hidden_size}, FFN {cfg.intermediate_size}, vocab "
        f"{cfg.vocab_size} (the GLUE fixtures' wordpieces), B "
        f"{cfg.batch_size} S {cfg.seq_len} on the tiny corpus: losses "
        f"{[round(v, 4) for v in losses]}; step "
        f"{float(np.median(secs[1:])) * 1e3:.1f} ms (median after the "
        f"first, {secs[0] * 1e3:.1f} ms); saved {n_vars} variables")
    del run
    torch.cuda.empty_cache()
    widths = ["--num-layers", str(b["layers"]), "--hidden", str(b["hidden"]),
              "--heads", str(b["heads"]), "--learning-rate",
              str(b["finetune_lr"])]
    glue = finetune_bert_glue.main([
        "--task", "sst-2", "--data-dir", str(FIXTURES / "glue" / "SST-2"),
        "--vocab-path", vocab, "--seq-len", str(b["seq"]), "--batch-size",
        "8", "--init-checkpoint", ckpt] + widths)
    if not glue["loaded"] == glue["backbone"] > 0:
        fail(f"14b GLUE: loaded {glue['loaded']} backbone tensors of "
             f"{glue['backbone']}")
    if not (all(np.isfinite(glue["losses"])) and falling(glue["losses"])):
        fail(f"14b GLUE: losses {glue['losses']} not finite and falling")
    if "accuracy" not in glue["metrics"]:
        fail(f"14b GLUE: no dev metrics ({glue['metrics']})")
    log(f"  14b GLUE SST-2 on {card}: {glue['loaded']} backbone tensors "
        f"loaded of {glue['backbone']} (the classifier fresh); losses "
        f"{[round(v, 4) for v in glue['losses']]}; dev metrics "
        f"{glue['metrics']}; step {glue['step_ms']:.1f} ms (mean)")
    shutil.rmtree(ckpt)
    torch.cuda.empty_cache()
    squad = finetune_bert_squad.main([
        "--data", str(FIXTURES / "squad" / "train-tiny.json"),
        "--seq-len", str(b["squad_seq"]), "--doc-stride",
        str(b["doc_stride"])] + widths)
    if not (all(np.isfinite(squad["losses"])) and falling(squad["losses"])):
        fail(f"14b SQuAD: losses {squad['losses']} not finite and falling")
    if not all(np.isfinite([squad["exact_match"], squad["f1"]])):
        fail(f"14b SQuAD: exact match {squad['exact_match']}, F1 "
             f"{squad['f1']}")
    log(f"  14b SQuAD train-tiny on {card}: S {b['squad_seq']}, doc stride "
        f"{b['doc_stride']}; losses "
        f"{[round(v, 4) for v in squad['losses']]}; exact match "
        f"{squad['exact_match']:.2f}, F1 {squad['f1']:.2f}; step "
        f"{squad['step_ms']:.1f} ms (mean)")
    torch.cuda.empty_cache()


def criteo_file(path, seed, rows, cardinality):
    """Criteo's raw ``train.txt``: label, 13 integer and 26 hex
    categorical fields a row, tab-separated, a few left blank."""
    rng = np.random.RandomState(seed)
    label = rng.randint(0, 2, rows)
    dense = rng.randint(-1, 1000, (rows, 13)).astype(str)
    dense[rng.rand(rows, 13) < 0.05] = ""
    cats = np.char.mod("%08x", rng.randint(0, cardinality, (rows, 26)))
    cats[rng.rand(rows, 26) < 0.05] = ""
    with open(os.path.join(path, "train.txt"), "w") as f:
        for i in range(rows):
            f.write("\t".join([str(label[i])] + list(dense[i])
                              + list(cats[i])) + "\n")


def phase14_criteo(torch, seed, card, tmp):
    """14c."""
    from hetu_tpu_torch import data, models
    from hetu_tpu_torch import graph as ht
    c, z = CRITEO14, ZOO["ctr"]
    t0 = time.perf_counter()
    criteo_file(tmp, seed + 140, c["rows"], c["cardinality"])
    arrays = data.load_criteo(tmp)
    if int(arrays[1].max()) >= z["feature_dimension"]:
        fail(f"14c: {int(arrays[1].max()) + 1} ids exceed the table")
    log(f"  14c: Criteo train.txt of {c['rows']} rows written and loaded "
        f"by data.load_criteo in {time.perf_counter() - t0:.2f} s "
        f"({int(arrays[1].max()) + 1} categorical ids)")
    built = []

    def build(prefetch):
        ops = [ht.dataloader_op([ht.Dataloader(a, z["batch"], "train",
                                               shuffle=True, seed=seed)])
               for a in arrays]
        loss, _, _, train = models.wdl_criteo(
            *ops, feature_dimension=z["feature_dimension"],
            embedding_size=z["embedding_size"])
        ex = ht.Executor({"train": [loss, train]}, prefetch=prefetch,
                         seed=seed)
        built.append(ops)
        return ex, ops

    def steps(ex, n):
        losses, secs = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            losses.append(float(ex.run("train")[0]))
            secs.append(time.perf_counter() - t0)
        return losses, secs

    runs = {}
    try:
        for prefetch in (True, False):
            ex, ops = build(prefetch)
            device = ex.device
            runs[prefetch] = steps(ex, c["steps"])
            if prefetch:
                peeked = [op.peek_arr("train") for op in ops]
                if not all(isinstance(t, torch.Tensor)
                           and t.device == ex.device for t in peeked):
                    fail(f"14c: the prefetch ring's batches are not on "
                         f"{ex.device}")
            del ex
        if runs[True][0] != runs[False][0]:
            fail(f"14c: prefetch on {runs[True][0]} != off "
                 f"{runs[False][0]}")
        k = c["save_at"]
        ex, _ = build(True)
        first, _ = steps(ex, k)
        ckpt = os.path.join(tmp, "wdl")
        ex.save(ckpt)
        del ex
        ex, ops = build(True)
        ex.load(ckpt)
        rest, _ = steps(ex, c["steps"] - k)
        if first + rest != runs[True][0]:
            fail(f"14c resume: {first + rest} != {runs[True][0]}")
        consumed = {k2: v["consumed"] for k2, v in
                    ex._loader_states().items()}
        if set(consumed.values()) != {c["steps"]}:
            fail(f"14c resume: loader positions {consumed}")
        del ex
    finally:
        for ops in built:
            for op in ops:
                for ld in op.dataloaders.values():
                    ld.stop_prefetch()
    on, off = (float(np.median(runs[p][1][1:])) * 1e3 for p in (True, False))
    log(f"  14c on {card}: wdl_criteo features {z['feature_dimension']} "
        f"embedding {z['embedding_size']} B {z['batch']}, {c['steps']} SGD "
        f"steps: losses {[round(v, 6) for v in runs[True][0]]} equal with "
        f"prefetch on and off; the ring's batches on {device}; saved after "
        f"{k} steps, rebuilt, loaded: the batch stream and losses continue "
        f"exactly; step {on:.2f} ms with prefetch, {off:.2f} ms without "
        f"(medians after the first)")
    torch.cuda.empty_cache()


def phase14(torch, seed, card):
    """Phase 14: 14a GPT-2-small from a token file (schedule, save and
    resume, --demo-generate), 14b BERT-base from text to GLUE and SQuAD,
    14c dataloader feeds on the card.  Returns 14a's (training launches,
    demo launches)."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke14_")
    try:
        counts = phase14_gpt(torch, seed, card, tmp)
        phase14_bert(torch, seed, card, tmp)
        phase14_criteo(torch, seed, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------- #
# phase 15: pipeline and sharded training on the graph surface
# ---------------------------------------------------------------- #

PP15 = dict(batch=16, seq=512, microbatches=8, stages=4, steps=3, lr=0.005)
PP15_RTOL = 2e-4        # JAX's own tolerance for the pipelined BERT test
PP15_ATOL = 1e-6        # final tensors: 1e-6 + 2e-4 |plain|


def bert15(ht, models, batch):
    """BertForSequenceClassification(num_labels=3) at BERT-base's widths,
    S 512, flash attention, dropout 0, built at ``batch`` rows, with an
    SGD step: (ids, labels, loss, train)."""
    cfg = models.BertConfig.base(
        batch_size=batch, seq_len=PP15["seq"], hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, use_flash_attention=True)
    ids, labels = ht.placeholder_op("input_ids"), ht.placeholder_op("labels")
    loss, _ = models.BertForSequenceClassification(cfg, num_labels=3)(
        ids, labels=labels)
    train = ht.optim.SGDOptimizer(learning_rate=PP15["lr"]).minimize(loss)
    return ids, labels, loss, train


def bert15_batches(seed, n):
    rng = np.random.RandomState(seed)
    B, S = PP15["batch"], PP15["seq"]
    return [(rng.randint(0, 30522, (B, S)).astype(np.int32),
             rng.randint(0, 3, (B,)).astype(np.int32)) for _ in range(n)]


def steps15(torch, ex, ids, labels, batches, want, tag):
    """One run of ``ex``'s "train" per batch, each launching exactly
    ``want``: (losses, seconds, peak bytes above the allocation before
    each step, launches of all the steps)."""
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    losses, secs, peaks = [], [], []
    total = collections.Counter()
    for i, (a, b) in enumerate(batches):
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = ex.run("train", feed_dict={ids: a, labels: b})
        losses.append(float(out[0]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() - before)
        counts = launch_counts()
        if counts != want:
            fail(f"{tag} step {i}: launches {counts}, want {want}")
        total.update(counts)
    if not all(np.isfinite(losses)):
        fail(f"{tag}: a loss is not finite: {losses}")
    return losses, secs, peaks, total


def step_ms15(secs):
    """The median step ms after the first (warm-up) step."""
    return float(np.median(secs[1:])) * 1e3


def close15(got, want, tag):
    """Losses within PP15_RTOL of the plain executor's, and every final
    tensor within PP15_ATOL + PP15_RTOL |want| of it (the atol covers
    tensors the loss does not move, such as the key biases, which only
    rounding drifts).  Returns the worst err / that bound."""
    got_l, got_w = got
    want_l, want_w = want
    if not np.allclose(got_l, want_l, rtol=PP15_RTOL, atol=0):
        fail(f"{tag}: losses {got_l} vs the plain executor's {want_l} "
             f"(rtol {PP15_RTOL})")
    worst, where = 0.0, None
    for k, w in want_w.items():
        w = w.astype(np.float64)
        ratio = float((np.abs(got_w[k] - w)
                       / (PP15_ATOL + PP15_RTOL * np.abs(w))).max())
        if ratio > worst:
            worst, where = ratio, k
    if worst > 1:
        fail(f"{tag}: {where} differs from the plain executor's by "
             f"{worst:.3f} x (atol {PP15_ATOL}, rtol {PP15_RTOL})")
    return worst


def phase15a(torch, seed, card):
    """15a: BERT-base pipelined over four stages of a virtual mesh, gpipe
    and 1f1b against the plain executor.  Returns 1f1b's launches."""
    from hetu_tpu_torch import graph as ht
    from hetu_tpu_torch import models
    from hetu_tpu_torch.kernels import launch_counts
    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.pipeline import HIGH_WATER
    B, S, M, St = (PP15[k] for k in ("batch", "seq", "microbatches",
                                      "stages"))
    batches = bert15_batches(seed + 15, PP15["steps"])
    ids, labels, loss, train = bert15(ht, models, B)
    ex = ht.Executor({"train": [loss, train]}, seed=seed)
    w0 = ex.return_tensor_values()
    L = 12
    want = flash_launches(launch_counts(), L)
    plain_l, plain_s, plain_p, _ = steps15(torch, ex, ids, labels, batches,
                                           want, "15a plain")
    plain = (plain_l, ex.return_tensor_values())
    del ex
    torch.cuda.empty_cache()
    rps = L // St
    stats = {"plain": (plain_l, plain_s, plain_p)}
    counts = {}
    for mode in ("gpipe", "1f1b"):
        ids, labels, loss, train = bert15(ht, models, B // M)
        ex = ht.Executor({"train": [loss, train]}, seed=seed, pipeline=mode,
                         mesh=make_mesh({"pp": St}), num_microbatches=M)
        sub = ex.subexecutor["train"]
        if not (sub.spmd and sub.plan.uniform
                and sub.plan.num_body_blocks() == L):
            fail(f"15a {mode}: the stage path was not taken (plan uniform "
                 f"{sub.plan.uniform}, {sub.plan.num_body_blocks()} body "
                 f"blocks)")
        emb = ex.local_shards("bert_embeddings_word_embeddings")
        ex.load_dict(w0)
        # gpipe: each layer once forward and once backward a microbatch;
        # 1f1b's backward adds a re-forward on the first S - 1 stages and
        # the recompute under each VJP
        k2 = L * M + ((St - 1) * rps * M + L * M) * (mode == "1f1b")
        want = flash_launches(launch_counts(), L * M)
        want["flash_attention"] = k2
        got = steps15(torch, ex, ids, labels, batches, want, f"15a {mode}")
        worst = close15((got[0], ex.return_tensor_values()), plain,
                        f"15a {mode}")
        stats[mode] = got[:3]
        counts[mode] = got[3]
        log(f"  15a {mode}: stage path, {St} stages x {rps} layers, M {M} "
            f"microbatches of {B // M}; the word embeddings' shards "
            f"{len(emb)} x {list(emb[0].shape)} (the ends split over pp); "
            f"launches a step {k2} K2, {L * M} K3 dK/dV, {L * M} K3 dQ; "
            f"boundary-slot high-water {HIGH_WATER[mode]}; losses {got[0]} "
            f"(plain {plain_l}), worst final tensor err / bound "
            f"{worst:.4f}")
        del ex
        torch.cuda.empty_cache()
    peak = {k: max(v[2]) for k, v in stats.items()}
    if not peak["1f1b"] < min(stats["gpipe"][2]):
        fail(f"15a: 1f1b's activation high-water {stats['1f1b'][2]} is not "
             f"below gpipe's {stats['gpipe'][2]}")
    for k, (l_, s_, p_) in stats.items():
        ms = step_ms15(s_)
        log(f"  15a on {card}: {k} f32 SGD step {ms:.2f} ms (median after "
            f"the first; steps {[round(x * 1e3, 2) for x in s_]}), "
            f"{B * S / (ms / 1e3):.1f} "
            f"tokens/s, peak memory above the step's start {p_} B "
            f"(max {max(p_) / 2 ** 30:.3f} GiB)")
    return counts["1f1b"], w0, batches, plain, plain_s


def phase15b(torch, F, seed, card, w0, batches, plain, plain_s):
    """15b: FSDP over a virtual dp 4 and ShardingPlan over dp 2 x tp 2,
    the graph built at the global batch, each three SGD steps against
    the plain executor's (one evaluation of the batch a step); then K2
    and K3's two kernels against their plain versions at the plan's
    per-rank shape (6 heads).  Returns (the plan's launches, {"fwd",
    "dkv", "dq": result})."""
    from hetu_tpu_torch import graph as ht
    from hetu_tpu_torch import models
    from hetu_tpu_torch.kernels import launch_counts
    B = PP15["batch"]
    tp = {}
    for i in range(12):
        pre = f"bert_layer{i}_"
        for n in ("attn_q_weight", "attn_k_weight", "attn_v_weight",
                  "intermediate_weight"):
            tp[pre + n] = (None, "tp")
        tp[pre + "attn_q_bias"] = ("tp",)
        tp[pre + "attn_k_bias"] = ("tp",)
        tp[pre + "attn_v_bias"] = ("tp",)
        tp[pre + "intermediate_bias"] = ("tp",)
        for n in ("attn_proj_weight", "output_weight"):
            tp[pre + n] = ("tp", None)
    for tag, strategy in (
            ("FSDP dp 4", ht.dist.FSDP(dp=4)),
            ("ShardingPlan dp 2 x tp 2",
             ht.dist.ShardingPlan(tp, mesh_axes={"dp": 2, "tp": 2}))):
        ids, labels, loss, train = bert15(ht, models, B)
        ex = ht.Executor({"train": [loss, train]}, seed=seed,
                         dist_strategy=strategy)
        ex.load_dict(w0)
        # the dp x tp plan splits the attention over tp: each rank
        # launches K2 and K3 on its heads
        tp_n = 1 if ex.tp_run is None else ex.tp_run.n
        want = flash_launches(launch_counts(), 12 * tp_n)
        got = steps15(torch, ex, ids, labels, batches, want, f"15b {tag}")
        if tp_n > 1:
            plan = (got[3], tp_n)
        if ex.tp_gathers:
            fail(f"15b {tag}: {ex.tp_gathers} gathers of split values in "
                 f"a step, want 0")
        worst = close15((got[0], ex.return_tensor_values()), plain,
                        f"15b {tag}")
        emb = ex.local_shards("bert_embeddings_word_embeddings")
        q0 = ex.local_shards("bert_layer0_attn_q_weight")
        if tag.startswith("FSDP") and [list(e.shape) for e in emb] != \
                [[30522, 192]] * 4:
            fail(f"15b {tag}: the ranks' shards of the word embeddings "
                 f"are {[list(e.shape) for e in emb]}, want 4 x "
                 f"[30522, 192]")
        log(f"  15b {tag} on {card}: {len(emb)} virtual ranks, a rank's "
            f"shard of the word embeddings {list(emb[0].shape)}, of layer "
            f"0's q weight {list(q0[0].shape)}; built at the global batch "
            f"{B}, one evaluation a step ({12 * tp_n} K2, {12 * tp_n} K3 "
            f"dK/dV, {12 * tp_n} K3 dQ: tp {tp_n}, {ex.tp_gathers} "
            f"gathers); "
            f"losses {got[0]} (plain {plain[0]}), worst final tensor err / "
            f"bound {worst:.4f}; step {step_ms15(got[1]):.2f} ms (median "
            f"after the first; steps {[round(x * 1e3, 2) for x in got[1]]}; "
            f"plain {step_ms15(plain_s):.2f}), peak above the step's start "
            f"{got[2]} B")
        del ex
        torch.cuda.empty_cache()
    counts, tp_n = plan
    kres = check_bert_kernels(
        torch, F, "float32", seed + 15, (B, PP15["seq"], H // tp_n, DH),
        None, "15b", "15b, a dp 2 x tp 2 rank's heads")
    return counts, kres


def trio_on_the_wire(torch, ht, mesh, seed):
    """The int8 trio in the per-rank view over ``mesh``'s one-rank NCCL
    world: its recorded collectives carry int8, the real run goes through
    NCCL's all-gather and equals the whole-value view's round trip bit
    for bit.  Returns (int8 bytes + scale bytes on the wire, f32 bytes)."""
    from hetu_tpu_torch.graph.node import TraceContext
    from hetu_tpu_torch.parallel import (check_collective_order,
                                         quantized_collectives)
    from hetu_tpu_torch.parallel.collectives import run_per_rank
    shape = (768, 3072)          # a BERT-base intermediate weight
    device = mesh.device_type
    g = torch.randn(shape, device=device,
                    generator=torch.Generator(device).manual_seed(seed))
    trio = ht.quantized_allreduce_op(ht.placeholder_op("g15"), shape=shape)
    gather, quant = trio.inputs[0], trio.inputs[0].inputs[0]

    def body(comm, x):
        tc = TraceContext(comm=comm, device=device)
        pair = gather.compute([quant.compute([x], tc)], tc)
        body.wire = pair
        return trio.compute([pair], tc)

    seq = check_collective_order(body, mesh, [(g,)])
    legs = quantized_collectives(seq)
    if not legs or legs[0][3] != ("int8",):
        fail(f"15c trio: no int8 collective in its recorded sequence {seq}")
    got = run_per_rank(body, mesh, (g,))
    q, scales = body.wire
    if q.dtype != torch.int8 or q.device != g.device:
        fail(f"15c trio: the gathered payload is {q.dtype} on "
             f"{q.device}, not int8 on the card")
    whole = trio.compute([gather.compute([quant.compute(
        [g], TraceContext(device=device))], TraceContext())],
        TraceContext())
    if not torch.equal(got, whole):
        fail("15c trio: the NCCL per-rank result differs from the "
             "whole-value round trip")
    return (q.numel() * q.element_size()
            + scales.numel() * scales.element_size()), g.numel() * 4, seq


def phase15c(torch, seed, card, w0, batches, plain, plain_s):
    """15c: DataParallel over a one-rank NCCL world (a DeviceMesh), three
    steps bit-equal to the plain executor's; the int8 trio's wire leg
    through NCCL's all-gather."""
    import torch.distributed as dist
    from hetu_tpu_torch import graph as ht
    from hetu_tpu_torch import models
    from hetu_tpu_torch.kernels import launch_counts
    from hetu_tpu_torch.parallel import make_mesh
    tmp = tempfile.mkdtemp(prefix="chip_smoke15_")
    try:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_mesh({"dp": 1})
            if type(mesh).__name__ != "DeviceMesh":
                fail(f"15c: make_mesh under torch.distributed gave "
                     f"{type(mesh).__name__}, not a DeviceMesh")
            ids, labels, loss, train = bert15(ht, models, PP15["batch"])
            ex = ht.Executor({"train": [loss, train]}, seed=seed, mesh=mesh,
                             dist_strategy=ht.dist.DataParallel())
            ex.load_dict(w0)
            want = flash_launches(launch_counts(), 12)
            got = steps15(torch, ex, ids, labels, batches, want, "15c")
            final = ex.return_tensor_values()
            if got[0] != plain[0]:
                fail(f"15c: losses {got[0]} differ from the plain "
                     f"executor's {plain[0]}")
            bad = [k for k, w in plain[1].items()
                   if not np.array_equal(final[k], w)]
            if bad:
                fail(f"15c: {len(bad)} tensors differ from the plain "
                     f"executor's, e.g. {bad[:3]}")
            log(f"  15c on {card}: DataParallel over a one-rank NCCL world "
                f"(NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, "
                f"DeviceMesh {mesh.mesh_dim_names}), three steps bit-equal "
                f"to the plain executor's (losses {got[0]}, "
                f"{len(final)} tensors); step {step_ms15(got[1]):.2f} ms "
                f"(median after the first; steps "
                f"{[round(x * 1e3, 2) for x in got[1]]}; plain "
                f"{step_ms15(plain_s):.2f})")
            del ex
            wire, f32, seq = trio_on_the_wire(torch, ht, mesh, seed)
            log(f"  15c int8 trio over NCCL: recorded {seq}; the all-gather "
                f"moved {wire} B (int8 payload + f32 scales) for a gradient "
                f"of {f32} B in f32 ({f32 / wire:.2f}x fewer bytes); the "
                f"result == the whole-value round trip bit for bit")
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


# the BatchNorm MLP of tests/test_torch_data_parallel.py (IN 8, HID 32,
# OUT 4, B 16, rows 8-15 scaled x3 + 2, SGD 0.1), two steps
BN15 = dict(inp=8, hid=32, out=4, batch=16, steps=2)


def bn15(ht):
    c = BN15
    x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
    h = ht.linear_op(x, ht.init.xavier_uniform((c["inp"], c["hid"]),
                                               name="bn_in_w"),
                     ht.init.zeros((c["hid"],), name="bn_in_b"))
    h = ht.layers.BatchNorm(c["hid"], name="bn0")(h)
    logits = ht.matmul_op(h, ht.init.xavier_uniform((c["hid"], c["out"]),
                                                    name="bn_head"))
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y), axes=0)
    return x, y, loss, ht.optim.SGDOptimizer(learning_rate=0.1).minimize(loss)


def phase15d(torch, seed, card, w0, batches):
    """15d: the global-batch step on the card: the BatchNorm MLP under a
    virtual DataParallel(2) equal to the plain executor's (losses, weights
    and running statistics within 1e-6); BERT-base's SGD step under
    DataParallel(aggregate="int8") (the trio spliced onto every dense
    gradient) equal to the plain step within the codec's bound."""
    from hetu_tpu_torch import graph as ht
    from hetu_tpu_torch import models
    from hetu_tpu_torch.graph.ops_comm import DequantizeCommOp
    from hetu_tpu_torch.kernels import launch_counts
    c = BN15
    rng = np.random.RandomState(7)
    xb = rng.randn(c["batch"], c["inp"]).astype(np.float32)
    xb[8:] = xb[8:] * 3 + 2
    yb = np.eye(c["out"], dtype=np.float32)[rng.randint(0, c["out"],
                                                       c["batch"])]
    res = {}
    for tag, kw in (("plain", {}),
                    ("dp 2", dict(dist_strategy=ht.dist.DataParallel(
                        num_devices=2)))):
        x, y, loss, train = bn15(ht)
        ex = ht.Executor({"train": [loss, train]}, seed=seed, **kw)
        if tag == "plain":
            bn_w0 = ex.return_tensor_values()
        ex.load_dict(bn_w0)
        res[tag] = ([float(ex.run("train", feed_dict={x: xb, y: yb})[0])
                     for _ in range(c["steps"])], ex.return_tensor_values())
    (pl, pw), (dl, dw) = res["plain"], res["dp 2"]
    worst = max(float(np.abs(dw[k] - v).max()) for k, v in pw.items())
    if not np.allclose(dl, pl, rtol=0, atol=1e-6) or worst > 1e-6:
        fail(f"15d BatchNorm dp 2: losses {dl} vs plain {pl}, worst tensor "
             f"{worst:.3e} (tol 1e-6)")
    log(f"  15d BatchNorm MLP, virtual DataParallel(2) on {card}: losses "
        f"{dl} (plain {pl}), worst tensor diff {worst:.3e} over "
        f"{len(pw)} tensors (running statistics included; tol 1e-6)")
    # BERT-base, one SGD step with the int8 trio against the plain step
    lr = PP15["lr"]
    one = {}
    for tag, kw in (("plain", {}),
                    ("int8", dict(dist_strategy=ht.dist.DataParallel(
                        aggregate="int8")))):
        ids, labels, loss, train = bert15(ht, models, PP15["batch"])
        ex = ht.Executor({"train": [loss, train]}, seed=seed, **kw)
        ex.load_dict(w0)
        dense = [g for i, g in enumerate(train.inputs)
                 if i not in train.sparse_inputs]
        if tag == "int8" and not all(isinstance(g, DequantizeCommOp)
                                     for g in dense):
            fail("15d int8: the trio is not on every dense gradient")
        want = flash_launches(launch_counts(), 12)
        got = steps15(torch, ex, ids, labels, batches[:1], want,
                      f"15d {tag}")
        one[tag] = (got[0], ex.return_tensor_values(), got[1])
        del ex
        torch.cuda.empty_cache()
    (pl, pw, ps), (ql, qw, qs) = one["plain"], one["int8"]
    if ql != pl:
        fail(f"15d int8: the first loss {ql} differs from plain's {pl}")
    worst, where = 0.0, None
    g_max = {k: float(np.abs(w0[k].astype(np.float64) - v).max()) / lr
             for k, v in pw.items()}
    g_all = max(g_max.values())
    for k, v in pw.items():
        w = w0[k].astype(np.float64)
        # each gradient element within half a step of its chunk (amax /
        # 254 <= max |g| / 254), 1e-5 more of its tensor's and of the
        # largest gradient's (the summation order; the attention k bias,
        # whose exact gradient is 0, is rounding alone), and one f32
        # rounding of w - lr g on each side
        tol = lr * (g_max[k] * (1 / 254 + 1e-5) + 1e-5 * g_all) \
            + 2.0 ** -22 * np.abs(w).max()
        err = float(np.abs(qw[k] - v).max())
        if tol > 0 and err / tol > worst:
            worst, where = err / tol, k
    if worst > 1:
        fail(f"15d int8: {where} differs from the plain step by {worst:.3f} "
             f"x the codec's bound")
    log(f"  15d BERT-base DataParallel(aggregate='int8') on {card}: one SGD "
        f"step, loss {ql} (plain {pl}); worst tensor err / the codec's "
        f"bound {worst:.4f} ({where}); the trio on all {len(dense)} dense "
        f"gradients ({len(train.sparse_inputs)} sparse ones keep their "
        f"path); step {qs[0] * 1e3:.2f} ms (plain {ps[0] * 1e3:.2f}, "
        f"one step each, with its first-step costs)")


def phase15(torch, F, seed, card):
    """Phase 15: 15-pre (f32 K2/K3 at 15a's microbatch shape), 15a, 15b,
    15c, 15d.  Returns (15-pre's {"fwd", "dkv", "dq": result}, 15a
    1f1b's launches, 15b's plan's launches and its per-rank results)."""
    t_phase = time.perf_counter()
    shape = (PP15["batch"] // PP15["microbatches"], PP15["seq"], H, DH)
    kres = check_bert_kernels(torch, F, "float32", seed + 15, shape, None,
                              "15-pre", "15-pre, 15a's microbatch")
    counts, w0, batches, plain, plain_s = phase15a(torch, seed, card)
    counts_b, kres_b = phase15b(torch, F, seed, card, w0, batches, plain,
                                plain_s)
    phase15c(torch, seed, card, w0, batches, plain, plain_s)
    phase15d(torch, seed, card, w0, batches)
    log(f"  phase 15 in {time.perf_counter() - t_phase:.1f} s")
    return kres, counts, counts_b, kres_b


# ---------------------------------------------------------------- #
# phase 16: GPT on the graph surface
# ---------------------------------------------------------------- #

# three AdamW steps (phase 8's rate, decay and clip) on phase 8's first
# three batches, the first a warm-up; greedy decoding of a 16-token
# prompt for 8 tokens; four requests through the engine; serve_gpt's
# tiny model trained for its default 250 steps
GPT16 = dict(steps=3, warm=1, prompt=16, new=8, requests=4, tiny_steps=250)
# the graph's f32 losses against phase 8's nn.Module trainer from the same
# weights on the same batches: phase 8's loss tolerance (flash vs
# unfused, relative)
GPT16_RTOL = 1e-5


def gpt16_executor(ht, models, cfg, seed, weights, mp=None):
    """The graph GPT (``models.GPTForCausalLM``) with an AdamW step and a
    logits subgraph, loaded with ``weights``: (ids, labels, executor)."""
    model = models.GPTForCausalLM(cfg, name="gpt")
    ids, labels = ht.placeholder_op("input_ids"), ht.placeholder_op("labels")
    loss, _ = model(ids, labels=labels)
    opt = ht.optim.AdamWOptimizer(learning_rate=3e-4, weight_decay=0.01)
    opt.clip_grad_norm = 1.0
    ex = ht.Executor({"train": [loss, opt.minimize(loss)],
                      "logits": [model(ids)]}, seed=seed, mixed_precision=mp)
    ex.load_dict(weights)
    return ids, labels, ex


def gpt16_steps(torch, ex, ids, labels, batches, L, tag):
    """One "train" run per batch, each launching exactly phase 8's K2, K3
    dK/dV and K3 dQ (one of each a layer): (losses, seconds, launches of
    all)."""
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    losses, secs = [], []
    total = collections.Counter()
    for i, (x, y) in enumerate(batches):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ex.run("train", feed_dict={ids: x, labels: y})
        losses.append(float(out[0]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = launch_counts()
        want = flash_launches(counts, L)
        if counts != want:
            fail(f"16 {tag} step {i}: launches {counts}, want {want}")
        total.update(counts)
    if not all(np.isfinite(losses)):
        fail(f"16 {tag}: a loss is not finite: {losses}")
    return losses, secs, total


def phase16(torch, seed, card, train_runs):
    """Phase 16: GPT-2-small on the graph surface.  ``train_runs``:
    phase 8's {dtype: (stats, launches)}.  Returns {dtype: the launches
    of the three training steps}."""
    import hetu_tpu_torch as htt
    from hetu_tpu_torch import graph as ht
    from hetu_tpu_torch import models, serve_gpt
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    from hetu_tpu_torch.models.gpt_decode import generate_fast
    from hetu_tpu_torch.train_gpt import synthetic
    t_phase = time.perf_counter()
    cfg = htt.GPTConfig(batch_size=TB, seq_len=TS, dropout_rate=0.0)
    if not cfg.use_flash:
        fail("16: GPT-2-small at seq 1024 with dropout 0 should take the "
             "flash path")
    n, L = GPT16["steps"], cfg.num_hidden_layers
    data = synthetic(cfg, np.random.RandomState(seed))
    batches = [next(data) for _ in range(n)]
    weights = htt.GPTForCausalLMModule(cfg, seed=seed).var_values()
    counts, res, final = {}, {}, {}
    for dt, mp in (("float32", None), ("bfloat16", "bf16")):
        ids, labels, ex = gpt16_executor(ht, models, cfg, seed, weights, mp)
        losses, secs, counts[dt] = gpt16_steps(torch, ex, ids, labels,
                                               batches, L, dt)
        final[dt] = ex.return_tensor_values()
        want = train_runs[dt][0]["losses"][:n]
        ms = float(np.median(secs[GPT16["warm"]:])) * 1e3
        res[dt] = (losses, ms)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        if dt == "float32" and not rel <= GPT16_RTOL:
            fail(f"16 f32: the graph's losses {losses} differ from phase "
                 f"8's nn.Module trainer's {want} by {rel:.3e} relative "
                 f"(tol {GPT16_RTOL})")
        log(f"  16 {dt}: graph GPT-2-small B {TB} S {TS}, losses {losses} "
            f"(phase 8's module {want}: {rel:.3e} relative"
            + (f", tol {GPT16_RTOL}" if dt == "float32" else ", logged")
            + f"); launches a step {L} K2, {L} K3 dK/dV, {L} K3 dQ; step "
            f"{ms:.2f} ms (median of steps {GPT16['warm'] + 1}-{n}; steps "
            f"{[round(x * 1e3, 2) for x in secs]}) on {card}, phase 8's "
            f"module {train_runs[dt][0]['step_ms']:.2f} ms")
        if dt == "float32":
            trained = ex
        else:
            del ex
    # greedy decoding on the graph against generate_fast's KV cache
    ex = trained
    prompt = batches[0][0][0, :GPT16["prompt"]].tolist()
    reset_launches()
    greedy = models.greedy_generate(ex, "logits", ids, 0, prompt,
                                    GPT16["new"], cfg.seq_len)
    g_counts = launch_counts()
    if g_counts["flash_attention"] != L * GPT16["new"]:
        fail(f"16 greedy: {g_counts['flash_attention']} K2 launches, want "
             f"{L * GPT16['new']} ({L} a forward)")
    reset_launches()
    fast = generate_fast(ex.var_values, cfg, prompt,
                         num_tokens=GPT16["new"])[0].tolist()
    f_counts = launch_counts()
    if greedy != fast:
        fail(f"16: graph greedy tokens {greedy[len(prompt):]} differ from "
             f"generate_fast's {fast[len(prompt):]}")
    log(f"  16 greedy_generate on the graph == generate_fast: "
        f"{greedy[len(prompt):]} ({g_counts['flash_attention']} K2 for "
        f"{GPT16['new']} full forwards; generate_fast "
        f"{f_counts['flash_attention']} K2, "
        f"{f_counts['paged_decode_attention']} K4)")
    # the engine over the graph-trained weights
    prompts = np.random.RandomState(seed + 16).randint(
        0, cfg.vocab_size, (GPT16["requests"], GPT16["prompt"])).tolist()
    want = generate_fast(ex.var_values, cfg, prompts,
                         num_tokens=GPT16["new"])
    eng = htt.ServingEngine(ex.var_values, cfg, slots=GPT16["requests"])
    reqs = [htt.Request(prompt=p, max_new_tokens=GPT16["new"])
            for p in prompts]
    reset_launches()
    out = eng.run(reqs)
    e_counts = launch_counts()
    bad = [i for i, r in enumerate(reqs)
           if list(out[r.request_id].tokens) != want[i].tolist()]
    if bad:
        fail(f"16: the engine's tokens over the graph-trained weights "
             f"differ from generate_fast's for requests {bad}")
    log(f"  16 ServingEngine(ex.var_values, cfg) over the graph-trained "
        f"weights: {len(reqs)} greedy requests == generate_fast "
        f"(ragged_paged_attention {e_counts['ragged_paged_attention']} "
        f"launches)")
    del eng, ex, trained
    torch.cuda.empty_cache()
    # serve_gpt: the tiny graph model trained on the +1 chain, served
    # with and without speculation
    t0 = time.perf_counter()
    tiny = serve_gpt.config(serve_gpt.parse_args([]))
    ex = serve_gpt.train_tiny(tiny, GPT16["tiny_steps"], 3e-3)
    train_s = time.perf_counter() - t0
    frac0, tok0, _ = serve_gpt.serve(ex, tiny)
    frac3, tok3, eng3 = serve_gpt.serve(ex, tiny, spec=3)
    if tok3 != tok0:
        fail(f"16 serve_gpt: spec 3 tokens {tok3} differ from spec 0's "
             f"{tok0}")
    log(f"  16 serve_gpt: {GPT16['tiny_steps']} graph Adam steps in "
        f"{train_s:.1f} s; {len(tok0)} requests, {frac0:.3f} of them on "
        f"the +1 chain; spec 3 tokens == spec 0's ({eng3.spec_waves} "
        f"waves, {eng3.spec_accepted}/{eng3.spec_proposed} drafts "
        f"accepted)")
    log(f"  phase 16 in {time.perf_counter() - t_phase:.1f} s")
    return counts, dict(cfg=cfg, weights=weights, batches=batches, res=res,
                        final=final)


# ---------------------------------------------------------------- #
# phase 17: expert parallelism
# ---------------------------------------------------------------- #

EP17 = dict(ep=4, tokens=1024, cf=8.0)
# 17a: the placed moe_ffn against the whole on one prompt wave, relative
# to the wave's largest |y|: the same kernels on the same values, but
# cuBLAS may pick another algorithm for a batch of one expert than for
# four, so the card is held to this bound, not to bit equality
EP_WAVE_RTOL = 1e-6
# 17b: the int8 wire against f32, relative to max |y|: each of the two
# hops decodes an element within its row's amax / 254, so one step of
# the codec a hop at the scale of the output (2 / 127) bounds it
EP_INT8_BOUND = 2 / 127
# 17c: Cora's published widths (Kipf & Welling, ICLR 2017)
GCN17 = dict(nodes=2708, feat=1433, hidden=16, classes=7, epochs=60,
             sgd_steps=3, lr=0.1)
# the per-rank layer against the whole-value one: the same f32 products
# summed in another order (A @ H in two column blocks, then the sum)
GCN17_TOL = (1e-5, 1e-5)


@contextlib.contextmanager
def expert_batches(md):
    """Record the expert count of every ``_experts`` product (each
    rank's batch of experts) while the block runs."""
    inner = md._experts
    seen = collections.Counter()

    def counted(xe, w1, *a):
        seen[int(w1.shape[0])] += 1
        return inner(xe, w1, *a)

    md._experts = counted
    try:
        yield seen
    finally:
        md._experts = inner


@contextlib.contextmanager
def first_moe_call(gd):
    """Keep the arguments of the serving cores' first ``moe_ffn`` call."""
    inner = gd.moe_ffn
    kept = []

    def keep(*a, **kw):
        if not kept:
            kept.append((a, dict(kw, stats=None)))
        return inner(*a, **kw)

    gd.moe_ffn = keep
    try:
        yield kept
    finally:
        gd.moe_ffn = inner


def ep_gate(torch, params, placed, cfg, want, got, prompt_len):
    """17a's token gate: identical greedy tokens, or a first difference
    at a position whose exact top-2 margin is at most 2 delta, delta the
    largest |placed - whole| teacher-forced logit over the sequence.
    Returns None or (position, margin, delta)."""
    from hetu_tpu_torch.models.gpt_decode import teacher_forced_logits
    want, got = list(want), list(got)
    if want == got:
        return None
    t = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    seq = np.asarray(want[:-1], np.int64)
    exact = teacher_forced_logits(params, cfg, seq, dtype=torch.float32)
    ep = teacher_forced_logits(placed, cfg, seq, dtype=torch.float32)
    delta = float((ep - exact).abs().max())
    top2 = torch.topk(exact[t - 1], 2).values
    margin = float(top2[0] - top2[1])
    if t < prompt_len or margin > 2 * delta:
        fail(f"17a: ep-placed greedy tokens first differ at position {t} "
             f"(prompt {prompt_len}), exact top-2 margin {margin:.4e} > "
             f"2 delta = {2 * delta:.4e}")
    return t, margin, delta


def phase17a(torch, htt, spec, moe10, card):
    """17a: phase 10's MoE GPT over a virtual ep 4 through the paged
    mixed engine, then a one-rank NCCL DeviceMesh.  Returns the engine's
    launches."""
    from hetu_tpu_torch.models import gpt_decode as gd
    from hetu_tpu_torch.models import moe_decode as md
    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.sharding import placement, rank_pieces
    params, cfg, (res10, _, st10) = moe10
    n, E = EP17["ep"], cfg.num_experts
    mesh = make_mesh({"ep": n}, device=params["gpt_wte_table"].device)
    placed = md.ep_shard_params(params, mesh, cfg, name="gpt")
    stacks = [k for k in placed if "_moe_expert_stack_" in k]
    for k in stacks:
        v = placed[k]
        views = rank_pieces(v, ("ep",) + (None,) * (v.dim() - 1), mesh)
        if placement(v) != (mesh, "ep", 0) or len(views) != n or any(
                q.shape[0] * n != v.shape[0] for q in views):
            fail(f"17a: {k} is not split over ep {n}")
    if any(placement(v) is not None
           for k, v in placed.items() if k not in stacks):
        fail("17a: a parameter other than the expert stacks is placed")
    with expert_batches(md) as seen, first_moe_call(gd) as kept:
        res, counts, st = serve(torch, htt, placed, cfg, spec, "float32",
                                "paged-mixed")
    if set(seen) != {E // n}:
        fail(f"17a: expert products ran on {dict(seen)} experts, want "
             f"{E // n} each")
    greedy = [i for i, (_, t, _) in enumerate(spec) if t == 0]
    gates = [ep_gate(torch, params, placed, cfg, res10[f"r{i}"].tokens,
                     res[f"r{i}"].tokens, len(spec[i][0])) for i in greedy]
    same = all(g is None for g in gates)
    if same and (st["expert_load"] != st10["expert_load"]
                 or st["expert_drops"] != st10["expert_drops"]):
        fail(f"17a: load {st['expert_load']} drops {st['expert_drops']} "
             f"differ from phase 10's {st10['expert_load']} "
             f"{st10['expert_drops']} on the same tokens")
    (a, kw), = kept
    x, us = a[2], a[1]
    y_ep = md.moe_ffn(placed, us, x, *a[3:], **kw)
    y = md.moe_ffn(params, us, x, *a[3:], **kw)
    wave_err = float((y_ep - y).abs().max() / y.abs().max())
    if not wave_err <= EP_WAVE_RTOL:
        fail(f"17a: placed moe_ffn on the first prompt wave {wave_err:.3e} "
             f"of max |y| from the whole > {EP_WAVE_RTOL}")
    log(f"  17a on {card}: ep {n} (VirtualMesh on the card), each rank's "
        f"view a quarter of {len(stacks)} stacks; {seen[E // n]} expert "
        f"products of {E // n} expert(s); greedy tokens == phase 10's for "
        f"{sum(g is None for g in gates)} of {len(greedy)} requests, the "
        f"rest within the gate (position, margin, delta): "
        f"{[g for g in gates if g is not None]}; load {st['expert_load']} "
        f"drops {st['expert_drops']} ({'==' if same else 'vs'} phase 10's "
        f"{st10['expert_load']} {st10['expert_drops']}); first prompt wave "
        f"({x.shape[0]} positions, {us}) placed vs whole {wave_err:.3e} of "
        f"max |y|; {st['tokens_per_s']:.1f} tok/s (unsharded "
        f"{st10['tokens_per_s']:.1f}), TTFT p50 {st['ttft_p50_ms']:.1f} "
        f"ms; K1 launches {counts['ragged_paged_attention']}")
    del placed
    nccl17(torch, params, cfg, card)
    return counts


def nccl17(torch, params, cfg, card):
    """17a's one-rank NCCL world: ProcessComm.all_to_all (f32, int8), the
    placed moe_ffn and moe_ffn_ep_reference equal the virtual mesh's."""
    import torch.distributed as dist
    from hetu_tpu_torch.models import moe_decode as md
    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.collectives import (ProcessComm,
                                                     run_per_rank)
    spec = md.moe_spec_of(cfg)._replace(capacity_factor=EP17["cf"])
    dev = params["gpt_wte_table"].device
    g = torch.Generator(dev).manual_seed(17)
    x = torch.randn(256, cfg.hidden_size, device=dev, generator=g)
    us = "gpt_h1"
    virtual = make_mesh({"ep": 1}, device=dev)
    want = {"moe_ffn": md.moe_ffn(params, us, x, spec)}
    for q in (None, "int8"):
        want[f"ref {q}"] = md.moe_ffn_ep_reference(params, us, x, spec,
                                                   virtual, quant=q)
    blocks = torch.randn(4, 6, cfg.hidden_size, device=dev, generator=g)
    tmp = tempfile.mkdtemp(prefix="chip_smoke17_")
    try:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_mesh({"ep": 1})
            if type(mesh).__name__ != "DeviceMesh":
                fail(f"17a: make_mesh under torch.distributed gave "
                     f"{type(mesh).__name__}")
            comm = ProcessComm(mesh)
            for t in (blocks, blocks.to(torch.int8)):
                got = comm.all_to_all(t, "ep", 0, 1)
                ref = run_per_rank(lambda c, b: c.all_to_all(b, "ep", 0, 1),
                                   virtual, [(t,)])[0]
                if got.dtype != t.dtype or not torch.equal(got, ref):
                    fail(f"17a: NCCL all_to_all of {t.dtype} differs from "
                         f"the virtual one")
            placed = md.ep_shard_params(params, mesh, cfg, name="gpt")
            got = {"moe_ffn": md.moe_ffn(placed, us, x, spec)}
            for q in (None, "int8"):
                got[f"ref {q}"] = md.moe_ffn_ep_reference(
                    placed, us, x, spec, mesh, quant=q)
            bad = [k for k in want if not torch.equal(got[k], want[k])]
            if bad:
                fail(f"17a: over the one-rank NCCL mesh {bad} differ from "
                     f"the virtual mesh's")
            del placed
            log(f"  17a on {card}: one-rank NCCL DeviceMesh "
                f"{mesh.mesh_dim_names}: all_to_all f32 and int8, the "
                f"placed moe_ffn and moe_ffn_ep_reference (f32, int8 wire) "
                f"on {x.shape[0]} tokens bit-equal to the virtual mesh's")
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase17b(torch, params, cfg, card):
    """17b: moe_ffn_ep_reference at phase 10's widths over a virtual ep
    4, f32 against moe_ffn, and the int8 wire's bytes and error."""
    from hetu_tpu_torch.models import moe_decode as md
    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.collectives import VirtualComm
    spec = md.moe_spec_of(cfg)._replace(capacity_factor=EP17["cf"],
                                        ep_axis="ep")
    dev = params["gpt_wte_table"].device
    mesh = make_mesh({"ep": EP17["ep"]}, device=dev)
    placed = md.ep_shard_params(params, mesh, cfg, name="gpt")
    g = torch.Generator(dev).manual_seed(171)
    x = torch.randn(EP17["tokens"], cfg.hidden_size, device=dev,
                    generator=g)
    us = "gpt_h1"
    inner = VirtualComm.all_to_all
    wire = collections.Counter()

    def counted(self, t, *a):
        wire[str(t.dtype).replace("torch.", "")] += t.numel() * \
            t.element_size()
        return inner(self, t, *a)

    y = md.moe_ffn(params, us, x, spec)
    out, ms = {}, {}
    VirtualComm.all_to_all = counted
    try:
        for q in (None, "int8"):
            wire.clear()
            out[q] = md.moe_ffn_ep_reference(placed, us, x, spec, mesh,
                                             quant=q)
            out[q, "wire"] = dict(wire)
            ms[q] = time_ms(torch, lambda q=q: md.moe_ffn_ep_reference(
                placed, us, x, spec, mesh, quant=q), reps=5, warm=1)
    finally:
        VirtualComm.all_to_all = inner
    ms["moe_ffn"] = time_ms(torch, lambda: md.moe_ffn(placed, us, x, spec),
                            reps=5, warm=1)
    ymax = float(y.abs().max())
    err32 = float((out[None] - y).abs().max())
    err8 = float((out["int8"] - y).abs().max())
    if not err32 <= 1e-4:
        fail(f"17b: f32 moe_ffn_ep_reference {err32:.3e} from moe_ffn "
             f"> 1e-4")
    if not err8 <= EP_INT8_BOUND * ymax or not err8 < 0.2:
        fail(f"17b: int8 wire {err8:.3e} from moe_ffn > "
             f"{EP_INT8_BOUND:.4f} x max |y| {ymax:.4f}")
    b32, b8 = sum(out[None, "wire"].values()), sum(out["int8", "wire"]
                                                    .values())
    if set(out["int8", "wire"]) != {"int8", "float32"}:
        fail(f"17b: the int8 wire carried {out['int8', 'wire']}")
    log(f"  17b on {card}: moe_ffn_ep_reference, {EP17['tokens']} tokens "
        f"x {cfg.hidden_size}, ep {EP17['ep']}, capacity {EP17['cf']}: f32 "
        f"{err32:.3e} from moe_ffn (<= 1e-4); int8 wire {err8:.3e} = "
        f"{err8 / ymax:.4e} of max |y| {ymax:.4f} (bound "
        f"{EP_INT8_BOUND:.4e}); bytes into the two all-to-all hops of all "
        f"ranks: f32 {b32}, int8 {out['int8', 'wire']} = {b8} "
        f"({b32 / b8:.2f}x fewer); {ms[None]:.3f} ms f32, "
        f"{ms['int8']:.3f} ms int8, the placed moe_ffn {ms['moe_ffn']:.3f} "
        f"ms (CUDA-event medians, host time included)")


def phase17c(torch, seed, card):
    """17c: train_gcn at Cora's widths, the per-rank 1.5-D layer, three
    SGD steps over a mesh."""
    from hetu_tpu_torch import graph as ht
    from hetu_tpu_torch import train_gcn
    from hetu_tpu_torch.graph.node import TraceContext
    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.collectives import run_per_rank
    c = GCN17
    t0 = time.perf_counter()
    run = train_gcn.run(["--nodes", str(c["nodes"]), "--feat-dim",
                         str(c["feat"]), "--hidden", str(c["hidden"]),
                         "--classes", str(c["classes"]), "--epochs",
                         str(c["epochs"])])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    losses = run["losses"]
    if not (np.isfinite(losses).all() and falling(losses, 10)):
        fail(f"17c: train_gcn's loss does not fall: {losses[:3]} .. "
             f"{losses[-3:]}")
    ex, data = run["executor"], run["data"]
    adj, feat = data["adj"], data["feat"]
    w1 = ex.return_tensor_values()["gcn_w1"]
    a, h = ht.placeholder_op("adj"), ht.placeholder_op("feat")
    z = ht.distgcn_15d_op(a, h, ht.Variable("gcn17_w", value=w1))
    mesh = make_mesh({"dp": 2, "tp": 2})
    (whole,) = ht.Executor([z], mesh=mesh).run(feed_dict={a: adj, h: feat})
    dev = whole.device
    A = torch.from_numpy(adj).to(dev)
    H = torch.from_numpy(feat).to(dev)
    W = torch.from_numpy(w1).to(dev)
    blocks = [(A.chunk(2)[i].chunk(2, dim=1)[j], H.chunk(2)[j])
              for i in range(2) for j in range(2)]
    outs = run_per_rank(lambda comm, ab, hb: z.compute(
        [ab, hb, W], TraceContext(device=dev, comm=comm)), mesh, blocks)
    per_rank = torch.cat([outs[0], outs[2]])
    err = float((per_rank - whole).abs().max())
    atol, rtol = GCN17_TOL
    if not (torch.equal(outs[0], outs[1]) and torch.equal(outs[2], outs[3])
            and bool(((per_rank - whole).abs()
                      <= atol + rtol * whole.abs()).all())):
        fail(f"17c: the per-rank 1.5-D layer is {err:.3e} from the "
             f"whole-value executor's (or a row's tp ranks differ)")
    traj = {}
    for key, m in (("plain", None), ("mesh", mesh)):
        phs, _, loss, train = train_gcn.build_gcn(
            c["feat"], c["hidden"], c["classes"],
            ht.optim.SGDOptimizer(learning_rate=c["lr"]))
        sex = ht.Executor({"train": [loss, train]}, seed=seed, mesh=m)
        if key == "plain":
            w0 = sex.return_tensor_values()
        else:
            sex.load_dict(w0)
        fd = dict(zip(phs, data.values()))
        traj[key] = [float(sex.run("train", feed_dict=fd)[0])
                     for _ in range(c["sgd_steps"])]
    if traj["mesh"] != traj["plain"]:
        fail(f"17c: SGD over dp 2 x tp 2 {traj['mesh']} != plain "
             f"{traj['plain']}")
    log(f"  17c on {card}: train_gcn at Cora's widths ({c['nodes']} nodes, "
        f"{c['feat']} features, hidden {c['hidden']}, {c['classes']} "
        f"classes), {c['epochs']} Adam epochs in {sec:.2f} s "
        f"({sec / c['epochs'] * 1e3:.2f} ms an epoch, evaluations "
        f"included): loss {losses[0]:.4f} -> {losses[-1]:.4f}, held-out "
        f"accuracy {run['accuracy']:.3f}; the per-rank 1.5-D layer over a "
        f"virtual dp 2 x tp 2 {err:.3e} from the whole-value executor's "
        f"(max |z| {float(whole.abs().max()):.4f}; 1e-5 + 1e-5 |z|); "
        f"{c['sgd_steps']} SGD steps over the mesh == plain "
        f"({traj['plain']})")


def phase17(torch, htt, seed, spec, moe10, card):
    """Phase 17: 17a, 17b, 17c.  ``moe10``: phase 10's (params, config,
    paged-mixed f32 run).  Returns 17a's launches."""
    t17 = time.perf_counter()
    counts = phase17a(torch, htt, spec, moe10, card)
    phase17b(torch, moe10[0], moe10[1], card)
    phase17c(torch, seed, card)
    torch.cuda.empty_cache()
    log(f"  phase 17 in {time.perf_counter() - t17:.1f} s")
    return counts


# ---------------------------------------------------------------- #
# phase 18: the tensor-parallel compute split
# ---------------------------------------------------------------- #

TP18 = dict(tp=4)
# placed vs whole logits of the first prompt (teacher-forced, flash):
# the all-reduce sums the out-projections' partials in another order
TP18_LOGIT_RTOL = 1e-5
# the one-rank NCCL mesh when it is not bit-equal
TP18_NCCL_RTOL = 1e-6
# 18b: phase 15's loss tolerance and final-tensor bound
TP18_LOSS_RTOL = PP15_RTOL
TP18_ATOL, TP18_RTOL = PP15_ATOL, PP15_RTOL
TP18_LR = 3e-4          # gpt16_executor's AdamW rate
# the serving cores' attention wrappers (models/gpt_decode.py's names)
SERVE_WRAPPERS = ("flash_attention", "ragged_attention",
                  "ragged_paged_attention", "paged_decode_attention",
                  "paged_block_decode_attention", "paged_verify_attention",
                  "paged_block_verify_attention")


@contextlib.contextmanager
def launch_heads(module, names):
    """Count each call of ``module``'s wrappers ``names`` by (wrapper,
    q's (heads, head dim)): what one rank's launch attends."""
    seen = collections.Counter()
    saved = {n: getattr(module, n) for n in names}

    def wrap(n, f):
        def call(q, *a, **kw):
            seen[n, tuple(q.shape[-2:])] += 1
            return f(q, *a, **kw)
        return call

    for n, f in saved.items():
        setattr(module, n, wrap(n, f))
    try:
        yield seen
    finally:
        for n, f in saved.items():
            setattr(module, n, f)


def heads_only(seen, want, tag):
    bad = {k: v for k, v in seen.items() if k[1] != want}
    if bad or not seen:
        fail(f"{tag}: launches on other heads than {want}: {dict(bad)}")


def rel_err(torch, got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def tp_serving_checks(torch, F, seed, heads):
    """18a's kernels against their plain versions at a rank's ``heads``
    (f32 q, phase 2's and phase 7's waves): each kernel that 18a's
    engines launch, {row key: ``measure``'s result}."""
    dt = "float32"
    return {
        "K1": check_k1(torch, F, dt, seed, heads=heads),
        "K1 decode": check_k1(torch, F, dt, seed, wave="decode",
                              heads=heads),
        "K1 verify": check_k1(torch, F, dt, seed, wave="verify",
                              heads=heads),
        "K8": check_k8(torch, F, dt, seed, heads=heads),
        "K8 decode": check_k8(torch, F, dt, seed, wave="decode",
                              heads=heads),
        "K4": check_decode(torch, F, dt, seed, False, heads=heads),
        "K5": check_decode(torch, F, dt, seed, True, heads=heads),
        "K2": check_k2(torch, F, dt, seed, heads=heads),
        "K1-int8": check_k1(torch, F, dt, seed, int8=True, heads=heads),
        "K1-int8 decode": check_k1(torch, F, dt, seed, int8=True,
                                   wave="decode", heads=heads)}


def phase18a(torch, F, htt, seed, spec, runs, spec_runs, runs8, res32,
             card):
    """18a: GPT-2-small placed by ``tp_shard_params`` over a virtual tp
    4 (3 heads a rank) through the four engine configurations, paged
    mixed with ``spec=4`` and with an int8 cache, f32, on phase 4's
    requests; then a one-rank NCCL ``DeviceMesh``; then each kernel the
    engines launched against its plain version at 3 heads.  Returns
    ({run tag: launches}, {row key: kernel result})."""
    from hetu_tpu_torch.models import gpt_decode as gd
    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.sharding import placement
    cfg = htt.GPTConfig()
    n, H = TP18["tp"], cfg.num_attention_heads
    Dh = cfg.hidden_size // H
    params = htt.params_from_numpy(gpt2_small_params(cfg, seed))
    mesh = make_mesh({"tp": n}, device=params["gpt_wte_table"].device)
    placed = gd.tp_shard_params(params, mesh, cfg)
    split = {k: placement(v)[2] for k, v in placed.items()
             if placement(v) is not None}
    if len(split) != 10 * cfg.num_hidden_layers:
        fail(f"18a: {len(split)} split parameters, want 10 a layer")
    greedy = [i for i, (_, t, _) in enumerate(spec) if t == 0]
    out, oracle = {}, {}
    for config, kw in [(c, {}) for c in CONFIGS] + [
            ("paged-mixed", {"spec": 4}), ("paged-mixed",
                                           {"kv_quant": "int8"})]:
        tag = config + "".join(f" {k}={v}" for k, v in kw.items())
        with launch_heads(gd, SERVE_WRAPPERS) as seen:
            res, counts, st = serve(torch, htt, placed, cfg, spec,
                                    "float32", config, **kw)
        heads_only(seen, (H // n, Dh), f"18a {tag}")
        if kw.get("kv_quant"):
            base = runs8[config, "float32"]
            gates = [margin_gate(torch, params, cfg, res32[f"r{i}"].tokens,
                                 res[f"r{i}"].tokens, len(spec[i][0]),
                                 oracle) for i in greedy]
            same = [i for i in greedy if list(res[f"r{i}"].tokens)
                    == list(base[0][f"r{i}"].tokens)]
            verdict = (f"int8 greedy tokens == the unplaced int8 run's for "
                       f"{len(same)} of {len(greedy)}; vs phase 4's f32 "
                       f"within the margin gate {[g for g in gates if g]}")
        else:
            base = (spec_runs if kw.get("spec") else runs)[config,
                                                           "float32"]
            bad = [i for i in greedy if list(res[f"r{i}"].tokens)
                   != list(base[0][f"r{i}"].tokens)]
            if bad:
                fail(f"18a {tag}: greedy tokens differ from the unplaced "
                     f"engine's for requests {bad}")
            verdict = (f"greedy tokens == the unplaced engine's "
                       f"({len(greedy)} requests)")
        ub = base[2]
        if st["cache_bytes"] * n != ub["cache_bytes"]:
            fail(f"18a {tag}: a rank's cache {st['cache_bytes']} B is not "
                 f"1/{n} of the unplaced {ub['cache_bytes']} B")
        out[tag] = (counts, st)
        log(f"  18a {tag} on {card}: tp {n}, {H // n} heads of {Dh} a "
            f"rank's launch ({sum(seen.values())} launches: "
            f"{dict(seen)}); {verdict}; {st['tokens_per_s']:.1f} tok/s, "
            f"TTFT p50 {st['ttft_p50_ms']:.1f} p99 {st['ttft_p99_ms']:.1f} "
            f"ms (unplaced {ub['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{ub['ttft_p50_ms']:.1f} ms); cache {st['cache_bytes']} B a "
            f"rank (unplaced {ub['cache_bytes']} B)")
    first = np.asarray(spec[0][0], np.int64)
    want = gd.teacher_forced_logits(params, cfg, first)
    got = gd.teacher_forced_logits(placed, cfg, first)
    err = rel_err(torch, got, want)
    if not err <= TP18_LOGIT_RTOL:
        fail(f"18a: placed vs whole logits of the first prompt {err:.3e} "
             f"of max |logit| > {TP18_LOGIT_RTOL}")
    log(f"  18a: placed vs whole teacher-forced logits of the first prompt "
        f"({first.size} positions) {err:.3e} of max |logit| (tol "
        f"{TP18_LOGIT_RTOL})")
    del placed
    nccl18(torch, htt, params, cfg, spec, res32, want, card)
    del params
    torch.cuda.empty_cache()
    log(f"  18a: the engines' kernels at a rank's {H // n} heads against "
        f"their plain versions")
    kres = tp_serving_checks(torch, F, seed, H // n)
    return {tag: c for tag, (c, _) in out.items()}, kres


def nccl18(torch, htt, params, cfg, spec, res32, want, card):
    """18a's one-rank NCCL world: the placed engine and logits against
    the unplaced ones, bit for bit or within TP18_NCCL_RTOL."""
    import torch.distributed as dist
    from hetu_tpu_torch.models import gpt_decode as gd
    from hetu_tpu_torch.parallel import make_mesh
    tmp = tempfile.mkdtemp(prefix="chip_smoke18_")
    try:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_mesh({"tp": 1})
            if type(mesh).__name__ != "DeviceMesh":
                fail(f"18a: make_mesh under torch.distributed gave "
                     f"{type(mesh).__name__}")
            placed = gd.tp_shard_params(params, mesh, cfg)
            res, _, st = serve(torch, htt, placed, cfg, spec, "float32",
                               "paged-mixed")
            bad = [i for i in range(len(spec)) if list(res[f"r{i}"].tokens)
                   != list(res32[f"r{i}"].tokens)]
            got = gd.teacher_forced_logits(placed, cfg,
                                           np.asarray(spec[0][0], np.int64))
            if torch.equal(got, want) and not bad:
                verdict = "bit-equal to the unplaced logits and tokens"
            else:
                err = rel_err(torch, got, want)
                why = ("the NCCL all-reduce of one rank returned other "
                       "bits than its input" if not torch.equal(got, want)
                       else f"tokens of requests {bad} differ")
                if bad or not err <= TP18_NCCL_RTOL:
                    fail(f"18a NCCL: {why}; logits {err:.3e} of max |logit|"
                         f" (tol {TP18_NCCL_RTOL})")
                verdict = (f"not bit-equal ({why}); logits {err:.3e} of "
                           f"max |logit| <= {TP18_NCCL_RTOL}")
            log(f"  18a on {card}: one-rank NCCL DeviceMesh "
                f"{mesh.mesh_dim_names}, paged mixed f32: all "
                f"{len(spec)} requests (greedy and sampled) and the first "
                f"prompt's logits {verdict}; {st['tokens_per_s']:.1f} "
                f"tok/s, cache {st['cache_bytes']} B")
            del placed
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def gpt_tp_specs(L):
    """JAX's GPT_TP_SPECS pattern (tests/test_all_layouts.py) over ``L``
    layers of the model named "gpt"."""
    specs = {}
    for i in range(L):
        for n in ("attn_q_weight", "attn_k_weight", "attn_v_weight",
                  "ffn_wi_weight"):
            specs[f"gpt_h{i}_{n}"] = (None, "tp")
        for n in ("attn_proj_weight", "ffn_wo_weight"):
            specs[f"gpt_h{i}_{n}"] = ("tp", None)
    return specs


def phase18b(torch, F, seed, card, graph16):
    """18b: phase 16's graph GPT-2-small (B 8, S 1024, three AdamW
    steps, f32 and bf16) under ``ModelParallel4LM(tp=4)`` with JAX's
    GPT_TP_SPECS pattern over all 12 layers, against phase 16's plain
    executor; then K2 and K3's two kernels against their plain versions
    at the training shape with a rank's 3 heads.  Returns ({dtype:
    launches of the three steps}, {"fwd", "dkv", "dq": {dtype:
    result}})."""
    import hetu_tpu_torch.kernels.flash_attention as fa
    from hetu_tpu_torch import graph as ht
    from hetu_tpu_torch import models
    from hetu_tpu_torch.kernels import launch_counts, reset_launches
    cfg, weights, batches = (graph16[k] for k in ("cfg", "weights",
                                                  "batches"))
    n, L, H = TP18["tp"], cfg.num_hidden_layers, cfg.num_attention_heads
    Dh = cfg.hidden_size // H
    counts = {}
    for dt, mp in (("float32", None), ("bfloat16", "bf16")):
        with launch_heads(fa, ("flash_attention",)) as seen:
            model = models.GPTForCausalLM(cfg, name="gpt")
            ids = ht.placeholder_op("input_ids")
            labels = ht.placeholder_op("labels")
            loss, _ = model(ids, labels=labels)
            opt = ht.optim.AdamWOptimizer(learning_rate=TP18_LR,
                                          weight_decay=0.01)
            opt.clip_grad_norm = 1.0
            ex = ht.Executor({"train": [loss, opt.minimize(loss)]},
                             seed=seed, mixed_precision=mp,
                             dist_strategy=ht.dist.ModelParallel4LM(
                                 tp=n, specs=gpt_tp_specs(L)))
            ex.load_dict(weights)
            losses, secs = [], []
            total = collections.Counter()
            for i, (x, y) in enumerate(batches):
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(ex.run("train", feed_dict={
                    ids: x, labels: y})[0]))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                c = launch_counts()
                want = flash_launches(c, L * n)
                if c != want:
                    fail(f"18b {dt} step {i}: launches {c}, want {want} "
                         f"({L} layers x tp {n})")
                if ex.tp_gathers:
                    fail(f"18b {dt} step {i}: {ex.tp_gathers} gathers of "
                         f"split values, want 0")
                total.update(c)
        heads_only(seen, (H // n, Dh), f"18b {dt}")
        counts[dt] = total
        plain_l, plain_ms = graph16["res"][dt]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_l))
        if not all(np.isfinite(losses)):
            fail(f"18b {dt}: a loss is not finite: {losses}")
        ms = float(np.median(secs[GPT16["warm"]:])) * 1e3
        text = ""
        if dt == "float32":
            if not rel <= TP18_LOSS_RTOL:
                fail(f"18b f32: losses {losses} vs plain {plain_l}: "
                     f"{rel:.3e} relative > {TP18_LOSS_RTOL}")
            got, want = ex.return_tensor_values(), graph16["final"][dt]
            # k's bias has an exact gradient of 0 (softmax is invariant to
            # it), so each side's rounding-level gradient becomes an AdamW
            # step of up to lr: held within steps x lr instead (as
            # tests/test_torch_gpt_graph.py holds it against JAX)
            kb = [k for k in want if k.endswith("_attn_k_bias")]
            kb_err = max(float(np.max(np.abs(got[k] - want[k]))) for k in kb)
            if not kb_err <= len(batches) * TP18_LR:
                fail(f"18b f32: k biases {kb_err:.3e} from plain > "
                     f"{len(batches)} steps x lr {TP18_LR}")
            ratio = {k: float(np.max(np.abs(got[k] - want[k])
                                     / (TP18_ATOL + TP18_RTOL
                                        * np.abs(want[k]))))
                     for k in want if k not in kb}
            worst = max(ratio, key=ratio.get)
            if not ratio[worst] <= 1.0:
                fail(f"18b f32: final tensors {ratio[worst]:.3f} x (atol "
                     f"{TP18_ATOL} + rtol {TP18_RTOL} |plain|) at {worst}; "
                     f"over: {sorted(k for k, r in ratio.items() if r > 1)}")
            text = (f", worst final tensor err / bound {ratio[worst]:.4f} "
                    f"({worst}), k biases {kb_err:.3e} (<= {len(batches)} "
                    f"x lr)")
        log(f"  18b {dt} on {card}: graph GPT-2-small B {TB} S {TS} over a "
            f"virtual tp {n} ({len(ex.tp_run.split_vars)} split weights), "
            f"losses {losses} (plain {plain_l}: {rel:.3e} relative"
            + (f", tol {TP18_LOSS_RTOL}" if dt == "float32" else ", logged")
            + f"){text}; {ex.tp_gathers} gathers, {ex.tp_run.grad_joins} "
            f"gradient joins a step; launches a step {L * n} K2, {L * n} K3 "
            f"dK/dV, {L * n} K3 dQ, K2 on {H // n} heads of {Dh}; step "
            f"{ms:.2f} ms (median of steps {GPT16['warm'] + 1}-"
            f"{len(batches)}; steps {[round(x * 1e3, 2) for x in secs]}), "
            f"plain {plain_ms:.2f} ms")
        del ex
        torch.cuda.empty_cache()
    kres = {}
    for dt in ("float32", "bfloat16"):
        for key, r in check_k3(torch, F, dt, seed, Hn=H // n).items():
            kres.setdefault(key, {})[dt] = r
    return counts, kres


def phase18(torch, F, htt, seed, spec, runs, spec_runs, runs8, res32,
            graph16, card):
    """Phase 18: 18a, 18b.  Returns (18a's {run tag: launches} and
    kernel results, 18b's {dtype: launches} and kernel results)."""
    t18 = time.perf_counter()
    r18a = phase18a(torch, F, htt, seed, spec, runs, spec_runs, runs8,
                    res32, card)
    torch.cuda.empty_cache()
    r18b = phase18b(torch, F, seed, card, graph16)
    log(f"  phase 18 in {time.perf_counter() - t18:.1f} s")
    return r18a, r18b


def request_set(prompts, seed, V):
    """16 requests: phase 3's four 128-token prompts (greedy), four that
    share a 128-token prefix, and eight of 32-600 tokens, four of them
    sampled."""
    rng = np.random.default_rng(seed + 7)
    spec = [(list(map(int, p)), 0.0, 0) for p in prompts]
    prefix = rng.integers(0, V, 128).tolist()
    for n in (40, 100, 200, 300):
        spec.append((prefix + rng.integers(0, V, n).tolist(), 0.0, 0))
    for i, n in enumerate((32, 77, 150, 256, 333, 420, 512, 600)):
        t, k = (0.8, 40) if i % 2 else (0.0, 0)
        spec.append((rng.integers(0, V, n).tolist(), t, k))
    return spec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="profile the serving runs (after the checks) and "
                         "three training steps, and write device time by "
                         "kernel into DIR")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "hetu_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {repo} holds no hetu_tpu_torch package",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    import torch.nn.functional as F

    import hetu_tpu_torch as htt
    from hetu_tpu_torch.kernels import _build
    # f32 parity: full-precision matmuls (the JAX package runs f32 at
    # Precision.HIGHEST)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # ---- phase 1 ---- #
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"  kernels built (or found built) in "
        f"{time.perf_counter() - t0:.2f} s into {_build.BUILD_ROOT}")
    for name, out in _build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    tc_report(_build, paths)
    map_us = tma_map_us(_build)
    log(f"  bf16 K2's three TMA tensor maps, encoded on the host on each "
        f"call: {map_us:.3f} us a call")

    # ---- phase 2 ---- #
    log("phase 2: kernels vs plain versions on the card")
    checks = {"K1": lambda dt: check_k1(torch, F, dt, args.seed),
              "K2": lambda dt: check_k2(torch, F, dt, args.seed),
              "K4": lambda dt: check_decode(torch, F, dt, args.seed, False),
              "K5": lambda dt: check_decode(torch, F, dt, args.seed, True),
              "K6": lambda dt: check_decode(torch, F, dt, args.seed, False,
                                            verify=True),
              "K7": lambda dt: check_decode(torch, F, dt, args.seed, True,
                                            verify=True),
              "K8": lambda dt: check_k8(torch, F, dt, args.seed)}
    for wave in ("decode", "verify"):
        checks[f"K1 {wave}"] = lambda dt, w=wave: check_k1(
            torch, F, dt, args.seed, wave=w)
        checks[f"K8 {wave}"] = lambda dt, w=wave: check_k8(
            torch, F, dt, args.seed, wave=w)
    kres = {k: {dt: fn(dt) for dt in ("float32", "bfloat16")}
            for k, fn in checks.items()}
    check_k8_equals_k1(torch, args.seed)
    check_k8_equals_k1(torch, args.seed, int8=True)
    check_k6_int8_equals_k8_int8(torch, args.seed)
    check_f32_verify_equals_ragged(torch, args.seed)
    check_decode_equals_ragged(torch, args.seed)

    # ---- phase 3 ---- #
    log("phase 3: offline generate_fast, GPT-2-small")
    cfg = htt.GPTConfig()
    t0 = time.perf_counter()
    params = htt.params_from_numpy(gpt2_small_params(cfg, args.seed))
    log(f"  weights from seed {args.seed} in "
        f"{time.perf_counter() - t0:.2f} s")
    prompts = np.random.default_rng(args.seed + 3).integers(
        0, cfg.vocab_size, (4, 128))
    off_f32, c_off32 = offline(torch, htt, params, cfg, prompts, "float32")
    _, c_off16 = offline(torch, htt, params, cfg, prompts, "bfloat16")

    # ---- phase 4 ---- #
    log("phase 4: ServingEngine, GPT-2-small, auto settings (paged mixed)")
    spec = request_set(prompts, args.seed, cfg.vocab_size)
    runs = {}      # (config, dtype) -> (results, launches, stats)
    runs["paged-mixed", "float32"] = serve(torch, htt, params, cfg, spec,
                                           "float32", "paged-mixed")
    res32 = runs["paged-mixed", "float32"][0]
    for i in range(4):
        got = res32[f"r{i}"].tokens[128:128 + 32]
        if list(got) != list(off_f32[i, 128:]):
            fail(f"f32 engine greedy tokens of r{i} differ from "
                 f"generate_fast: {list(got)} vs {list(off_f32[i, 128:])}")
    log("  f32 engine greedy tokens == generate_fast tokens (4 prompts)")
    runs["paged-mixed", "bfloat16"] = serve(torch, htt, params, cfg, spec,
                                            "bfloat16", "paged-mixed")
    res16 = runs["paged-mixed", "bfloat16"][0]
    agree = [int(np.argmax(np.append(
        res16[f"r{i}"].tokens != res32[f"r{i}"].tokens, True)))
        - len(spec[i][0]) for i in range(len(spec)) if spec[i][1] == 0]
    log(f"  bf16 vs f32 greedy: identical leading generated tokens per "
        f"request {agree} (of 64)")

    # ---- phase 5 ---- #
    log("phase 5: ServingEngine, GPT-2-small, the other layouts and "
        "schedulers")
    greedy = [i for i, (_, t, _) in enumerate(spec) if t == 0]
    for config in ("contiguous-split", "paged-split", "contiguous-mixed"):
        for dt in ("float32", "bfloat16"):
            runs[config, dt] = serve(torch, htt, params, cfg, spec, dt,
                                     config)
        res = runs[config, "float32"][0]
        bad = [i for i in greedy
               if list(res[f"r{i}"].tokens) != list(res32[f"r{i}"].tokens)]
        if bad:
            fail(f"{config} f32 greedy tokens differ from phase 4's for "
                 f"requests {bad}")
        log(f"  {config} f32 greedy tokens == phase 4's ({len(greedy)} "
            f"requests)")
    for (config, dt), (_, _, st) in runs.items():
        log(f"  serving on {card}: {config} {dt} "
            f"{st['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{st['ttft_p50_ms']:.1f} p99 {st['ttft_p99_ms']:.1f} ms")

    # ---- phase 6 ---- #
    log("phase 6: speculative decoding (spec 4, auto draft, adaptive k)")
    spec_runs = phase6(torch, htt, params, cfg, spec, runs, res32, prompts,
                       off_f32, card, args.seed)

    # ---- phase 7 ---- #
    log("phase 7: int8 KV cache: the int8 twins vs their plain versions "
        "(phase 2's K/V encoded on the card), then the engines")
    checks8 = {
        "K1-int8": lambda dt: check_k1(torch, F, dt, args.seed, int8=True),
        "K4-int8": lambda dt: check_decode(torch, F, dt, args.seed, False,
                                           int8=True),
        "K5-int8": lambda dt: check_decode(torch, F, dt, args.seed, True,
                                           int8=True),
        "K6-int8": lambda dt: check_decode(torch, F, dt, args.seed, False,
                                           verify=True, int8=True),
        "K7-int8": lambda dt: check_decode(torch, F, dt, args.seed, True,
                                           verify=True, int8=True),
        "K8-int8": lambda dt: check_k8(torch, F, dt, args.seed, int8=True)}
    for wave in ("decode", "verify"):
        checks8[f"K1-int8 {wave}"] = lambda dt, w=wave: check_k1(
            torch, F, dt, args.seed, int8=True, wave=w)
        checks8[f"K8-int8 {wave}"] = lambda dt, w=wave: check_k8(
            torch, F, dt, args.seed, int8=True, wave=w)
    kres.update({k: {dt: fn(dt) for dt in ("float32", "bfloat16")}
                 for k, fn in checks8.items()})
    runs8, spec_runs8 = phase7(torch, htt, params, cfg, spec, res32, card)

    # ---- phase 8 ---- #
    log("phase 8: training: K3 vs its plain version, GPT-2-small f32 and "
        "bf16, trained weights through the serving forward")
    del params
    kres8, train_runs = phase8(torch, F, htt, args.seed, card,
                               prof_dir=args.profile)

    # ---- phase 9 ---- #
    log("phase 9: context parallelism: K2-carry vs its plain version, the "
        "cp-4 ring and Ulysses at full width on a virtual mesh")
    kres9, ring_counts = phase9(torch, F, htt, args.seed)

    # ---- phase 10 ---- #
    log("phase 10: MoE serving: the MoE GPT at GPT-2-small width through "
        "generate_fast and the engines")
    moe10 = phase10(torch, htt, args.seed, spec, prompts, runs, card)

    # ---- phase 11 ---- #
    log("phase 11: the serving fleet: two replicas of phase 4's engine "
        "behind the router (chaos kill, KV handoff over both wires, a "
        "rolling weight swap, the host KV tier)")
    phase11(torch, htt, cfg, args.seed, spec, res32,
            runs["paged-mixed", "float32"][2], card)

    # ---- phase 12 ---- #
    log("phase 12: the graph surface: train_long_context's causal LM at "
        "the JAX example's full width (S 4096), bf16 flash steps, the eval "
        "subgraph, f32 flash vs unfused")
    phase12(torch, htt, args.seed, card)

    # ---- phase 13 ---- #
    log("phase 13: BERT and the model zoo on the graph surface: K2/K3 at "
        "BERT's shape with kv_lens, BERT-base bf16 pretraining (S 512, "
        "kv_lens), f32 flash vs unfused, BertMoE-base, the other families")
    kres13, counts13 = phase13(torch, F, args.seed, card)

    # ---- phase 14 ---- #
    log("phase 14: data, schedules, metrics and checkpoints: GPT-2-small "
        "from a token file under a warmup-cosine schedule, saved and "
        "resumed, --demo-generate; BERT-base from text to GLUE and SQuAD; "
        "wdl_criteo on dataloader feeds")
    counts14, demo14 = phase14(torch, args.seed, card)

    # ---- phase 15 ---- #
    log("phase 15: pipeline and sharded training on the graph surface: "
        "BERT-base pipelined over four stages of a virtual mesh (gpipe, "
        "1f1b), FSDP and a dp x tp ShardingPlan on virtual ranks, "
        "DataParallel over a one-rank NCCL world")
    kres15, counts15, counts15b, kres15b = phase15(torch, F, args.seed,
                                                   card)

    # ---- phase 16 ---- #
    log("phase 16: GPT on the graph surface: GPT-2-small (B 8, S 1024) "
        "three AdamW steps in f32 and bf16 against phase 8's nn.Module "
        "trainer, greedy_generate vs generate_fast, the engine over the "
        "graph-trained weights, serve_gpt")
    counts16, graph16 = phase16(torch, args.seed, card, train_runs)

    # ---- phase 17 ---- #
    log("phase 17: expert parallelism: phase 10's MoE GPT over a virtual "
        "ep 4 through the paged mixed engine and a one-rank NCCL mesh, "
        "moe_ffn_ep_reference with the int8 wire, train_gcn at Cora's "
        "widths with the 1.5-D layer")
    counts17 = phase17(torch, htt, args.seed, spec, moe10, card)
    del moe10

    # ---- phase 18 ---- #
    log("phase 18: tensor parallelism: GPT-2-small placed by "
        "tp_shard_params over a virtual tp 4 through every engine "
        "configuration and a one-rank NCCL mesh; the graph GPT-2-small "
        "under ModelParallel4LM(tp=4), f32 and bf16")
    (counts18a, kres18a), (counts18b, kres18b) = phase18(
        torch, F, htt, args.seed, spec, runs, spec_runs, runs8, res32,
        graph16, card)
    del graph16

    # each kernel's launches from the run of the path it serves: K1 the
    # phase-4 engine, K2 phase 3's generate_fast, K4/K5/K8 the phase-5
    # engine of their layout and scheduler, K6/K7 the phase-6 speculative
    # engine of their layout, phase-split; each int8 twin the phase-7
    # engine of its float twin's path.  K1/K8 and their int8 twins count
    # by regime: the Q 256 / Q 1024 rows their wide waves (Q > 16), the
    # decode rows the narrow waves (Q <= 16) of the same engine, the
    # verify rows the narrow waves of the (phase-6 or phase-7)
    # speculative engine of their layout.  Sources: f32, bf16.
    src = "hetu_tpu_torch/kernels/csrc/"
    # K1/K8 and their int8 twins: f32 q's wide waves on the TF32 body,
    # its narrow waves on the split body; bf16 q's both in one source
    k1 = ("ragged_tf32.cuh", "ragged_paged_bf16.cu")
    k1n = ("split_kv_f32.cuh", "ragged_paged_bf16.cu")
    # K4-K7 and their int8 twins: f32 q on the f32 split body, bf16 q
    # all in one source
    split = ("split_kv_f32.cuh", "decode_attention_bf16.cu")
    r1 = "hetu_tpu/kernels/ragged_attention.py:184"
    r8 = "hetu_tpu/kernels/ragged_attention.py:133"
    rq = "hetu_tpu/kernels/ragged_attention.py:96"
    table = (
        ("K1", "ragged_paged_attention", k1, r1, "paged-mixed"),
        ("K1 decode", "ragged_paged_attention", k1n, r1, "paged-mixed"),
        ("K1 verify", "ragged_paged_attention", k1n, r1,
         "spec paged-mixed"),
        ("K2", "flash_attention", ("flash_fwd.cu", "flash_fwd_bf16.cu"),
         "hetu_tpu/kernels/flash_attention.py:173", None),
        ("K4", "paged_decode_attention", split,
         "hetu_tpu/kernels/decode_attention.py:159", "contiguous-split"),
        ("K5", "paged_block_decode_attention", split,
         "hetu_tpu/kernels/decode_attention.py:259", "paged-split"),
        ("K6", "paged_verify_attention", split,
         "hetu_tpu/kernels/decode_attention.py:478",
         "spec contiguous-split"),
        ("K7", "paged_block_verify_attention", split,
         "hetu_tpu/kernels/decode_attention.py:572", "spec paged-split"),
        ("K8", "ragged_attention", k1, r8, "contiguous-mixed"),
        ("K8 decode", "ragged_attention", k1n, r8, "contiguous-mixed"),
        ("K8 verify", "ragged_attention", k1n, r8,
         "spec contiguous-mixed"),
        ("K1-int8", "ragged_paged_attention_int8", k1, rq,
         "int8 paged-mixed"),
        ("K1-int8 decode", "ragged_paged_attention_int8", k1n, rq,
         "int8 paged-mixed"),
        ("K1-int8 verify", "ragged_paged_attention_int8", k1n, rq,
         "int8 spec paged-mixed"),
        ("K4-int8", "paged_decode_attention_int8", split,
         "hetu_tpu/kernels/decode_attention.py:120",
         "int8 contiguous-split"),
        ("K5-int8", "paged_block_decode_attention_int8", split,
         "hetu_tpu/kernels/decode_attention.py:247", "int8 paged-split"),
        ("K6-int8", "paged_verify_attention_int8", split,
         "hetu_tpu/kernels/decode_attention.py:448",
         "int8 spec contiguous-split"),
        ("K7-int8", "paged_block_verify_attention_int8", split,
         "hetu_tpu/kernels/decode_attention.py:562",
         "int8 spec paged-split"),
        ("K8-int8", "ragged_attention_int8", k1, rq,
         "int8 contiguous-mixed"),
        ("K8-int8 decode", "ragged_attention_int8", k1n, rq,
         "int8 contiguous-mixed"),
        ("K8-int8 verify", "ragged_attention_int8", k1n, rq,
         "int8 spec contiguous-mixed"))
    kernels = []
    for k, name, files, replaces, config in table:
        for dt, file in zip(("float32", "bfloat16"), files):
            if config is None:
                counts = c_off32 if dt == "float32" else c_off16
            elif config.startswith("int8 spec "):
                counts = spec_runs8[config[10:], dt][1]
            elif config.startswith("int8 "):
                counts = runs8[config[5:], dt][1]
            elif config.startswith("spec "):
                counts = spec_runs[config[5:], dt][1]
            else:
                counts = runs[config, dt][1]
            r = kres[k][dt]
            wave = k.split(" ")[1] if " " in k else None
            if k.split()[0] in ("K1", "K8", "K1-int8", "K8-int8"):
                counter = f"{name}:{'narrow' if wave else 'wide'}"
            else:
                counter = name
            kernels.append(dict(
                name=(f"{name}[{dt}, {wave} Q {NARROW_WAVES[wave][0]}]"
                      if wave else f"{name}[{dt}]"), route="cuda",
                source=src + file, replaces=replaces,
                launches=counts[counter],
                max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"], dev_ms=r.get("dev_ms")))
    # K2 at the training shape and K3's two kernels: launches from the
    # phase-8 training run of their dtype
    for key, name, file, replaces in (
            ("fwd", "flash_attention", "flash_fwd",
             "hetu_tpu/kernels/flash_attention.py:173"),
            ("dkv", "flash_attention_bwd_dkv", "flash_bwd",
             "hetu_tpu/kernels/flash_attention.py:396"),
            ("dq", "flash_attention_bwd_dq", "flash_bwd",
             "hetu_tpu/kernels/flash_attention.py:428")):
        for dt in ("float32", "bfloat16"):
            r = kres8[key][dt]
            kernels.append(dict(
                name=f"{name}[{dt}, training shape]" if key == "fwd"
                else f"{name}[{dt}]", route="cuda",
                source=src + file + ("_bf16.cu" if dt == "bfloat16"
                                     else ".cu"),
                replaces=replaces, launches=train_runs[dt][1][name],
                max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"], dev_ms=r.get("dev_ms")))
    # K2-carry: launches from phase 9's causal ring of its dtype
    for dt in ("float32", "bfloat16"):
        r = kres9[dt]
        kernels.append(dict(
            name=f"flash_attention_carry[{dt}]", route="cuda",
            source=src + ("flash_fwd_bf16.cu" if dt == "bfloat16"
                          else "flash_fwd.cu"),
            replaces="hetu_tpu/kernels/flash_attention.py:173",
            launches=ring_counts[dt]["flash_attention_carry"],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], dev_ms=r.get("dev_ms")))
    # K2 and K3 at BERT's shape with kv_lens: launches from phase 13's
    # BERT-base runs, bf16 13a's steps, f32 13b's flash step
    for key, name, file, replaces in (
            ("fwd", "flash_attention", "flash_fwd",
             "hetu_tpu/kernels/flash_attention.py:173"),
            ("dkv", "flash_attention_bwd_dkv", "flash_bwd",
             "hetu_tpu/kernels/flash_attention.py:396"),
            ("dq", "flash_attention_bwd_dq", "flash_bwd",
             "hetu_tpu/kernels/flash_attention.py:428")):
        for dt in ("float32", "bfloat16"):
            r = kres13[key][dt]
            kernels.append(dict(
                name=f"{name}[{dt}, BERT kv_lens]", route="cuda",
                source=src + file + ("_bf16.cu" if dt == "bfloat16"
                                     else ".cu"),
                replaces=replaces, launches=counts13[dt][name],
                max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"], dev_ms=r.get("dev_ms")))
    # K2 and K3 at the training shape, f32: launches from phase 14a's
    # uninterrupted run on the token file; K4 (f32): from its
    # --demo-generate's generate_fast (the numbers: phase 8's and phase
    # 2's measurements of the same kernels)
    for key, name, file, replaces in (
            ("fwd", "flash_attention", "flash_fwd.cu",
             "hetu_tpu/kernels/flash_attention.py:173"),
            ("dkv", "flash_attention_bwd_dkv", "flash_bwd.cu",
             "hetu_tpu/kernels/flash_attention.py:396"),
            ("dq", "flash_attention_bwd_dq", "flash_bwd.cu",
             "hetu_tpu/kernels/flash_attention.py:428")):
        r = kres8[key]["float32"]
        kernels.append(dict(
            name=f"{name}[float32, 14a token file]", route="cuda",
            source=src + file, replaces=replaces, launches=counts14[name],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], dev_ms=r.get("dev_ms")))
    r = kres["K4"]["float32"]
    kernels.append(dict(
        name="paged_decode_attention[float32, 14a demo-generate]",
        route="cuda", source=src + split[0],
        replaces="hetu_tpu/kernels/decode_attention.py:159",
        launches=demo14["paged_decode_attention"], max_abs_err=r["err"],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        dev_ms=r.get("dev_ms")))
    # K2 and K3 at 15a's microbatch shape, f32: launches from 15a's 1f1b
    # run (three steps), the numbers 15-pre's
    for key, name, file, replaces in (
            ("fwd", "flash_attention", "flash_fwd.cu",
             "hetu_tpu/kernels/flash_attention.py:173"),
            ("dkv", "flash_attention_bwd_dkv", "flash_bwd.cu",
             "hetu_tpu/kernels/flash_attention.py:396"),
            ("dq", "flash_attention_bwd_dq", "flash_bwd.cu",
             "hetu_tpu/kernels/flash_attention.py:428")):
        r = kres15[key]
        kernels.append(dict(
            name=f"{name}[float32, 15a 1f1b]", route="cuda",
            source=src + file, replaces=replaces, launches=counts15[name],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], dev_ms=r.get("dev_ms")))
    # K2 and K3 at 15b's per-rank shape (the dp 2 x tp 2 plan, 6 heads),
    # f32: launches from the plan's three steps, the numbers 15b's checks
    for key, name, file, replaces in (
            ("fwd", "flash_attention", "flash_fwd.cu",
             "hetu_tpu/kernels/flash_attention.py:173"),
            ("dkv", "flash_attention_bwd_dkv", "flash_bwd.cu",
             "hetu_tpu/kernels/flash_attention.py:396"),
            ("dq", "flash_attention_bwd_dq", "flash_bwd.cu",
             "hetu_tpu/kernels/flash_attention.py:428")):
        r = kres15b[key]
        kernels.append(dict(
            name=f"{name}[float32, 15b tp 2, 6 heads]", route="cuda",
            source=src + file, replaces=replaces, launches=counts15b[name],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], dev_ms=r.get("dev_ms")))
    # K2 and K3 at the training shape: launches from phase 16's three
    # graph steps of their dtype (the numbers phase 8's)
    for key, name, file, replaces in (
            ("fwd", "flash_attention", "flash_fwd",
             "hetu_tpu/kernels/flash_attention.py:173"),
            ("dkv", "flash_attention_bwd_dkv", "flash_bwd",
             "hetu_tpu/kernels/flash_attention.py:396"),
            ("dq", "flash_attention_bwd_dq", "flash_bwd",
             "hetu_tpu/kernels/flash_attention.py:428")):
        for dt in ("float32", "bfloat16"):
            r = kres8[key][dt]
            kernels.append(dict(
                name=f"{name}[{dt}, 16 graph GPT]", route="cuda",
                source=src + file + ("_bf16.cu" if dt == "bfloat16"
                                     else ".cu"),
                replaces=replaces, launches=counts16[dt][name],
                max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"], dev_ms=r.get("dev_ms")))
    # K1 on its mixed (Q 256) and decode (Q 1) waves: launches from 17a's
    # ep-placed engine (f32), the numbers phase 2's
    for k, wave in (("K1", None), ("K1 decode", "decode")):
        r = kres[k]["float32"]
        kernels.append(dict(
            name=(f"ragged_paged_attention[float32, 17a ep 4"
                  f"{', decode Q 1' if wave else ''}]"), route="cuda",
            source=src + (k1n if wave else k1)[0], replaces=r1,
            launches=counts17["ragged_paged_attention:"
                              + ("narrow" if wave else "wide")],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], dev_ms=r.get("dev_ms")))
    # 18a's kernels at a rank's 3 heads: launches from the 18a run of
    # their path (K1 and its int8 twin the paged mixed engine, f32 and
    # int8; K1's verify rows its spec 4 run; K8 the contiguous mixed
    # engine; K4 and K2 the contiguous split engine; K5 the paged split
    # engine), the numbers 18a's checks at those heads
    for k, name, file, replaces, tag, counter in (
            ("K1", "ragged_paged_attention", k1[0], r1, "paged-mixed",
             "ragged_paged_attention:wide"),
            ("K1 decode", "ragged_paged_attention", k1n[0], r1,
             "paged-mixed", "ragged_paged_attention:narrow"),
            ("K1 verify", "ragged_paged_attention", k1n[0], r1,
             "paged-mixed spec=4", "ragged_paged_attention:narrow"),
            ("K8", "ragged_attention", k1[0], r8, "contiguous-mixed",
             "ragged_attention:wide"),
            ("K8 decode", "ragged_attention", k1n[0], r8,
             "contiguous-mixed", "ragged_attention:narrow"),
            ("K4", "paged_decode_attention", split[0],
             "hetu_tpu/kernels/decode_attention.py:159", "contiguous-split",
             "paged_decode_attention"),
            ("K5", "paged_block_decode_attention", split[0],
             "hetu_tpu/kernels/decode_attention.py:259", "paged-split",
             "paged_block_decode_attention"),
            ("K2", "flash_attention", "flash_fwd.cu",
             "hetu_tpu/kernels/flash_attention.py:173", "contiguous-split",
             "flash_attention"),
            ("K1-int8", "ragged_paged_attention_int8", k1[0], rq,
             "paged-mixed kv_quant=int8", "ragged_paged_attention_int8:wide"),
            ("K1-int8 decode", "ragged_paged_attention_int8", k1n[0], rq,
             "paged-mixed kv_quant=int8",
             "ragged_paged_attention_int8:narrow")):
        r = kres18a[k]
        wave = k.split(" ")[1] if " " in k else None
        kernels.append(dict(
            name=(f"{name}[float32, 18a tp 4, 3 heads"
                  + (f", {wave} Q {NARROW_WAVES[wave][0]}" if wave else "")
                  + "]"), route="cuda", source=src + file,
            replaces=replaces, launches=counts18a[tag][counter],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], dev_ms=r.get("dev_ms")))
    # K2 and K3 at the training shape with a rank's 3 heads: launches
    # from 18b's steps of their dtype, the numbers 18b's checks
    for key, name, file, replaces in (
            ("fwd", "flash_attention", "flash_fwd",
             "hetu_tpu/kernels/flash_attention.py:173"),
            ("dkv", "flash_attention_bwd_dkv", "flash_bwd",
             "hetu_tpu/kernels/flash_attention.py:396"),
            ("dq", "flash_attention_bwd_dq", "flash_bwd",
             "hetu_tpu/kernels/flash_attention.py:428")):
        for dt in ("float32", "bfloat16"):
            r = kres18b[key][dt]
            kernels.append(dict(
                name=f"{name}[{dt}, 18b tp 4, 3 heads]", route="cuda",
                source=src + file + ("_bf16.cu" if dt == "bfloat16"
                                     else ".cu"),
                replaces=replaces, launches=counts18b[dt][name],
                max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"], dev_ms=r.get("dev_ms")))
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on the main path")
    if args.profile:
        log("profile: the serving runs under torch.profiler")
        profile_serve(torch, htt, htt.params_from_numpy(
            gpt2_small_params(cfg, args.seed)), cfg, spec, args.profile)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
