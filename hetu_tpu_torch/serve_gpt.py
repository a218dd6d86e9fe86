"""Continuous-batching GPT serving from graph-trained weights, the port of
the JAX package's ``examples/nlp/serve_gpt.py``.

Trains a tiny GPT on the graph surface (``models.GPTForCausalLM``,
Adam) on the synthetic next-token task next = (x + 1) % V, a few hundred
steps of which make greedy decoding follow the +1 chain, then serves a
mixed-length burst through ``ServingEngine(executor.var_values, cfg)``:
short requests retire and free their slots while a long straggler keeps
decoding; tokens stream per step, and the engine's metrics (TTFT, tok/s,
occupancy) are logged at the end.  ``main`` returns the fraction of
requests whose tokens follow the chain.

    python -m hetu_tpu_torch.serve_gpt --requests 6 --slots 2
    python -m hetu_tpu_torch.serve_gpt --requests 6 --slots 2 --spec 3

``--spec K`` turns on speculative decoding: a draft of the trained
model's first ``--spec-draft-layers`` layers proposes up to K tokens a
wave and the target verifies them in one step; the tokens stay those of
plain greedy decoding.  Runs on the card unless ``--device cpu`` is
given.  The flags and defaults are the JAX example's but ``--heads``:
one head of 32, since the card's attention kernels take head dims 32,
64 and 128 (the example's two heads of 16 raise there).
"""

import argparse
import logging

import numpy as np

from . import graph as ht
from .models import GPTConfig, GPTForCausalLM
from .serving import Request, ServingEngine

logger = logging.getLogger("serve_gpt")


def train_tiny(cfg, steps, lr, device=None):
    """The graph GPT (variables named ``sg_*``) after ``steps`` Adam steps
    on the +1 task: its executor."""
    m = GPTForCausalLM(cfg, name="sg")
    ids = ht.placeholder_op("sg_ids")
    labels = ht.placeholder_op("sg_labels")
    loss, _ = m(ids, labels=labels)
    train = ht.optim.AdamOptimizer(learning_rate=lr).minimize(loss)
    ex = ht.Executor({"train": [loss, train]}, device=device)
    rng = np.random.RandomState(1)
    for step in range(steps):
        iv = rng.randint(0, cfg.vocab_size,
                         (cfg.batch_size, cfg.seq_len)).astype(np.int32)
        tv = ((iv + 1) % cfg.vocab_size).astype(np.int32)
        lv = ex.run("train", feed_dict={ids: iv, labels: tv})[0]
        if step % 100 == 0:
            logger.info("train step %d loss %.4f", step, float(lv))
    return ex


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vocab-size", type=int, default=61)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=1)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--train-steps", type=int, default=250)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--spec", type=int, default=0,
                    help="speculative decoding: a truncated-layer "
                         "draft proposes up to this many tokens per "
                         "wave (0 = off); outputs stay token-identical")
    ap.add_argument("--spec-draft-layers", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def requests(n, vocab_size, seq_len, stream_cb=None):
    """The burst: one straggler of ``seq_len - 2`` new tokens, the rest of
    2-5 (the shorts cycle through the straggler's slot-mates while it
    keeps decoding), each a one-token prompt."""
    rng = np.random.RandomState(7)
    reqs = []
    for i in range(n):
        start = int(rng.randint(0, vocab_size - 1))
        m = seq_len - 2 if i == 0 else int(rng.randint(2, 6))
        reqs.append(Request(prompt=[start], max_new_tokens=m,
                            stream_cb=stream_cb))
    return reqs


def serve(ex, cfg, slots=2, num_requests=6, spec=0, spec_draft_layers=1):
    """Serve the burst from the executor's variables: (fraction of
    requests on the +1 chain, each request's tokens (prompt included) in
    order, the engine)."""

    def stream(req, tok):
        logger.info("  %s += %d", req.request_id, tok)

    eng = ServingEngine(ex.var_values, cfg, slots=slots,
                        queue_limit=num_requests, spec=spec or None,
                        spec_draft_layers=spec_draft_layers,
                        device=ex.device)
    reqs = requests(num_requests, cfg.vocab_size, cfg.seq_len, stream)
    results = eng.run(reqs)
    ok, tokens = 0, []
    for r in reqs:
        res = results[r.request_id]
        got = [int(t) for t in res.tokens]
        tokens.append(got)
        want = [(r.prompt[0] + k) % cfg.vocab_size for k in range(len(got))]
        good = got == want
        ok += good
        logger.info("%s (%s, %d tokens, ttft %.1f ms): %s%s",
                    r.request_id, res.finish_reason, res.n_generated,
                    res.ttft_s * 1e3, got,
                    "" if good else f"  EXPECTED {want}")
    snap = eng.metrics.snapshot()
    logger.info("served %d requests, %s tokens @ %s tok/s, "
                "mean occupancy %s, %d fused steps",
                snap["requests_finished"], snap["tokens_generated"],
                snap["tokens_per_sec"], snap.get("mean_batch_occupancy"),
                snap["steps"])
    if spec:
        logger.info("speculative: %d waves, accepted %d/%d drafts "
                    "(rate %s), %s tokens/step",
                    eng.spec_waves, eng.spec_accepted, eng.spec_proposed,
                    round(eng.spec_acceptance, 3)
                    if eng.spec_acceptance is not None else "-",
                    snap.get("tokens_per_step_mean"))
    return ok / len(reqs), tokens, eng


def config(args):
    return GPTConfig(vocab_size=args.vocab_size, hidden_size=args.hidden,
                     num_hidden_layers=args.num_layers,
                     num_attention_heads=args.heads,
                     max_position_embeddings=args.seq_len, batch_size=4,
                     seq_len=args.seq_len, dropout_rate=0.0)


def run(argv=None):
    """Train, serve the burst: (fraction of requests on the +1 chain,
    each request's tokens (prompt included) in order, the training
    executor, the config)."""
    args = parse_args(argv)
    cfg = config(args)
    ex = train_tiny(cfg, args.train_steps, args.lr, device=args.device)
    frac, tokens, _ = serve(ex, cfg, args.slots, args.requests, args.spec,
                            args.spec_draft_layers)
    return frac, tokens, ex, cfg


def main(argv=None):
    """The fraction of requests whose tokens follow the +1 chain."""
    return run(argv)[0]


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
