#!/usr/bin/env python3
"""Time the port's attention kernels of one or more checkouts on one
NVIDIA card, each checkout in a process of its own, in the order given.

    python3 kernel_times.py [--trees DIR [DIR ...]] [--seed N]
                            [--dtypes float32 bfloat16] [--out FILE]
                            [--kernels PREFIX ...]
                            [--engines DIR [--engine-labels L ...]]
                            [--train]

A tree is the root of a checkout holding ``hetu_tpu_torch`` (the
default is this one); an older commit is unpacked there with ``git
archive`` into a git-ignored directory, e.g.

    git archive <commit> | tar -x -C _archive/parent
    python3 kernel_times.py --trees _archive/parent . . _archive/parent

``--kernels`` keeps the rows whose name starts with one of the given
prefixes (``--kernels K2`` times K2 at both shapes and K2-carry; K2 at
the training shape comes with K3's two kernels).

Every tree is driven by THIS checkout's ``chip_smoke.py`` phase-2
functions, so all meet the same shapes, checks and timing: K1 and K8
and their int8 twins (K1-int8, K8-int8: phase 2's K/V encoded by
``kv_encode``) at their mixed waves (Q 256 / 1024) and at the decode
(Q 1) and verify (Q 8) waves, K4-K7 and their int8 twins at phase 2's
decode (Q 1) and verify (Q 5) waves, K4 and K5 also at a decode wave of
short slots (``K4 short``, ``K5 short``: ``SHORT_LENGTHS``, each slot
within one 128-position split), K2 at the serving and the training
shape, K2-carry at the ring's block, K3's two kernels at the training
shape.  Each result is held to its plain version as chip_smoke holds it
(a tree that predates ``ragged_rounding_bound`` gets this checkout's
definition of it, and a tree whose bf16-q int8 kernels round P once is
held to that bound there: ``chip_smoke.INT8_ROUNDS_P``) and reports the
one-call CUDA-event median (``ms``), ten calls back to back
(``run_ms``) and the kernels' device time per call under
torch.profiler (``dev_ms``: a split-K call's two kernels, without the
wrapper's host time, which sets ``run_ms`` once the kernels are faster
than the host).
With ``--engines DIR`` each tree then also serves chip_smoke's request
set on GPT-2-small (random weights from ``--seed``) through the engines
of ``ENGINES``: in bf16 and in f32 the phase-split engines with
``spec=4`` on the slot rows (K6 and the draft's K4), on an int8 copy of
them (K6-int8 and K4), on the pool (K7 and K4) and on an int8 pool
(K7-int8 and K4); the pool without spec in bf16 and in f32 (K5, whose
only engine path this is) and the slot rows without spec in f32 (K4);
in bf16 and
in f32 the phase-split engines over an int8 cache without spec, on
slot rows (K4-int8) and on the pool (K5-int8); in f32 the
auto paged mixed engine (K1 on every wave), the contiguous mixed engine
(K8 on every wave) and the paged mixed engine over an int8 pool
(K1-int8 on every wave) and the contiguous mixed engine over int8
slot rows (K8-int8 on every wave), and in f32 the paged mixed engine
over the dict ``tp_shard_params`` places on a virtual tp 4 (K1 once per
rank, on 3 heads): one run for tok/s, then one
under torch.profiler (device ms by kind, tables into DIR/<run>/);
``--engine-labels`` runs only the engines of those labels.  With
``--train`` each tree also trains GPT-2-small in f32 at B 8, S 1024 for
8 steps (chip_smoke phase 8's ``train``: step ms, tokens/s, K2's 12
launches a step), and with ``--engines DIR`` three more steps under
torch.profiler (device ms a step by kind, K3's two kernels among
them).  Each tree builds its kernels into its own
``hetu_tpu_torch/_build``.  Order the trees parent, change, change,
parent to see the drift between runs.  Prints one JSON line per tree
run (and writes them to ``--out``), then a table of the times.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
TAG = "kernel_times: "


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bound_of(ra):
    """``ragged_rounding_bound`` for a tree that predates it: 2^-8 times
    the tree's own plain version over (q, k, |v|), an int8 cache
    dequantized first."""
    def bound(q, k, v, lengths, q_lens, block_tables=None, k_scale=None,
              v_scale=None):
        if k_scale is not None:
            k = k.float() * k_scale[..., None]
            v = v.float() * v_scale[..., None]
        va = v.float().abs()
        if block_tables is None:
            w = ra.ragged_masked_reference(q, k, va, lengths, q_lens)
        else:
            w = ra.ragged_paged_reference(q, k, va, lengths, q_lens,
                                          block_tables)
        return 2.0 ** -8 * w
    return bound


# the engines of ``--engines``: (label, configuration, spec, kv_quant,
# dtype, the kinds whose device ms the table prints).  The phase-split
# spec 4 engines' verify waves, bf16 and f32, run K6 (slot rows), K6-int8
# (int8 slot rows), K7 (the pool) or K7-int8 (an int8 pool) and their
# drafts K4 (the draft's own cache is a float one); without spec the
# slot rows run K4 in their decode waves (f32) and the pool K5 (bf16 and
# f32), and over an int8 cache, in bf16 and in
# f32, the slot rows without spec run K4-int8 and the pool K5-int8 (and
# K1-int8 for its chunk passes); the f32 paged mixed engine runs K1 on
# every wave (narrow decode waves, wide prompt chunks), the f32
# contiguous mixed engine K8, the f32 paged mixed engine over an int8
# pool K1-int8 and the f32 contiguous mixed engine over int8 slot rows
# K8-int8, the same way; "paged-mixed-tp4-f32" is the f32 paged mixed
# engine over ``tp_shard_params`` on a virtual tp 4 (``TP_ENGINES``: K1
# once per rank, on 3 heads)
ENGINES = (("contiguous-split", "contiguous-split", 4, None, "bfloat16",
            ("K6 paged_verify_attention", "K4 paged_decode_attention")),
           ("contiguous-split-int8", "contiguous-split", 4, "int8",
            "bfloat16", ("K6-int8 paged_verify_attention",
                         "K4 paged_decode_attention")),
           ("paged-split", "paged-split", 4, None, "bfloat16",
            ("K7 paged_block_verify_attention",
             "K4 paged_decode_attention")),
           ("paged-split-int8", "paged-split", 4, "int8", "bfloat16",
            ("K7-int8 paged_block_verify_attention",
             "K4 paged_decode_attention")),
           ("contiguous-split-f32", "contiguous-split", 4, None, "float32",
            ("K6 paged_verify_attention", "K4 paged_decode_attention")),
           ("contiguous-split-int8-f32", "contiguous-split", 4, "int8",
            "float32", ("K6-int8 paged_verify_attention",
                        "K4 paged_decode_attention")),
           ("paged-split-f32", "paged-split", 4, None, "float32",
            ("K7 paged_block_verify_attention",
             "K4 paged_decode_attention")),
           ("paged-split-int8-f32", "paged-split", 4, "int8", "float32",
            ("K7-int8 paged_block_verify_attention",
             "K4 paged_decode_attention")),
           ("paged-split-nospec", "paged-split", 0, None, "bfloat16",
            ("K5 paged_block_decode_attention",)),
           ("contiguous-split-nospec-f32", "contiguous-split", 0, None,
            "float32", ("K4 paged_decode_attention",)),
           ("paged-split-nospec-f32", "paged-split", 0, None, "float32",
            ("K5 paged_block_decode_attention",)),
           ("contiguous-split-int8-nospec", "contiguous-split", 0, "int8",
            "bfloat16", ("K4-int8 paged_decode_attention",)),
           ("paged-split-int8-nospec", "paged-split", 0, "int8",
            "bfloat16", ("K5-int8 paged_block_decode_attention",
                         "K1-int8 ragged_paged_attention")),
           ("contiguous-split-int8-nospec-f32", "contiguous-split", 0,
            "int8", "float32", ("K4-int8 paged_decode_attention",)),
           ("paged-split-int8-nospec-f32", "paged-split", 0, "int8",
            "float32", ("K5-int8 paged_block_decode_attention",
                        "K1-int8 ragged_paged_attention")),
           ("paged-mixed-f32", "paged-mixed", 0, None, "float32",
            ("K1 ragged_paged_attention",)),
           ("contiguous-mixed-f32", "contiguous-mixed", 0, None, "float32",
            ("K8 ragged_attention",)),
           ("paged-mixed-int8-f32", "paged-mixed", 0, "int8", "float32",
            ("K1-int8 ragged_paged_attention",)),
           ("contiguous-mixed-int8-f32", "contiguous-mixed", 0, "int8",
            "float32", ("K8-int8 ragged_attention",)),
           ("paged-mixed-tp4-f32", "paged-mixed", 0, None, "float32",
            ("K1 ragged_paged_attention",)))
# the engines of ENGINES that serve a dict placed over a virtual tp
# mesh of this size
TP_ENGINES = {"paged-mixed-tp4-f32": 4}


def engines(torch, cs, seed, out_dir, labels):
    """Serve chip_smoke's request set through the ``ENGINES`` of
    ``labels``: {label: {"tokens_per_s": an unprofiled run's,
    "profiled": the profiled run's stats and device ms by kind}}."""
    import numpy as np
    import hetu_tpu_torch as htt
    cfg = htt.GPTConfig()
    params = htt.params_from_numpy(cs.gpt2_small_params(cfg, seed))
    prompts = np.random.default_rng(seed + 3).integers(
        0, cfg.vocab_size, (4, 128))
    spec = cs.request_set(prompts, seed, cfg.vocab_size)
    out = {}
    for label, config, spec_k, quant, dtype, _ in ENGINES:
        if label not in labels:
            continue
        p = params
        if label in TP_ENGINES:
            from hetu_tpu_torch.models.gpt_decode import tp_shard_params
            from hetu_tpu_torch.parallel import make_mesh
            p = tp_shard_params(params, make_mesh(
                {"tp": TP_ENGINES[label]},
                device=params["gpt_wte_table"].device), cfg)
        st = cs.serve(torch, htt, p, cfg, spec, dtype, config,
                      spec=spec_k, kv_quant=quant)[2]
        prof = cs.profile_serve(torch, htt, p, cfg, spec, out_dir,
                                runs=((config, spec_k, quant, dtype),))
        out[label] = dict(tokens_per_s=st["tokens_per_s"],
                          profiled=next(iter(prof.values())))
    return out


def train_f32(torch, cs, seed, out_dir=None):
    """chip_smoke's f32 training run (GPT-2-small, B 8, S 1024, 8
    steps): its stats (step ms, tokens/s, peak bytes) and K2's launches
    a step; with ``out_dir`` also three more steps under torch.profiler
    (``train_gpt.profile_steps``: device ms a step by kind, K2 and K3's
    two kernels among them, the table into ``out_dir``)."""
    import numpy as np
    import hetu_tpu_torch as htt
    from hetu_tpu_torch.train_gpt import profile_steps, synthetic
    cfg = htt.GPTConfig(batch_size=cs.TB, seq_len=cs.TS, dropout_rate=0.0)
    ex, st, counts = cs.train(torch, htt, cfg, "float32", seed)
    res = dict(st, k2_launches=counts["flash_attention"])
    if out_dir is not None:
        res["profile"] = profile_steps(
            ex, synthetic(cfg, np.random.RandomState(seed + 1)), 3,
            Path(out_dir) / "train_float32")
    return res


def worker(tree, seed, dtypes, engines_dir=None, train=False,
           labels=(), kernels=None):
    """Time one tree's kernels (those whose row name starts with one of
    ``kernels``, or all); returns {kernel: {dtype: result}}, with
    ``engines_dir`` {label: engine result} of the engines of ``labels``
    (``engines``), with ``train`` the f32 training run
    (``train_f32``)."""
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    import hetu_tpu_torch
    if Path(hetu_tpu_torch.__file__).resolve().parent.parent != root:
        raise SystemExit(f"kernel_times: imported {hetu_tpu_torch.__file__},"
                         f" not the tree {root}")
    from hetu_tpu_torch.kernels import _build
    from hetu_tpu_torch.kernels import ragged_attention as ra
    if not hasattr(ra, "ragged_rounding_bound"):
        ra.ragged_rounding_bound = _bound_of(ra)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _chip_smoke()
    # the split of p times the V scale (flash_mma.cuh acc_to_a_lo): a
    # tree without it rounds that product once
    cs.INT8_ROUNDS_P = "acc_to_a_lo" not in (
        root / "hetu_tpu_torch/kernels/csrc/flash_mma.cuh").read_text()
    _build.build_all()
    res = {}

    def want(*keys):
        return kernels is None or any(k.startswith(p) for k in keys
                                      for p in kernels)
    for dt in dtypes:
        for int8, wave in itertools.product((False, True),
                                            ("mixed", "decode", "verify")):
            q = "-int8" if int8 else ""
            for k, check in (("K1", cs.check_k1), ("K8", cs.check_k8)):
                if want(f"{k}{q} {wave}"):
                    res.setdefault(f"{k}{q} {wave}", {})[dt] = check(
                        torch, F, dt, seed, int8=int8, wave=wave)
        for int8, (k, paged, verify) in itertools.product(
                (False, True), (("K4", False, False), ("K5", True, False),
                                ("K6", False, True), ("K7", True, True))):
            if want(f"{k}{'-int8' if int8 else ''}"):
                res.setdefault(f"{k}{'-int8' if int8 else ''}", {})[dt] = \
                    cs.check_decode(torch, F, dt, seed, paged,
                                    verify=verify, int8=int8)
        for k, paged in (("K4", False), ("K5", True)):
            if want(f"{k} short"):
                res.setdefault(f"{k} short", {})[dt] = cs.check_decode(
                    torch, F, dt, seed, paged, lengths=cs.SHORT_LENGTHS)
        if want("K2 serving"):
            res.setdefault("K2 serving", {})[dt] = cs.check_k2(torch, F, dt,
                                                               seed)
        if want("K2 training", "K3 dkv", "K3 dq"):
            k3 = cs.check_k3(torch, F, dt, seed)
            res.setdefault("K2 training", {})[dt] = k3["fwd"]
            res.setdefault("K3 dkv", {})[dt] = k3["dkv"]
            res.setdefault("K3 dq", {})[dt] = k3["dq"]
        if want("K2-carry"):
            res.setdefault("K2-carry", {})[dt] = cs.check_carry(torch, dt,
                                                               seed)
    eng = (engines(torch, cs, seed, engines_dir, labels) if engines_dir
           else None)
    return res, eng, (train_f32(torch, cs, seed, engines_dir) if train
                      else None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--engines", default=None, metavar="DIR",
                    help="also serve through the engines of ENGINES, "
                         "one profiled run each (tables into DIR)")
    ap.add_argument("--engine-labels", nargs="+",
                    default=[e[0] for e in ENGINES],
                    help="the labels of ENGINES to run with --engines")
    ap.add_argument("--train", action="store_true",
                    help="also train GPT-2-small in f32 (8 steps)")
    ap.add_argument("--kernels", nargs="+", default=None, metavar="PREFIX",
                    help="time only the rows whose name starts with one "
                         "of these")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        res, eng, tr = worker(args.worker, args.seed, args.dtypes,
                              args.engines, args.train, args.engine_labels,
                              args.kernels)
        print(TAG + json.dumps({"tree": args.worker, "results": res,
                                "engines": eng, "train": tr}), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    runs = []
    for i, tree in enumerate(args.trees):
        eng = (["--engines", str(Path(args.engines) / f"run{i}"),
                "--engine-labels", *args.engine_labels]
               if args.engines else [])
        eng += ["--train"] if args.train else []
        eng += ["--kernels", *args.kernels] if args.kernels else []
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", tree,
             "--seed", str(args.seed), "--dtypes", *args.dtypes, *eng],
            stdout=subprocess.PIPE, text=True, timeout=1800)
        lines = [ln for ln in out.stdout.splitlines()]
        for ln in lines:
            if not ln.startswith(TAG):
                print(f"  [{tree}] {ln}", flush=True)
        if out.returncode != 0:
            raise SystemExit(f"kernel_times: {tree} exited "
                             f"{out.returncode}")
        run = json.loads(next(ln for ln in lines
                              if ln.startswith(TAG))[len(TAG):])
        run["card"] = card
        runs.append(run)
        print(TAG + json.dumps(run), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in runs))
    print(f"one call / ten back to back [/ device], ms (max abs err), on "
          f"{card}; trees "
          f"in order: "
          + ", ".join(r["tree"] for r in runs))
    for key in runs[0]["results"]:
        for dt in args.dtypes:
            cells = []
            for r in runs:
                x = r["results"][key][dt]
                cell = f"{x['ms']:.4f} / {x['run_ms']:.4f}"
                if x.get("dev_ms") is not None:
                    cell += f" / {x['dev_ms']:.4f}"
                cells.append(f"{cell} (err {x['err']:.3g})")
            print(f"  {key:17s} {dt:8s}  " + "  |  ".join(cells)
                  + f"  (bound {runs[0]['results'][key][dt]['bound_ms']:.4f})",
                  flush=True)
    if args.engines:
        print("engines: tok/s unprofiled / profiled, device ms "
              "(launches) of each listed kind under the profiler, device "
              "busy s")
        for label, _, spec_k, _, dtype, kinds in ENGINES:
            if label not in args.engine_labels:
                continue
            cells = []
            for r in runs:
                e = r["engines"][label]
                ks = ", ".join(
                    "{:.3f} ({})".format(
                        *e["profiled"]["kinds"].get(kind, (0.0, 0)))
                    for kind in kinds)
                cells.append(f"{e['tokens_per_s']:.1f} / "
                             f"{e['profiled']['tokens_per_s']:.1f}, {ks}, "
                             f"{e['profiled']['busy_s']:.4f}")
            print(f"  {label:21s} {dtype:8s} [spec {spec_k}: "
                  + ", ".join(k.split()[0] for k in kinds) + "] "
                  + "  |  ".join(cells), flush=True)
    if args.train:
        print("f32 training, GPT-2-small B 8 S 1024: step ms, tokens/s")
        print("  " + "  |  ".join(
            f"{r['train']['step_ms']:.1f}, {r['train']['tokens_per_s']:.1f}"
            for r in runs), flush=True)
        for r in runs:
            for line in r["train"].get("profile", ()):
                print(f"  [{r['tree']}] {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
