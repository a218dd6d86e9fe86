#!/usr/bin/env python3
"""Time the port's attention kernels of one or more checkouts on one
NVIDIA card, each checkout in a process of its own, in the order given.

    python3 kernel_times.py [--trees DIR [DIR ...]] [--seed N]
                            [--dtypes float32 bfloat16] [--out FILE]

A tree is the root of a checkout holding ``hetu_tpu_torch`` (the
default is this one); an older commit is unpacked there with ``git
archive`` into a git-ignored directory, e.g.

    git archive <commit> | tar -x -C _archive/parent
    python3 kernel_times.py --trees _archive/parent . . _archive/parent

Every tree is driven by THIS checkout's ``chip_smoke.py`` phase-2
functions, so all meet the same shapes, checks and timing: K1 and K8
and their int8 twins (K1-int8, K8-int8: phase 2's K/V encoded by
``kv_encode``) at their mixed waves (Q 256 / 1024) and at the decode
(Q 1) and verify (Q 8) waves, K2 at the serving and the training shape,
K2-carry at the ring's block, K3's two kernels at the training shape.
Each result is held to its plain version as chip_smoke holds it (a tree
that predates ``ragged_rounding_bound`` gets this checkout's definition
of it) and reports the one-call CUDA-event median (``ms``), ten calls
back to back (``run_ms``) and, for K1, K8 and their int8 twins, the
kernels' device time per call under torch.profiler (``dev_ms``: a
narrow wave's two kernels, without the wrapper's host time, which sets
``run_ms`` once the kernels are faster than the host).  Each tree
builds its kernels into its own ``hetu_tpu_torch/_build``.  Order the
trees parent, change, change, parent to see the drift between runs.
Prints one JSON line per tree run (and writes them to ``--out``), then
a table of the times.
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


def worker(tree, seed, dtypes):
    """Time one tree's kernels; returns {kernel: {dtype: result}}."""
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
    _build.build_all()
    res = {}
    for dt in dtypes:
        for int8, wave in itertools.product((False, True),
                                            ("mixed", "decode", "verify")):
            q = "-int8" if int8 else ""
            res.setdefault(f"K1{q} {wave}", {})[dt] = cs.check_k1(
                torch, F, dt, seed, int8=int8, wave=wave)
            res.setdefault(f"K8{q} {wave}", {})[dt] = cs.check_k8(
                torch, F, dt, seed, int8=int8, wave=wave)
        res.setdefault("K2 serving", {})[dt] = cs.check_k2(torch, F, dt,
                                                           seed)
        k3 = cs.check_k3(torch, F, dt, seed)
        res.setdefault("K2 training", {})[dt] = k3["fwd"]
        res.setdefault("K3 dkv", {})[dt] = k3["dkv"]
        res.setdefault("K3 dq", {})[dt] = k3["dq"]
        res.setdefault("K2-carry", {})[dt] = cs.check_carry(torch, dt, seed)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        res = worker(args.worker, args.seed, args.dtypes)
        print(TAG + json.dumps({"tree": args.worker, "results": res}),
              flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    runs = []
    for tree in args.trees:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", tree,
             "--seed", str(args.seed), "--dtypes", *args.dtypes],
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
    print(f"one call / ten back to back [/ device], ms, on {card}; trees "
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
                cells.append(cell)
            print(f"  {key:17s} {dt:8s}  " + "  |  ".join(cells)
                  + f"  (bound {runs[0]['results'][key][dt]['bound_ms']:.4f})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
