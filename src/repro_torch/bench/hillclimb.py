"""Roofline hillclimbing on the three chosen pairs (port of
``benchmarks/hillclimb.py``): each variant is one ``analyze_pair`` record,
on H100 terms (``launch.roofline``).

  1. llama4-maverick-400b-a17b x train_4k   (does not fit; worst MoE pair)
  2. xlstm-1.3b x train_4k                  (the collective-bound train pair)
  3. internlm2-1.8b x train_4k              (representative; + the paper's own
     technique: retention sweep = NetworkReconfigure at production scale)

Run: PYTHONPATH=src python -m repro_torch.bench.hillclimb [--pair N] [--out f.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.roofline import analyze_pair

__all__ = ["PAIRS", "run", "main"]


def run(recs, out):
    for kw in recs:
        try:
            rec = analyze_pair(**kw)
        except Exception as e:
            rec = {**kw, "status": "FAILED", "error": f"{type(e).__name__}: {e}"}
        if rec["status"] == "ok":
            print(
                f"[hillclimb] {rec['arch']} x {rec['shape']} [{rec['label']}]: "
                f"dom={rec['dominant']} tc={rec['t_compute_s']:.2f}s "
                f"tm={rec['t_memory_s']:.2f}s tx={rec['t_collective_s']:.2f}s "
                f"temp={rec['temp_bytes']/2**30:.1f}GiB args={rec['arg_bytes']/2**30:.1f}GiB "
                f"fits={rec['fits_hbm']} useful={rec['useful_flops_ratio']:.2f}"
            )
        else:
            print(f"[hillclimb] {kw.get('arch')} [{kw.get('label')}]: {rec['status']} {rec.get('error','')[:120]}")
        if out:
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")


PAIRS = {
    1: [  # llama4 train_4k: memory-dominated, does not fit
        dict(arch="llama4-maverick-400b-a17b", shape_name="train_4k", label="ll4-1-seqshard", seq_shard=True),
        dict(arch="llama4-maverick-400b-a17b", shape_name="train_4k", label="ll4-2-seqshard+bf16opt", seq_shard=True, opt_dtype="bfloat16"),
        dict(arch="llama4-maverick-400b-a17b", shape_name="train_4k", label="ll4-3-seqshard+bf16opt+mb4", seq_shard=True, opt_dtype="bfloat16", microbatch=4),
        dict(arch="llama4-maverick-400b-a17b", shape_name="train_4k", label="ll4-4-seqshard+bf16opt+mb16", seq_shard=True, opt_dtype="bfloat16", microbatch=16),
    ],
    2: [  # xlstm train_4k: collective-dominated
        dict(arch="xlstm-1.3b", shape_name="train_4k", label="xl-1-seqshard", seq_shard=True),
        dict(arch="xlstm-1.3b", shape_name="train_4k", label="xl-2-seqshard+mb2", seq_shard=True, microbatch=2),
        dict(arch="xlstm-1.3b", shape_name="train_4k", label="xl-3-fulldp", full_dp=True),
        dict(arch="xlstm-1.3b", shape_name="train_4k", label="xl-4-fulldp+mb2", full_dp=True, microbatch=2),
    ],
    3: [  # internlm2 train_4k: representative + the paper's technique
        dict(arch="internlm2-1.8b", shape_name="train_4k", label="il2-1-seqshard", seq_shard=True),
        dict(arch="internlm2-1.8b", shape_name="train_4k", label="il2-2-seqshard+mb2", seq_shard=True, microbatch=2),
        # paper-faithful: reconfigured sub-models (AdaptCL NetworkReconfigure)
        dict(arch="internlm2-1.8b", shape_name="train_4k", label="il2-paper-gamma0.6", retention=0.6),
        dict(arch="internlm2-1.8b", shape_name="train_4k", label="il2-paper-gamma0.3", retention=0.3),
    ],
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", type=int, default=None)
    ap.add_argument("--out", default="results/hillclimb.jsonl")
    args = ap.parse_args(argv)
    pairs = [args.pair] if args.pair else sorted(PAIRS)
    for p in pairs:
        run(PAIRS[p], args.out)


if __name__ == "__main__":
    main()
