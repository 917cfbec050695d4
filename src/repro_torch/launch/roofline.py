"""Roofline terms of every (arch x shape x mesh) pair on H100 terms (port
of ``repro/launch/roofline.py``).

Per pair, from one ``launch.dryrun`` count of the step on ``meta``:

    compute    = flops_per_device / peak bf16 FLOP/s
    memory     = bytes_per_device / HBM bandwidth
    collective = collective_bytes_per_device / NVLink bandwidth

with ``launch.mesh.HARDWARE`` (the H100 datasheet); the record names the
link its collective term assumes (``collective_link``).  The reference
counts a ``lax.scan`` body once and extrapolates from cost artifacts of one
and two pattern periods; the port runs every layer unrolled, so its count
is the whole step already (``tests/test_torch_dryrun.py`` holds that the
count at ``k`` periods is ``outer + k * per_period`` exactly).  As the
reference's, the count keeps remat, so recompute FLOPs are counted, and a
``microbatch`` step counts all its chunks.  Which fields are the
reference's own and which are port-side estimates: ``launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.roofline --mesh both --out results/roofline.jsonl
    PYTHONPATH=src python -m repro_torch.launch.roofline --out results/roofline_single.jsonl   # bench.run roofline_table
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional

from repro_torch.configs import SHAPES, list_archs
from repro_torch.launch.dryrun import count_pair, long_500k_eligible, prepare_config, record
from repro_torch.launch.mesh import HARDWARE, make_production_mesh
from repro_torch.models.config import flops_per_token
from repro_torch.sharding import specs as _specs

__all__ = ["analyze_pair", "main"]


def analyze_pair(
    arch: str,
    shape_name: str,
    mesh_kind: str = "single",
    *,
    retention: float = 1.0,
    variant: Optional[str] = None,
    seq_shard: bool = False,
    label: str = "baseline",
    opt_dtype: str = "float32",
    microbatch: int = 1,
    full_dp: bool = False,
) -> Dict[str, Any]:
    """The reference's record for one pair; ``full_dp`` sets
    ``sharding.specs.FULL_DP`` for the call."""
    was = _specs.FULL_DP
    _specs.FULL_DP = full_dp
    try:
        return _analyze(arch, shape_name, mesh_kind, retention, variant, seq_shard, label,
                        opt_dtype, microbatch, full_dp)
    finally:
        _specs.FULL_DP = was


def _analyze(arch, shape_name, mesh_kind, retention, variant, seq_shard, label, opt_dtype,
             microbatch, full_dp):
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    cfg = prepare_config(arch, shape_name, retention=retention, variant=variant,
                         seq_shard=seq_shard)
    if shape_name == "long_500k" and not long_500k_eligible(cfg, variant):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "label": label, "status": "skipped",
                "reason": "quadratic attention at 500k (DESIGN.md §5)"}
    t0 = time.perf_counter()
    count, args = count_pair(cfg, shape_name, mesh, opt_dtype=opt_dtype, microbatch=microbatch)
    rec = record(cfg, shape_name, mesh, count, args, microbatch=microbatch)
    n_dev = rec["devices"]
    flops_dev = rec["hlo_flops_per_device"]
    bytes_dev = rec["hlo_bytes_per_device"]
    coll_dev = rec["collectives"]["total"]

    hw = HARDWARE
    t_compute = flops_dev / hw["peak_flops_bf16"]
    t_memory = bytes_dev / hw["hbm_bandwidth"]
    t_coll = coll_dev / hw["nvlink_bandwidth"]
    dominant = max(
        (("compute", t_compute), ("memory", t_memory), ("collective", t_coll)),
        key=lambda kv: kv[1],
    )[0]

    shp = SHAPES[shape_name]
    if shp.kind == "train":
        tokens = shp.global_batch * shp.seq_len
        mf_tok = flops_per_token(cfg, shp.seq_len)           # 6N(+attn)
    elif shp.kind == "prefill":
        tokens = shp.global_batch * shp.seq_len
        mf_tok = flops_per_token(cfg, shp.seq_len) / 3.0     # fwd only: 2N
    else:  # decode: one token per sequence against a cache of seq_len
        tokens = shp.global_batch
        mf_tok = flops_per_token(cfg, shp.seq_len) / 3.0
    model_flops_dev = mf_tok * tokens / n_dev
    useful = model_flops_dev / flops_dev if flops_dev else float("nan")
    mem = rec["memory"]

    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "label": label,
        "status": "ok",
        "retention": retention,
        "variant": variant,
        "seq_shard": seq_shard,
        "opt_dtype": opt_dtype,
        "microbatch": microbatch,
        "full_dp": full_dp,
        "devices": n_dev,
        "params": rec["params"],
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "collective_schedule": {k: v for k, v in rec["collectives"].items()
                                if k not in ("count", "total") and v > 0},
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_device": model_flops_dev,
        "useful_flops_ratio": useful,
        "temp_bytes": mem["temp_bytes"],
        "arg_bytes": mem["argument_bytes"],
        "fits_hbm": (mem["temp_bytes"] + mem["argument_bytes"]) <= hw["hbm_bytes"],
        "compile_s": time.perf_counter() - t0,
        "hardware": hw["name"],
        "collective_link": rec["collective_link"],
        "exact_fields": ["params", "arg_bytes", "model_flops_per_device"],
        "estimated_fields": ["flops_per_device", "bytes_per_device",
                             "collective_bytes_per_device", "temp_bytes"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--retention", type=float, default=1.0)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--label", default="baseline")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    t0 = time.perf_counter()
    for mesh in meshes:
        for arch in archs:
            for shape in shapes:
                variant = "windowed" if (shape == "long_500k" and arch == "granite-moe-1b-a400m") else None
                try:
                    rec = analyze_pair(arch, shape, mesh, retention=args.retention,
                                       seq_shard=args.seq_shard, variant=variant,
                                       label=args.label)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh,
                           "label": args.label, "status": "FAILED",
                           "error": f"{type(e).__name__}: {e}"}
                if rec["status"] == "ok":
                    print(f"[roofline] {arch} x {shape} x {mesh}: dominant={rec['dominant']} "
                          f"tc={rec['t_compute_s']*1e3:.1f}ms tm={rec['t_memory_s']*1e3:.1f}ms "
                          f"tx={rec['t_collective_s']*1e3:.1f}ms useful={rec['useful_flops_ratio']:.2f} "
                          f"fits={rec['fits_hbm']}")
                else:
                    print(f"[roofline] {arch} x {shape} x {mesh}: {rec['status']} "
                          f"{rec.get('reason', rec.get('error', ''))[:100]}")
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    print(f"[roofline] done in {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
