"""Perf hill-climbing harness (the JAX package's ``launch/hillclimb.py``):
dry-run named VARIANTS of an (arch x shape) pair on the production mesh,
appending records tagged with the variant name to results/hillclimb.jsonl.
Each variant is one config change; its record is ``dryrun.run_one``'s.

The profile store (``serving/profiling.ProfileStore``) keeps every fresh
'ok' record and replays it on a later run of the same (arch, shape, mesh,
variant): a warm start.  Its key carries ``backend=torch``, so a record the
JAX tool wrote into the same file is never replayed here.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --arch deepseek-67b --shape decode_32k --variant int8_cache

``--device cpu`` traces with fake CPU tensors on a host without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import traceback

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import run_one

DOC = __doc__

# the store key's tag of this package's records (the JAX tool's have none)
BACKEND = "torch"


def _spa(cfg, **kw):
    return dataclasses.replace(cfg, spa=dataclasses.replace(cfg.spa, **kw))


VARIANTS = {
    # paper-faithful reference points
    "baseline": lambda c: c,
    "paper_value_proxy": lambda c: _spa(c, identifier="value"),
    "paper_uniform_rho": lambda c: _spa(c, schedule="uniform"),
    # beyond-paper candidates
    "incremental_ident": lambda c: _spa(c, incremental_ident=True),
    "int8_cache": lambda c: dataclasses.replace(c, cache_dtype="int8"),
    "bf16_cache": lambda c: dataclasses.replace(c,
                                                cache_dtype="bfloat16"),
    "buckets_2": lambda c: _spa(c, n_buckets=2),
    "buckets_12": lambda c: _spa(c, n_buckets=12),
    "rank_64": lambda c: _spa(c, rank=64),
    "rank_256": lambda c: _spa(c, rank=256),
    "microbatch_1": lambda c: dataclasses.replace(c, microbatch=1),
    "microbatch_2": lambda c: dataclasses.replace(c, microbatch=2),
    "microbatch_4": lambda c: dataclasses.replace(c, microbatch=4),
    "microbatch_16": lambda c: dataclasses.replace(c, microbatch=16),
    "no_zero3": lambda c: dataclasses.replace(c, zero3=False),
    "zero3": lambda c: dataclasses.replace(c, zero3=True),
    "no_remat": lambda c: dataclasses.replace(c, remat=False),
    "replicated_weights": lambda c: dataclasses.replace(
        c, tp_weights=False),
    "bf16_grad_accum": lambda c: dataclasses.replace(
        c, accum_dtype="bfloat16"),
    "int8_cache_incremental": lambda c: dataclasses.replace(
        _spa(c, incremental_ident=True), cache_dtype="int8"),
    "mb4_unrolled": lambda c: dataclasses.replace(
        c, microbatch=4, accum_unroll=True),
    "mb8_unrolled": lambda c: dataclasses.replace(c, accum_unroll=True),
    "repl_weights_nohint": lambda c: dataclasses.replace(
        c, tp_weights=False),
}


def store_key(arch: str, shape: str, mesh: str, variant: str):
    return dict(kind="hillclimb", arch=arch, shape=shape, mesh=mesh,
                variant=variant, backend=BACKEND)


def main(argv=None):
    ap = argparse.ArgumentParser(description=DOC,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True,
                    help="|".join(VARIANTS))
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default="results/hillclimb.jsonl")
    ap.add_argument("--profile-store", default="auto",
                    help="variant profile store: an (arch, shape, mesh, "
                         "variant) hit short-circuits the re-search and "
                         "replays the persisted record; every fresh 'ok' "
                         "run is written back.  'auto' = the shared "
                         "BENCH_artifacts/kernel_profiles.json; '' = off")
    ap.add_argument("--device", default=None,
                    help="device type of the dry run's fake tensors "
                         "(default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from repro_torch.serving.profiling import ProfileStore
    store = None
    if args.profile_store:
        path = None if args.profile_store == "auto" else args.profile_store
        store = ProfileStore(path)
    key = store_key(args.arch, args.shape, args.mesh, args.variant)

    cached = store.get(**key) if store is not None else None
    if cached is not None and cached.get("status") == "ok":
        rec = {k: v for k, v in cached.items() if k != "key"}
        rec["warm_start"] = True
        print(f"[hillclimb] warm start: {args.variant} on "
              f"{args.arch}/{args.shape} from {store.path}")
    else:
        cfg = VARIANTS[args.variant](get_arch(args.arch))
        try:
            rec = run_one(args.arch, args.shape, args.mesh,
                          cfg_override=cfg, tag=args.variant, device=dev)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            rec = {"arch": args.arch, "shape": args.shape,
                   "mesh": args.mesh, "tag": args.variant,
                   "status": "error", "error": repr(e)[:500]}
        finally:
            mesh_lib.destroy_mesh()
        if store is not None and rec.get("status") == "ok":
            store.put(rec, **key)
            store.save()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return 0 if rec.get("status") == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
