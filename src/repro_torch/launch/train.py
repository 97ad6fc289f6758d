"""Training launcher (the JAX package's ``launch/train.py`` on one device).

Trains a config on the synthetic Markov token stream (``data/synthetic``;
frames and cluster targets for an audio config, patches for a vision one)
with AdamW, on the card unless ``--device`` names another.  The reduced
config by default; ``--full-size`` takes the published widths and depth.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.data.synthetic import token_batches
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.trainer import batch_to_device, train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full-size", action="store_true",
                    help="the full config (its widths and depth)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=args.steps)
    params = transformer.init_params(cfg, 0, device=dev)
    opt = init_opt_state(params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    data = token_batches(cfg, args.batch, args.seq, seed=0)
    for i in range(args.steps):
        batch = batch_to_device(next(data), dev)
        t0 = time.time()
        params, opt, metrics = train_step(params, opt, batch, gen, cfg=cfg,
                                          opt_cfg=opt_cfg)
        loss = float(metrics["loss"])
        if i % 5 == 0:
            print(f"step {i:4d} loss {loss:.4f} "
                  f"({(time.time() - t0) * 1e3:.0f} ms)", flush=True)
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
