"""Training launcher: train any assigned architecture (its smoke variant
unless ``--full-config``) on the synthetic pipeline, with checkpointing.
Runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \
      --steps 200 --batch 8 --seq 64 --ckpt out/ck.npz

Weights are drawn from a seeded ``torch.Generator`` on the device; the
per-step lines are the JAX launcher's.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint
from repro_torch.train.data import TokenStream
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-smoke) config — production only")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full_config)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    opt = init_opt_state(params)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(1, args.steps // 20),
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg)
    ds = iter(TokenStream(cfg, args.batch, args.seq))

    t0 = time.perf_counter()
    for i in range(1, args.steps + 1):
        b = next(ds)
        params, opt, m = step_fn(params, opt, torch.from_numpy(b["inputs"]).to(device),
                                 torch.from_numpy(b["labels"]).to(device))
        if i % 10 == 0 or i == 1:
            print(f"step {i:5d}  loss {float(m['loss']):.4f}  "
                  f"ce {float(m['ce']):.4f}  gnorm {float(m['grad_norm']):.3f}"
                  f"  lr {float(m['lr']):.2e}  "
                  f"({i/(time.perf_counter()-t0):.2f} it/s)")
        if args.ckpt and i % args.ckpt_every == 0:
            checkpoint.save(args.ckpt, params, opt, step=i)
            print(f"checkpointed -> {args.ckpt}")
    if args.ckpt:
        checkpoint.save(args.ckpt, params, opt, step=args.steps)


if __name__ == "__main__":
    main()
