"""Train a reduced assigned-architecture config for a few hundred steps on
the synthetic data pipeline, with checkpointing — exercising the training
substrate end to end.

  PYTHONPATH=src python examples/train_tiny_torch.py [--arch mixtral_8x7b] [--device cuda]
"""
import argparse
import os
import tempfile

import torch

from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint
from repro_torch.train.data import TokenStream
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step

CKPT = os.path.join(tempfile.gettempdir(), "train_tiny_ck_torch.npz")


def run(arch="internlm2_1_8b", steps=200, device=None, weights=None, *,
        cfg=None, ckpt=CKPT, on_step=None):
    """Train ``steps`` AdamW steps of ``cfg`` (default: ``arch``'s smoke
    config), save a checkpoint at ``ckpt`` and restore it.  ``weights``,
    a numpy tree of the JAX package's layout, replaces the seeded draw;
    ``on_step(i, metrics)`` sees every step.  Returns the config, the
    loss of every step, the trained and restored trees and the restored
    step."""
    dev = resolve_device(device)
    cfg = cfg or get_config(arch, smoke=True)
    params = (T.init_params(cfg, torch.Generator(dev).manual_seed(0))
              if weights is None else params_from_numpy(weights, dev))
    opt = init_opt_state(params)
    # eager: the step updates params and moments in place
    step = make_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps))
    ds = iter(TokenStream(cfg, batch=8, seq_len=64))
    losses = []
    for i in range(1, steps + 1):
        b = next(ds)
        params, opt, m = step(params, opt, torch.from_numpy(b["inputs"]).to(dev),
                              torch.from_numpy(b["labels"]).to(dev))
        losses.append(float(m["loss"]))
        if on_step is not None:
            on_step(i, m)
    checkpoint.save(ckpt, params, opt, step=steps)
    p2, o2, s = checkpoint.load(ckpt, params, opt)
    return {"cfg": cfg, "losses": losses, "params": params, "opt": opt,
            "restored": (p2, o2), "restored_step": s}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=True)
    print(f"training reduced {cfg.name}: {cfg.num_layers}L d={cfg.d_model}")

    def report(i, m):
        if i % 25 == 0:
            print(f"step {i:4d} loss {float(m['loss']):.4f}")
    out = run(args.arch, args.steps, args.device, on_step=report)
    print(f"final loss {out['losses'][-1]:.4f} (from {out['losses'][0]:.4f}); "
          f"checkpoint round-trip ok at step {out['restored_step']}")


if __name__ == "__main__":
    main()
