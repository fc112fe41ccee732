"""End-to-end training driver with checkpoint/restart (port of
``repro.launch.train``).

Trains a smoke config (f32) or a full config (bf16) on the synthetic
pipeline, one device.  Fault tolerance: step-atomic checkpoints every
``--ckpt-every`` steps; ``--resume`` picks up the latest one (the data
pipeline is stateless-indexed, so the token stream continues exactly).
The lr schedule depends on ``--steps``, so a resumed run continues the
same run only with the same ``--steps``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --smoke --steps 50 --batch 8 --seq 64 --ckpt-dir CKPT --resume \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ckpt.checkpoint import (latest_checkpoint, load_checkpoint,
                               save_checkpoint)
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..data.pipeline import DataConfig, sample_batch, sample_embedding_batch
from ..kernels.config import resolve_device
from ..models import init_params
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.step import train_step


def main(argv=None) -> list[float]:
    """Train; returns the loss of every step this call ran."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda or cpu; default cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dtype = torch.float32 if args.smoke else torch.bfloat16
    model = init_params(cfg, args.seed, device=dev, dtype=dtype)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20))
    opt_state = init_opt_state(model)
    start_step = 0

    if args.resume and args.ckpt_dir:
        ck = latest_checkpoint(args.ckpt_dir)
        if ck:
            (params, opt_state), start_step = load_checkpoint(
                ck, (model.state_dict(), opt_state), device=dev)
            model.load_state_dict(params)
            print(f"resumed from {ck} at step {start_step}")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        if cfg.takes_embeddings:
            batch = sample_embedding_batch(dcfg, step, cfg.d_model)
        else:
            batch = sample_batch(dcfg, step)
        opt_state, metrics = train_step(
            model, opt_state, batch, cfg=cfg, opt_cfg=opt_cfg,
            microbatches=args.microbatches, device=dev)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({time.time() - t0:.1f}s)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            f = save_checkpoint(args.ckpt_dir,
                                (model.state_dict(), opt_state), step + 1)
            print(f"checkpoint -> {f}")

    print(f"final loss {np.mean(losses[-5:]):.4f} "
          f"(first {np.mean(losses[:5]):.4f})")
    return losses


if __name__ == "__main__":
    main()
