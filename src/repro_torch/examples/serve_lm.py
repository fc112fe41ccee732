"""Batched serving demo (twin of ``examples/serve_lm.py``): prefill a batch
of prompts token-parallel, then greedy-decode continuations with
ring-buffer / recurrent caches.

Runs the arch's smoke config in f32, weights drawn from seed 0 on the
device; the prompt comes from ``numpy.random.default_rng(1)`` (the
reference draws both with ``jax.random``, which torch cannot replay).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \
        --arch mixtral-8x22b [--device cpu]
"""
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_smoke_config
from ..kernels.config import resolve_device
from ..models import init_params
from ..serve.step import greedy_generate, prefill
from . import device_parser


def main(argv=None) -> dict:
    ap = device_parser(__doc__)
    ap.add_argument("--arch", default="mixtral-8x22b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=24)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    params = init_params(cfg, 0, device=device, dtype=torch.float32)
    rng = np.random.default_rng(1)
    max_len = args.prompt_len + args.new_tokens
    out = dict(arch=cfg.name, batch=args.batch, prompt_len=args.prompt_len,
               new_tokens=args.new_tokens, device=str(device))
    if cfg.takes_embeddings:
        prompt = torch.tensor(rng.normal(
            size=(args.batch, args.prompt_len, cfg.d_model)) * 0.3,
            dtype=torch.float32)
        print("frontend-stub arch: prompt = precomputed embeddings")
        _, logits = prefill(params, cfg, prompt, max_len=max_len,
                            cache_dtype=torch.float32, device=device)
        print(f"prefill logits: {tuple(logits.shape)}; decode loop skipped "
              f"for stub frontends (needs a tokenizer round-trip)")
        return dict(out, logits_shape=tuple(logits.shape), tokens=None)

    prompt = torch.tensor(rng.integers(0, cfg.vocab,
                                       size=(args.batch, args.prompt_len)))
    t0 = time.perf_counter()
    toks = greedy_generate(params, cfg, prompt, args.new_tokens,
                           max_len=max_len, cache_dtype=torch.float32,
                           device=device).cpu().numpy()
    dt = time.perf_counter() - t0        # .cpu() waited for the device
    tok_per_s = args.batch * args.new_tokens / dt
    print(f"arch={cfg.name}  batch={args.batch}  "
          f"prompt={args.prompt_len}  new={args.new_tokens}")
    print(f"generated token ids:\n{toks}")
    print(f"{tok_per_s:.1f} tok/s ({device}, smoke config)")
    return dict(out, tokens=toks, tok_per_s=tok_per_s)


if __name__ == "__main__":
    main()
