"""End-to-end driver (twin of ``examples/train_lm.py``): train the
~130M-parameter mamba2-130m (full config, bf16) on synthetic data with
checkpointing, through ``repro_torch.launch.train``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \
        [--ckpt-dir DIR] [--device cpu]

The checkpoints go to ``--ckpt-dir`` (default ``mamba2_ckpt`` under the
temporary directory, ``TMPDIR``); a rerun resumes from the latest one.
"""
import os
import tempfile

from ..launch.train import main as train_main
from . import device_parser


def main(argv=None) -> dict:
    ap = device_parser(__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "mamba2_ckpt"))
    args = ap.parse_args(argv)
    losses = train_main([
        "--arch", "mamba2-130m",            # full config, not smoke
        "--steps", str(args.steps),
        "--batch", str(args.batch),
        "--seq", str(args.seq),
        "--lr", "1e-3",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "50",
        "--resume",
        "--device", args.device,
    ])
    return dict(arch="mamba2-130m", steps=args.steps, batch=args.batch,
                seq=args.seq, ckpt_dir=args.ckpt_dir, losses=losses)


if __name__ == "__main__":
    main()
