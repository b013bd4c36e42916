"""Training launcher (``repro.launch.train``, flag for flag, plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \
        --reduced --steps 200 --batch 8 --seq 128

trains on the card (``--device cuda``, the default); ``--device cpu`` trains
on the host.  Weights are drawn in torch from ``--seed`` on that device, so
they (and the losses) differ from the reference's, which draws them from
JAX's PRNG; the token batches are the reference's for the same seed.

``--dry-run`` traces the ``--shape`` step on the production mesh (16 x 16,
or 2 x 16 x 16 with ``--multi-pod``) over the fake process group, without a
card, and writes its record to ``results/dryrun`` (``launch/dryrun.py``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-34b --shape train_4k --dry-run
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    if args.dry_run:
        from repro_torch.launch.dryrun import run_one

        return run_one(args.arch, args.shape, args.multi_pod, "results/dryrun")

    from repro_torch.configs import get_config
    from repro_torch.training.train_loop import train

    name = args.arch + ("-reduced" if args.reduced else "")
    cfg = get_config(name)
    res = train(
        cfg,
        steps=args.steps,
        batch_size=args.batch,
        seq_len=args.seq,
        seed=args.seed,
        ckpt_dir=args.ckpt_dir,
        device=args.device,
    )
    print(
        f"done: loss {res['first_loss']:.4f} → {res['final_loss']:.4f} "
        f"in {res['wall_s']:.1f}s"
    )
    return res


if __name__ == "__main__":
    main()
