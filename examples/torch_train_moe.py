"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-parameter
DeepSeek-style MoE for a few hundred steps (``examples/train_moe.py`` on
``repro_torch``): synthetic structured data, the full substrate — pipeline →
model → optimizer → checkpointing.

Run:  PYTHONPATH=src python examples/torch_train_moe.py [--steps 300] [--device cpu]
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import train


def make_100m_config():
    """~100M-param MoE in the dsv2 family (8 experts, top-2, 4 layers)."""
    base = get_config("dsv2-lite")
    return dataclasses.replace(
        base,
        name="dsv2-100m",
        num_layers=4,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        vocab_size=32_000,
        num_experts=8,
        num_shared_experts=1,
        top_k=2,
        d_ff_expert=1024,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=100, help="learning-rate warmup steps (the reference's 100)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt_100m"),
                    help="checkpoint directory ('' saves none)")
    ap.add_argument("--device", default="cuda", help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    cfg = make_100m_config()
    print(f"training {cfg.name}: {cfg.total_params()/1e6:.0f}M params "
          f"({cfg.expert_param_fraction()*100:.0f}% in experts), "
          f"{args.steps} steps × {args.batch}×{args.seq} tokens")
    res = train(
        cfg,
        steps=args.steps,
        batch_size=args.batch,
        seq_len=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=max(50, args.steps // 4),
        log_every=10,
        opt_cfg=AdamWConfig(total_steps=args.steps, warmup_steps=args.warmup),
        device=args.device,
    )
    print(f"loss {res['first_loss']:.3f} → {res['final_loss']:.3f} "
          f"({res['wall_s']:.0f}s, {args.steps*args.batch*args.seq/res['wall_s']:.0f} tok/s)")
    assert res["final_loss"] < res["first_loss"], "training failed to reduce loss"
    return res


if __name__ == "__main__":
    main()
