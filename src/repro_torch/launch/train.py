"""Training launcher: a REDUCED variant of ``--arch`` unless ``--full``,
trained with real optimizer steps on ``synthetic_token_stream`` batches,
on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --steps 100 [--full] [--seq 128 --batch 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from ..configs import get_config
from ..data import synthetic_token_stream
from ..models import build_model
from ..train import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="use the full config (published widths)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg)
    print(f"arch={cfg.name} family={cfg.family} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} device={args.device}")

    tr = Trainer(model, lr=args.lr, total_steps=args.steps,
                 device=args.device)
    stream = synthetic_token_stream(cfg.vocab_size, args.seq, args.batch)
    t0 = time.time()
    tr.fit(stream, steps=args.steps, log_every=args.log_every,
           callback=lambda i, m: print(
               f"step {i:5d}  loss {float(m['loss']):.4f}  "
               f"lr {float(m['lr']):.2e}  {time.time()-t0:.1f}s"))
    print(f"final loss: {tr.history[-1][1]:.4f}")
    return tr.history


if __name__ == "__main__":
    main()
