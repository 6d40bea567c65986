"""Train an expert LM end to end on the synthetic token pipeline, then
checkpoint and reload it, as the reference's ``examples/train_expert.py``
does: a few hundred optimizer steps on a reduced llama-family expert
through the port's ``Trainer`` (2 microbatches), saved with
``save_pytree`` in the npz format both packages read. Runs on the card
unless ``--device cpu``. Without ``--ckpt`` the checkpoint goes to a
temporary directory, removed at the end.

  PYTHONPATH=src python -m repro_torch.examples.train_expert [--steps 200]
"""
from __future__ import annotations

import argparse
import tempfile
import time

import torch

from ..checkpoint import load_pytree, save_pytree
from ..configs import get_config
from ..data import synthetic_token_stream
from ..models import build_model
from ..train import Trainer
from ..tree import leaves


def main(argv=None) -> dict:
    """Returns {"history": [(step, loss)], "n_params", "ckpt", "params"
    (the trained tree, on the device), "first_leaf_shape",
    "round_trip_bit_equal"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced(
        n_layers=4, d_model=256, d_ff=512, vocab_size=1024)
    model = build_model(cfg)
    n_params = sum(t.numel() for t in leaves(model.param_shapes()))
    print(f"training {cfg.name} ({n_params/1e6:.1f}M params) "
          f"for {args.steps} steps")

    tr = Trainer(model, lr=3e-3, total_steps=args.steps, microbatches=2,
                 device=args.device)
    stream = synthetic_token_stream(cfg.vocab_size, args.seq, args.batch)
    t0 = time.time()
    hist = tr.fit(stream, steps=args.steps, log_every=25,
                  callback=lambda i, m: print(
                      f"  step {i:4d}  loss {float(m['loss']):.4f}  "
                      f"lr {float(m['lr']):.2e}"))
    print(f"done in {time.time()-t0:.1f}s; "
          f"loss {hist[0][1]:.3f} -> {hist[-1][1]:.3f}")

    params = tr.state["params"]
    with tempfile.TemporaryDirectory(prefix="expert-ckpt-") as tmp:
        ckpt = args.ckpt or tmp
        save_pytree(params, ckpt)
        restored = load_pytree(ckpt)
        same = all(torch.equal(a.cpu(), b)
                   for a, b in zip(leaves(params), leaves(restored)))
        k0 = leaves(restored)[0]
        print(f"checkpoint round-trip OK ({ckpt}, first leaf "
              f"{tuple(k0.shape)}, bit-equal {same})")
    if not same:
        raise AssertionError("checkpoint round trip changed a leaf")
    return {"history": hist, "n_params": n_params, "ckpt": args.ckpt,
            "params": params, "first_leaf_shape": tuple(k0.shape),
            "round_trip_bit_equal": same}


if __name__ == "__main__":
    main()
