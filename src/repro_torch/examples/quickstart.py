"""Quickstart: the paper's pipeline on the port.

Trains an autoencoder bank on three synthetic dataset analogues, builds
an ExpertMatcher, and routes held-out client samples (coarse + fine), as
the reference's ``examples/quickstart.py`` does. Runs on the card unless
``--device cpu``; ``--n-per-dataset`` and ``--epochs`` default to the
reference's constants. ``main(aes=...)`` routes with a given bank (as
``train_bank`` returns it) in place of training one.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import MatcherConfig, build_matcher, train_bank
from ..data import load_benchmark
from ..device import resolve_device


def main(argv=None, *, aes=None) -> dict:
    """Returns {"names", "coarse_accuracy": {client: [per dataset]},
    "coarse": {client: [predictions per dataset]}, "mixed_experts",
    "mixed_fine"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-per-dataset", type=int, default=1200)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("generating synthetic benchmark (mnist/har/reuters analogues)...")
    bench = load_benchmark(names=["mnist", "har", "reuters"],
                           n_per_dataset=args.n_per_dataset, seed=0)
    names = list(bench)

    if aes is None:
        print("training one AE per dataset (paper recipe: Adam 1e-2, step "
              "decay)")
        aes, _ = train_bank([(n, bench[n]["server"][0]) for n in names],
                            epochs=args.epochs, batch_size=128, device=dev)

    cents = [(bench[n]["server"][0], bench[n]["server"][1]) for n in names]
    matcher = build_matcher(aes, names, cents,
                            config=MatcherConfig(top_k=2), device=dev)

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    accuracy, coarse = {}, {}
    for client in ("client_a", "client_b"):
        accs, preds = [], []
        for i, n in enumerate(names):
            x, _ = bench[n][client]
            pred = matcher.assign_coarse(on_dev(x)).cpu().numpy()
            accs.append(float((pred == i).mean()))
            preds.append(pred.tolist())
        accuracy[client], coarse[client] = accs, preds
        print(f"{client}: coarse assignment accuracy per dataset "
              f"{[f'{a:.1%}' for a in accs]} (paper: ~99%)")

    # hierarchical route of a mixed batch
    x = np.concatenate([bench[n]["client_a"][0][:4] for n in names])
    routed = matcher.route(on_dev(x))
    experts = [names[i] for i in routed["coarse"][:, 0].cpu().numpy()]
    fine = routed["fine"].cpu().numpy().tolist()
    print("mixed batch -> experts:", experts)
    print("fine classes:", fine)
    return {"names": names, "coarse_accuracy": accuracy, "coarse": coarse,
            "mixed_experts": experts, "mixed_fine": fine}


if __name__ == "__main__":
    main()
