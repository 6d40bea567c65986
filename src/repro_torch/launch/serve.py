"""Serving launcher: an ExpertMatcher-routed fleet (Fig. 2 of the paper),
the counterpart of the reference's ``repro.launch.serve``.

Trains the AE bank on the 6 synthetic benchmark datasets, registers one
expert engine per dataset and serves batches of mixed-modality requests,
on the card unless ``--device cpu``. Expert i runs ``ALL_ARCHS[i % 10]``
reduced (random seeded weights); the encoder-decoder and VLM slots take
a reduced llama instead (the demo's requests carry tokens only), and
``--kv paged`` falls back to the ring layout for families without the
paged protocol (RWKV6, Zamba2).

With ``--hub-slots K`` (K > 0) the experts, one reduced llama per
dataset, are served through an ``ExpertHub`` holding only K device
slots: each expert is checkpointed cold to ``--store`` (or a temporary
directory, removed at the end), staged on demand and evicted by
popularity-weighted LRU; the launcher prints the hub's lifecycle ledger
after serving.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 32
  PYTHONPATH=src python -m repro_torch.launch.serve --hub-slots 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --requests 6 --n-per-dataset 64 --epochs 1 --max-new 2
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from ..configs import ALL_ARCHS, get_config
from ..core import ExpertRegistry, build_matcher, train_bank
from ..data import load_benchmark
from ..device import resolve_device
from ..models import build_model
from ..obs import Tracer
from ..serve import ExpertEngine, ExpertHub, Request, RoutedServer

#: families the token-only demo swaps for a reduced llama
TOKEN_ONLY_SWAP = ("encdec", "vlm")


def expert_config(i: int, name: str):
    """The reduced config expert ``i`` (dataset ``name``) runs on the
    per-engine path: ``ALL_ARCHS[i % len(ALL_ARCHS)]``, or a reduced
    llama for an encoder-decoder or VLM slot."""
    arch = ALL_ARCHS[i % len(ALL_ARCHS)]
    cfg = get_config(arch).reduced(name=f"{arch}@{name}")
    if cfg.family in TOKEN_ONLY_SWAP:
        cfg = get_config("llama3_2_1b").reduced(name=f"llama@{name}")
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--n-per-dataset", type=int, default=2000)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--executor", choices=("serial", "overlapped"),
                    default="overlapped",
                    help="dispatch executor: 'overlapped' enqueues every "
                         "shard's prefill/decode before blocking; "
                         "'serial' is the blocking reference")
    ap.add_argument("--kv", choices=("ring", "paged"), default="ring",
                    help="KV cache layout: 'paged' pools fixed-size "
                         "pages per shard and shares prompt-prefix "
                         "pages between requests (dense-family experts "
                         "only; others keep the ring layout)")
    ap.add_argument("--hub-slots", type=int, default=0,
                    help="serve through an ExpertHub with this many "
                         "device slots (0 = every expert resident, the "
                         "per-engine path); experts are checkpointed "
                         "cold and staged on demand")
    ap.add_argument("--store", default=None,
                    help="expert checkpoint store dir for --hub-slots "
                         "(default: a temporary directory)")
    ap.add_argument("--trace", metavar="OUT", default=None,
                    help="record request-lifecycle spans while serving "
                         "and write a Chrome trace_event JSON to OUT, "
                         "plus a greppable JSONL sibling at OUT + 'l'")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.time()
    bench = load_benchmark(n_per_dataset=args.n_per_dataset)
    names = list(bench)
    aes, _ = train_bank([(n, bench[n]["server"][0]) for n in names],
                        epochs=args.epochs, batch_size=64, device=dev)
    cents = [(bench[n]["server"][0], bench[n]["server"][1]) for n in names]
    matcher = build_matcher(aes, names, cents, device=dev)
    print(f"[{time.time()-t0:.1f}s] matcher ready ({len(names)} experts)")

    with tempfile.TemporaryDirectory(prefix="expert-store-") as tmp:
        hub = None
        archs = {}
        if args.hub_slots > 0:
            # the hub's slot bank needs one architecture (equal
            # ExpertSpec = slot compatibility); each expert is
            # checkpointed cold, so staging runs the whole lifecycle
            cfg = get_config("llama3_2_1b").reduced(name="llama-hub")
            model = build_model(cfg)
            kv = args.kv if model.supports_paged_kv else "ring"
            store = args.store or tmp
            hub = ExpertHub(model, n_slots=args.hub_slots, max_len=64,
                            kv_layout=kv, store=store, device=dev)
            for i, n in enumerate(names):
                hub.add_expert(n, model.init(i, device=dev), cold=True)
                archs[n] = cfg.name
            registry = hub.build_registry()
            print(f"[{time.time()-t0:.1f}s] hub: {len(registry)} experts "
                  f"checkpointed to {store}, {args.hub_slots} device slots")
        else:
            registry = ExpertRegistry()
            for i, n in enumerate(names):
                cfg = expert_config(i, n)
                model = build_model(cfg)
                kv = args.kv if model.supports_paged_kv else "ring"
                registry.add(n, ExpertEngine(
                    model, model.init(i, device=dev), max_len=64,
                    kv_layout=kv, device=dev), arch=cfg.name)
                archs[n] = cfg.name
        tracer = Tracer() if args.trace else None
        with RoutedServer(matcher, registry, executor=args.executor,
                          hub=hub, tracer=tracer, device=dev) as server:
            rng = np.random.default_rng(0)
            reqs, truth = [], []
            for uid in range(args.requests):
                n = names[rng.integers(len(names))]
                x, _ = bench[n]["client_a"]
                reqs.append(Request(uid=uid,
                                    features=x[rng.integers(len(x))],
                                    prompt=rng.integers(0, 100, size=8),
                                    max_new_tokens=args.max_new))
                truth.append(n)
            t1 = time.time()
            resps = server.serve(reqs)
            dt = time.time() - t1
            acc = float(np.mean([r.expert == t
                                 for r, t in zip(resps, truth)]))
            print(f"served {len(resps)} reqs in {dt:.2f}s "
                  f"({len(resps)/dt:.1f} req/s); routing accuracy "
                  f"{acc:.1%}")
            st = server.stats
            blocks = sum(es.host_blocks
                         for es in {**st["engines"], **st["banks"]}.values())
            print(f"executor={args.executor}: {blocks} host-blocking syncs "
                  f"across all engines")
            if hub is not None:
                print(f"hub: {hub.stats!r}")
                print(f"resident now: "
                      f"{[hub.catalog[e].name for e in hub.resident_experts]}"
                      f" ({server.scheduler.stats.resident_stalls} "
                      "resident-miss stalls)")
    if tracer is not None:
        n_events = tracer.export_chrome(args.trace)
        tracer.export_jsonl(args.trace + "l")
        print(f"trace: {n_events} events -> {args.trace} "
              f"(+ {args.trace}l)")
    return {"responses": resps, "accuracy": acc, "archs": archs,
            "host_blocks": blocks, "seconds": dt}


if __name__ == "__main__":
    main()
