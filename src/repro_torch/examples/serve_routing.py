"""End-to-end serving example (the paper's deployment scenario, Fig. 2),
the reference's ``examples/serve_routing.py`` on the port.

Builds the full 6-dataset ExpertMatcher, registers three *different*
zoo architectures as expert backends (dense llama, attention-free RWKV6,
MoE mixtral, reduced variants with random seeded weights) and serves
batched client requests: featurize -> coarse route -> fine route ->
per-expert batched generation. Coarse scores go through the
``expert_score`` kernel (``MatcherConfig(use_kernel=True)``) and fine
classes through ``cosine_fine``; the llama experts decode through
``decode_attention`` and the RWKV6 ones through ``wkv_step`` (their
plain versions on the CPU).

``--banked`` banks each bankable architecture's two experts into one
``BankedEngine`` (``plan_placement``), sharded over a mesh ``expert``
axis (``make_expert_mesh``: every visible card) when more than one card
is visible; capacity-dispatch MoE experts (mixtral) stay singleton
shards because their outputs depend on batch padding.

``--executor`` picks the dispatch executor: ``overlapped`` (default)
enqueues every shard's prefill and decode tick before blocking on
anything; ``serial`` is the blocking per-tick reference. Both give
identical tokens; the run prints the host-sync counter.

``--hub`` serves the experts (one reduced llama per dataset) through an
``ExpertHub`` with only ``--resident`` device slots: a request landing
on a non-resident expert parks while the hub commits its weights into a
slot; the demo walks one such cold-start request through park -> load
-> serve and prints the ``HubStats`` ledger.

``--long-prompt`` instead drives whale prompts through the chunked
suffix-prefill path (``paged_decode_attention`` on the card): cohorts
of long prompts share a 32-token head, the chunked server adopts the
cached head pages and computes only the uncached suffix chunks, and the
run prints the prefill tokens saved against a storage-only paged
baseline serving the identical stream.

Runs on the card unless ``--device cpu``. ``--n-per-dataset`` and
``--epochs`` default to the reference's constants (2000, 40).
``main(aes=..., init_expert=...)`` serves with a given AE bank (as
``train_bank`` returns it) and expert weights (``init_expert(model, i)``
for the i-th dataset's expert) in place of training and drawing them.

  PYTHONPATH=src python -m repro_torch.examples.serve_routing \\
      [--requests 48] [--banked] [--executor {serial,overlapped}] \\
      [--hub --resident 2] [--long-prompt] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config
from ..core import (ExpertRegistry, MatcherConfig, build_matcher,
                    train_bank)
from ..data import load_benchmark
from ..device import resolve_device
from ..launch.mesh import make_expert_mesh
from ..models import build_model
from ..serve import (ExpertEngine, ExpertHub, Request, RoutedServer,
                     plan_placement)


def _engine_counters(stats) -> dict:
    return {name: {"prefill_calls": es.prefill_calls,
                   "decode_steps": es.decode_steps,
                   "jit_cache_entries": es.jit_cache_entries,
                   "host_blocks": es.host_blocks}
            for name, es in {**stats["engines"], **stats["banks"]}.items()}


def hub_cold_start_demo(server, hub, bench, names, t0):
    """Walk one request to a *non-resident* expert through the full
    lifecycle: park (NotResident backpressure) -> commit (host -> device
    slot) -> serve. Returns {"expert", "states": [(step, state)] with
    step 0 the state before the request, "misses", "loads", "served_by",
    "tokens"}, or None when every expert is resident."""
    sched = server.scheduler
    cold = [e for e in range(len(names)) if hub.slot_of(e) is None]
    if not cold:
        print("    (every expert is resident; raise the expert count "
              "or lower --resident to see a cold start)")
        return None
    # a cold expert AND a client feature the matcher really routes to it
    # (a misroute would demo another expert's path)
    e, feat = cold[0], None
    for cand_e in cold:
        x, _ = bench[names[cand_e]]["client_a"]
        for cand in x[:32]:
            if int(server.router.route(cand[None]).coarse[0, 0]) == cand_e:
                e, feat = cand_e, cand
                break
        if feat is not None:
            break
    if feat is None:
        x, _ = bench[names[e]]["client_a"]
        feat = x[0]
    name = hub.catalog[e].name
    print(f"[{time.time()-t0:5.1f}s] cold-start demo: expert {name!r} "
          f"is {hub.catalog[e].state} (resident: "
          f"{[hub.catalog[r].name for r in hub.resident_experts]})")
    misses0, loads0 = hub.catalog[e].misses, hub.stats.loads
    server.submit([Request(uid=999_000, features=feat,
                           prompt=np.arange(12, dtype=np.int32),
                           max_new_tokens=6)])
    resp, step, seen = None, 0, [(0, hub.catalog[e].state)]
    while resp is None:
        got = server.step()
        step += 1
        state = hub.catalog[e].state
        if seen[-1][1] != state:
            seen.append((step, state))
        for r in got:
            if r.uid == 999_000:
                resp = r
    for step_no, state in seen:
        print(f"    step {step_no}: {name!r} {state}")
    stalls = sched.stats.resident_stalls
    print(f"[{time.time()-t0:5.1f}s] served by {resp.expert!r} after "
          f"{step} steps ({stalls} resident-miss stalls so far); "
          f"tokens {resp.tokens.tolist()}")
    print(f"    {hub.stats!r}")
    return {"expert": name, "states": seen,
            "misses": hub.catalog[e].misses - misses0,
            "loads": hub.stats.loads - loads0, "served_by": resp.expert,
            "tokens": resp.tokens.tolist()}


def make_requests(bench, names, n_requests):
    """The served stream: request ``uid`` draws a dataset, one of its
    client_a rows and a 4-23 token prompt from ``default_rng(0)``.
    Returns (requests, truth), truth[uid] the dataset drawn."""
    rng = np.random.default_rng(0)
    reqs, truth = [], []
    for uid in range(n_requests):
        n = names[rng.integers(len(names))]
        x, _ = bench[n]["client_a"]
        reqs.append(Request(
            uid=uid, features=x[rng.integers(len(x))],
            prompt=rng.integers(0, 200, size=int(rng.integers(4, 24))),
            max_new_tokens=8))
        truth.append(n)
    return reqs, truth


def long_prompt_demo(matcher, bench, names, t0, dev, init_expert,
                     n_requests=36):
    """Whale prompts through the chunked suffix-prefill path: two
    cohorts of long prompts share a 32-token head, so after a priming
    wave the chunked server adopts the cached head pages and computes
    only the uncached suffix chunk of each whale, while the storage-only
    paged baseline recomputes every whale in full. Returns {label:
    {"computed", "submitted", "tokens": {uid: tokens}}}."""
    cfg = get_config("llama3.2-1b").reduced(name="lp-expert")
    model = build_model(cfg)
    params = {n: init_expert(model, i) for i, n in enumerate(names)}

    def make_server(chunked):
        registry = ExpertRegistry()
        for n in names:
            registry.add(n, ExpertEngine(
                model, params[n], max_len=128, kv_layout="paged",
                chunk_len=32 if chunked else None, device=dev))
        return RoutedServer(matcher, registry, max_batch=8,
                            prefill_tokens_per_step=32 if chunked else 0,
                            device=dev)

    rng = np.random.default_rng(7)
    cohorts = names[::3]  # two whale cohorts, one shared head each
    heads = {n: rng.integers(0, 200, size=32) for n in cohorts}

    def whale(uid, n):
        x, _ = bench[n]["client_a"]
        tail = rng.integers(0, 200, size=int(rng.integers(20, 29)))
        return Request(uid=uid, features=x[int(rng.integers(len(x)))],
                       prompt=np.concatenate([heads[n], tail]),
                       max_new_tokens=6)

    def short(uid):
        n = names[int(rng.integers(len(names)))]
        x, _ = bench[n]["client_a"]
        return Request(uid=uid, features=x[int(rng.integers(len(x)))],
                       prompt=rng.integers(0, 200,
                                           size=int(rng.integers(4, 20))),
                       max_new_tokens=6)

    prime = [whale(900 + i, n) for i, n in enumerate(cohorts)]
    stream = [whale(uid, cohorts[(uid // 3) % len(cohorts)])
              if uid % 3 == 0 else short(uid)
              for uid in range(n_requests)]
    n_whales = sum(1 for r in stream if len(r.prompt) > 32)
    print(f"[{time.time()-t0:5.1f}s] long-prompt demo: "
          f"{len(prime)} priming whales, then {len(stream)} requests "
          f"({n_whales} cohort whales interleaved with short traffic)")

    results = {}
    for label, chunked in (("chunked+suffix", True), ("storage-only", False)):
        with make_server(chunked) as srv:
            toks = {}
            for wave in (prime, stream):
                for r in srv.serve(list(wave)):
                    toks[r.uid] = r.tokens.tolist()
            es = list(srv.stats["engines"].values())
        computed = sum(e.prefill_tokens_computed for e in es)
        submitted = sum(e.prefill_tokens_submitted for e in es)
        results[label] = {"computed": computed, "submitted": submitted,
                          "tokens": toks}
        print(f"[{time.time()-t0:5.1f}s] {label:>14}: computed {computed} "
              f"prompt tokens ({submitted} submitted before padding)")
    c1, c0 = (results[k]["computed"]
              for k in ("chunked+suffix", "storage-only"))
    if results["chunked+suffix"]["tokens"] != \
            results["storage-only"]["tokens"]:
        raise AssertionError("token divergence between chunked and "
                             "storage-only")
    print(f"    suffix prefill over cached cohort heads computed "
          f"{c0 - c1} fewer prompt tokens ({1 - c1 / max(c0, 1):.0%} less "
          f"than storage-only paged); tokens identical across both servers")
    return results


def main(argv=None, *, aes=None, init_expert=None) -> dict:
    """Returns {"names", "matcher", "long_prompt"} with ``--long-prompt``;
    otherwise {"names", "matcher", "responses": {uid: {"expert",
    "fine_class", "tokens"}}, "truth": {uid: dataset}, "accuracy",
    "seconds" (of the serve), "scheduler_batches",
    "route_cache_hits", "engines": {engine or bank: counters},
    "executor", "placement", "cold_start", "hub_stats", "repeat":
    {"seconds", "route_cache_hits", "responses"}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--n-per-dataset", type=int, default=2000)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--banked", action="store_true",
                    help="bank homogeneous experts via plan_placement")
    ap.add_argument("--executor", choices=("serial", "overlapped"),
                    default="overlapped",
                    help="dispatch executor (overlapped = async; serial "
                         "= blocking per-tick reference)")
    ap.add_argument("--hub", action="store_true",
                    help="serve through an ExpertHub with --resident "
                         "device slots: non-resident experts cold-start "
                         "on demand (park -> load -> serve)")
    ap.add_argument("--resident", type=int, default=2,
                    help="hub device slots (with --hub; fewer than the "
                         "6 experts so evictions actually happen)")
    ap.add_argument("--long-prompt", action="store_true",
                    help="whale-prompt demo: chunked suffix prefill "
                         "over cached cohort heads vs storage-only "
                         "paged, printing prefill-tokens-computed "
                         "savings")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.hub and args.banked:
        ap.error("--hub and --banked are exclusive (the hub owns its "
                 "own slot bank)")
    if args.long_prompt and (args.hub or args.banked):
        ap.error("--long-prompt is a standalone demo (no --hub/--banked)")
    dev = resolve_device(args.device)

    t0 = time.time()
    bench = load_benchmark(n_per_dataset=args.n_per_dataset, seed=0)
    names = list(bench)
    print(f"[{time.time()-t0:5.1f}s] datasets: {names}")

    if aes is None:
        aes, _ = train_bank([(n, bench[n]["server"][0]) for n in names],
                            epochs=args.epochs, batch_size=64, device=dev)
    if init_expert is None:
        def init_expert(model, i):
            return model.init(i, device=dev)
    cents = [(bench[n]["server"][0], bench[n]["server"][1]) for n in names]
    matcher = build_matcher(aes, names, cents,
                            MatcherConfig(use_kernel=True), device=dev)
    print(f"[{time.time()-t0:5.1f}s] matcher bank trained (6 AEs)")

    if args.long_prompt:
        lp = long_prompt_demo(matcher, bench, names, t0, dev, init_expert,
                              n_requests=args.requests)
        return {"names": names, "matcher": matcher, "long_prompt": lp}

    hub = None
    if args.hub:
        # one homogeneous architecture: hub slots are shape-compatible
        # by construction (equal ExpertSpec), so any expert can land in
        # any slot
        cfg = get_config("llama3.2-1b").reduced(name="llama-expert")
        model = build_model(cfg)
        hub = ExpertHub(model, n_slots=args.resident, max_len=96,
                        device=dev)
        for i, n in enumerate(names):
            hub.add_expert(n, init_expert(model, i))
        registry = hub.build_registry()
        print(f"[{time.time()-t0:5.1f}s] hub up: {len(registry)} "
              f"experts catalogued, {args.resident} device slots")
    else:
        # three heterogeneous expert backends, cycled over the datasets
        backends = ["llama3.2-1b", "rwkv6-7b", "mixtral-8x22b"]
        registry = ExpertRegistry()
        for i, n in enumerate(names):
            arch = backends[i % len(backends)]
            cfg = get_config(arch).reduced(name=f"{arch}-expert-{n}")
            model = build_model(cfg)
            registry.add(n, ExpertEngine(model, init_expert(model, i),
                                         max_len=96, device=dev),
                         arch=arch)
        print(f"[{time.time()-t0:5.1f}s] {len(registry)} expert engines "
              f"up (families: dense, rwkv, moe)")

    plan = None
    if args.banked:
        mesh = make_expert_mesh(dev)
        plan = plan_placement(registry, mesh=mesh)
        print(f"[{time.time()-t0:5.1f}s] placement "
              f"({mesh.shape['expert']} {dev.type} device(s)):")
        for line in plan.describe(registry.names).splitlines():
            print(f"    {line}")
    with RoutedServer(matcher, registry, max_batch=8, placement=plan,
                      executor=args.executor, hub=hub,
                      device=dev) as server:
        reqs, truth = make_requests(bench, names, args.requests)
        t1 = time.time()
        resps = server.serve(reqs)
        dt = time.time() - t1
        correct = sum(r.expert == t for r, t in zip(resps, truth))
        print(f"[{time.time()-t0:5.1f}s] served {len(resps)} requests in "
              f"{dt:.2f}s ({len(resps)/dt:.1f} req/s on one {dev.type} "
              f"device)")
        print(f"routing accuracy: {correct}/{len(resps)} "
              f"({correct/len(resps):.1%})")
        for r in resps[:5]:
            print(f"  req {r.uid}: -> {r.expert} (fine class "
                  f"{r.fine_class}) tokens {r.tokens.tolist()}")

        # continuous-batching internals: executables stay bucket-bounded
        st = server.stats
        counters = _engine_counters(st)
        print(f"scheduler: {st['scheduler'].batches} micro-batches, "
              f"{st['router']['cache_hits']} route-cache hits, "
              f"executor={st['executor']}")
        for name, c in counters.items():
            print(f"  {name}: {c['prefill_calls']} prefills, "
                  f"{c['decode_steps']} decode ticks, "
                  f"{c['jit_cache_entries']} compiled executables, "
                  f"{c['host_blocks']} host-blocking syncs")
        out = {"names": names, "matcher": matcher, "seconds": dt,
               "accuracy": correct / len(resps),
               "responses": {r.uid: {"expert": r.expert,
                                     "fine_class": int(r.fine_class),
                                     "tokens": r.tokens.tolist()}
                             for r in resps},
               "truth": dict(enumerate(truth)),
               "scheduler_batches": st["scheduler"].batches,
               "route_cache_hits": st["router"]["cache_hits"],
               "engines": counters, "executor": st["executor"],
               "placement": (plan.describe(registry.names)
                             if plan is not None else None),
               "cold_start": None, "hub_stats": None}

        if args.hub:
            out["cold_start"] = hub_cold_start_demo(server, hub, bench,
                                                    names, t0)
            out["hub_stats"] = hub.stats.as_dict()

        # a second wave with repeated fingerprints rides the routing LRU
        # and the executables already built
        t2 = time.time()
        again = server.serve([
            Request(uid=10_000 + r.uid, features=reqs[i].features,
                    prompt=reqs[i].prompt,
                    max_new_tokens=reqs[i].max_new_tokens)
            for i, r in enumerate(resps)])
        hits = server.stats["router"]["cache_hits"]
        print(f"repeat wave: {len(again)} reqs in {time.time()-t2:.2f}s "
              f"(route-cache hits now {hits})")
        out["repeat"] = {"seconds": time.time() - t2,
                         "route_cache_hits": hits,
                         "responses": {r.uid - 10_000: r.tokens.tolist()
                                       for r in again}}
    return out


if __name__ == "__main__":
    main()
