#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env — torch / CUDA versions, the card's name and power limit, and the
   seconds ``nvcc`` took to build the port's CUDA kernels from
   ``src/repro_torch/kernels/csrc``.
2. reference — a reduced float32 ``llama3_2_1b`` expert generates on the
   card (through the kernels) and on the CPU (through their plain
   versions) from the same weights: greedy tokens must be equal and
   logits must agree.
3. serve — the main path: an AE-bank matcher (K = 6, 784 -> 128, coarse
   scoring through ``expert_score``, fine through ``cosine_scores``) in
   front of six full-width bf16 ``llama3_2_1b`` engines (random seeded
   weights, ring KV, ``max_len`` 256) serving 24 routed requests, once
   with the serial and once with the overlapped executor. Every kernel's
   launch counter is reset just before each run and read just after;
   each must have launched, and the two executors' tokens must be equal.
4. breakdown — one wave's decode step at the serve phase's largest batch
   bucket: eager wall time, device time (the step replayed as a CUDA
   graph), the kernels it launches (``torch.profiler``), and the device's
   busy share.
5. kernels — each kernel against its plain PyTorch version on the same
   inputs at the shapes the serve phase gave it (tolerance stated), and
   its device time beside the plain version's, a library yardstick's and
   its bound (L2 flushed before every timed launch, as the serving path
   finds it).

Then a summary line ``{"kernels": [...]}``, the raw ``nvidia-smi`` name
and power-limit line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result, as it does without a CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12,    # f32 outside the tensor cores
              "bfloat16": 989e12}  # dense bf16 tensor cores
SLEEP_CYCLES = 20_000_000          # stalls the stream while launches queue
FLUSH_BYTES = 128 << 20            # > the 50 MB L2
N_TIMED = 30


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    print(build.build_log, file=sys.stderr)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "gpu": smi, "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "kernel_build_s": build_s, "nvcc_build_s": build.build_seconds})

    emit(reference_phase(np, torch, dev))
    serve, shapes = serve_phase(np, torch, dev, ops)
    emit(serve)
    emit(breakdown_phase(np, torch, dev, shapes))
    kernels = kernel_phase(np, torch, dev, ops, shapes)
    for k in kernels:
        k["launches"] = serve["serial"]["launches"][k["name"]]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# ---------------------------------------------------------------------------
# reference: the card's kernel path against the CPU's plain path
# ---------------------------------------------------------------------------


def reference_phase(np, torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ExpertEngine

    cfg = get_config("llama3_2_1b").reduced(name="smoke-ref")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(SEED), device="cpu")
    gpu = _tree(cpu, lambda t: t.to(dev))
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 40)).astype(np.int32)

    # logits of a prefill and three decode steps, fed the CPU's tokens
    worst = 0.0
    lc, cc = model.prefill(cpu, {"tokens": torch.from_numpy(toks)},
                           capacity=64)
    lg, cg = model.prefill(gpu, {"tokens": torch.from_numpy(toks).to(dev)},
                           capacity=64)
    for _ in range(4):
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
        tok = lc.argmax(-1).to(torch.int32)[:, None]
        lc, cc = model.decode(cpu, cc, {"token": tok})
        lg, cg = model.decode(gpu, cg, {"token": tok.to(dev)})
    worst = max(worst, (lg.cpu() - lc).abs().max().item())
    scale = lc.abs().max().item()
    if not worst <= 1e-4 * max(scale, 1.0):
        raise AssertionError(f"reference: card logits differ from the CPU "
                             f"plain path by {worst} (scale {scale})")
    want = ExpertEngine(model, cpu, max_len=64, device="cpu").generate(
        toks, 12)
    got = ExpertEngine(model, gpu, max_len=64, device=dev).generate(
        toks, 12)
    if not np.array_equal(got, want):
        raise AssertionError(f"reference: greedy tokens differ\n{got}\n"
                             f"{want}")
    return {"phase": "reference", "config": cfg.name,
            "logits_max_abs_err": worst, "logits_scale": scale,
            "logits_tol": "abs 1e-4 x max(|logit|, 1)",
            "tokens_equal": True, "rows": int(toks.shape[0]),
            "new_tokens": 12}


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)


# ---------------------------------------------------------------------------
# serve: the main path
# ---------------------------------------------------------------------------

DATASETS = [("stl10", 10), ("mnist", 10), ("har", 6), ("reuters", 4),
            ("nlos", 3), ("db", 3)]


def serve_phase(np, torch, dev, ops):
    from repro_torch.configs import get_config
    from repro_torch.core import (ExpertRegistry, MatcherConfig,
                                  build_matcher, init_ae)
    from repro_torch.models import build_model
    from repro_torch.serve import ExpertEngine, Request, RoutedServer
    from repro_torch.serve.core import bucket_for

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    names = [n for n, _ in DATASETS]
    aes = [init_ae(gen, device=dev) for _ in names]
    cent_data = []
    for _, n_cls in DATASETS:
        xs = rng.random((256, 784), dtype=np.float32)
        cent_data.append((xs, np.arange(256) % n_cls))
    matcher = build_matcher(aes, names, cent_data,
                            MatcherConfig(use_kernel=True), device=dev)

    cfg = get_config("llama3_2_1b")
    model = build_model(cfg)
    registry = ExpertRegistry()
    for i, name in enumerate(names):
        params = model.init(
            torch.Generator(device=dev).manual_seed(SEED + 1 + i),
            device=dev)
        registry.add(name, ExpertEngine(model, params, max_len=256,
                                        device=dev))
    torch.cuda.synchronize()
    mem_gb = torch.cuda.memory_allocated() / 1e9

    def requests(uid0):
        out = []
        for u in range(24):
            out.append(Request(
                uid=uid0 + u,
                features=rng.random(784, dtype=np.float32),
                prompt=rng.integers(0, cfg.vocab_size,
                                    size=int(rng.integers(8, 65))
                                    ).astype(np.int32),
                max_new_tokens=16))
        return out

    # warm-up traffic (cuBLAS handles, allocator) on its own server
    RoutedServer(matcher, registry, executor="serial",
                 device=dev).serve(requests(10_000))
    reqs = requests(0)
    engines = [registry[e].backend for e in range(len(registry))]
    runs, tokens = {}, {}
    for executor in ("serial", "overlapped"):
        server = RoutedServer(matcher, registry, executor=executor,
                              device=dev)
        before = [(e.stats.host_blocks, e.stats.decode_steps)
                  for e in engines]
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        resps = server.serve(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = ops.launches()
        if len(resps) != len(reqs):
            raise AssertionError(f"{executor}: {len(resps)} responses "
                                 f"for {len(reqs)} requests")
        for r, q in zip(resps, reqs):
            if r.uid != q.uid or r.tokens.shape != (16,) \
                    or not ((r.tokens >= 0)
                            & (r.tokens < cfg.padded_vocab)).all():
                raise AssertionError(f"{executor}: bad response {r}")
        steps = sum(e.stats.decode_steps - b[1]
                    for e, b in zip(engines, before))
        blocks = sum(e.stats.host_blocks - b[0]
                     for e, b in zip(engines, before))
        if min(launches.values()) == 0:
            raise AssertionError(f"{executor}: a kernel never launched on "
                                 f"the main path: {launches}")
        if launches["decode_attention"] != cfg.n_layers * steps:
            raise AssertionError(
                f"{executor}: decode_attention launched "
                f"{launches['decode_attention']} times for {steps} decode "
                f"steps of {cfg.n_layers} layers")
        n_tok = sum(len(r.tokens) for r in resps)
        tokens[executor] = [r.tokens for r in resps]
        runs[executor] = {
            "seconds": dt, "req_per_s": len(resps) / dt,
            "generated_tok_per_s": n_tok / dt, "tokens": n_tok,
            "decode_steps": steps, "host_blocks": blocks,
            "launches": launches,
            "routed": sorted({r.expert for r in resps}),
        }
    if not all(np.array_equal(a, b) for a, b in
               zip(tokens["serial"], tokens["overlapped"])):
        raise AssertionError("serial and overlapped tokens differ")
    # the shapes the main path gave each kernel
    groups = {}
    for r in resps:
        groups[r.expert] = groups.get(r.expert, 0) + 1
    row_buckets = server.router.row_buckets
    shapes = {
        "route_rows": bucket_for(len(reqs), row_buckets),
        "group_rows": bucket_for(max(groups.values()), row_buckets),
        "decode_rows": max(max(e.core._decode_shapes, default=1)
                           for e in engines),
        # q_pos of the last decode step of the longest prompt bucket: the
        # fullest ring the main path gave the decode kernel
        "decode_q_pos": max(sb for e in engines
                            for _, sb in e.core._prefill_shapes) + 16 - 2,
        "n_classes": int(matcher.centroids.shape[1]),
        "max_len": 256, "cfg": cfg, "engine": engines[0],
    }
    return ({"phase": "serve", "config": cfg.name, "experts": len(names),
             "requests": len(reqs), "max_new_tokens": 16,
             "prompt_len": [8, 64], "kv": "ring", "max_len": 256,
             "param_gb": mem_gb, "tokens_equal": True,
             "serial": runs["serial"], "overlapped": runs["overlapped"],
             "kernel_shapes": {k: v for k, v in shapes.items()
                               if k not in ("cfg", "engine")}}, shapes)


# ---------------------------------------------------------------------------
# breakdown: where one decode step's time goes
# ---------------------------------------------------------------------------


def breakdown_phase(np, torch, dev, shapes):
    """One wave's decode step at the main path's largest batch bucket:
    wall time per step (host clock, synchronised, eager), device time per
    step (the same step captured once in a CUDA graph and replayed, so no
    host gap is timed), and the kernels one eager step launches, from
    ``torch.profiler``. Device busy share = graph time / eager wall."""
    eng, cfg = shapes["engine"], shapes["cfg"]
    model, params = eng.model, eng.params
    B, Sb, n = shapes["decode_rows"], 64, 20
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(B, Sb)).astype(np.int32)).to(dev)
    _, cache = model.prefill(params, {"tokens": toks},
                             capacity=shapes["max_len"])
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    pos0, t0_ = cache["pos"].clone(), cache["t"].clone()

    def step():
        # restart from the same position each call: the decode advances
        # pos/t in the dict, the graph below replays a fixed position
        cache["pos"], cache["t"] = pos0, t0_
        return model.decode(params, cache, {"token": tok})[0]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph.replay()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    s.record()
    for _ in range(n):
        graph.replay()
    e.record()
    torch.cuda.synchronize()
    device = s.elapsed_time(e) / n
    del graph

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    kern = [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for ev in kern:
        by_name[ev.name] = by_name.get(ev.name, 0.0) \
            + ev.time_range.elapsed_us() / 3e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       _leaves(params))
    return {"phase": "breakdown", "rows": B, "prompt_len": Sb,
            "cache_len": shapes["max_len"], "steps_timed": n,
            "wall_ms_per_step": wall, "graph_device_ms_per_step": device,
            "device_busy_share": device / wall,
            "profiler_kernels_per_step": len(kern) / 3,
            "profiler_kernel_ms_per_step": sum(by_name.values()),
            "profiler_top_kernels_ms": [[k[:60], v] for k, v in top],
            "weight_gb": weight_bytes / 1e9,
            "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3}


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


# ---------------------------------------------------------------------------
# kernels: each against its plain version, timed beside its bound
# ---------------------------------------------------------------------------


def kernel_phase(np, torch, dev, ops, shapes):
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush_buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                            device=dev)

    def flush():
        flush_buf.zero_()

    def device_ms(fn):
        """Median device time of one call, L2 flushed before each call;
        a sleep kernel holds the stream while launches queue, so host
        launch overhead stays out of the reading. If the sleep ended
        before the last launch was queued, the device may have waited on
        the host inside a timed call: measure again with a longer sleep."""
        fn()
        torch.cuda.synchronize()
        cycles = SLEEP_CYCLES
        while True:
            evs = [(torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
                   for _ in range(N_TIMED)]
            torch.cuda._sleep(cycles)
            slept = torch.cuda.Event()
            slept.record()
            for s, e in evs:
                flush()
                s.record()
                fn()
                e.record()
            starved = slept.query()
            torch.cuda.synchronize()
            if not starved:
                return statistics.median(s.elapsed_time(e) for s, e in evs)
            if cycles >= 64 * SLEEP_CYCLES:
                raise RuntimeError("device_ms: the host cannot queue "
                                   f"{N_TIMED} calls within a long sleep")
            cycles *= 4

    def bound(nbytes, flops, dtype):
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        to = flops / PEAK_FLOPS[dtype] * 1e3
        return (max(tb, to), "bytes" if tb >= to else "operations")

    def record(name, source, replaces, got, want, rtol, atol, fn, plain,
               library, library_call, nbytes, flops, dtype, shape):
        fin = torch.isfinite(want)
        if not torch.equal(torch.isfinite(got), fin) or not torch.equal(
                got[~fin], want[~fin]):
            raise AssertionError(f"{name}: non-finite entries differ")
        g, w = got[fin].float(), want[fin].float()
        err = (g - w).abs()
        if not bool((err <= atol + rtol * w.abs()).all()):
            raise AssertionError(f"{name}: max abs err {err.max().item()} "
                                 f"beyond rtol {rtol} atol {atol}")
        b_ms, b_by = bound(nbytes, flops, dtype)
        ms = device_ms(fn)
        plain_ms = device_ms(plain)
        ms2 = device_ms(fn)       # kernel, plain, kernel, library
        lib_ms = device_ms(library)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": None,
                "max_abs_err": err.max().item(),
                "max_rel_err": (err / w.abs().clamp_min(1e-30)).max().item(),
                "rtol": rtol, "atol": atol, "ms": min(ms, ms2),
                "ms_runs": [ms, ms2], "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "library_call": library_call, "shape": shape,
                "l2": "flushed before every call"}

    out = []

    # -- kernel 1: expert_score at the router's row bucket ---------------
    B, K, D, H = shapes["route_rows"], 6, 784, 128
    bp = {"w_enc": torch.randn(K, D, H, generator=gen, device=dev) * 0.03,
          "b_enc": torch.randn(K, H, generator=gen, device=dev) * 0.01,
          "bn_scale": 1 + torch.randn(K, H, generator=gen, device=dev) * 0.1,
          "bn_bias": torch.randn(K, H, generator=gen, device=dev) * 0.05,
          "w_dec": torch.randn(K, H, D, generator=gen, device=dev) * 0.03,
          "b_dec": torch.randn(K, D, generator=gen, device=dev) * 0.01}
    bs = {"mean": torch.randn(K, H, generator=gen, device=dev) * 0.1,
          "var": 1 + torch.rand(K, H, generator=gen, device=dev)}
    folded = ops.fold_bank(bp, bs)
    x = torch.rand(B, D, generator=gen, device=dev)
    got = ops.expert_score_folded(folded, x)
    want = ops.expert_score_plain(folded, x)
    xk = x.expand(K, B, D)

    def lib1():
        h = torch.baddbmm(folded["b1"][:, None, :], xk, folded["w1"])
        xhat = torch.baddbmm(folded["b2"][:, None, :], h.relu_(),
                             folded["w2"])
        return (xhat - x).square_().sum(-1).div_(D).T

    out.append(record(
        "expert_score", "src/repro_torch/kernels/csrc/expert_score.cu",
        "src/repro/kernels/expert_score.py:39", got, want, 2e-5, 1e-6,
        lambda: ops.expert_score_folded(folded, x),
        lambda: ops.expert_score_plain(folded, x), lib1,
        "torch.baddbmm x2 + square/sum", 4 * (B * D + K * (2 * D * H + H + D)
                                              + B * K),
        2 * B * K * 2 * D * H, "float32", [B, K, D, H]))

    # -- kernel 2: cosine_scores at the largest routed group's bucket ----
    B2, M, h = shapes["group_rows"], shapes["n_classes"], 128
    z = torch.relu(torch.randn(B2, h, generator=gen, device=dev))
    z[-1] = 0.0                      # a router zero-padding row
    cents = torch.relu(torch.randn(M, h, generator=gen, device=dev))
    mask = (torch.arange(M, device=dev) < M - 3).float()
    got = ops.cosine_scores(z, cents, mask)
    want = ops.cosine_scores_plain(z, cents, mask)

    def lib2():
        s = F.normalize(z, dim=-1) @ F.normalize(cents, dim=-1).T
        return s.masked_fill_(mask <= 0, float("-inf"))

    out.append(record(
        "cosine_scores", "src/repro_torch/kernels/csrc/cosine_scores.cu",
        "src/repro/kernels/cosine_topk.py:27", got, want, 2e-5, 1e-6,
        lambda: ops.cosine_scores(z, cents, mask),
        lambda: ops.cosine_scores_plain(z, cents, mask), lib2,
        "F.normalize x2 + matmul + masked_fill",
        4 * (B2 * h + M * h + M + B2 * M), 2 * B2 * M * h + 3 * (B2 + M) * h,
        "float32", [B2, M, h]))

    # -- kernel 3: decode_attention over one decode step's 16 layers, with
    # the ring as full as the main path's last decode step left it ------
    cfg = shapes["cfg"]
    B3, S = shapes["decode_rows"], shapes["max_len"]
    Hq, KV, dh, L = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.n_layers
    bf = torch.bfloat16
    q = torch.randn(B3, Hq, dh, generator=gen, device=dev).to(bf)
    kc = torch.randn(L, B3, S, KV, dh, generator=gen, device=dev).to(bf)
    vc = torch.randn(L, B3, S, KV, dh, generator=gen, device=dev).to(bf)
    t = shapes["decode_q_pos"]
    q_pos = torch.full((), t, dtype=torch.int32, device=dev)
    ar = torch.arange(S, dtype=torch.int32, device=dev)
    kv_pos = torch.where(ar <= t, ar, torch.full_like(ar, -1))
    live = int(((kv_pos >= 0) & (kv_pos <= t)).sum())   # slots it must read
    got = ops.decode_attention(q, kc[0], vc[0], q_pos, kv_pos)
    want = ops.decode_attention_plain(q, kc[0], vc[0], q_pos, kv_pos)
    layer = [0]

    def step(fn):
        def run():
            i = layer[0] = (layer[0] + 1) % L
            return fn(i)
        return run

    kern = step(lambda i: ops.decode_attention(q, kc[i], vc[i], q_pos,
                                               kv_pos))
    plain = step(lambda i: ops.decode_attention_plain(q, kc[i], vc[i],
                                                      q_pos, kv_pos))
    qs = q[:, :, None, :]
    ks = [kc[i].transpose(1, 2) for i in range(L)]
    vs = [vc[i].transpose(1, 2) for i in range(L)]
    amask = ((kv_pos >= 0) & (kv_pos <= t))[None, None, None, :]
    lib3 = step(lambda i: F.scaled_dot_product_attention(
        qs, ks[i], vs[i], attn_mask=amask, enable_gqa=True))
    out.append(record(
        "decode_attention",
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:76", got, want, 4e-3, 4e-3,
        kern, plain, lib3,
        "F.scaled_dot_product_attention(enable_gqa=True, bool mask)",
        2 * (2 * B3 * Hq * dh + 2 * B3 * live * KV * dh) + 4 * (S + 1),
        4 * B3 * Hq * live * dh, "bfloat16", [B3, Hq, KV, dh, S, live]))
    return out


if __name__ == "__main__":
    sys.exit(main())
