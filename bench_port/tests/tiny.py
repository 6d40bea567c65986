"""Tiny cells for the harness's CPU tests: the benchmark's own
configuration and mix files, cut to a size the CPU runs in seconds
(two layers, widths of 64, a 512-token vocabulary, a bank of 300
fingerprints a dataset)."""
from __future__ import annotations

import json
import os
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bench_port import harness  # noqa: E402

CELLS = {"moe": "olmoe-batch", "rwkv": "rwkv6-batch"}
SMALL_MOE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                 d_ff=32, vocab_size=512, n_experts=8, experts_per_token=2,
                 moe_capacity_factor=4.0)
SMALL_RWKV = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                  head_dim=16, d_ff=96, vocab_size=512, rwkv_lora_dim=8,
                  ssm_chunk=8)
LENGTHS = {"prompt_tokens": {"dist": "lognormal", "median": 12,
                             "sigma": 0.6, "min": 4, "max": 40},
           "new_tokens": {"dist": "lognormal", "median": 6, "sigma": 0.4,
                          "min": 2, "max": 10}}


def spec(kind: str, dtype: str = "float32"):
    """A cell spec (what ``harness.CellSpec`` gives) of a tiny cut of the
    cell ``CELLS[kind]``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    s = harness.CellSpec(bench, CELLS[kind], ROOT)
    cfg, mix = s.cfg, s.mix
    cfg.update(SMALL_RWKV if cfg["family"] == "rwkv" else SMALL_MOE)
    cfg.update(param_dtype=dtype, compute_dtype=dtype)
    fl = cfg["fleet"]
    fl.update(max_len=128, batch_buckets=[1, 2, 4], max_batch=4)
    if fl.get("kv_layout") == "paged":
        fl.update(pool_pages=256, chunk_len=16, prefill_tokens_per_step=32)
    cfg["bank"].update(samples=300, epochs=2)
    mix.update(LENGTHS, job_requests=12)
    return s


def run(s, seed: int = 12345678901, seconds: float = 2.0, trace=False,
        **kw):
    torch.set_num_threads(max(1, min(2, os.cpu_count() or 1)))
    return harness.run_cell(s, seed, seconds, trace, "cpu",
                            time.perf_counter(), log=lambda m: None, **kw)


def namespace(**kw):
    return types.SimpleNamespace(**kw)
