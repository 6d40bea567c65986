#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

(``--only breakdown_moe,train_lm,train_sharded`` runs the env phase and
those phases alone and prints no result line: copied to the root of a
second tree, it times both trees' code in one call.)

Phases, each printing one JSON line:

1. env — torch / CUDA versions, the card's name and power limit, and the
   seconds ``nvcc`` took to build the port's CUDA kernels from
   ``src/repro_torch/kernels/csrc``.
2. reference — a reduced float32 ``llama3_2_1b`` expert generates on the
   card (through the kernels) and on the CPU (through their plain
   versions) from the same weights: greedy tokens must be equal and
   logits must agree. Then a paged ``RoutedServer`` of two such experts
   (``chunk_len`` 32) serves cohort traffic on the card and on the CPU:
   greedy tokens must be equal. Then the same f32 expert speculates on
   the card (``table`` draft, k 1 and 4, ring and paged, each verify a
   replay of its captured verify graph): its tokens must equal the CPU's
   plain-decode tokens. Then four reduced f32 experts serve pre-routed
   traffic as a bank (``plan_placement``) and through a 2-slot
   ``ExpertHub`` staged from host memory, on the card and on the CPU,
   and on the card again over a 2-position expert mesh
   (``ExpertMesh((cuda:0,) * 2)``): tokens, the hub's counters and its
   victims must be equal.
2a. encdec_reference — a reduced f32 ``seamless_m4t_large_v2`` (2 + 2
   layers, GQA 4 over 2) on the card and on the CPU from the same
   weights, plain and with the encoder and the prefill's cross-attention
   on the blockwise branch (``enc_seq_len`` 128, ``attn_chunk`` 32):
   prefill logits and every cache leaf, then 6 decode steps past a ring
   wrap within 1e-5 of the CPU's scale, greedy tokens equal, two decode
   launches bit-equal, a captured decode step's replayed tokens equal to
   the eager ones, no kernel launched, the loss equal and gradients
   within 2e-5 of scale.
3. serve — the ring-KV main path: an AE-bank matcher (K = 6, 784 -> 128,
   coarse scoring through ``expert_score``, fine through one grouped
   ``cosine_fine`` launch per route chunk) in front of six full-width
   bf16 ``llama3_2_1b`` engines (random seeded weights, ring KV,
   ``max_len`` 256) serving 24 routed requests, once with the serial and
   once with the overlapped executor, each decode step a replay of its
   bucket's captured CUDA graph (every bucket captured by a warm-up
   serve of the same requests); then the same two runs through engines
   on the same weights with ``capture_decode=False`` (the eager step).
   Every run's tokens must equal the first's, its ``host_blocks`` the
   executor's count before capture (176 / 11), and a replay counts the
   launches its capture recorded. Every kernel's launch counter is
   reset just before each run and read just after; each kernel of the
   path must have launched, ``expert_score`` and ``cosine_scores``
   exactly once per route chunk with misses (counted by wrapping the
   router's per-chunk fine match, ``Router._fine_grouped``, here and in
   phases 4 and 6-9), each request's expert
   and fine class must equal the CPU plain path's (a Router over a CPU
   copy of the bank), and the two executors' tokens must be equal.
4. serve_paged — the paged-KV path: the same matcher in front of six
   paged engines sharing the serve phase's weight tensors (page 8, pool
   of 1536 pages + trash per expert, ``chunk_len`` 64, 64 prompt tokens
   per step) serving 24 requests of cohort traffic (shared prefixes,
   exact duplicates, two-chunk prompts and a wrapping duplicate pair):
   serial, overlapped, then again on the same server with fresh uids.
   Every decode layer goes through ``paged_decode_attention`` and never
   through ``decode_attention``; the prefix, copy-on-write and chunk
   counters must all move and the pools' books must balance. Each fleet
   is fresh and warmed by the same requests with every token shifted by
   one (the same decode buckets captured, no prefix of the timed
   requests cached); graph and eager fleets, serial and overlapped, give
   equal tokens, ``host_blocks`` 96 / 6.
5. breakdown — one wave's decode step at the serve phase's largest batch
   bucket: eager wall time, device time (the step replayed as a CUDA
   graph), the kernels it launches (``torch.profiler``), the share of
   ``decode_attention`` in them, and the device's busy share; then the
   engine's own tick of such a wave, host-synchronised, replaying its
   bucket's graph and eagerly, ring and paged, with the decode kernels'
   time per launch inside the replay.
6. serve_spec — speculative decoding: six full-width ``llama3_2_1b``
   spec engines (``speculate_k`` 4, the bigram ``table`` draft, ring,
   ``max_len`` 256) on the serve phase's weights and matcher serve the
   reference bench's decode-heavy mix (24 requests, prompts of 3-16
   tokens, 32-64 new): graph serial, graph overlapped, eager serial,
   eager overlapped. Every run's tokens must equal the first's, no wave
   may fall back to plain decode, every verify graph must be captured
   in the warm-up, routes must equal the CPU's and no decode kernel may
   run in a verify. The serve phase's plain graph fleet serves the same
   traffic: decoded tok/s of spec against plain, and each row must
   equal the plain one or differ first where the two tokens are the
   plain path's top 2 (its wave replayed exactly), at most two bf16 ulps
   apart (printed). Then a paged spec run, an
   ``always-wrong`` wave (acceptance 0, max(max_new) - 1 verifies) and
   the engine's own verify tick (the breakdown's wave), replayed and
   eager.
7. serve_banked — the serve phase's six engines placed as one bank
   (``plan_placement``: one ``BankedEngine`` of E = 6 on the same weight
   tensors, one captured decode step per batch bucket for all six)
   serving the serve phase's 24 requests: graph serial, graph
   overlapped, eager serial, eager overlapped, every run's tokens equal
   to the first's and each row equal to the per-engine fleet's or a
   reported near tie (the bank's decode bucket is the largest over its
   members, so its bf16 GEMMs run at other M); ``decode_attention`` E x
   n_layers times a bank step (a bank steps every member, rows or not).
   Then a paged bank on the serve_paged phase's cohort traffic (B4 only,
   pool books balanced) and the bank's own tick.
7a. serve_mesh — the same six experts as one E = 6 bank over a 1-D
   expert mesh of three positions on the card (``ExpertMesh((cuda:0,) *
   3)``: two members a position, each position with its own graphs and
   state), serve_banked's 24 requests graph / eager x serial /
   overlapped: rows equal serve_banked's or reported near ties,
   ``host_blocks`` equal serve_banked's, ``decode_attention`` E x
   n_layers a bank step, every position capturing the same buckets in
   the warm-up and none after; seconds and the bank tick beside
   serve_banked's, with the card's name and power limit. With two or
   more cards it also serves over every card (``make_expert_mesh()``).
8. serve_hub — an ``ExpertHub`` of 2 slots over a catalog of the same
   six experts saved ``cold`` into a store under a temporary directory
   (removed at the end), behind the serve phase's matcher: ``warmup``,
   then 24 requests (a catalog sweep, then Zipf(1.1) over expert rank)
   serial and overlapped. Held: every expert served, evictions, no
   capture after the warmup (installs copy into the slots' tensors in
   place), the hub's invariants and pin conservation every step, and
   each row equal to the bank's on the same requests or a reported near
   tie. Printed: the hub's counters, stage and commit ms per expert, an
   install timed to completion against a measured pinned host link, the
   store's size and write time, host and device memory, the split of a
   serve between ``_service_hub`` and the rest, and the tick of the
   2-slot bank beside the 6-member bank's and a single engine's.
9. serve_rwkv — a mixed-family server, as the reference's launcher
   builds one: an AE bank of K = 4 in front of two full-width bf16
   ``rwkv6_7b`` engines (random seeded weights, ring, ``max_len`` 256)
   and two ``llama3_2_1b`` engines sharing the serve phase's weight
   tensors, serving 24 routed requests (fingerprints chosen by their
   route: at least 6 per RWKV expert, RWKV prompt buckets both below the
   32-token chunk, a scan prefill, and at or above it, a chunked one),
   serial and overlapped, through graphs and eagerly. Every RWKV decode
   layer goes through ``wkv_step`` (32 launches per RWKV replay: an RWKV
   engine's waves share replays through row slots, fewer than its decode
   steps) and every llama one through ``decode_attention``; every run's
   tokens must equal the first's, ``host_blocks`` 192 / 12.
10. breakdown_rwkv — one RWKV decode step at that phase's largest RWKV
   decode bucket, timed as in phase 5, with ``wkv_step``'s share, and the
   engine's own tick replayed and eager.
10a. serve_moe — once the RWKV weights are freed: an AE bank of K = 4 in
   front of two full-width bf16 ``olmoe_1b_7b`` engines (64 experts
   top-8, capacity dispatch; random seeded weights, 13.8 GB each,
   ``max_len`` 256) and two ``llama3_2_1b`` engines on the serve phase's
   tensors, 24 routed requests (8-64 prompt tokens, 16 new): ring, then
   paged (page 8, ``chunk_len`` 32) on fresh warmed fleets, each graph
   and eager, serial and overlapped. Every run's tokens equal the
   first's of its layout, and graph and eager runs of one executor make
   the same MoE prefill calls (tokens, assignments dropped);
   ``decode_attention`` (ring) or ``paged_decode_attention`` (paged) 16 x
   the decode steps; routes equal the CPU's. Recorded: req/s, tok/s, the
   assignments each MoE prefill routed and dropped. The timed runs carry
   the smoke's own recorders (drops, routes, and in the first paged run
   the MoE engines' decode shapes), so the rates include them.
10b. breakdown_moe — one olmoe wave's decode tick at B 8, timed as in
   phase 5 (bare step, and the engine's tick replayed and eager, with
   ``decode_attention``'s us per launch at dh 128, group 1), against its
   weight-read bound (the dropless dispatch reads all 64 experts).
10c. serve_zamba — once the olmoe weights are freed: an AE bank of K = 4
   in front of two full-width bf16 ``zamba2_7b`` engines (81 Mamba2
   layers and one shared attention block applied 13 times, head_dim
   112; random seeded weights, 13.5 GB each, ring, ``max_len`` 256) and
   two ``llama3_2_1b`` engines on the serve phase's tensors, 24 routed
   requests (8-64 prompt tokens, 16 new): graph and eager, serial and
   overlapped. Every run's tokens equal the first's, ``host_blocks``
   192 / 12, ``decode_attention``
   16 x the llama decode steps and none from the Zamba2 engines (they
   attend through plain ``attention``, as the reference's), routes equal
   the CPU's. Recorded: req/s, tok/s.
10d. breakdown_zamba — one Zamba2 wave's decode tick at B 8, timed as in
   phase 5 (bare step, and the engine's tick replayed and eager), the
   device time of the same tick without the shared block, of one Mamba2
   layer and of its ``w_out`` promoted to f32, each replayed alone, and
   the tick against its least bytes (weights, the shared block once per
   application, the SSM states and conv windows read and written, the
   live K/V).
10e. encdec — once the Zamba2 weights are freed: full-width bf16
   ``seamless_m4t_large_v2``, depth not cut (24 + 24 layers, 2.03 B
   parameters, ``enc_seq_len`` 4096; random seeded), B 8 with stub
   frames and 64-token prompts into a ring of 80: the prefill and the
   encoder alone against their operation bound (989 TFLOP/s bf16), 16
   greedy tokens eager and through a captured, replayed decode step
   (equal), no kernel launch (the reference's encdec decode attends
   through plain ``attention``), the decode tick (``step_times``)
   against its least bytes, the 24 cross-attentions replayed alone, and
   peak device memory. The family is not served (the reference's
   launcher swaps it for a llama).
11. kernels — each kernel against its plain PyTorch version on the same
   inputs at the shapes its serve phase gave it (tolerance stated), and
   its device time beside the plain version's, a library yardstick's and
   its bound (L2 flushed before every timed launch, as the serving path
   finds it). The ``cosine_scores`` row is the grouped ``cosine_fine``
   launch at the serve phase's route chunk (every routed group's bucket
   stacked over the matcher's K = 6, M = 10, h = 128 centroids), classes
   equal to the plain version's and bit-equal to per-group launches,
   with a single-group case at the largest group's bucket (its classes
   through ``cosine_fine`` with one expert);
   ``paged_decode_attention`` must also equal
   ``decode_attention`` on the gathered view bit for bit, and 256
   chained ``wkv_step`` launches must follow 256 plain steps, at the
   serve's bucket and at B = 32. Every row reports its time less the
   launch floor: a one-element ``add_`` timed the same way. The
   ``expert_score`` row, at the router's bucket and at B = 64 (two row
   tiles), reports its cluster plan, the clusters the card holds at
   once, shared memory and the launch timed at other cluster sizes; the
   two decode rows their cluster split and shared memory, and those
   three, ``cosine_scores`` and ``wkv_step`` the registers and spills
   ptxas reported; the
   ring row adds a long-ring case (B = 1, 4000 of 4096 slots live) beside
   SDPA.

12. train_bank — the paper's protocol on the card: the six generators at
   their Table 1 counts (``load_benchmark``), one ``fit_ae`` and one
   ``fit_mlp`` step from one init on the card and on the CPU (leaves at
   rtol 1e-5 where the gradient is at least 1e-5, within the step's
   bound elsewhere; the pre-BN biases' gradients below 1e-6 on both),
   ``train_bank`` on the server splits at the paper's recipe (45 epochs,
   batch 256, lr 1e-2 decayed x0.1 every 15 epochs; seconds per AE,
   steps/s), ``build_matcher(MatcherConfig(use_kernel=True))`` with the
   class centroids, every (dataset, client) split routed as one call
   through a card ``Router`` (``expert_score`` and ``cosine_fine`` once
   per 256-row route chunk, nothing else) and through a CPU Router over
   a copy of the bank: every (expert, fine class) equal but for near
   ties (the two choices' CPU scores within rtol 2e-5, counted); mean
   coarse accuracy > 0.9 on each client split, ``mnist`` fine accuracy
   > twice chance; ``assign_coarse`` on each whole split (one
   ``expert_score`` launch at up to 11274 rows) against the plain
   version, and the kernel timed on the trained bank at B 256 and at the
   largest split; then ``train_mlp`` on the same splits and its accuracy.
13. train_lm — 20 ``Trainer`` steps of full-width bf16 ``llama3_2_1b``
   (remat, 2 microbatches, clip 1.0) and 10 of ``rwkv6_7b`` at published
   widths cut to 4 layers, on ``synthetic_token_stream`` at seq 128 x
   batch 8: ms a step (median of the last 10), tokens/s, 6 x params x
   tokens against the bf16 peak, peak memory; losses finite and falling;
   no kernel launched. Then one ``make_train_step`` of each, reduced and
   f32, on the card against the CPU: loss, gradients and updated params.
13a. train_sharded — the same full-width ``llama3_2_1b`` step (bf16,
   remat, 2 microbatches, clip 1.0, seq 128 x batch 8) as DTensors on
   the 1 x 1 ``data`` x ``model`` host mesh (``make_host_mesh``: a
   one-rank NCCL group) with ``fsdp`` specs, against the unsharded step
   from the same init and batch: loss within 1e-4, params max |diff|
   within 5e-4, AdamW's moments within 1e-4 of each leaf's scale, every
   state leaf back in its placements, no kernel launched; both steps'
   wall ms, twice each. With four cards, also ``tests/_sharded_worker.py``
   on a (2, 2) NCCL mesh of four ranks (reduced f32 llama, 2
   microbatches, and a reduced capacity-dispatch olmoe on ``fsdp`` specs
   grouped by its ``data`` axis) against the plain step on the first
   card; with fewer, the line ``{"multi_card": "skipped: <n>
   device(s)"}``.
13b. dryrun — after train_sharded: (i) the dry run's CLI,
   ``python -m repro_torch.launch.dryrun`` on the card (fake tensors,
   a fake process group of 256 ranks), ``qwen2_72b`` at published widths
   at decode_32k at full depth, prefill_32k cut to 40 layers and
   train_4k to 2 (16 microbatches through 80 layers take longer than
   the phase's cap), three processes on the CPU while (ii) and (iii)
   run on the card, each line ``ok``, its per-device peak against the
   card's memory; (ii)
   train_sharded's full-width ``llama3_2_1b`` step (seq 128 x batch 8, 2
   microbatches) as a dry run on a one-rank fake group, against the same
   step run for real on the 1 x 1 NCCL mesh: the predicted peak within
   ``DRYRUN_PEAK_RTOL`` of ``torch.cuda.max_memory_allocated``, the
   local flops equal to the real step's count, no collective in either;
   (iii) serve_sharded: full-width ``llama3_2_1b`` params and cache as
   DTensors on that mesh, a prefill of 8 prompts and 16 greedy decode
   steps, tokens bit-equal to the plain path's, ``decode_attention``
   launched 16 layers x 16 steps = 256 times in the sharded decode; the
   same for ``rwkv6_7b`` at full width cut to 4 layers, ``wkv_step``
   launched 4 x 16 = 64 times.
13c. contracts — after dryrun (``--only contracts`` runs it alone): the
   port's contract gate on the card. ``repro_torch.analysis``'s graphs
   pass (H001-H004) on full-width ``smollm_135m`` engines (bf16, every
   layer): a ring and a chunked paged ``ExpertHub`` of 4 slots over
   ``ExpertMesh((cuda:0,) * 2)`` and a speculating engine on the
   wrap-risk grid, and a full-width ``rwkv6_7b`` engine whose rows share
   replays (row slots, buckets 1 and 2: installs, packing and group
   swaps), every decode and verify body captured under a
   recording dispatch mode and ``torch.cuda.set_sync_debug_mode
   ("error")``; its kernels pass (K001-K004, capture, not execution);
   the ``H100`` table the planners read held against
   ``get_device_properties`` and ``expert_score_max_clusters``, and the
   pass's shared-memory formulas against the C entries'. One line with
   each rule's count of findings; an unbaselined error fails the run.
14. launch_serve — the serving launcher ``repro_torch.launch.serve.main``
   on its default device (the card), twice: the reference launcher's
   family cycle (reduced RWKV6, Zamba2, smollm, qwen2_72b, and llama in
   the encoder-decoder and VLM slots) and ``--hub-slots 2 --kv paged
   --trace``; each trains its bank and serves 24 requests of 8 new
   tokens. Every request answered, the trace written, the routing
   accuracy it reports printed.
15. examples — ``repro_torch.examples``' three ``main``s on the card:
   ``quickstart`` at its defaults, ``train_expert --steps 50``, and
   ``serve_routing --n-per-dataset 600 --requests 24`` overlapped,
   serial, banked, through a 2-slot hub and ``--long-prompt``. Held:
   the default run's matcher routes > 90% of every client_a row (900),
   serial == overlapped == banked per request,
   the hub's cold request parked, loaded and served by its expert,
   long-prompt tokens equal with fewer prompt tokens computed chunked,
   the checkpoint round trip bit-equal, and all five kernels launched.

The reference phase (2) also runs a reduced f32 ``rwkv6_7b`` expert
(``ssm_chunk`` 16) on the card and on the CPU, through both of its
prefill branches: logits must agree and greedy tokens be equal; a
reduced f32 ``olmoe_1b_7b`` (4 experts, top 2: ring, paged with
``chunk_len`` 16, the same at capacity factor 0.5, spec k 4 with the
``table`` draft, ``moe_impl="dense"``; router top-k choices that differ
between card and CPU reported with their f32 gap) and a reduced f32
``internvl2_26b`` (8 stub embeddings, prefill and decode): card tokens
must equal the CPU's; and a reduced f32 ``zamba2_7b`` (5 layers, two
shared-block applications, trained-like ``dt_bias``): logits and cache
leaves within 1e-4 of the CPU's scale, two decode launches bit-equal,
graph, eager and CPU greedy tokens equal, the loss and gradients card
against CPU. The kernels phase (11) adds rows 3 and 4 at the
olmoe decode shapes (16 heads over 16 KV heads, dh 128: the ring at B 8,
S 256; the paged at serve_moe's largest paged MoE bucket, page 8), and
train_lm (13) a reduced f32 MoE step, card against CPU, router top-k
choices that differ reported with their f32 gap.

Phases 3, 4 and 6-9 report each run's seconds, decode steps, residency
swaps and captures, and the fleet's graphs (``graphs``: step objects,
graphs captured, host ms of the captures, swaps).

Then a summary line ``{"kernels": [...], "launch_floor_ms": ...}`` (rows
3-5 with ``ms_in_graph_step``, their time per launch inside the
engine's replayed step, row 3 also ``ms_in_moe_graph_step``; rows 1-4
with ``launches_banked``, ``launches_hub``, ``launches_moe`` and
``launches_zamba``, rows 1-3 with ``launches_mesh``, rows 1-2 with
``launches_train_bank``, every row
with ``launches_examples`` and ``launches_encdec`` (0: the family runs
no kernel);
``script_wall_s`` from the start of ``main``), the
raw ``nvidia-smi`` name and power-limit line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result, as it does without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import gc
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


#: the phases ``--only`` can run on their own
ONLY = ("breakdown_moe", "train_lm", "train_sharded", "dryrun",
        "contracts")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="On-chip smoke test of the "
                                 "PyTorch port; with no arguments, every "
                                 "phase.")
    ap.add_argument("--only", type=lambda v: v.split(","), default=None,
                    help=f"comma-separated phases of {', '.join(ONLY)}: "
                    "the env phase and these alone, in that order, then "
                    "the nvidia-smi line and no result line (to time two "
                    "trees of the repo in one call, each with this script "
                    "at its root)")
    args = ap.parse_args(argv)
    if args.only and not set(args.only) <= set(ONLY):
        ap.error(f"--only takes phases of {', '.join(ONLY)}")

    import numpy as np
    import torch

    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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

    if args.only:
        return only_phases(np, torch, dev, ops, args.only, smi)
    emit(reference_phase(np, torch, dev))
    emit(encdec_reference(np, torch, dev))
    serve, shapes = serve_phase(np, torch, dev, ops)
    emit(serve)
    paged = serve_paged_phase(np, torch, dev, ops, shapes)
    emit(paged)
    dense = breakdown_phase(np, torch, dev, shapes)
    emit(dense)
    emit(serve_spec_phase(np, torch, dev, ops, shapes, dense["engine"]))
    banked, fleet = serve_banked_phase(np, torch, dev, ops, shapes)
    emit(banked)
    mesh = serve_mesh_phase(np, torch, dev, ops, shapes, banked, smi)
    emit(mesh)
    hub = serve_hub_phase(np, torch, dev, ops, shapes, fleet, {
        "bank": banked["bank_tick"],
        "single": dense["engine"]["graph_wall_ms_per_step"]})
    emit(hub)
    del fleet                        # the bank's caches and graphs
    gc.collect()
    torch.cuda.empty_cache()
    rwkv, rshapes = serve_rwkv_phase(np, torch, dev, ops, shapes)
    emit(rwkv)
    recur = breakdown_rwkv_phase(np, torch, dev, rshapes)
    emit(recur)
    shapes["rwkv_rows"] = rshapes["decode_rows"]
    del rshapes                      # the last RWKV expert's weights
    gc.collect()
    torch.cuda.empty_cache()
    moe, mshapes = serve_moe_phase(np, torch, dev, ops, shapes)
    emit(moe)
    moe_tick = breakdown_moe_phase(np, torch, dev, mshapes)
    emit(moe_tick)
    shapes["moe"] = {k: mshapes[k] for k in ("cfg", "decode_rows",
                                             "decode_q_pos", "paged")}
    del mshapes                      # the first olmoe expert's weights
    gc.collect()
    torch.cuda.empty_cache()
    zamba, zshapes = serve_zamba_phase(np, torch, dev, ops, shapes)
    emit(zamba)
    emit(breakdown_zamba_phase(np, torch, dev, zshapes))
    del zshapes                      # the first Zamba2 expert's weights
    gc.collect()
    torch.cuda.empty_cache()
    encdec = encdec_phase(np, torch, dev, ops)
    emit(encdec)
    gc.collect()
    torch.cuda.empty_cache()
    kernels, floor = kernel_phase(np, torch, dev, ops, shapes)
    # rows 3-5 inside the engine's replayed step (torch.profiler)
    in_step = {"decode_attention": dense["engine"],
               "paged_decode_attention": dense["engine"]["paged"],
               "wkv_step": recur["engine"]}
    for k in kernels:
        # each kernel's count from the serial run of the path it serves
        run = {"paged_decode_attention": paged,
               "wkv_step": rwkv}.get(k["name"], serve)
        k["launches"] = run["serial"]["launches"][k["name"]]
        # and from serve_moe's graph serial run of that layout
        k["launches_moe"] = moe[
            "paged_runs" if k["name"] == "paged_decode_attention"
            else "ring"]["graph serial"]["launches"][k["name"]]
        # and from serve_zamba's graph serial run (ring)
        k["launches_zamba"] = zamba["runs"]["graph serial"]["launches"][
            k["name"]]
        if k["name"] == "decode_attention":
            k["ms_in_moe_graph_step"] = (
                None if moe_tick["engine"]["decode_attention_kernel"
                                           "_us_per_launch"] is None
                else moe_tick["engine"]["decode_attention_kernel"
                                        "_us_per_launch"] / 1e3)
        for key, phase in (("launches_banked", banked),
                           ("launches_mesh", mesh),
                           ("launches_hub", hub)):
            if k["name"] in phase[key]:
                k[key] = phase[key][k["name"]]
        if k["name"] in in_step:
            eng = in_step[k["name"]]
            us = next(v for key, v in eng.items()
                      if key.endswith("_us_per_launch"))
            k["ms_in_graph_step"] = None if us is None else us / 1e3
            k["graph_step_rows"] = eng["rows"]
    # the training phases, on a card freed of the serve fleets
    shapes.clear()
    gc.collect()
    torch.cuda.empty_cache()
    bank = train_bank_phase(np, torch, dev, ops, make_timers(torch, dev)[1])
    emit(bank)
    emit(train_lm_phase(np, torch, dev, ops))
    emit(train_sharded_phase(np, torch, dev, ops))
    emit(dryrun_phase(np, torch, dev, ops))
    emit(contracts_phase(np, torch, dev, smi))
    emit(launch_serve_phase(np, torch, dev, ops))
    examples = examples_phase(np, torch, dev, ops)
    emit(examples)
    for k in kernels:
        if k["name"] in bank["route_launches"]:
            # launches while routing every client split (train_bank)
            k["launches_train_bank"] = bank["route_launches"][k["name"]]
        # the examples phase's, and the full-width encdec's (none)
        k["launches_examples"] = examples["launches"][k["name"]]
        k["launches_encdec"] = encdec["launches"][k["name"]]
    emit({"kernels": kernels, "launch_floor_ms": min(floor),
          "launch_floor_ms_runs": floor,
          "launch_floor_call": "one-element float32 add_, 8 bytes",
          "script_wall_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def only_phases(np, torch, dev, ops, names, smi) -> int:
    """``--only``: each named phase alone, breakdown_moe on the seeded
    olmoe weights of serve_moe's first expert."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    for name in names:
        if name == "breakdown_moe":
            cfg = get_config("olmoe_1b_7b")
            model = build_model(cfg)
            params = model.init(torch.Generator(device=dev)
                                .manual_seed(SEED + 80), device=dev)
            emit(breakdown_moe_phase(np, torch, dev, {
                "cfg": cfg, "model": model, "params": params}))
            del params
            gc.collect()
            torch.cuda.empty_cache()
        elif name == "contracts":
            emit(contracts_phase(np, torch, dev, smi))
        else:
            phase = {"train_lm": train_lm_phase,
                     "train_sharded": train_sharded_phase,
                     "dryrun": dryrun_phase}[name]
            emit(phase(np, torch, dev, ops))
    print(smi, flush=True)
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
            "new_tokens": 12,
            "paged": paged_reference(np, torch, dev, model, cpu),
            "spec": spec_reference(np, torch, dev, model, cpu, gpu),
            "bank_hub": bank_hub_reference(np, torch, dev, model),
            "rwkv": rwkv_reference(np, torch, dev),
            "moe": moe_reference(np, torch, dev),
            "vlm": vlm_reference(np, torch, dev),
            "zamba": zamba_reference(np, torch, dev)}


def bank_hub_reference(np, torch, dev, model):
    """Four reduced f32 experts (seeded weights) on the card and on the
    CPU, pre-routed traffic (a sweep, then Zipf(``HUB_ZIPF``) over the
    four; prompts of 4-40 tokens, 8 new): once as a bank of four
    (``plan_placement``, a router-less scheduler), once through a hub of
    2 slots whose experts are staged from host memory (no worker: the
    same installs and evictions on both devices). On the card both run
    twice: unsharded, then over a 2-position expert mesh on the card
    (``ExpertMesh((cuda:0,) * 2)``: two members, one slot, a position).
    Card tokens must equal the CPU's exactly, the hub's counters and
    victims too."""
    from repro_torch.core import ExpertRegistry
    from repro_torch.launch.mesh import ExpertMesh
    from repro_torch.serve import (ExpertEngine, ExpertHub, Request,
                                   RoutedServer, Scheduler, SchedulerConfig,
                                   plan_placement)
    cpu = [model.init(torch.Generator().manual_seed(SEED + 40 + i),
                      device="cpu") for i in range(4)]
    rng = np.random.default_rng(SEED + 17)
    p = np.arange(1, 5, dtype=np.float64) ** -HUB_ZIPF
    experts = list(range(4)) + list(rng.choice(4, size=12, p=p / p.sum()))
    reqs = [Request(uid=u, features=np.zeros(784, np.float32),
                    prompt=rng.integers(0, model.cfg.vocab_size, size=int(
                        rng.integers(4, 41))).astype(np.int32),
                    max_new_tokens=8, expert=int(e))
            for u, e in enumerate(experts)]
    out = {}
    mesh = ExpertMesh((torch.device("cuda", 0),) * 2)
    for key, where, m in (("cpu", "cpu", None), ("card", dev, None),
                          ("card_mesh", dev, mesh)):
        reg = ExpertRegistry()
        for i, params in enumerate(cpu):
            reg.add(f"x{i}", ExpertEngine(
                model, params if where == "cpu" else _tree(
                    params, lambda t: t.to(dev)), max_len=64, device=where))
        plan = plan_placement(reg, mesh=m)
        if m is not None and (plan.shards[0].devices != mesh.devices
                              or plan.shards[0].bank.core.per_pos != 2):
            raise AssertionError(f"reference: mesh plan {plan.describe()}")
        sched = Scheduler(None, reg, SchedulerConfig(max_batch=4),
                          placement=plan)
        sched.submit(reqs)
        bank = {r.uid: r.tokens for r in sched.drain()}
        hub = ExpertHub(model, n_slots=2, max_len=64, mesh=m, device=where)
        victims = []
        evict = hub._evict_locked
        hub._evict_locked = lambda e: (victims.append(e), evict(e))[1]
        for i, params in enumerate(cpu):
            hub.add_expert(f"x{i}", params)
        with RoutedServer(None, hub.build_registry(), max_batch=4, hub=hub,
                          check_every=1, device=where) as srv:
            served = {r.uid: r.tokens for r in srv.serve(reqs)}
        out[key] = (bank, served, {**{k: hub.stats.as_dict()[k] for k in (
            "loads", "evictions", "resident_misses")}, "victims": victims})
    for key in ("card", "card_mesh"):
        for i, label in enumerate(("bank", "hub")):
            if not all(np.array_equal(out[key][i][u], out["cpu"][i][u])
                       for u in out["cpu"][i]):
                raise AssertionError(f"reference: {key} {label} tokens "
                                     "differ from the CPU's")
        if out[key][2] != out["cpu"][2] or not out[key][2]["evictions"]:
            raise AssertionError(f"reference: {key} hub counters {out}")
    return {"experts": 4, "requests": len(reqs), "new_tokens": 8,
            "hub_slots": 2, "tokens_equal_cpu": True,
            "mesh_positions": len(mesh.devices),
            "mesh_tokens_equal_cpu": True,
            "hub_counters": out["card"][2]}


def spec_reference(np, torch, dev, model, cpu, gpu):
    """The reduced f32 dense expert speculating on the card (``table``
    draft, k 1 and 4, ring and paged, each verify a replay of its
    bucket's captured graph) against the CPU's plain decode on the same
    weights: three rows of 5-16 token prompts and 17-24 new tokens, one
    wave; the tokens must be equal, every wave must speculate."""
    from repro_torch.serve import ExpertEngine
    rng = np.random.default_rng(SEED + 7)
    prompts = [rng.integers(0, 100, size=n).astype(np.int32)
               for n in (5, 12, 16)]
    caps = [24, 17, 20]

    def drain(eng):
        eng.admit([0, 1, 2], prompts, caps, defer=True)
        while eng.n_active:
            eng.tick(defer=True)
            eng.harvest()
        return dict(eng.poll())

    want = drain(ExpertEngine(model, cpu, max_len=64, device="cpu"))
    out = []
    for layout in ("ring", "paged"):
        for k in (1, 4):
            eng = ExpertEngine(model, gpu, max_len=64, kv_layout=layout,
                               speculate_k=k, draft="table", device=dev)
            got = drain(eng)
            st = eng.stats
            if any(not np.array_equal(got[u], want[u]) for u in want):
                raise AssertionError(f"reference: spec tokens ({layout}, k "
                                     f"{k}) differ from the CPU's plain ones"
                                     f"\n{got}\n{want}")
            if st.spec_fallback_waves or not st.verify_captured:
                raise AssertionError(f"reference: spec ({layout}, k {k}) "
                                     f"{st.as_dict()}")
            out.append({"kv": layout, "k": k,
                        "verify_steps": st.verify_steps,
                        "acceptance_rate": st.acceptance_rate})
    return {"rows": 3, "max_new": caps, "draft": "table",
            "tokens_equal_cpu_plain": True, "cases": out}


def rwkv_reference(np, torch, dev):
    """A reduced f32 ``rwkv6_7b`` expert (``ssm_chunk`` 16) on the card,
    through ``wkv_step``, and on the CPU, through its plain version, from
    the same weights. Model calls: prompts of 8 (scan), 32 (chunked) and
    40 tokens (not a multiple of the chunk: scan), a prefill and four
    decode steps fed the CPU's tokens; engine ``generate`` pads the same
    prompts to buckets 8 (scan), 32 and 64 (chunked). Logits must agree
    within abs 1e-4 x max(|logit|, 1) and greedy tokens be equal."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import ExpertEngine

    cfg = get_config("rwkv6_7b").reduced(name="smoke-rwkv-ref")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(SEED), device="cpu")
    trained_like(torch, cpu, torch.Generator().manual_seed(SEED + 1))
    gpu = _tree(cpu, lambda t: t.to(dev))
    rng = np.random.default_rng(SEED + 7)
    worst, scale, n_steps = 0.0, 0.0, 0
    ops.reset_launches()
    for S in (8, 32, 40):
        toks = rng.integers(0, cfg.vocab_size, size=(3, S)).astype(np.int32)
        lc, cc = model.prefill(cpu, {"tokens": torch.from_numpy(toks)})
        lg, cg = model.prefill(gpu, {"tokens": torch.from_numpy(toks).to(dev)})
        for _ in range(4):
            worst = max(worst, (lg.cpu() - lc).abs().max().item())
            scale = max(scale, lc.abs().max().item())
            tok = lc.argmax(-1).to(torch.int32)[:, None]
            lc, cc = model.decode(cpu, cc, {"token": tok})
            lg, cg = model.decode(gpu, cg, {"token": tok.to(dev)})
            n_steps += 1
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
        for key in ("S", "x_tm", "x_cm"):
            worst = max(worst, (cg[key].cpu() - cc[key]).abs().max().item())
    launches = ops.launches()["wkv_step"]
    if launches != cfg.n_layers * n_steps:
        raise AssertionError(f"reference: wkv_step launched {launches} times "
                             f"for {n_steps} decode steps of {cfg.n_layers} "
                             "layers")
    if not worst <= 1e-4 * max(scale, 1.0):
        raise AssertionError(f"reference: card RWKV logits or states differ "
                             f"from the CPU plain path by {worst} (scale "
                             f"{scale})")
    toks = [rng.integers(0, cfg.vocab_size, size=(3, S)).astype(np.int32)
            for S in (8, 32, 40)]
    want = [ExpertEngine(model, cpu, max_len=64, device="cpu").generate(t, 12)
            for t in toks]
    got = [ExpertEngine(model, gpu, max_len=64, device=dev).generate(t, 12)
           for t in toks]
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"reference: RWKV greedy tokens differ\n{got}\n"
                             f"{want}")
    return {"config": cfg.name, "ssm_chunk": cfg.ssm_chunk,
            "prompt_lens": [8, 32, 40], "model_prefill": ["scan", "chunked",
                                                          "scan"],
            "engine_buckets": [8, 32, 64], "decode_steps": n_steps,
            "wkv_step_launches": launches,
            "max_abs_err": worst, "logits_scale": scale,
            "tol": "abs 1e-4 x max(|logit|, 1), logits and state leaves",
            "tokens_equal": True, "new_tokens": 12}


#: the reduced MoE reference's engine cases: (label, config overrides,
#: engine options). Paged prompts of 20-60 tokens take 2-4 chunks of 16;
#: at factor 0.5 every prefill chunk drops assignments.
MOE_CASES = (
    ("ring", {}, {}),
    ("paged_chunk16", {}, {"kv_layout": "paged", "chunk_len": 16}),
    ("paged_chunk16_factor0.5", {"moe_capacity_factor": 0.5},
     {"kv_layout": "paged", "chunk_len": 16}),
    ("spec_k4_table", {}, {"speculate_k": 4, "draft": "table"}),
    ("dense_impl", {"moe_impl": "dense"}, {}),
)


def route_log(moe_mod, out):
    """Wrap ``moe_mod._route`` so that every call appends its (expert ids,
    probabilities) to ``out``; returns the unwrap function. Only for
    eager model calls: nothing here may run inside a capture."""
    route = moe_mod._route

    def wrapped(params, x2d, cfg):
        w, ids, probs = route(params, x2d, cfg)
        out.append((ids.detach().cpu(), probs.detach().float().cpu()))
        return w, ids, probs
    moe_mod._route = wrapped

    def undo():
        moe_mod._route = route
    return undo


def route_flips(np, cpu_log, card_log):
    """Router top-k choices that differ between the CPU's and the card's
    calls (one entry per token whose ids differ): the call, the token,
    the CPU's and the card's expert at the first differing choice, and
    the gap of their CPU probabilities, absolute and in f32 ulps of the
    larger. A flip is a near tie when that gap is a few ulps."""
    import math
    flips = []
    for i, ((ic, pc), (ig, _)) in enumerate(zip(cpu_log, card_log)):
        diff = np.flatnonzero((ic != ig).any(-1).numpy())
        for t in diff:
            j = int(np.flatnonzero((ic[t] != ig[t]).numpy())[0])
            a, b = int(ic[t, j]), int(ig[t, j])
            pa, pb = float(pc[t, a]), float(pc[t, b])
            ulp = 2.0 ** (math.floor(math.log2(max(pa, pb))) - 23)
            flips.append({"call": i, "token": int(t), "cpu": a, "card": b,
                          "gap": abs(pa - pb), "f32_ulps": abs(pa - pb) / ulp})
    return flips


def moe_reference(np, torch, dev):
    """A reduced f32 ``olmoe_1b_7b`` (4 experts, top 2, capacity dispatch)
    on the card (decode attention through ``decode_attention`` /
    ``paged_decode_attention``, decode and verify steps captured) and on
    the CPU, from the same weights. Model calls: a prefill of 3 x 40
    tokens and four decode steps fed the CPU's tokens, the router's
    top-k logged on both (``route_flips``: any choice that differs is
    reported with its f32 gap), logits within abs 1e-4 x max(|logit|,
    1). Engine cases (``MOE_CASES``): five prompts of 9-60 tokens, 8-12
    new each, one wave; ring, paged with ``chunk_len`` 16 (prompts of
    2-4 chunks, prefix-free), the same at capacity factor 0.5 (drops in
    every chunk, counted), spec k 4 with the ``table`` draft, and
    ``moe_impl="dense"``: card tokens must equal the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import ExpertEngine

    cfg = get_config("olmoe_1b_7b").reduced(name="smoke-moe")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(SEED + 50), device="cpu")
    gpu = _tree(cpu, lambda t: t.to(dev))
    rng = np.random.default_rng(SEED + 13)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 40)).astype(np.int32)
    logs, logits, fed = {}, {}, []
    for where, params in (("cpu", cpu), ("card", gpu)):
        d = "cpu" if where == "cpu" else dev
        logs[where] = []
        undo = route_log(moe_mod, logs[where])
        try:
            lg, c = model.prefill(
                params, {"tokens": torch.from_numpy(toks).to(d)},
                capacity=64)
            logits[where] = [lg.cpu()]
            for i in range(4):
                if where == "cpu":
                    fed.append(lg.argmax(-1).to(torch.int32)[:, None])
                lg, c = model.decode(params, c, {"token": fed[i].to(d)})
                logits[where].append(lg.cpu())
        finally:
            undo()
    worst = max((a - b).abs().max().item()
                for a, b in zip(logits["cpu"], logits["card"]))
    scale = max(a.abs().max().item() for a in logits["cpu"])
    flips = route_flips(np, logs["cpu"], logs["card"])
    if not worst <= 1e-4 * max(scale, 1.0):
        raise AssertionError(f"reference moe: card logits differ from the "
                             f"CPU by {worst} (scale {scale}); router flips "
                             f"{flips}")
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 20, 33, 47, 60)]
    caps = [10, 12, 9, 11, 8]
    cases = []
    for label, kw, eng_kw in MOE_CASES:
        m = build_model(cfg.replace(**kw))
        got, drops = {}, {}
        for where, params in (("cpu", cpu), ("card", gpu)):
            counted = []
            undo = count_drops(torch, moe_mod, counted)
            try:
                # max_len 128: a spec wave of the 60-token prompt (bucket
                # 64) passes the no-wrap gate
                eng = ExpertEngine(m, params, max_len=128, device=where if
                                   where == "cpu" else dev, **eng_kw)
                # blocking admission: every prefill chunk lands first
                eng.admit(list(range(5)), prompts, caps)
                while eng.n_active:
                    eng.tick(defer=True)
                    eng.harvest()
                got[where] = dict(eng.poll())
            finally:
                undo()
            drops[where] = drop_totals(counted)
            st = eng.stats
        if any(not np.array_equal(got["card"][u], got["cpu"][u])
               for u in got["cpu"]):
            raise AssertionError(f"reference moe {label}: card tokens differ "
                                 f"from the CPU's\n{got}\nrouter flips in "
                                 f"the model calls: {flips}")
        if drops["card"] != drops["cpu"]:
            raise AssertionError(f"reference moe {label}: drops {drops}")
        if "0.5" in label and not drops["card"]["dropped"]:
            raise AssertionError(f"reference moe {label}: no drop {drops}")
        if eng_kw.get("speculate_k") and (st.spec_fallback_waves
                                          or not st.verify_captured):
            raise AssertionError(f"reference moe {label}: {st.as_dict()}")
        cases.append({"case": label, "tokens_equal_cpu": True,
                      "prefill_calls": drops["card"]["prefills"],
                      "assignments_routed": drops["card"]["routed"],
                      "assignments_dropped": drops["card"]["dropped"],
                      "suffix_shapes": st.suffix_compiles,
                      "verify_steps": st.verify_steps,
                      "decode_captured": st.decode_captured
                      + st.verify_captured})
    return {"config": cfg.name, "experts": cfg.n_experts,
            "top_k": cfg.experts_per_token,
            "logits_max_abs_err": worst, "logits_scale": scale,
            "logits_tol": "abs 1e-4 x max(|logit|, 1)",
            "router_calls": len(logs["card"]), "router_flips": flips,
            "prompt_lens": [len(p) for p in prompts], "new_tokens": caps,
            "cases": cases}


def count_drops(torch, moe_mod, out):
    """Wrap ``moe_mod._moe_dispatch`` (what ``moe_ffn`` calls) so that
    every call that can drop (a prefill's, not a dropless decode's or
    verify's) appends (T * k assignments, dropped assignments as a device
    tensor): the smoke's own count, nothing added to the package. The
    count is three small kernels per layer of a prefill; nothing is read
    back until ``drop_totals``. Returns the unwrap function."""
    import torch.nn.functional as F
    dispatch = moe_mod._moe_dispatch

    def wrapped(params, x2d, w, ids, cfg, dropless=False):
        if not dropless:
            cap = moe_mod.capacity(cfg, x2d.shape[0], False)
            per = F.one_hot(ids.reshape(-1), num_classes=cfg.n_experts).sum(0)
            # the expert's params: every layer's view shares one storage
            out.append((params["w_gate"].untyped_storage().data_ptr(),
                        cfg.n_layers, x2d.shape[0], ids.numel(),
                        (per - cap).clamp_min(0).sum()))
        return dispatch(params, x2d, w, ids, cfg, dropless)
    moe_mod._moe_dispatch = wrapped

    def undo():
        moe_mod._moe_dispatch = dispatch
    return undo


def drop_totals(counted):
    """``count_drops``' records read back and summed: assignments routed
    and dropped, and per MoE expert (in the order each first ran) its
    prefills, each as [tokens T of the call (padding included),
    assignments dropped over its n_layers layer calls]."""
    per, routed, dropped = {}, 0, 0
    for key, L, T, n, d in counted:
        calls = per.setdefault(key, [])
        d = int(d)
        routed, dropped = routed + n, dropped + d
        if calls and calls[-1][2] < L:
            calls[-1][1] += d
            calls[-1][2] += 1
        else:
            calls.append([T, d, 1])
    prefills = [[[T, d] for T, d, _ in calls] for calls in per.values()]
    return {"prefills": sum(len(c) for c in prefills), "routed": routed,
            "dropped": dropped, "per_expert": prefills}


def vlm_reference(np, torch, dev):
    """A reduced f32 ``internvl2_26b`` (8 stub embeddings prepended) on
    the card and on the CPU from the same weights and stubs: a prefill of
    8 stubs + 24 text tokens (3 rows), then 12 greedy decode steps
    (``decode_attention`` on the card), each side feeding its own argmax:
    tokens must be equal, logits within abs 1e-4 x max(|logit|, 1)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    cfg = get_config("internvl2_26b").reduced(name="smoke-vlm")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(SEED + 60), device="cpu")
    gpu = _tree(cpu, lambda t: t.to(dev))
    rng = np.random.default_rng(SEED + 14)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 24))
                            .astype(np.int32))
    stubs = torch.from_numpy((rng.standard_normal(
        (3, cfg.n_stub_embeds, cfg.d_model)) * 0.1).astype(np.float32))
    out = {}
    ops.reset_launches()
    for where, params in (("cpu", cpu), ("card", gpu)):
        d = "cpu" if where == "cpu" else dev
        lg, c = model.prefill(params, {"tokens": toks.to(d),
                                       "stub_embeds": stubs.to(d)},
                              capacity=64)
        seq, logits = [], [lg.cpu()]
        for _ in range(12):
            tok = lg.argmax(-1).to(torch.int32)[:, None]
            seq.append(tok.cpu())
            lg, c = model.decode(params, c, {"token": tok})
            logits.append(lg.cpu())
        out[where] = (torch.cat(seq, 1).numpy(), logits, int(c["t"]))
    launches = ops.launches()["decode_attention"]
    if not np.array_equal(out["card"][0], out["cpu"][0]):
        raise AssertionError(f"reference vlm: greedy tokens differ\n"
                             f"{out['card'][0]}\n{out['cpu'][0]}")
    worst = max((a - b).abs().max().item()
                for a, b in zip(out["card"][1], out["cpu"][1]))
    scale = max(a.abs().max().item() for a in out["cpu"][1])
    if not worst <= 1e-4 * max(scale, 1.0) or launches != 12 * cfg.n_layers \
            or out["card"][2] != cfg.n_stub_embeds + 24 + 12:
        raise AssertionError(f"reference vlm: logits err {worst} (scale "
                             f"{scale}), decode_attention {launches}, t "
                             f"{out['card'][2]}")
    return {"config": cfg.name, "stub_embeds": cfg.n_stub_embeds,
            "text_tokens": 24, "rows": 3, "new_tokens": 12,
            "tokens_equal": True, "logits_max_abs_err": worst,
            "logits_scale": scale, "decode_attention_launches": launches}


def trained_like(torch, params, gen):
    """Give the RWKV6 leaves its init sets to zero the values of a trained
    checkpoint, in place: token-shift mixes in [0, 1), a small ddlerp LoRA
    input (tanh unsaturated), a bonus ``first_u`` of scale 0.5. At zero
    the bonus, token-shift and ddlerp terms would multiply zero."""
    lay = params["layers"]
    D = lay["maa_x"].shape[-1]
    for name in ("maa_x", "maa_base", "ch_maa_k", "ch_maa_r"):
        lay[name].copy_(torch.rand(lay[name].shape, generator=gen,
                                   device=gen.device))
    lay["maa_w1"].copy_(torch.randn(lay["maa_w1"].shape, generator=gen,
                                    device=gen.device) * (0.5 / D ** 0.5))
    lay["first_u"].copy_(torch.randn(lay["first_u"].shape, generator=gen,
                                     device=gen.device) * 0.5)


def paged_reference(np, torch, dev, model, cpu_params):
    """A paged, chunked RoutedServer of two reduced f32 experts serves
    cohort traffic (scaled down from the serve_paged phase: shared
    prefixes, duplicates, two-chunk prompts, a wrapping duplicate pair)
    on the card, through the kernels, and on the CPU, through their plain
    versions: the greedy tokens must be equal."""
    from repro_torch.core import (ExpertRegistry, ExpertMatcher,
                                  build_matcher, init_ae)
    from repro_torch.serve import ExpertEngine, Request, RoutedServer

    rng = np.random.default_rng(SEED + 3)
    names = ["a", "b"]
    aes = [init_ae(torch.Generator().manual_seed(SEED + i), device="cpu")
           for i in range(2)]
    data = [(rng.random((64, 784), dtype=np.float32), np.arange(64) % 3)
            for _ in names]
    m_cpu = build_matcher(aes, names, data, device="cpu")
    m_dev = ExpertMatcher(_tree(m_cpu.bank_params, lambda t: t.to(dev)),
                          _tree(m_cpu.bank_states, lambda t: t.to(dev)),
                          names, m_cpu.centroids.to(dev),
                          m_cpu.centroid_mask.to(dev))
    cfg = model.cfg
    traffic = cohort_traffic(np, rng, cfg.vocab_size, n_cohorts=2,
                             per_cohort=3, head=16, own=(6, 14),
                             long=(40, 61), wrap=60)
    out = {}
    for key, where, params, matcher in (
            ("cpu", "cpu", cpu_params, m_cpu),
            ("card", dev, _tree(cpu_params, lambda t: t.to(dev)), m_dev)):
        reg = ExpertRegistry()
        for n in names:
            reg.add(n, ExpertEngine(model, params, max_len=64,
                                    kv_layout="paged", chunk_len=32,
                                    device=where))
        srv = RoutedServer(matcher, reg, max_batch=8, executor="serial",
                           prefill_tokens_per_step=32, check_every=1,
                           device=where)
        resps = srv.serve([Request(uid=u, features=f, prompt=p,
                                   max_new_tokens=8)
                           for u, (f, p, _) in enumerate(traffic)])
        out[key] = ([r.tokens for r in resps], [r.expert for r in resps],
                      {k: sum(getattr(reg[e].backend.stats, k)
                              for e in range(2))
                       for k in PREFIX_COUNTERS})
    if out["cpu"][1] != out["card"][1] or not all(
            np.array_equal(a, b) for a, b in zip(out["cpu"][0],
                                                 out["card"][0])):
        raise AssertionError("reference: paged greedy tokens differ between "
                             "the card and the CPU")
    if out["cpu"][2] != out["card"][2]:
        raise AssertionError(f"reference: paged counters differ "
                             f"{out['cpu'][2]} {out['card'][2]}")
    return {"requests": len(traffic), "new_tokens": 8, "chunk_len": 32,
            "tokens_equal": True, "counters": out["card"][2]}


PREFIX_COUNTERS = ("prefill_tokens_submitted", "prefill_tokens_computed",
                   "prefill_rows_computed", "prefix_dup_rows",
                   "prefix_full_hits", "prefix_pages_shared",
                   "pages_copied", "suffix_compiles", "decode_steps",
                   "host_blocks")


def cohort_traffic(np, rng, vocab, *, n_cohorts, per_cohort, head, own,
                   long, wrap):
    """(features, prompt, kind) triples: ``n_cohorts`` cohorts of
    ``per_cohort`` clients sharing a ``head``-token prefix plus ``own``
    tokens of their own, one exact duplicate of each cohort's first
    prompt, two prompts of ``long`` tokens, and two identical prompts of
    ``wrap`` tokens. A cohort and each duplicate pair share one 784-d
    fingerprint, so they route to one expert together: clients of one
    cohort share a data source, the paper's setting."""
    out = []
    for _ in range(n_cohorts):
        f = rng.random(784, dtype=np.float32)
        h = rng.integers(0, vocab, size=head)
        prompts = [np.concatenate([h, rng.integers(
            0, vocab, size=int(rng.integers(own[0], own[1] + 1)))])
            for _ in range(per_cohort)]
        prompts.append(prompts[0].copy())
        out += [(f, p.astype(np.int32), "cohort") for p in prompts]
    for _ in range(2):
        out.append((rng.random(784, dtype=np.float32), rng.integers(
            0, vocab, size=int(rng.integers(long[0], long[1] + 1))).astype(
                np.int32), "long"))
    f = rng.random(784, dtype=np.float32)
    p = rng.integers(0, vocab, size=wrap).astype(np.int32)
    out += [(f, p, "wrap"), (f, p.copy(), "wrap")]
    return out


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree(v, fn) for v in node)
    return fn(node)


# ---------------------------------------------------------------------------
# serve: the main path
# ---------------------------------------------------------------------------

#: the kernels the ring-KV main path runs (serve phase)
RING_PATH = ("expert_score", "cosine_scores", "decode_attention")
DATASETS = [("stl10", 10), ("mnist", 10), ("har", 6), ("reuters", 4),
            ("nlos", 3), ("db", 3)]


#: each serve phase's runs, (captured graphs, executor): the graph runs,
#: then the same requests through the eager step (capture_decode=False)
RUNS = ((True, "serial"), (True, "overlapped"), (False, "serial"),
        (False, "overlapped"))
#: host blocks a serve makes, the executors' promise (PERF.md §2): the
#: same through graphs and eagerly
HOST_BLOCKS = {"serve": {"serial": 176, "overlapped": 11},
               "serve_paged": {"serial": 96, "overlapped": 6},
               "serve_rwkv": {"serial": 192, "overlapped": 12},
               "serve_zamba": {"serial": 192, "overlapped": 12}}
#: engine counters a serve run reports as deltas
DELTAS = ("host_blocks", "decode_steps", "decode_replays", "decode_swaps",
          "decode_captured", "decode_capture_ms")


def warm_graphs(server_cls, matcher, registry, reqs, dev, **kw):
    """Serve ``reqs`` under fresh uids through ``registry`` on a server of
    its own (its router starts cold, as each timed run's does), so every
    decode bucket the timed runs reach is captured before they start."""
    server_cls(matcher, registry, executor="serial", device=dev,
               **kw).serve([dataclasses.replace(q, uid=q.uid + 20_000)
                            for q in reqs])


def engine_delta(engines, before, keys=DELTAS):
    """What one run added to the engines' counters ``keys``."""
    return {k: sum(e.stats.as_dict()[k] - b[k]
                   for e, b in zip(engines, before)) for k in keys}


def graph_stats(engines):
    """The decode step objects of a fleet: how many, how many captured,
    the host ms their captures took, the residency swaps so far."""
    st = [e.stats for e in engines]
    return {"decode_compiles": sum(s.decode_compiles for s in st),
            "captured": sum(s.decode_captured for s in st),
            "capture_ms": sum(s.decode_capture_ms for s in st),
            "swaps": sum(s.decode_swaps for s in st),
            "buckets": sorted({b for s in st for b in s.decode_graphs}),
            "bound": sum(e.core.executable_bounds()["decode"]
                         for e in engines)}


def check_blocks(label, delta, want):
    if delta["host_blocks"] != want:
        raise AssertionError(f"{label}: {delta['host_blocks']} host blocks, "
                             f"{want} before the decode was captured")


def same_tokens(phase, tokens, equal):
    """Every run of the phase (graph and eager, serial and overlapped)
    gave the first run's tokens."""
    (first, want), *rest = tokens.items()
    for label, got in rest:
        if len(got) != len(want) or not all(equal(a, b)
                                            for a, b in zip(got, want)):
            raise AssertionError(f"{phase}: {label} tokens differ from "
                                 f"{first}'s")


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
    # one fleet steps through captured graphs, the other (same weight
    # tensors) eagerly: capture_decode=False
    registry, eager = ExpertRegistry(), ExpertRegistry()
    for i, name in enumerate(names):
        params = model.init(
            torch.Generator(device=dev).manual_seed(SEED + 1 + i),
            device=dev)
        registry.add(name, ExpertEngine(model, params, max_len=256,
                                        device=dev))
        eager.add(name, ExpertEngine(model, params, max_len=256,
                                     device=dev, capture_decode=False))
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
    # and the timed requests' own buckets, so every graph the timed runs
    # replay is captured here (each server's router starts cold)
    warm_graphs(RoutedServer, matcher, registry, reqs, dev)
    engines = [registry[e].backend for e in range(len(registry))]
    want_routes = cpu_routes(np, torch, matcher, reqs)
    runs, tokens = {True: {}, False: {}}, {}
    for capture, executor in RUNS:
        reg = registry if capture else eager
        label = f"{'graph' if capture else 'eager'} {executor}"
        server = RoutedServer(matcher, reg, executor=executor, device=dev)
        fleet = [reg[e].backend for e in range(len(reg))]
        before = [e.stats.as_dict() for e in fleet]
        seen = []
        fine_calls = _record_route(server.router, seen)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        resps = server.serve(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = ops.launches()
        _unrecord_route(server.router)
        chunks = route_chunks(label, fine_calls, launches)
        check_routes(label, want_routes, resps)
        if len(resps) != len(reqs):
            raise AssertionError(f"{label}: {len(resps)} responses "
                                 f"for {len(reqs)} requests")
        for r, q in zip(resps, reqs):
            if r.uid != q.uid or r.tokens.shape != (16,) \
                    or not ((r.tokens >= 0)
                            & (r.tokens < cfg.padded_vocab)).all():
                raise AssertionError(f"{label}: bad response {r}")
        delta = engine_delta(fleet, before)
        steps = delta["decode_steps"]
        if not all(launches[k] for k in RING_PATH):
            raise AssertionError(f"{label}: a kernel never launched on "
                                 f"the main path: {launches}")
        if launches["paged_decode_attention"] or launches["wkv_step"]:
            raise AssertionError(f"{label}: the paged or RWKV kernel ran "
                                 f"on the dense ring path: {launches}")
        if launches["decode_attention"] != cfg.n_layers * steps:
            raise AssertionError(
                f"{label}: decode_attention launched "
                f"{launches['decode_attention']} times for {steps} decode "
                f"steps of {cfg.n_layers} layers")
        check_blocks(label, delta, HOST_BLOCKS["serve"][executor])
        n_tok = sum(len(r.tokens) for r in resps)
        tokens[label] = [r.tokens for r in resps]
        runs[capture][executor] = {
            "seconds": dt, "req_per_s": len(resps) / dt,
            "generated_tok_per_s": n_tok / dt, "tokens": n_tok,
            **delta, "launches": launches, "route_chunks": chunks,
            "routed": sorted({r.expert for r in resps}),
        }
        if capture and executor == "serial":
            if len(seen) != 1 or seen[0][1] or chunks != 1:
                raise AssertionError(f"serial: {len(seen)} route calls, "
                                     f"{chunks} chunks; expected one chunk "
                                     "of misses")
            chunk_top1 = seen[0][2]
    same_tokens("serve", tokens, lambda a, b: np.array_equal(a, b))
    # the shapes the main path gave each kernel: the serial run's first
    # route chunk (all 24 rows missed its fresh router's LRU)
    row_buckets = server.router.row_buckets
    experts, counts = np.unique(chunk_top1, return_counts=True)
    groups = [(int(e), int(n), bucket_for(int(n), row_buckets))
              for e, n in zip(experts, counts)]
    shapes = {
        "route_rows": bucket_for(len(reqs), row_buckets),
        "group_rows": max(nb for _, _, nb in groups),
        "route_groups": groups,
        "decode_rows": max(max(e.stats.decode_graphs, default=1)
                           for e in engines),
        # q_pos of the last decode step of the longest prompt bucket: the
        # fullest ring the main path gave the decode kernel
        "decode_q_pos": max(sb for e in engines
                            for _, sb in e.core._prefill_shapes) + 16 - 2,
        "n_classes": int(matcher.centroids.shape[1]),
        "max_len": 256, "cfg": cfg, "engine": engines[0],
        "matcher": matcher, "registry": registry, "requests": reqs,
    }
    return ({"phase": "serve", "config": cfg.name, "experts": len(names),
             "requests": len(reqs), "max_new_tokens": 16,
             "prompt_len": [8, 64], "kv": "ring", "max_len": 256,
             "param_gb": mem_gb, "tokens_equal": True,
             "tokens_equal_graph_eager": True, "routes_equal_cpu": True,
             "serial": runs[True]["serial"],
             "overlapped": runs[True]["overlapped"], "eager": runs[False],
             "graphs": graph_stats(engines),
             "kernel_shapes": {k: v for k, v in shapes.items()
                               if k not in ("cfg", "engine", "matcher",
                                            "registry", "requests")}},
            shapes)


# ---------------------------------------------------------------------------
# serve_paged: the paged-KV path
# ---------------------------------------------------------------------------


def serve_paged_phase(np, torch, dev, ops, shapes):
    """Six paged ``llama3_2_1b`` engines at published widths behind the
    serve phase's matcher, sharing its engines' weight tensors (no second
    copy): page 8, ``max_len`` 256, the default pool of 3 x 16 x 32 =
    1536 pages + trash per expert, ``chunk_len`` 64, 64 prompt tokens of
    pending chunks per shard per step. 24 requests of 16 new tokens: 4
    cohorts of 4 (a 48-token prefix + 8-16 own tokens, bucket 64), one
    exact duplicate per cohort, 2 prompts of 100-128 tokens (two chunks)
    and 2 identical 180-token prompts (four chunks; decode wraps into
    their prompt pages, so copy-on-write)."""
    from repro_torch.core import ExpertRegistry
    from repro_torch.serve import ExpertEngine, Request, RoutedServer

    cfg, matcher, ring = shapes["cfg"], shapes["matcher"], shapes["registry"]
    model = shapes["engine"].model
    rng = np.random.default_rng(SEED + 5)
    traffic = cohort_traffic(np, rng, cfg.vocab_size, n_cohorts=4,
                             per_cohort=4, head=48, own=(8, 16),
                             long=(100, 128), wrap=180)
    assert len(traffic) == 24

    def requests(uid0, tr=traffic):
        return [Request(uid=uid0 + u, features=f, prompt=p,
                        max_new_tokens=16) for u, (f, p, _) in enumerate(tr)]

    # warm-up traffic: the same fingerprints, prompt lengths, shared
    # prefixes and duplicates as the timed requests, every token shifted
    # by one, so it reaches the same decode buckets (captured here) and
    # none of its prefixes is one of the timed requests'
    warm = [(f, (p + 1) % cfg.vocab_size, k) for f, p, k in traffic]

    def fleet(capture):
        """Six fresh paged engines (an empty prefix cache), warmed."""
        reg = ExpertRegistry()
        for e in range(len(ring)):
            reg.add(ring[e].name, ExpertEngine(
                model, ring[e].backend.params, max_len=256,
                kv_layout="paged", page_size=8, chunk_len=64, device=dev,
                capture_decode=capture))
        warm_graphs(RoutedServer, matcher, reg, requests(0, warm), dev,
                    prefill_tokens_per_step=64)
        torch.cuda.synchronize()
        return reg

    want_routes = cpu_routes(np, torch, matcher, requests(0))

    def run(server, reg, uid0, label):
        engines = [reg[e].backend for e in range(len(reg))]
        before = [e.stats.as_dict() for e in engines]
        seen, routed = [], []
        for e in engines:
            e.core._decode_step = _record_decode(e.core, seen)
        fine_calls = _record_route(server.router, routed)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        resps = server.serve(requests(uid0))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = ops.launches()
        for e in engines:
            del e.core._decode_step
        _unrecord_route(server.router)
        chunks = route_chunks(label, fine_calls, launches)
        check_routes(label, want_routes, resps)
        delta = engine_delta(engines, before, [
            k for k in dict.fromkeys(DELTAS + PREFIX_COUNTERS)
            if k != "suffix_compiles"])
        delta["suffix_shapes"] = sum(e.stats.suffix_compiles
                                     for e in engines)
        for r, (f, p, _) in zip(resps, traffic):
            if r.tokens.shape != (16,) or not (
                    (r.tokens >= 0) & (r.tokens < cfg.padded_vocab)).all():
                raise AssertionError(f"{label}: bad response {r}")
        steps = delta["decode_steps"]
        if launches["paged_decode_attention"] != cfg.n_layers * steps:
            raise AssertionError(
                f"{label}: paged_decode_attention launched "
                f"{launches['paged_decode_attention']} times for {steps} "
                f"paged decode steps of {cfg.n_layers} layers")
        if launches["decode_attention"]:
            raise AssertionError(f"{label}: the ring decode kernel ran on "
                                 f"the paged path: {launches}")
        for e in engines:
            pool = e.core.pool
            pool.check()
            cached = sum(1 for k in e.core.prefix_cache._lru if k[0] == "pg")
            if pool.used_count(0) != cached:
                raise AssertionError(f"{label}: {pool.used_count(0)} pages "
                                     f"in use after the drain, {cached} "
                                     "held by the prefix cache")
        n_tok = sum(len(r.tokens) for r in resps)
        # the largest decode bucket and the most live slots kernel 4 read
        # at it: slots with 0 <= pos < t after the step, t = q_pos + 1
        rows = max(r_ for r_, _, _ in seen)
        live = max(int(((p >= 0) & (p < t[:, None])).sum(-1).max())
                   for r_, p, t in seen if r_ == rows)
        return resps, {
            "seconds": dt, "req_per_s": len(resps) / dt,
            "generated_tok_per_s": n_tok / dt, "tokens": n_tok,
            "launches": launches, "route_chunks": chunks, **delta,
            "routed": sorted({r.expert for r in resps}),
            "pages_in_use_after": sum(e.core.pool.used_count(0)
                                      for e in engines),
            "decode_rows_max": rows, "live_slots_at_max_rows": live}

    runs, resps, graphs = {True: {}, False: {}}, {}, {}
    for capture, executor in RUNS:
        label = f"{'graph' if capture else 'eager'} {executor}"
        reg = fleet(capture)
        srv = RoutedServer(matcher, reg, executor=executor,
                           prefill_tokens_per_step=64, device=dev)
        resps[label], r = run(srv, reg, 0, label)
        check_blocks(label, r, HOST_BLOCKS["serve_paged"][executor])
        if not (r["prefix_dup_rows"] and r["pages_copied"]
                and r["suffix_shapes"] and r["route_chunks"]
                and r["prefill_tokens_computed"]
                < r["prefill_tokens_submitted"]):
            raise AssertionError(f"{label}: a paged counter did not move: "
                                 f"{r}")
        runs[capture][executor] = r
        if capture and executor == "overlapped":
            _, again = run(srv, reg, 100, "again")
            if not again["prefix_full_hits"]:
                raise AssertionError(f"the repeat run hit no cached prefix: "
                                     f"{again}")
            n_pages = reg[0].backend.core.pool.n_pages
            pool_bytes = sum(t.numel() * t.element_size()
                             for part in reg[0].backend.core.kv_pool
                             for t in part.values())
        if capture:
            graphs[executor] = graph_stats(
                [reg[e].backend for e in range(len(reg))])
        del srv, reg
    same_tokens("serve_paged", {k: [(r.expert, r.tokens) for r in v]
                                for k, v in resps.items()},
                lambda a, b: a[0] == b[0] and np.array_equal(a[1], b[1]))
    serial, resp_s = runs[True]["serial"], resps["graph serial"]

    # the same requests through the ring engines, serial: tokens and time
    # reported, not asserted (bf16 at full width: the packed paged
    # prefills run other shapes)
    ring_srv = RoutedServer(matcher, ring, executor="serial", device=dev)
    steps0 = sum(ring[e].backend.stats.decode_steps for e in range(len(ring)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp_r = ring_srv.serve(requests(0))
    torch.cuda.synchronize()
    ring_run = {"seconds": time.perf_counter() - t0, "decode_steps": sum(
        ring[e].backend.stats.decode_steps for e in range(len(ring))) - steps0}
    kinds = [k for _, _, k in traffic]
    same = [bool(np.array_equal(a.tokens, b.tokens))
            for a, b in zip(resp_s, resp_r)]
    cohort = [s_ for s_, k in zip(same, kinds) if k == "cohort"]
    # the shapes kernel 4 saw in the serial run: its largest decode
    # bucket, at the fullest live-slot count any step of that bucket had
    shapes["paged"] = {"rows": serial["decode_rows_max"],
                       "live": serial["live_slots_at_max_rows"],
                       "n_pages": n_pages, "page": 8, "n_logical": 32}
    shapes["paged_traffic"] = traffic
    shapes["paged_tokens"] = [r.tokens for r in resp_s]
    return {"phase": "serve_paged", "config": cfg.name,
            "experts": len(ring), "requests": len(traffic),
            "max_new_tokens": 16, "kv": "paged", "page": 8, "max_len": 256,
            "chunk_len": 64, "prefill_tokens_per_step": 64,
            "pool_pages_per_expert": n_pages,
            "pool_gb": pool_bytes * len(ring) / 1e9,
            "traffic": {k: kinds.count(k) for k in sorted(set(kinds))},
            "tokens_equal_serial_overlapped": True,
            "tokens_equal_graph_eager": True, "routes_equal_cpu": True,
            "serial": serial, "overlapped": runs[True]["overlapped"],
            "eager": runs[False], "again": again,
            "graphs": graphs,
            "ring_serial_same_traffic": ring_run,
            "ring_equal_share_cohort": sum(cohort) / len(cohort),
            "ring_equal_share_all": sum(same) / len(same),
            "kernel_shape": shapes["paged"]}


# ---------------------------------------------------------------------------
# breakdown: where one decode step's time goes
# ---------------------------------------------------------------------------


def breakdown_phase(np, torch, dev, shapes):
    """One wave's decode step at the main path's largest batch bucket:
    wall time per step (host clock, synchronised, eager), device time per
    step (the same step captured once in a CUDA graph and replayed, so no
    host gap is timed), and the kernels one eager step launches, from
    ``torch.profiler``. Device busy share = graph time / eager wall. Then
    the engine's own tick of such a wave, host-synchronised, through its
    bucket's captured graph and eagerly (``engine_step``), on the ring and
    on the paged layout (at serve_paged's largest decode bucket)."""
    eng = shapes["engine"]
    model, params = eng.model, eng.params
    B, Sb, n = shapes["decode_rows"], 64, 20
    timed = bare_decode_step(np, torch, dev, model, params, B, Sb, n)
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       _leaves(params))
    ps = shapes["paged"]
    engine = engine_step(np, torch, dev, model, params, B, Sb, n,
                         "decode_attention_kernel")
    engine["paged"] = engine_step(
        np, torch, dev, model, params, ps["rows"], Sb, n,
        "decode_attention_kernel", kv_layout="paged", page_size=ps["page"],
        chunk_len=64)
    return {"phase": "breakdown", "rows": B, "prompt_len": Sb,
            "cache_len": shapes["max_len"], **timed, "engine": engine,
            "weight_gb": weight_bytes / 1e9,
            "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3}


def bare_decode_step(np, torch, dev, model, params, B, Sb, n):
    """``step_times`` of one decode step of a ``DecoderLM`` wave of B rows
    prefilled with Sb seeded tokens (ring of 256 slots), restarted from
    the same position each call (the decode advances pos/t in place),
    with ``decode_attention``'s ms a step and share of the kernel time
    and the six largest kernels."""
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, size=(B, Sb)).astype(np.int32)).to(dev)
    _, cache = model.prefill(params, {"tokens": toks}, capacity=256)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    pos0, t0_ = cache["pos"].clone(), cache["t"].clone()

    def step():
        cache["pos"].copy_(pos0)
        cache["t"].copy_(t0_)
        return model.decode(params, cache, {"token": tok})[0]

    timed = step_times(torch, step, n)
    by_name = timed.pop("by_name")
    del timed["launches_by_name"]
    attn_ms = sum(v for k, v in by_name.items()
                  if "decode_attention_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {**timed, "decode_attention_ms_per_step": attn_ms,
            "decode_attention_share_of_kernel_ms":
                attn_ms / timed["profiler_kernel_ms_per_step"],
            "profiler_top_kernels_ms": [[k[:60], v] for k, v in top]}


def engine_step(np, torch, dev, model, params, B, Sb, n, needle, **kw):
    """The engine's own decode tick of one resident wave (B rows, prompts
    of Sb tokens): wall ms per tick, host-synchronised, median of ``n``
    ticks once the bucket's graph is captured (``graph``), and of an
    engine with ``capture_decode=False`` (``eager``); from
    ``torch.profiler`` over three replayed ticks, the kernels a tick
    runs and the ms per launch of those whose name holds ``needle``
    (None where the trace shows none)."""
    from repro_torch.serve import ExpertEngine
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 2)
    prompts = list(rng.integers(0, model.cfg.vocab_size, size=(B, Sb))
                   .astype(np.int32))
    out = {"rows": B, "prompt_len": Sb}
    for capture in (True, False):
        eng = ExpertEngine(model, params, max_len=256, device=dev,
                           capture_decode=capture, **kw)
        eng.admit(list(range(B)), prompts, [n + 8] * B, defer=True)
        for _ in range(2):            # eager first step; capture + replay
            eng.tick(defer=True)
        torch.cuda.synchronize()
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            eng.tick(defer=True)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        key = "graph" if capture else "eager"
        out[f"{key}_wall_ms_per_step"] = statistics.median(walls)
        out[f"{key}_wall_ms_runs"] = [min(walls), max(walls)]
        if capture:
            # a speculative engine's tick is a verify
            out["captured"] = (eng.stats.decode_captured
                               + eng.stats.verify_captured)
            out["capture_ms"] = (eng.stats.decode_capture_ms
                                 + eng.stats.verify_capture_ms)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    eng.tick(defer=True)
                torch.cuda.synchronize()
            kern = [ev for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA]
            mine = [ev.time_range.elapsed_us() for ev in kern
                    if needle in ev.name]
            out["graph_kernels_per_step"] = len(kern) / 3
            out["graph_kernel_ms_per_step"] = sum(
                ev.time_range.elapsed_us() for ev in kern) / 3e3
            out[f"{needle}_launches_per_step"] = len(mine) / 3
            out[f"{needle}_us_per_launch"] = (sum(mine) / len(mine)
                                              if mine else None)
            # where a replayed tick's kernel time goes: [name, ms a step,
            # launches a step] of the six largest
            by_name = {}
            for ev in kern:
                t = by_name.setdefault(ev.name[:60], [0.0, 0])
                t[0] += ev.time_range.elapsed_us() / 3e3
                t[1] += 1
            out["graph_top_kernels"] = [
                [k, v[0], v[1] / 3] for k, v in
                sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]]
        del eng
    out["graph_over_eager"] = (out["graph_wall_ms_per_step"]
                               / out["eager_wall_ms_per_step"])
    return out


def step_times(torch, step, n):
    """Eager wall ms per call of ``step`` (median of ``n``, synchronised),
    device ms per call (captured once in a CUDA graph, replayed ``n``
    times), device busy share, and the kernels three eager calls launch
    (``torch.profiler``): count and ms per step, ms by kernel name."""
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
    by_name, count = {}, {}
    for ev in kern:
        by_name[ev.name] = by_name.get(ev.name, 0.0) \
            + ev.time_range.elapsed_us() / 3e3
        count[ev.name] = count.get(ev.name, 0) + 1
    return {"steps_timed": n, "wall_ms_per_step": wall,
            "graph_device_ms_per_step": device,
            "device_busy_share": device / wall,
            "profiler_kernels_per_step": len(kern) / 3,
            "profiler_kernel_ms_per_step": sum(by_name.values()),
            "by_name": by_name,
            "launches_by_name": {k: c / 3 for k, c in count.items()}}


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


# ---------------------------------------------------------------------------
# serve_spec: speculative decoding on the main path
# ---------------------------------------------------------------------------

#: the speculative engines' draft length and draft
SPEC_K = 4
SPEC_DRAFT = "table"
#: the widest plain top-2 gap, in bf16 ulps of the top logit, at which a
#: spec row may take the other token: the verify's GEMMs run at M = Bb (k
#: + 1) and its attention is plain, where plain decode runs M = Bb and
#: the decode kernel, so the paths' bf16 logits differ by rounding. The
#: flips seen on an H100 80GB HBM3 at 700 W lie at 0, 1 and 2 ulps
#: (PERF.md §6)
TIE_ULPS = 2
#: engine counters a spec run reports as deltas
SPEC_DELTAS = DELTAS + ("verify_steps", "tokens_drafted", "tokens_accepted",
                        "spec_fallback_waves", "verify_captured",
                        "verify_capture_ms", "tokens_generated")


def spec_traffic(np, rng, n):
    """The reference bench's decode-heavy speculative traffic
    (``benchmarks/serving_bench.py``, ``speculative_requests``): prompts
    of 3-16 tokens over ids 0-99, 32-64 new tokens each, as (features,
    prompt, max_new). At ``max_len`` 256 every wave passes the no-wrap
    gate: Sb <= 16 and steps <= 63, so Sb + steps + k < 256."""
    return [(rng.random(784, dtype=np.float32),
             rng.integers(0, 100, size=int(rng.integers(3, 17))).astype(
                 np.int32), int(rng.integers(32, 65))) for _ in range(n)]


def _record_waves(core, out):
    """Wrap ``core.admit_wave`` on the instance: ``out`` maps each
    admitted uid to its wave — the model, its expert's params, the cache
    capacity, the prompts of its expert's group, the wave's batch and
    length buckets — and its row in the group."""
    admit = core.admit_wave

    def wrapped(groups, **kw):
        rows = [g for g in groups.values() if g[0]]
        Bb, Sb = core.pad_shape(max(len(g[0]) for g in rows),
                                max(len(p) for g in rows for p in g[1]))
        for local, (uids, prompts, _) in groups.items():
            for i, u in enumerate(uids):
                out[u] = (core.model, core.params[local], core.max_len,
                          list(prompts), Bb, Sb, i)
        return admit(groups, **kw)
    core.admit_wave = wrapped


def near_tie(np, torch, dev, wave, want, d):
    """The plain path's top-2 logits at position ``d`` of one row: its
    wave (prompts padded to the wave's buckets, as the engine pads them)
    prefilled and decoded eagerly at the served shapes, the row fed its
    served plain tokens ``want`` (GEMM and attention rows do not read
    other rows, which are fed 0). ``exact`` says the replay's argmax
    gave the served tokens up to and including ``d``. Returns (gap, one
    bf16 ulp of the top logit, top-2 ids, exact)."""
    import math
    model, params, max_len, prompts, Bb, Sb, row = wave
    toks = np.zeros((Bb, Sb), np.int32)
    for i, p in enumerate(prompts):
        p = np.asarray(p, np.int32)[-Sb:]
        toks[i, :len(p)] = p
    logits, cache = model.prefill(
        params, {"tokens": torch.from_numpy(toks).to(dev)},
        capacity=max_len)
    got = [int(logits[row].argmax())]
    for i in range(d):
        tok = torch.zeros((Bb, 1), dtype=torch.int32, device=dev)
        tok[row, 0] = int(want[i])
        logits, cache = model.decode(params, cache, {"token": tok})
        got.append(int(logits[row].argmax()))
    top = logits[row].float().topk(2)
    v = top.values.tolist()
    ulp = 2.0 ** (math.floor(math.log2(abs(v[0]))) - 7)
    return (v[0] - v[1], ulp, top.indices.tolist(),
            got == [int(t) for t in want[:d + 1]])


def tie_rows(np, torch, dev, got, ref, waves):
    """Hold responses ``got`` row by row to a reference run's ``ref``,
    whose waves ``waves`` recorded (``_record_waves``): (rows equal,
    differing rows, the differing rows that are not a near tie). A near
    tie: at the first differing position the two tokens are the
    reference run's top 2 (its wave replayed exactly), at most
    ``TIE_ULPS`` bf16 ulps apart."""
    ties, same = [], 0
    for r, p in zip(got, ref):
        if np.array_equal(r.tokens, p.tokens):
            same += 1
            continue
        d = int(np.flatnonzero(r.tokens != p.tokens)[0])
        gap, ulp, top2, exact = near_tie(np, torch, dev, waves[p.uid],
                                         p.tokens, d)
        ties.append({"uid": r.uid, "position": d, "ref": int(p.tokens[d]),
                     "got": int(r.tokens[d]), "ref_top2": top2,
                     "top2_gap": gap, "bf16_ulp": ulp,
                     "replay_exact": exact})
    bad = [t for t in ties if not t["replay_exact"]
           or {t["ref"], t["got"]} != set(t["ref_top2"])
           or t["top2_gap"] > TIE_ULPS * t["bf16_ulp"]]
    return same, ties, bad


def serve_spec_phase(np, torch, dev, ops, shapes, plain_engine):
    """Speculative decoding at full width: six spec ``llama3_2_1b``
    engines (``speculate_k`` 4, the bigram ``table`` draft, ring,
    ``max_len`` 256) sharing the serve phase's weight tensors, behind its
    matcher, serving the reference bench's decode-heavy traffic (24
    requests, prompts of 3-16 tokens, 32-64 new): graph serial, graph
    overlapped, eager serial, eager overlapped, each fleet warmed by the
    same requests with every prompt token shifted by one (the same
    buckets captured; the table draft learns on the warm-up, as it keeps
    learning for an engine's lifetime). Every run's tokens must equal the
    first's; no wave may fall back; routes equal the CPU's;
    ``expert_score`` / ``cosine_scores`` once per route chunk and no
    decode kernel in a verify. Then the serve phase's plain graph fleet
    on the same traffic (warmed the same way), serial and overlapped:
    decoded tok/s of spec against plain, and the tokens row by row — a
    row may differ only where, at the first differing position, the two
    tokens are the plain path's top 2 at most ``TIE_ULPS`` bf16 ulps apart
    (the verify's GEMMs run
    at M = Bb (k+1), plain decode's at M = Bb). Then one paged spec run
    (page 8, graph, overlapped), one ``always-wrong`` wave (acceptance 0,
    max(max_new) - 1 verifies), and the engine's own verify tick of one
    resident wave at the breakdown phase's bucket, replayed and eager."""
    from repro_torch.core import ExpertRegistry
    from repro_torch.serve import ExpertEngine, Request, RoutedServer

    cfg, matcher, ring = shapes["cfg"], shapes["matcher"], shapes["registry"]
    model = shapes["engine"].model
    rng = np.random.default_rng(SEED + 9)
    traffic = spec_traffic(np, rng, 24)
    warm = [(f, (p + 1) % 100, m) for f, p, m in traffic]
    decoded = sum(m - 1 for _, _, m in traffic)

    def requests(uid0, tr=traffic):
        return [Request(uid=uid0 + u, features=f, prompt=p, max_new_tokens=m)
                for u, (f, p, m) in enumerate(tr)]

    def fleet(capture=True, **kw):
        """Six spec engines on the serve phase's weights, warmed."""
        reg = ExpertRegistry()
        for e in range(len(ring)):
            reg.add(ring[e].name, ExpertEngine(
                model, ring[e].backend.params, max_len=256, device=dev,
                capture_decode=capture, speculate_k=SPEC_K, draft=SPEC_DRAFT,
                **kw))
        RoutedServer(matcher, reg, executor="serial", device=dev,
                     speculate_k=SPEC_K).serve(requests(20_000, warm))
        torch.cuda.synchronize()
        return reg

    want_routes = cpu_routes(np, torch, matcher, requests(0))

    def run(reg, executor, label, paged=False, spec=True):
        engines = [reg[e].backend for e in range(len(reg))]
        server = RoutedServer(matcher, reg, executor=executor, device=dev,
                              speculate_k=SPEC_K if spec else 0)
        before = [e.stats.as_dict() for e in engines]
        fine_calls = _record_route(server.router, [])
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        resps = server.serve(requests(0))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = ops.launches()
        _unrecord_route(server.router)
        chunks = route_chunks(label, fine_calls, launches)
        check_routes(label, want_routes, resps)
        for r, (_, _, m) in zip(resps, traffic):
            if r.tokens.shape != (m,) or not (
                    (r.tokens >= 0) & (r.tokens < cfg.padded_vocab)).all():
                raise AssertionError(f"{label}: bad response {r}")
        d = engine_delta(engines, before, SPEC_DELTAS)
        plain_steps = d["decode_steps"] - d["verify_steps"]
        attn, other = ("paged_decode_attention", "decode_attention") \
            if paged else ("decode_attention", "paged_decode_attention")
        if launches[attn] != cfg.n_layers * plain_steps or launches[other] \
                or launches["wkv_step"]:
            raise AssertionError(
                f"{label}: {launches} for {plain_steps} plain decode steps "
                f"of {cfg.n_layers} layers")
        if spec and (d["spec_fallback_waves"] or not d["verify_steps"]):
            raise AssertionError(f"{label}: {d['spec_fallback_waves']} "
                                 f"fallback waves, {d['verify_steps']} "
                                 "verifies on the bench geometry")
        out = {"seconds": dt, "req_per_s": len(resps) / dt,
               "decoded_tokens": decoded, "decoded_tok_per_s": decoded / dt,
               "generated_tok_per_s": sum(len(r.tokens) for r in resps) / dt,
               **d, "launches": launches, "route_chunks": chunks}
        if spec:
            out["acceptance_rate"] = (d["tokens_accepted"]
                                      / max(d["tokens_drafted"], 1))
            out["tokens_per_verify"] = decoded / d["verify_steps"]
            out["tokens_per_row_verify"] = decoded / (d["tokens_drafted"]
                                                      / SPEC_K)
        return resps, out

    runs, tokens, graphs = {True: {}, False: {}}, {}, {}
    for capture, executor in RUNS:
        label = f"{'graph' if capture else 'eager'} {executor}"
        if executor == "serial":
            reg = fleet(capture)
        resps, r = run(reg, executor, label)
        if capture and r["verify_captured"]:
            raise AssertionError(f"{label}: a verify graph was captured in "
                                 "a timed run, not in the warm-up")
        runs[capture][executor] = r
        tokens[label] = [x.tokens for x in resps]
        if capture and executor == "overlapped":
            spec_resps = resps
            st = [reg[e].backend.stats for e in range(len(reg))]
            graphs = {"verify_compiles": sum(s.verify_compiles for s in st),
                      "verify_captured": sum(s.verify_captured for s in st),
                      "verify_capture_ms": sum(s.verify_capture_ms
                                               for s in st),
                      "decode_compiles": sum(s.decode_compiles for s in st),
                      "swaps": sum(s.decode_swaps for s in st),
                      "bound": sum(reg[e].backend.core.executable_bounds()[
                          "verify"] for e in range(len(reg)))}
            if graphs["verify_captured"] != graphs["verify_compiles"] or \
                    graphs["verify_compiles"] > graphs["bound"]:
                raise AssertionError(f"verify graphs: {graphs}")
    same_tokens("serve_spec", tokens, lambda a, b: np.array_equal(a, b))
    del reg

    # the plain graph fleet of the serve phase on the same traffic
    RoutedServer(matcher, ring, executor="serial", device=dev).serve(
        requests(30_000, warm))
    waves = {}
    cores = [ring[e].backend.core for e in range(len(ring))]
    for c in cores:
        _record_waves(c, waves)
    plain = {}
    for executor in ("serial", "overlapped"):
        plain_resps, plain[executor] = run(ring, executor,
                                           f"plain {executor}", spec=False)
    for c in cores:
        del c.admit_wave
    same, ties, bad = tie_rows(np, torch, dev, spec_resps, plain_resps,
                               waves)

    # one paged spec run (page 8, no chunking: the gate lets every wave in)
    preg = fleet(True, kv_layout="paged", page_size=8)
    presps, paged = run(preg, "overlapped", "paged", paged=True)
    for e in range(len(preg)):
        core = preg[e].backend.core
        core.pool.check()
        cached = sum(1 for k in core.prefix_cache._lru if k[0] == "pg")
        if core.pool.used_count(0) != cached:
            raise AssertionError(f"paged spec: {core.pool.used_count(0)} "
                                 f"pages in use, {cached} cached")
    paged["equal_share_ring_spec"] = sum(
        bool(np.array_equal(a.tokens, b.tokens))
        for a, b in zip(presps, spec_resps)) / len(presps)
    del preg

    # one always-wrong wave beside the same wave through the table draft
    prompts = [p for _, p, _ in traffic[:4]]
    caps = [m for _, _, m in traffic[:4]]
    wave = {}
    for draft in ("always-wrong", SPEC_DRAFT):
        eng = ExpertEngine(model, ring[0].backend.params, max_len=256,
                           device=dev, speculate_k=SPEC_K, draft=draft)
        eng.admit(list(range(4)), prompts, caps, defer=True)
        while eng.n_active:
            eng.tick(defer=True)
            eng.harvest()
        wave[draft] = (dict(eng.poll()), eng.stats)
    got, st = wave["always-wrong"]
    if st.tokens_accepted or not st.tokens_drafted \
            or st.verify_steps != max(caps) - 1:
        raise AssertionError(f"always-wrong: {st.as_dict()}")
    always = {"rows": 4, "max_new": caps, "verify_steps": st.verify_steps,
              "tokens_drafted": st.tokens_drafted,
              "acceptance_rate": st.acceptance_rate,
              "tokens_equal_table_draft": all(
                  np.array_equal(got[u], wave[SPEC_DRAFT][0][u])
                  for u in range(4)),
              "table_draft_verify_steps": wave[SPEC_DRAFT][1].verify_steps}

    # the engine's own verify tick (breakdown's wave: B rows, 64-token
    # prompts), replayed and eager
    B = plain_engine["rows"]
    tick = engine_step(np, torch, dev, model, ring[0].backend.params, B, 64,
                       20, "gemm", speculate_k=SPEC_K, draft=SPEC_DRAFT)
    tick["plain_graph_wall_ms_per_step"] = plain_engine[
        "graph_wall_ms_per_step"]
    tick["verify_over_plain_replayed"] = (tick["graph_wall_ms_per_step"]
                                          / plain_engine[
                                              "graph_wall_ms_per_step"])
    g = runs[True]["overlapped"]
    out = {"phase": "serve_spec", "config": cfg.name,
            "experts": len(ring), "requests": len(traffic),
            "speculate_k": SPEC_K, "draft": SPEC_DRAFT, "kv": "ring",
            "max_len": 256, "prompt_len": [3, 16], "max_new_tokens": [32, 64],
            "decoded_tokens": decoded, "tokens_equal": True,
            "tokens_equal_graph_eager": True, "routes_equal_cpu": True,
            "serial": runs[True]["serial"], "overlapped": g,
            "eager": runs[False], "graphs": graphs,
            "plain": plain,
            "spec_over_plain_decoded_tok_per_s": {
                ex: runs[True][ex]["decoded_tok_per_s"]
                / plain[ex]["decoded_tok_per_s"] for ex in plain},
            "rows_equal_plain": same, "rows_near_tie": ties,
            "near_tie_gaps_ulps": sorted(t["top2_gap"] / t["bf16_ulp"]
                                         for t in ties),
            "paged": paged, "always_wrong": always, "engine": tick}
    if bad:
        print(json.dumps(out), file=sys.stderr, flush=True)
        raise AssertionError(f"serve_spec: rows differ from the plain "
                             f"server other than at a near tie of its top-2 "
                             f"logits (<= {TIE_ULPS} bf16 ulps): {bad}")
    return out


# ---------------------------------------------------------------------------
# serve_banked: the serve phase's six experts as one bank
# ---------------------------------------------------------------------------


def bank_fleet(dev, model, ring, capture=True, mesh=None, **kw):
    """Six engines on the serve phase's weight tensors, placed by
    ``plan_placement`` (over ``mesh`` when given): (registry, plan)
    holding one bank of all six."""
    from repro_torch.core import ExpertRegistry
    from repro_torch.serve import ExpertEngine, plan_placement
    reg = ExpertRegistry()
    for e in range(len(ring)):
        reg.add(ring[e].name, ExpertEngine(
            model, ring[e].backend.params, max_len=256, device=dev,
            capture_decode=capture, **kw))
    plan = plan_placement(reg, mesh=mesh)
    if [s.experts for s in plan.shards if s.banked] != \
            [tuple(range(len(ring)))]:
        raise AssertionError(f"plan_placement: {plan.describe()}")
    return reg, plan


def bank_tick(np, torch, bank, B, Sb, n):
    """The bank's own decode tick of one resident wave (B rows of Sb
    prompt tokens, all in member 0: every member computes anyway),
    host-synchronised: median wall ms of ``n`` ticks after the bucket's
    step is captured."""
    rng = np.random.default_rng(SEED + 2)
    prompts = list(rng.integers(0, bank.model.cfg.vocab_size, size=(B, Sb))
                   .astype(np.int32))
    bank.admit({0: (list(range(B)), prompts, [n + 8] * B)}, defer=True)
    for _ in range(2):               # eager first step; capture + replay
        bank.tick(defer=True)
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        bank.tick(defer=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    while bank.n_active:
        bank.tick(defer=True)
        bank.harvest()
    bank.poll()
    return {"rows": B, "prompt_len": Sb, "members": bank.n_experts,
            "graph_wall_ms_per_step": statistics.median(walls),
            "graph_wall_ms_runs": [min(walls), max(walls)]}


def timed_serve(torch, ops, server, reqs):
    """Serve ``reqs`` with every launch counter reset just before and
    read just after: (responses, seconds, launches, route chunks with
    misses)."""
    chunks = _record_route(server.router, [])
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    resps = server.serve(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ops.launches()
    _unrecord_route(server.router)
    return resps, dt, launches, chunks


def check_responses(label, resps, reqs, vocab):
    if [r.uid for r in resps] != [q.uid for q in reqs] or not all(
            r.tokens.shape == (q.max_new_tokens,)
            and ((r.tokens >= 0) & (r.tokens < vocab)).all()
            for r, q in zip(resps, reqs)):
        raise AssertionError(f"{label}: bad responses {resps}")


def check_decode_launches(label, launches, kernel, per_step, steps):
    """``kernel`` launched ``per_step`` times a decode step (E members x
    layers: a bank computes every member, rows or not) and the other
    decode kernels never."""
    others = {"decode_attention", "paged_decode_attention",
              "wkv_step"} - {kernel}
    if launches[kernel] != per_step * steps or any(launches[k]
                                                   for k in others):
        raise AssertionError(f"{label}: {launches} for {steps} decode steps "
                             f"of {per_step} {kernel} launches")


def serve_banked_phase(np, torch, dev, ops, shapes):
    """The serve phase's six experts placed as one bank (``plan_placement``
    over six ring ``llama3_2_1b`` engines on the serve phase's weight
    tensors: one ``BankedEngine`` of E = 6, full width, bf16, ``max_len``
    256) serving the serve phase's 24 routed requests: graph serial,
    graph overlapped, eager serial, eager overlapped. Every run's tokens
    equal the first's and its host blocks the other capture mode's; each
    row equals the per-engine fleet's (a serial run whose waves are
    recorded) or differs first at a reported near tie; ``decode_attention``
    launches E x n_layers a bank step; routes equal the CPU's, B1/B2 once
    per route chunk. Then one paged bank run (page 8, ``chunk_len`` 64)
    on the serve_paged phase's cohort traffic: B4 E x n_layers a step,
    never B3, its pools' books balanced. Last the bank's own tick."""
    from repro_torch.serve import Request, RoutedServer

    cfg, matcher, ring = shapes["cfg"], shapes["matcher"], shapes["registry"]
    model = shapes["engine"].model
    reqs = shapes["requests"]
    E, L = len(ring), cfg.n_layers
    want_routes = cpu_routes(np, torch, matcher, reqs)

    # the reference run: the per-engine graph fleet, serial, its waves
    # recorded for the near-tie replays
    waves = {}
    cores = [ring[e].backend.core for e in range(E)]
    for c in cores:
        _record_waves(c, waves)
    ref = RoutedServer(matcher, ring, executor="serial",
                       device=dev).serve(reqs)
    for c in cores:
        del c.admit_wave
    fleet_graphs = graph_stats([ring[e].backend for e in range(E)])

    fleets = {c: bank_fleet(dev, model, ring, c) for c in (True, False)}
    warm_graphs(RoutedServer, matcher, fleets[True][0], reqs, dev,
                placement=fleets[True][1])
    runs, tokens = {True: {}, False: {}}, {}
    for capture, executor in RUNS:
        label = f"serve_banked {'graph' if capture else 'eager'} {executor}"
        reg, plan = fleets[capture]
        bank = plan.shards[0].bank
        server = RoutedServer(matcher, reg, placement=plan,
                              executor=executor, device=dev)
        before = bank.stats.as_dict()
        resps, dt, launches, chunks = timed_serve(torch, ops, server, reqs)
        chunks = route_chunks(label, chunks, launches)
        check_routes(label, want_routes, resps)
        check_responses(label, resps, reqs, cfg.padded_vocab)
        if any(r.shard != 0 for r in resps):
            raise AssertionError(
                f"{label}: shard ids {[r.shard for r in resps]}")
        delta = engine_delta([bank], [before])
        check_decode_launches(label, launches, "decode_attention", E * L,
                              delta["decode_steps"])
        tokens[label] = [r.tokens for r in resps]
        steps = server.scheduler._steps
        runs[capture][executor] = {
            "seconds": dt, "req_per_s": len(resps) / dt,
            "generated_tok_per_s": sum(len(r.tokens) for r in resps) / dt,
            **delta, "launches": launches, "route_chunks": chunks,
            "scheduler_steps": steps,
            "bank_steps_per_scheduler_step": delta["decode_steps"] / steps}
        if capture and executor == "serial":
            bank_resps = resps
    same_tokens("serve_banked", tokens, lambda a, b: np.array_equal(a, b))
    for executor in ("serial", "overlapped"):
        if runs[True][executor]["host_blocks"] != \
                runs[False][executor]["host_blocks"]:
            raise AssertionError(f"serve_banked {executor}: host blocks "
                                 f"graph {runs[True][executor]} eager "
                                 f"{runs[False][executor]}")
    bank = fleets[True][1].shards[0].bank
    graphs = graph_stats([bank])
    if graphs["captured"] != graphs["decode_compiles"] or \
            graphs["decode_compiles"] > len(bank.batch_buckets):
        raise AssertionError(f"serve_banked graphs: {graphs}")
    same, ties, bad = tie_rows(np, torch, dev, bank_resps, ref, waves)
    shapes["banked_resps"] = bank_resps        # serve_mesh's reference
    del fleets[False]

    # one paged bank run on the serve_paged phase's cohort traffic
    traffic = shapes["paged_traffic"]
    preg, pplan = bank_fleet(dev, model, ring, kv_layout="paged",
                             page_size=8, chunk_len=64)
    pbank = pplan.shards[0].bank
    warm_graphs(RoutedServer, matcher, preg, [
        Request(uid=u, features=f, prompt=(p + 1) % cfg.vocab_size,
                max_new_tokens=16) for u, (f, p, _) in enumerate(traffic)],
        dev, placement=pplan, prefill_tokens_per_step=64)
    preqs = [Request(uid=u, features=f, prompt=p, max_new_tokens=16)
             for u, (f, p, _) in enumerate(traffic)]
    server = RoutedServer(matcher, preg, placement=pplan,
                          executor="overlapped", prefill_tokens_per_step=64,
                          device=dev)
    before = pbank.stats.as_dict()
    presps, pdt, plaunches, pchunks = timed_serve(torch, ops, server, preqs)
    route_chunks("serve_banked paged", pchunks, plaunches)
    check_responses("serve_banked paged", presps, preqs, cfg.padded_vocab)
    pdelta = engine_delta([pbank], [before], [
        k for k in dict.fromkeys(DELTAS + PREFIX_COUNTERS)
        if k != "suffix_compiles"])
    check_decode_launches("serve_banked paged", plaunches,
                          "paged_decode_attention", E * L,
                          pdelta["decode_steps"])
    pool = pbank.core.pool
    pool.check()
    for e in range(E):
        cached = sum(1 for k in pbank.core.prefix_cache._lru
                     if k[0] == "pg" and k[1] == e)
        if pool.used_count(e) != cached:
            raise AssertionError(f"serve_banked paged: member {e} holds "
                                 f"{pool.used_count(e)} pages, the prefix "
                                 f"cache {cached}")
    paged = {"seconds": pdt, "req_per_s": len(presps) / pdt, **pdelta,
             "launches": plaunches, "pages_in_use_after": sum(
                 pool.used_count(e) for e in range(E)),
             "equal_share_per_engine_paged": sum(
                 bool(np.array_equal(a.tokens, b))
                 for a, b in zip(presps, shapes["paged_tokens"]))
             / len(presps)}
    del preg, pplan, pbank, server

    tick = bank_tick(np, torch, bank, shapes["decode_rows"], 64, 20)
    out = {"phase": "serve_banked", "config": cfg.name, "experts": E,
           "banks": 1, "requests": len(reqs), "max_new_tokens": 16,
           "kv": "ring", "max_len": 256, "tokens_equal": True,
           "tokens_equal_graph_eager": True, "routes_equal_cpu": True,
           "serial": runs[True]["serial"],
           "overlapped": runs[True]["overlapped"], "eager": runs[False],
           "graphs": graphs, "per_engine_graphs": fleet_graphs,
           "rows_equal_per_engine": same, "rows_near_tie": ties,
           "near_tie_gaps_ulps": sorted(t["top2_gap"] / t["bf16_ulp"]
                                        for t in ties),
           "paged": paged, "bank_tick": tick,
           "launches_banked": {
               **{k: runs[True]["serial"]["launches"][k]
                  for k in RING_PATH},
               "paged_decode_attention": plaunches[
                   "paged_decode_attention"]}}
    if bad:
        print(json.dumps(out), file=sys.stderr, flush=True)
        raise AssertionError(f"serve_banked: rows differ from the per-engine "
                             f"fleet's other than at a near tie: {bad}")
    return out, fleets[True]


# ---------------------------------------------------------------------------
# serve_mesh: the bank of six split over a 1-D expert mesh
# ---------------------------------------------------------------------------

#: positions of serve_mesh's mesh on the one card (two members each)
MESH_POSITIONS = 3


def serve_mesh_phase(np, torch, dev, ops, shapes, banked, smi):
    """serve_banked's six full-width ``llama3_2_1b`` experts (the serve
    phase's weight tensors, depth not cut) as one E = 6 bank placed by
    ``plan_placement`` over ``ExpertMesh((cuda:0,) * 3)``: positions of
    two members, each with its own graphs and state on the card, the
    port's counterpart of the reference's forced host device count.
    serve_banked's 24 requests: graph serial, graph overlapped, eager
    serial, eager overlapped. Held: every row equal to serve_banked's
    unsharded bank's (graph serial) or differing first at a reported near
    tie; ``host_blocks`` equal to serve_banked's for each executor;
    ``decode_attention`` E x n_layers a bank step; routes equal the
    CPU's; each position captures the same decode buckets in the warm-up
    and nothing after. Printed beside serve_banked's: serve seconds and
    the bank's own tick, with the card's name and power limit. With two
    or more cards the bank also serves over ``make_expert_mesh()`` (every
    card), each card's allocated bytes printed; on one card the phase
    says that run waits for such a machine."""
    from repro_torch.launch.mesh import ExpertMesh, make_expert_mesh
    from repro_torch.serve import RoutedServer

    cfg, matcher, ring = shapes["cfg"], shapes["matcher"], shapes["registry"]
    model = shapes["engine"].model
    reqs, ref = shapes["requests"], shapes["banked_resps"]
    E, L = len(ring), cfg.n_layers
    want_routes = cpu_routes(np, torch, matcher, reqs)
    mesh = ExpertMesh((torch.device("cuda", 0),) * MESH_POSITIONS)
    fleets = {c: bank_fleet(dev, model, ring, c, mesh=mesh)
              for c in (True, False)}
    for reg, plan in fleets.values():
        core = plan.shards[0].bank.core
        if plan.shards[0].devices != mesh.devices or \
                core.per_pos != E // MESH_POSITIONS or any(
                    p["embed"].data_ptr() !=
                    ring[e].backend.params["embed"].data_ptr()
                    for e, p in enumerate(core.params)):
            raise AssertionError(f"serve_mesh plan: {plan.describe()}")
    waves = {}
    bank = fleets[True][1].shards[0].bank
    warm_graphs(RoutedServer, matcher, fleets[True][0], reqs, dev,
                placement=fleets[True][1])
    warm = graph_stats([bank])
    counts = set(bank.stats.decode_graphs.values())
    if counts != {MESH_POSITIONS} or warm["captured"] != \
            warm["decode_compiles"]:
        raise AssertionError(f"serve_mesh warm-up graphs: {warm}")
    runs, tokens = {True: {}, False: {}}, {}
    for capture, executor in RUNS:
        label = f"serve_mesh {'graph' if capture else 'eager'} {executor}"
        reg, plan = fleets[capture]
        b = plan.shards[0].bank
        first = capture and executor == "serial"
        if first:
            _record_waves(b.core, waves)
        server = RoutedServer(matcher, reg, placement=plan,
                              executor=executor, device=dev)
        before = b.stats.as_dict()
        resps, dt, launches, chunks = timed_serve(torch, ops, server, reqs)
        if first:
            del b.core.admit_wave
        chunks = route_chunks(label, chunks, launches)
        check_routes(label, want_routes, resps)
        check_responses(label, resps, reqs, cfg.padded_vocab)
        delta = engine_delta([b], [before])
        check_decode_launches(label, launches, "decode_attention", E * L,
                              delta["decode_steps"])
        want_blocks = banked["serial" if executor == "serial"
                             else "overlapped"]["host_blocks"]
        if delta["host_blocks"] != want_blocks or delta["decode_captured"]:
            raise AssertionError(f"{label}: {delta}, serve_banked blocked "
                                 f"{want_blocks} times")
        tokens[label] = resps
        runs[capture][executor] = {
            "seconds": dt, "req_per_s": len(resps) / dt,
            "generated_tok_per_s": sum(len(r.tokens) for r in resps) / dt,
            "banked_seconds": (banked if capture else banked["eager"])[
                executor]["seconds"],
            **delta, "launches": launches, "route_chunks": chunks}
    rows = {}
    for label, resps in tokens.items():
        same, ties, bad = tie_rows(np, torch, dev, resps, ref, waves)
        rows[label] = {"rows_equal_banked": same, "rows_near_tie": ties}
        if bad:
            raise AssertionError(f"{label}: rows differ from serve_banked's "
                                 f"other than at a near tie: {bad}")
    del fleets[False]
    tick = bank_tick(np, torch, bank, shapes["decode_rows"], 64, 20)
    out = {"phase": "serve_mesh", "config": cfg.name, "gpu": smi,
           "experts": E, "positions": MESH_POSITIONS,
           "mesh": [str(d) for d in mesh.devices],
           "members_per_position": E // MESH_POSITIONS,
           "requests": len(reqs), "kv": "ring", "max_len": 256,
           "tokens_equal_banked_or_near_tie": True,
           "routes_equal_cpu": True, "rows": rows,
           "serial": runs[True]["serial"],
           "overlapped": runs[True]["overlapped"], "eager": runs[False],
           "graphs": graph_stats([bank]),
           "graphs_per_bucket": MESH_POSITIONS,
           "bank_tick": tick, "banked_bank_tick": banked["bank_tick"],
           "launches_mesh": {k: runs[True]["serial"]["launches"][k]
                             for k in RING_PATH},
           "distinct_devices": torch.cuda.device_count()}
    del fleets, bank
    if torch.cuda.device_count() < 2:
        out["distinct_devices_run"] = (
            "not run: one card visible; the bank over distinct cards "
            "waits for a machine with several")
        return out
    # every visible card: members move to their cards (copies)
    cards = make_expert_mesh()
    reg, plan = bank_fleet(dev, model, ring, True, mesh=cards)
    warm_graphs(RoutedServer, matcher, reg, reqs, dev, placement=plan)
    multi = {}
    for executor in ("serial", "overlapped"):
        resps, dt, launches, _ = timed_serve(
            torch, ops, RoutedServer(matcher, reg, placement=plan,
                                     executor=executor, device=dev), reqs)
        same, ties, bad = tie_rows(np, torch, dev, resps, ref, waves)
        if bad:
            raise AssertionError(f"serve_mesh cards {executor}: rows "
                                 f"differ from serve_banked's: {bad}")
        multi[executor] = {"seconds": dt, "rows_equal_banked": same,
                           "rows_near_tie": ties}
    out["distinct_devices_run"] = {
        "devices": [str(d) for d in plan.shards[0].devices], **multi,
        "allocated_bytes": [torch.cuda.memory_allocated(i) for i in
                            range(torch.cuda.device_count())]}
    return out


# ---------------------------------------------------------------------------
# serve_hub: a catalog of six behind two device slots
# ---------------------------------------------------------------------------

#: the hub phase's slots, and the Zipf exponent of its traffic over expert
#: rank after a sweep of the catalog
HUB_SLOTS = 2
HUB_ZIPF = 1.1
#: PCIe Gen5 x16, one direction (the H100 SXM's host link), theoretical
HOST_LINK_BYTES_PER_S = 64e9


def hub_traffic(np, torch, rng, matcher, vocab, n):
    """``n`` requests over the matcher's experts: a catalog sweep (each
    expert once), then Zipf(``HUB_ZIPF``) over expert rank; each
    fingerprint chosen by its CPU route (a margin of at least 1e-3; an
    expert's fingerprints are reused, as repeat clients send them, when
    it wins fewer than its requests); prompts of 8-64 tokens, 16 new."""
    from repro_torch.serve import Request
    K = matcher.n_experts
    cands, best, margin = routed_candidates(np, torch, cpu_matcher(matcher),
                                            rng)
    pools = [np.flatnonzero((best == e) & (margin >= 1e-3)) for e in range(K)]
    if not all(len(p) for p in pools):
        missing = [e for e in range(K) if not len(pools[e])]
        raise AssertionError(f"serve_hub: no fingerprint of 4096 routes to "
                             f"experts {missing}")
    p = np.arange(1, K + 1, dtype=np.float64) ** -HUB_ZIPF
    experts = list(range(K)) + list(rng.choice(K, size=n - K, p=p / p.sum()))
    used = [0] * K
    out = []
    for u, e in enumerate(experts):
        j = pools[e][used[e] % len(pools[e])]
        used[e] += 1
        out.append(Request(uid=u, features=cands[j], prompt=rng.integers(
            0, vocab, size=int(rng.integers(8, 65))).astype(np.int32),
            max_new_tokens=16))
    return out


def _meminfo_gb(key):
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024 / 1e9
    return None


def host_link_gbps(torch):
    """One 1 GiB pinned host-to-device copy, timed with CUDA events (the
    median of three): the host link rate this machine gives."""
    src = torch.empty(1 << 28, dtype=torch.float32).pin_memory()
    dst = torch.empty_like(src, device="cuda")
    times = []
    for _ in range(3):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        dst.copy_(src, non_blocking=True)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return (1 << 30) / (statistics.median(times) / 1e3) / 1e9


def serve_hub_phase(np, torch, dev, ops, shapes, fleet, ticks):
    """An ``ExpertHub`` of ``HUB_SLOTS`` device slots (``llama3_2_1b``
    full width, bf16, ring, ``max_len`` 256) whose catalog is the serve
    phase's six experts, each saved ``cold`` into a store under a
    temporary directory (fewer, at least two, where disk is short; the
    rest staged from host memory; removed at the end), fronted by the
    serve phase's matcher (its router's hits bound as the popularity).
    ``hub.warmup`` captures every decode bucket first. Traffic: 24
    requests (``hub_traffic``): a catalog sweep, then Zipf over expert
    rank. Served serial, then overlapped, with the invariant checks every
    step. Held: every expert served, evictions > 0 and loads >= 6,
    ``hub.check()`` and pin conservation, no capture after the warmup,
    routes equal the CPU's and B1/B2 once per route chunk,
    ``decode_attention`` ``HUB_SLOTS`` x n_layers a bank step, and every
    row equal to serve_banked's bank's on the same requests or differing
    first at a reported near tie."""
    import resource
    import shutil
    import tempfile
    from repro_torch.checkpoint import expert_nbytes
    from repro_torch.serve import ExpertHub, RoutedServer

    cfg, matcher, ring = shapes["cfg"], shapes["matcher"], shapes["registry"]
    model = shapes["engine"].model
    E, L = len(ring), cfg.n_layers
    names = [ring[e].name for e in range(E)]
    reqs = hub_traffic(np, torch, np.random.default_rng(SEED + 13), matcher,
                       cfg.vocab_size, 24)
    want_routes = cpu_routes(np, torch, matcher, reqs)

    # the reference run: serve_banked's bank on the same requests
    reg, plan = fleet
    waves = {}
    _record_waves(plan.shards[0].bank.core, waves)
    ref = RoutedServer(matcher, reg, placement=plan, executor="serial",
                       device=dev).serve(reqs)
    del plan.shards[0].bank.core.admit_wave

    expert_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(ring[0].backend.params))
    store = tempfile.mkdtemp(prefix="hub_store_")
    disk_free = shutil.disk_usage(store).free
    n_cold = min(E, int(disk_free // (1.1 * expert_bytes)))
    if n_cold < 2:
        raise AssertionError(f"serve_hub: {disk_free / 1e9:.1f} GB free "
                             "holds fewer than two experts")
    host = {"mem_available_gb_before": _meminfo_gb("MemAvailable"),
            "maxrss_gb_before": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dev0 = torch.cuda.memory_allocated()
    try:
        hub = ExpertHub(model, n_slots=HUB_SLOTS, max_len=256, store=store,
                        device=dev)
        t0 = time.perf_counter()
        for e in range(E):
            hub.add_expert(names[e], ring[e].backend.params, cold=e < n_cold)
        write_s = time.perf_counter() - t0
        store_bytes = sum(expert_nbytes(store, names[e])
                          for e in range(n_cold))
        t0 = time.perf_counter()
        hub.warmup(max_batch=16)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        captured = hub.bank.stats.decode_captured
        if captured != len(hub.bank.batch_buckets):
            raise AssertionError(f"serve_hub warmup captured {captured}")
        registry = hub.build_registry()
        runs, resps_by = {}, {}
        for executor in ("serial", "overlapped"):
            label = f"serve_hub {executor}"
            server = RoutedServer(matcher, registry, hub=hub,
                                  executor=executor, check_every=1,
                                  device=dev)
            sched = server.scheduler
            service, service_s = sched._service_hub, []

            def timed_service():
                t = time.perf_counter()
                service()
                service_s.append(time.perf_counter() - t)
            sched._service_hub = timed_service
            stats0 = dict(hub.stats.as_dict())
            before = hub.bank.stats.as_dict()
            resps, dt, launches, chunks = timed_serve(torch, ops, server,
                                                      reqs)
            del sched._service_hub
            chunks = route_chunks(label, chunks, launches)
            check_routes(label, want_routes, resps)
            check_responses(label, resps, reqs, cfg.padded_vocab)
            delta = engine_delta([hub.bank], [before])
            check_decode_launches(label, launches, "decode_attention",
                                  HUB_SLOTS * L, delta["decode_steps"])
            served = sorted({r.expert for r in resps})
            if served != sorted(names):
                raise AssertionError(f"{label}: served {served}")
            hub.check()
            if hub.total_pins():
                raise AssertionError(f"{label}: {hub.total_pins()} pins left")
            if hub.bank.stats.decode_captured != captured:
                raise AssertionError(f"{label}: a capture after the warmup")
            resps_by[executor] = resps
            st = hub.stats.as_dict()
            runs[executor] = {
                "seconds": dt, "req_per_s": len(resps) / dt,
                "generated_tok_per_s": sum(len(r.tokens)
                                           for r in resps) / dt,
                **delta, "launches": launches, "route_chunks": chunks,
                "scheduler_steps": sched._steps,
                "service_hub_s": sum(service_s),
                "rest_of_steps_s": dt - sum(service_s),
                "resident_stalls": sched.stats.resident_stalls,
                "hub_delta": {k: st[k] - stats0[k] for k in
                              ("loads", "evictions", "resident_misses",
                               "stage_count", "commit_count")}}
        st = hub.stats
        if not (st.evictions > 0 and st.loads >= E):
            raise AssertionError(f"serve_hub: {st}")
        # one install timed to completion: a staged, non-resident expert
        # into an idle hub's slot (an eviction, pinning, the copy)
        e = next(i for i, c in enumerate(hub.catalog)
                 if c.state == "staged")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hub.want(e)
        hub.service()
        torch.cuda.synchronize()
        commit_sync_s = time.perf_counter() - t0
        if hub.slot_of(e) is None:
            raise AssertionError("serve_hub: the timed install did not land")
        link = host_link_gbps(torch)
        snap = hub.metrics_snapshot()
        tick = bank_tick(np, torch, hub.bank, shapes["decode_rows"], 64, 20)
        device_peak_gb = (torch.cuda.max_memory_allocated() - dev0) / 1e9
        host["maxrss_gb_after"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
        host["mem_available_gb_after"] = _meminfo_gb("MemAvailable")
        hub.close()
    finally:
        shutil.rmtree(store, ignore_errors=True)
    ties = {}
    bad = []
    for executor, resps in resps_by.items():
        same, t, b = tie_rows(np, torch, dev, resps, ref, waves)
        ties[executor] = {"rows_equal_bank": same, "rows_near_tie": t}
        bad += b
    stats = st.as_dict()
    out = {"phase": "serve_hub", "config": cfg.name, "catalog": E,
           "slots": HUB_SLOTS, "kv": "ring", "max_len": 256,
           "requests": len(reqs), "max_new_tokens": 16, "prompt_len": [8, 64],
           "traffic": {"sweep": E, "zipf": HUB_ZIPF,
                       "per_expert": {n: sum(r.expert == n
                                             for r in resps_by["serial"])
                                      for n in names}},
           "cold_experts": n_cold, "host_staged_experts": E - n_cold,
           "disk_free_gb": disk_free / 1e9, "expert_gb": expert_bytes / 1e9,
           "store_gb": store_bytes / 1e9, "store_write_s": write_s,
           "warmup_s": warmup_s, "decode_captured_after_warmup": captured,
           "hub_stats": stats,
           "per_expert": {n: {k: v[k] for k in ("stage_ms", "commit_ms",
                                                "misses", "hits")}
                          for n, v in snap["experts"].items()},
           "commit_enqueue_gb_per_s": stats["commit_bytes"]
           / max(st.commit_ms, 1e-9) / 1e6,
           "commit_sync_ms": commit_sync_s * 1e3,
           "commit_sync_gb_per_s": expert_bytes / commit_sync_s / 1e9,
           "host_link_gb_per_s_measured": link,
           "host_link_gb_per_s_theoretical": HOST_LINK_BYTES_PER_S / 1e9,
           "host_memory": host, "device_peak_gb_above_phase_start":
               device_peak_gb,
           "serial": runs["serial"], "overlapped": runs["overlapped"],
           "vs_bank": ties,
           "tick": {"hub_bank": tick, "bank6": ticks["bank"],
                    "single_engine_graph_wall_ms_per_step":
                        ticks["single"]},
           "launches_hub": {k: runs["serial"]["launches"][k]
                            for k in RING_PATH + ("paged_decode_attention",)}}
    if bad:
        print(json.dumps(out), file=sys.stderr, flush=True)
        raise AssertionError(f"serve_hub: rows differ from the bank's other "
                             f"than at a near tie: {bad}")
    return out


# ---------------------------------------------------------------------------
# serve_rwkv: RWKV6 experts beside dense ones behind one router
# ---------------------------------------------------------------------------

#: (name, family) of the mixed-family server's experts, in bank order, and
#: the requests each gets out of 24
RWKV_FLEET = (("rwkv_a", "rwkv", 7), ("rwkv_b", "rwkv", 7),
              ("llama_a", "dense", 5), ("llama_b", "dense", 5))


def routed_candidates(np, torch, m_cpu, rng, n=4096):
    """``n`` candidate fingerprints (uniform draws raised to powers in
    [0.2, 5], so the bank's experts all win some), each one's CPU route
    through ``m_cpu`` and its relative margin over the runner-up."""
    cands = (rng.random((n, 784), dtype=np.float32)
             ** rng.uniform(0.2, 5.0, (n, 1)).astype(np.float32))
    sc = torch.sort(m_cpu.coarse_scores(torch.from_numpy(cands)), dim=-1)
    best = m_cpu.assign_coarse(torch.from_numpy(cands)).numpy()
    margin = ((sc.values[:, 1] - sc.values[:, 0])
              / sc.values[:, 0].abs().clamp_min(1e-30)).numpy()
    return cands, best, margin


def serve_rwkv_phase(np, torch, dev, ops, shapes):
    """Two full-width bf16 ``rwkv6_7b`` engines (random seeded weights,
    the leaves their init zeroes set as a trained checkpoint has them;
    ring, ``max_len`` 256) and two ``llama3_2_1b`` engines sharing the
    serve phase's weight tensors, behind an AE bank of K = 4 built on the
    CPU from seeded AEs (coarse scoring through ``expert_score``). The 24
    fingerprints are chosen by their route on the CPU copy of the bank,
    each winning by a relative margin of at least 1e-3: 7 per RWKV
    expert, 5 per llama one. RWKV prompts alternate between 8-16 tokens
    (buckets 8 / 16: scan prefill, below the 32-token chunk) and 17-64
    (buckets 32 / 64: chunked prefill); llama prompts take 8-64. 16 new
    tokens each; serial, then overlapped."""
    from repro_torch.configs import get_config
    from repro_torch.core import (ExpertRegistry, MatcherConfig,
                                  build_matcher, init_ae)
    from repro_torch.models import build_model
    from repro_torch.serve import ExpertEngine, Request, RoutedServer

    rng = np.random.default_rng(SEED + 11)
    names = [n for n, _, _ in RWKV_FLEET]
    aes = [init_ae(torch.Generator().manual_seed(SEED + 20 + i),
                   device="cpu") for i in range(len(names))]
    cent_data = [(rng.random((256, 784), dtype=np.float32),
                  np.arange(256) % 4) for _ in names]
    m_cpu = build_matcher(aes, names, cent_data, device="cpu")
    matcher = build_matcher(aes, names, cent_data,
                            MatcherConfig(use_kernel=True), device=dev)
    cands, best, margin = routed_candidates(np, torch, m_cpu, rng)
    picks = []
    for e, (name, family, n) in enumerate(RWKV_FLEET):
        idx = np.flatnonzero((best == e) & (margin >= 1e-3))
        if len(idx) < n:
            raise AssertionError(f"serve_rwkv: only {len(idx)} of 4096 "
                                 f"fingerprints route to {name}")
        for i, j in enumerate(idx[:n]):
            if family == "rwkv":
                lo, hi = (8, 16) if i % 2 == 0 else (17, 64)
            else:
                lo, hi = 8, 64
            picks.append((name, cands[j], int(rng.integers(lo, hi + 1))))
    picks = [picks[i] for i in rng.permutation(len(picks))]

    rcfg = get_config("rwkv6_7b")
    rmodel = build_model(rcfg)
    ring = shapes["registry"]
    lmodel = shapes["engine"].model
    registry, eager = ExpertRegistry(), ExpertRegistry()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    for e, (name, family, _) in enumerate(RWKV_FLEET):
        if family == "rwkv":
            gen = torch.Generator(device=dev).manual_seed(SEED + 30 + e)
            model, params = rmodel, rmodel.init(gen, device=dev)
            trained_like(torch, params, gen)
        else:
            model, params = lmodel, ring[e - 2].backend.params
        registry.add(name, ExpertEngine(model, params, max_len=256,
                                        device=dev))
        eager.add(name, ExpertEngine(model, params, max_len=256, device=dev,
                                     capture_decode=False))
    torch.cuda.synchronize()
    rwkv_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
    engines = [registry[e].backend for e in range(len(registry))]
    is_rwkv = [f == "rwkv" for _, f, _ in RWKV_FLEET]

    def requests(uid0):
        return [Request(uid=uid0 + u, features=f,
                        prompt=np.random.default_rng(SEED + u).integers(
                            0, rcfg.vocab_size, size=n).astype(np.int32),
                        max_new_tokens=16)
                for u, (_, f, n) in enumerate(picks)]

    # warm-up: the same requests under other uids on a server of its own,
    # so every decode bucket the timed runs reach is captured here
    RoutedServer(matcher, registry, executor="serial",
                 device=dev).serve(requests(10_000))
    want_routes = cpu_routes(np, torch, matcher, requests(0))
    runs, tokens = {True: {}, False: {}}, {}
    for capture, executor in RUNS:
        reg = registry if capture else eager
        fleet = [reg[e].backend for e in range(len(reg))]
        server = RoutedServer(matcher, reg, executor=executor, device=dev)
        before = [e.stats.as_dict() for e in fleet]
        seen = []
        fine_calls = _record_route(server.router, seen)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        resps = server.serve(requests(0))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = ops.launches()
        _unrecord_route(server.router)
        label = f"serve_rwkv {'graph' if capture else 'eager'} {executor}"
        chunks = route_chunks(label, fine_calls, launches)
        check_routes(label, want_routes, resps)
        if len(resps) != len(picks):
            raise AssertionError(f"serve_rwkv {executor}: {len(resps)} "
                                 f"responses for {len(picks)} requests")
        for r in resps:
            vocab = engines[names.index(r.expert)].model.cfg.padded_vocab
            if r.tokens.shape != (16,) or not (
                    (r.tokens >= 0) & (r.tokens < vocab)).all():
                raise AssertionError(f"{label}: bad response {r}")
        delta = engine_delta(fleet, before)
        steps = [e.stats.decode_steps - b["decode_steps"]
                 for e, b in zip(fleet, before)]
        r_steps = sum(s_ for s_, r in zip(steps, is_rwkv) if r)
        l_steps = sum(steps) - r_steps
        r_replays = sum(e.stats.decode_replays - b["decode_replays"]
                        for e, b, r in zip(fleet, before, is_rwkv) if r)
        check_blocks(label, delta, HOST_BLOCKS["serve_rwkv"][executor])
        if launches["wkv_step"] != rcfg.n_layers * r_replays \
                or not 0 < r_replays <= r_steps:
            raise AssertionError(
                f"{label}: wkv_step launched "
                f"{launches['wkv_step']} times for {r_replays} RWKV replays "
                f"({r_steps} decode steps) of {rcfg.n_layers} layers")
        if launches["decode_attention"] != lmodel.cfg.n_layers * l_steps:
            raise AssertionError(
                f"{label}: decode_attention launched "
                f"{launches['decode_attention']} times for {l_steps} llama "
                f"decode steps of {lmodel.cfg.n_layers} layers")
        if not chunks or launches["paged_decode_attention"]:
            raise AssertionError(f"{label}: launches {launches} over "
                                 f"{chunks} route chunks")
        routed = {n: sum(r.expert == n for r in resps) for n in names}
        # the (batch, length) buckets each engine ran: the warm-up served
        # the same traffic, so these are this run's
        buckets = {n: sorted({sb for _, sb in e.core._prefill_shapes})
                   for n, e in zip(names, fleet)}
        for n, f, _ in RWKV_FLEET:
            if f == "rwkv" and (routed[n] < 6 or min(buckets[n]) > 16
                                or max(buckets[n]) < 32):
                raise AssertionError(
                    f"{label}: {n} got {routed[n]} requests "
                    f"in prompt buckets {buckets[n]}")
        n_tok = sum(len(r.tokens) for r in resps)
        tokens[label] = [(r.expert, r.tokens) for r in resps]
        runs[capture][executor] = {
            "seconds": dt, "req_per_s": len(resps) / dt,
            "generated_tok_per_s": n_tok / dt, "tokens": n_tok,
            "decode_steps_rwkv": r_steps, "decode_replays_rwkv": r_replays,
            "decode_steps_llama": l_steps,
            **delta, "launches": launches,
            "route_chunks": chunks, "routed": routed,
            "prefill_buckets": buckets,
            "rwkv_decode_rows_max": max(
                max(e.stats.decode_graphs, default=0)
                for e, r in zip(fleet, is_rwkv) if r)}
    same_tokens("serve_rwkv", tokens,
                lambda a, b: a[0] == b[0] and np.array_equal(a[1], b[1]))
    rows = runs[True]["serial"]["rwkv_decode_rows_max"]
    return ({"phase": "serve_rwkv", "config": rcfg.name,
             "experts": {n: f for n, f, _ in RWKV_FLEET},
             "requests": len(picks), "max_new_tokens": 16,
             "kv": "ring", "max_len": 256, "rwkv_param_gb": rwkv_gb,
             "tokens_equal": True, "tokens_equal_graph_eager": True,
             "routes_equal_cpu": True,
             "serial": runs[True]["serial"],
             "overlapped": runs[True]["overlapped"], "eager": runs[False],
             "graphs": graph_stats(engines),
             "kernel_shape": {"wkv_step": [rows, rcfg.n_heads, rcfg.dh]}},
            {"decode_rows": rows, "engine": engines[0], "cfg": rcfg})


def breakdown_rwkv_phase(np, torch, dev, rshapes):
    """One RWKV decode step of a wave at serve_rwkv's largest RWKV decode
    bucket, after a 32-token (chunked) prefill, timed as
    ``breakdown_phase`` times the dense step; ``wkv_step``'s share of the
    step's kernel time from ``torch.profiler``. The step updates the
    state in place, so each replay decodes from the state the last one
    left (same shapes, same work)."""
    eng, cfg = rshapes["engine"], rshapes["cfg"]
    model, params = eng.model, eng.params
    B, Sb, n = rshapes["decode_rows"], 32, 20
    rng = np.random.default_rng(SEED + 1)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(B, Sb)).astype(np.int32)).to(dev)
    _, cache = model.prefill(params, {"tokens": toks})
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)

    def step():
        return model.decode(params, cache, {"token": tok})[0]

    timed = step_times(torch, step, n)
    by_name = timed.pop("by_name")
    wkv_ms = sum(v for k, v in by_name.items() if "wkv_step" in k)
    n_wkv = sum(c for k, c in timed.pop("launches_by_name").items()
                if "wkv_step" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       _leaves(params))
    state_bytes = sum(cache[k].numel() * cache[k].element_size()
                      for k in ("S", "x_tm", "x_cm"))
    del cache
    engine = engine_step(np, torch, dev, model, params, B, Sb, n,
                         "wkv_step")
    return {"phase": "breakdown_rwkv", "config": cfg.name, "rows": B,
            "prompt_len": Sb, **timed, "engine": engine,
            "wkv_step_ms_per_step": wkv_ms,
            "wkv_step_launches_per_step": n_wkv,
            "wkv_step_ms_per_launch": wkv_ms / n_wkv if n_wkv else None,
            "wkv_step_share_of_kernel_ms":
                wkv_ms / timed["profiler_kernel_ms_per_step"],
            "profiler_top_kernels_ms": [[k[:60], v] for k, v in top],
            "weight_gb": weight_bytes / 1e9, "state_gb": state_bytes / 1e9,
            "weight_and_state_bound_ms":
                (weight_bytes + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3}


# ---------------------------------------------------------------------------
# serve_moe: full-width MoE experts beside dense ones behind one router
# ---------------------------------------------------------------------------

#: (name, family, requests of 24) of the MoE server's experts, bank order
MOE_FLEET = (("olmoe_a", "moe", 7), ("olmoe_b", "moe", 7),
             ("llama_a", "dense", 5), ("llama_b", "dense", 5))
#: the paged MoE runs' geometry: prompts over 32 tokens take two chunks
MOE_PAGED = {"kv_layout": "paged", "page_size": 8, "chunk_len": 32}


def serve_moe_phase(np, torch, dev, ops, shapes):
    """Two full-width bf16 ``olmoe_1b_7b`` engines (16 layers, d_model
    2048, 16 heads of 128 with 16 KV heads, 64 experts top-8, d_ff 1024,
    vocab 50304, untied: ~6.9 B parameters each; random seeded weights,
    capacity dispatch at factor 1.25, ``max_len`` 256) and two
    ``llama3_2_1b`` engines sharing the serve phase's weight tensors,
    behind an AE bank of K = 4 built from seeded AEs (coarse scoring
    through ``expert_score``). The 24 fingerprints are chosen by their
    route on the CPU copy of the bank (relative margin >= 1e-3): 7 per
    olmoe expert, 5 per llama one; prompts of 8-64 tokens, 16 new each.
    Ring: graph serial, graph overlapped, eager serial, eager overlapped.
    Paged (page 8, ``chunk_len`` 32, 64 prompt tokens a step): the same
    four runs, each on a fresh fleet warmed by the same requests with
    every token shifted by one (an empty prefix cache at the start of
    each run, so every run prefills the same chunks). Held: every run's
    tokens equal the first's of its layout, and the graph and eager runs
    of one executor make the same MoE prefill calls (tokens, drops: a
    MoE prefill's drops depend on the whole padded wave, padding rows
    included; ``same``); ``decode_attention`` (ring) or
    ``paged_decode_attention`` (paged) launches = n_layers x decode steps
    summed over the engines, replays counted, and the other decode
    kernel none; ``expert_score`` / ``cosine_scores`` once per route
    chunk; each request's expert and class equal a CPU Router's.
    Recorded: req/s, tok/s, and the assignments each MoE prefill routed
    and dropped (``count_drops``); the first paged run also keeps the
    MoE engines' decode shapes (``_record_decode``: kernel 4's olmoe
    case). The rates include these recorders: three small kernels a MoE
    prefill layer for the drops, two copies a paged MoE decode step."""
    from repro_torch.configs import get_config
    from repro_torch.core import (ExpertRegistry, MatcherConfig,
                                  build_matcher, init_ae)
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import ExpertEngine, Request, RoutedServer

    rng = np.random.default_rng(SEED + 12)
    names = [n for n, _, _ in MOE_FLEET]
    aes = [init_ae(torch.Generator().manual_seed(SEED + 70 + i),
                   device="cpu") for i in range(len(names))]
    cent_data = [(rng.random((256, 784), dtype=np.float32),
                  np.arange(256) % 4) for _ in names]
    m_cpu = build_matcher(aes, names, cent_data, device="cpu")
    matcher = build_matcher(aes, names, cent_data,
                            MatcherConfig(use_kernel=True), device=dev)
    cands, best, margin = routed_candidates(np, torch, m_cpu, rng)
    picks = []
    for e, (name, _, n) in enumerate(MOE_FLEET):
        idx = np.flatnonzero((best == e) & (margin >= 1e-3))
        if len(idx) < n:
            raise AssertionError(f"serve_moe: only {len(idx)} of 4096 "
                                 f"fingerprints route to {name}")
        picks += [(name, cands[j], int(rng.integers(8, 65)))
                  for j in idx[:n]]
    picks = [picks[i] for i in rng.permutation(len(picks))]

    mcfg = get_config("olmoe_1b_7b")
    mmodel = build_model(mcfg)
    ring = shapes["registry"]
    lmodel = shapes["engine"].model
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    experts = []
    for e, (name, family, _) in enumerate(MOE_FLEET):
        if family == "moe":
            gen = torch.Generator(device=dev).manual_seed(SEED + 80 + e)
            experts.append((mmodel, mmodel.init(gen, device=dev)))
        else:
            experts.append((lmodel, ring[e - 2].backend.params))
    torch.cuda.synchronize()
    moe_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
    is_moe = [f == "moe" for _, f, _ in MOE_FLEET]

    def fleet(capture, **kw):
        reg = ExpertRegistry()
        for (name, _, _), (model, params) in zip(MOE_FLEET, experts):
            reg.add(name, ExpertEngine(model, params, max_len=256,
                                       device=dev, capture_decode=capture,
                                       **kw))
        return reg

    def requests(uid0, shift=0):
        return [Request(uid=uid0 + u, features=f,
                        prompt=((np.random.default_rng(SEED + 100 + u)
                                 .integers(0, mcfg.vocab_size, size=n)
                                 + shift) % mcfg.vocab_size).astype(
                                     np.int32), max_new_tokens=16)
                for u, (_, f, n) in enumerate(picks)]

    want_routes = cpu_routes(np, torch, matcher, requests(0))

    def run(reg, executor, label, budget=0, decodes=None):
        engines = [reg[e].backend for e in range(len(reg))]
        server = RoutedServer(matcher, reg, executor=executor, device=dev,
                              prefill_tokens_per_step=budget)
        before = [e.stats.as_dict() for e in engines]
        seen, counted = [], []
        fine_calls = _record_route(server.router, seen)
        undo = count_drops(torch, moe_mod, counted)
        recorded = [e for e, m in zip(engines, is_moe)
                    if m and decodes is not None]
        for e in recorded:
            e.core._decode_step = _record_decode(e.core, decodes)
        try:
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            resps = server.serve(requests(0))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            undo()
            _unrecord_route(server.router)
            for e in recorded:
                del e.core._decode_step
        launches = ops.launches()
        chunks = route_chunks(label, fine_calls, launches)
        check_routes(label, want_routes, resps)
        if len(resps) != len(picks):
            raise AssertionError(f"{label}: {len(resps)} responses for "
                                 f"{len(picks)} requests")
        for r in resps:
            vocab = engines[names.index(r.expert)].model.cfg.padded_vocab
            if r.tokens.shape != (16,) or not (
                    (r.tokens >= 0) & (r.tokens < vocab)).all():
                raise AssertionError(f"{label}: bad response {r}")
        delta = engine_delta(engines, before)
        steps = [e.stats.decode_steps - b["decode_steps"]
                 for e, b in zip(engines, before)]
        paged = engines[0].kv_layout == "paged"
        kernel, other = (("paged_decode_attention", "decode_attention")
                         if paged else
                         ("decode_attention", "paged_decode_attention"))
        want = sum(e.model.cfg.n_layers * s_ for e, s_ in zip(engines, steps))
        if launches[kernel] != want or launches[other] \
                or launches["wkv_step"]:
            raise AssertionError(f"{label}: launches {launches} for decode "
                                 f"steps {steps} (16 layers each)")
        n_tok = sum(len(r.tokens) for r in resps)
        return [(r.expert, r.tokens) for r in resps], {
            "seconds": dt, "req_per_s": len(resps) / dt,
            "generated_tok_per_s": n_tok / dt, "tokens": n_tok,
            "decode_steps_moe": sum(s_ for s_, m in zip(steps, is_moe) if m),
            "decode_steps_llama": sum(s_ for s_, m in zip(steps, is_moe)
                                      if not m),
            **delta, "launches": launches, "route_chunks": chunks,
            "routed": {n: sum(r.expert == n for r in resps) for n in names},
            "moe_prefill": drop_totals(counted),
            "prefill_buckets": {n: sorted(e.core._prefill_shapes) for n, e
                                in zip(names, engines)}}

    def same(layout, tokens, runs):
        """Every run's tokens equal the first's of this layout; the graph
        and eager runs of one executor made the same MoE prefill calls,
        each expert's (T, assignments dropped) in any order (the drops
        are a function of the padded calls: runs that differ there
        computed something else). Between executors the paged calls may
        differ: a suffix chunk's padding rows read the trash page, whose
        contents depend on the decode steps run before it, and the
        executors interleave chunks and steps otherwise; padding rows
        take expert slots, so the drops move (reported, and where tokens
        differ the error says whether the calls did)."""
        calls = {k: [sorted(map(tuple, c)) for c in
                     r["moe_prefill"]["per_expert"]] for k, r in runs.items()}
        (first, want), *rest = tokens.items()
        for label, got in rest:
            if len(got) != len(want) or not all(
                    a[0] == b[0] and np.array_equal(a[1], b[1])
                    for a, b in zip(got, want)):
                raise AssertionError(
                    f"serve_moe {layout}: {label} tokens differ from "
                    f"{first}'s; MoE prefill calls (T, dropped) "
                    f"{'the same' if calls[label] == calls[first] else 'differ'}"
                    f": {calls[first]} / {calls[label]}")
        for executor in ("serial", "overlapped"):
            a, b = calls[f"graph {executor}"], calls[f"eager {executor}"]
            if a != b:
                raise AssertionError(
                    f"serve_moe {layout}: graph and eager {executor} MoE "
                    f"prefill calls (T, dropped) differ: {a} / {b}")
        return calls["graph serial"] == calls["graph overlapped"]

    out, calls_equal = {}, {}
    for layout, kw, budget in (("ring", {}, 0), ("paged", MOE_PAGED, 64)):
        runs, tokens = {}, {}
        graph = fleet(True, **kw) if layout == "ring" else None
        if graph is not None:
            warm_graphs(RoutedServer, matcher, graph, requests(0), dev)
        for capture, executor in RUNS:
            label = f"{'graph' if capture else 'eager'} {executor}"
            if layout == "ring":
                reg = graph if capture else fleet(False)
            else:
                # a fresh fleet (empty prefix cache), its buckets captured
                # by the same requests with every token shifted by one
                reg = fleet(capture, **kw)
                warm_graphs(RoutedServer, matcher, reg, requests(0, 1), dev,
                            prefill_tokens_per_step=budget)
            # the MoE engines' paged decode steps of the first run:
            # kernel 4's shape at this expert (the kernels phase)
            decodes = [] if layout == "paged" and not runs else None
            tokens[label], runs[label] = run(reg, executor,
                                             f"serve_moe {layout} {label}",
                                             budget, decodes)
            if decodes is not None:
                core = reg[0].backend.core
                prow = max(r_ for r_, _, _ in decodes)
                paged_shape = {
                    "rows": prow, "page": core.page,
                    "n_logical": core.n_logical,
                    "n_pages": core.pool.n_pages,
                    # slots with 0 <= pos < t after the step, t = q_pos + 1
                    "live": max(int(((p >= 0) & (p < t[:, None])).sum(-1)
                                    .max()) for r_, p, t in decodes
                                if r_ == prow)}
            if capture:
                runs[label]["graphs"] = graph_stats(
                    [reg[e].backend for e in range(len(reg))])
            if layout == "paged":
                for e in range(len(reg)):
                    reg[e].backend.core.pool.check()
                del reg
        calls_equal[layout] = same(layout, tokens, runs)
        out[layout] = runs
        if layout == "ring":
            moe_engines = [graph[e].backend for e, m in enumerate(is_moe)
                           if m]
            rows = max(max(e.stats.decode_graphs, default=0)
                       for e in moe_engines)
            q_pos = max(sb for e in moe_engines
                        for _, sb in e.core._prefill_shapes) + 16 - 2
            del graph
        gc.collect()
        torch.cuda.empty_cache()
    return ({"phase": "serve_moe", "config": mcfg.name,
             "experts": {n: f for n, f, _ in MOE_FLEET},
             "requests": len(picks), "max_new_tokens": 16,
             "prompt_len": [8, 64], "max_len": 256,
             "moe_capacity_factor": mcfg.moe_capacity_factor,
             "moe_param_gb": moe_gb, "paged": MOE_PAGED,
             "prefill_tokens_per_step_paged": 64,
             "tokens_equal_within_layout": True, "routes_equal_cpu": True,
             "prefill_calls_equal_serial_overlapped": calls_equal,
             "ring": out["ring"], "paged_runs": out["paged"],
             "kernel_shape": {"decode_attention": [
                 rows, mcfg.n_heads, mcfg.n_kv_heads, mcfg.dh, 256,
                 q_pos + 1], "paged_decode_attention": paged_shape}},
            {"cfg": mcfg, "model": mmodel, "params": experts[0][1],
             "decode_rows": rows, "decode_q_pos": q_pos,
             "paged": paged_shape})


def breakdown_moe_phase(np, torch, dev, mshapes):
    """One olmoe wave's decode tick at B 8 after a 64-token prefill, timed
    as ``breakdown_phase`` times the dense step (eager wall, the step
    replayed as a CUDA graph, the kernels of three eager steps), with
    ``decode_attention``'s share; the engine's own tick replayed and
    eager, and ``decode_attention``'s us per launch inside the replay at
    this expert's shape (dh 128, group 1, 16 KV heads); the tick against
    its weight-read bound: the dropless dispatch runs all 64 experts on
    a (64, B, 2048) buffer, so a tick reads every layer's parameters and
    the unembedding (the embedding table only B rows)."""
    cfg, model, params = mshapes["cfg"], mshapes["model"], mshapes["params"]
    B, Sb, n = 8, 64, 20
    timed = bare_decode_step(np, torch, dev, model, params, B, Sb, n)
    read = sum(t.numel() * t.element_size() for k, v in params.items()
               if k != "embed" for t in _leaves(v))
    engine = engine_step(np, torch, dev, model, params, B, Sb, n,
                         "decode_attention_kernel")
    return {"phase": "breakdown_moe", "config": cfg.name, "rows": B,
            "prompt_len": Sb, "cache_len": 256, **timed, "engine": engine,
            "weight_read_gb": read / 1e9,
            "weight_read_bound_ms": read / HBM_BYTES_PER_S * 1e3,
            "graph_tick_over_bound": engine["graph_wall_ms_per_step"]
            / (read / HBM_BYTES_PER_S * 1e3)}


# ---------------------------------------------------------------------------
# Zamba2: the hybrid family (Mamba2 + one shared attention block)
# ---------------------------------------------------------------------------

#: the reduced Zamba2 of the reference phase: A = 2 applications of the
#: shared block and a Mamba2 layer after the last one
ZAMBA_SMALL = {"n_layers": 5, "attn_every": 2}
#: (name, family, requests of 24) of the Zamba2 server's experts, bank
#: order
ZAMBA_FLEET = (("zamba_a", "hybrid", 7), ("zamba_b", "hybrid", 7),
               ("llama_a", "dense", 5), ("llama_b", "dense", 5))
#: a leaf's gradient, card against CPU: |card - cpu| <= this x (|cpu| +
#: max|cpu|) (tests/test_torch_zamba.py's GRAD_TOL)
ZAMBA_GRAD_TOL = 2e-4


def zamba_trained_like(torch, params, gen):
    """``dt_bias`` = log(expm1(dt)) for dt ~ U[1e-3, 1e-1], ``D_skip`` and
    ``ssm_norm`` 1 + N(0, 0.2), in place: at the init's dt_bias of 0 the
    state decays within a 16-token chunk, and a wrong carry across chunks
    would agree unseen."""
    lay = params["layers"]
    dt = torch.rand(lay["dt_bias"].shape, generator=gen,
                    device=gen.device) * (1e-1 - 1e-3) + 1e-3
    lay["dt_bias"].copy_(torch.log(torch.expm1(dt)))
    for name in ("D_skip", "ssm_norm"):
        lay[name].copy_(1 + 0.2 * torch.randn(lay[name].shape, generator=gen,
                                              device=gen.device))


def zamba_reference(np, torch, dev):
    """A reduced f32 ``zamba2_7b`` (5 layers, ``attn_every`` 2, ``ssm_chunk``
    16, trained-like ``dt_bias``) on the card and on the CPU from the
    same weights. Model calls: prompts of 8, 24 (a padded chunk) and 32
    tokens (two chunks) into rings of S + 2 slots, a prefill and four
    decode steps fed the CPU's tokens (the ring wraps): logits and every
    cache leaf within abs 1e-4 x max(|logit|, 1); no kernel launches
    (the family attends through plain ``attention``). Two launches of one
    eager decode step from the same cache are bit-equal. Engine
    ``generate`` of 12 tokens: the CPU's, the card's through captured
    decode graphs and the card's eager tokens are equal. One loss and
    its gradients on a (2, 32) batch: the loss within rtol 1e-5, each
    gradient leaf within ``ZAMBA_GRAD_TOL``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import ExpertEngine
    from repro_torch.tree import leaves, value_and_grad

    cfg = get_config("zamba2_7b").reduced(name="smoke-zamba-ref",
                                          **ZAMBA_SMALL)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(SEED), device="cpu")
    zamba_trained_like(torch, cpu, torch.Generator().manual_seed(SEED + 1))
    gpu = _tree(cpu, lambda t: t.to(dev))
    rng = np.random.default_rng(SEED + 8)
    worst, scale, n_steps = 0.0, 0.0, 0
    ops.reset_launches()
    for S in (8, 24, 32):
        toks = rng.integers(0, cfg.vocab_size, size=(3, S)).astype(np.int32)
        lc, cc = model.prefill(cpu, {"tokens": torch.from_numpy(toks)},
                               capacity=S + 2)
        lg, cg = model.prefill(gpu, {"tokens": torch.from_numpy(toks).to(dev)},
                               capacity=S + 2)
        for _ in range(4):
            worst = max(worst, (lg.cpu() - lc).abs().max().item())
            scale = max(scale, lc.abs().max().item())
            tok = lc.argmax(-1).to(torch.int32)[:, None]
            lc, cc = model.decode(cpu, cc, {"token": tok})
            lg, cg = model.decode(gpu, cg, {"token": tok.to(dev)})
            n_steps += 1
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
        for key in cc:
            worst = max(worst, (cg[key].cpu().float()
                                - cc[key].float()).abs().max().item())
    launches = ops.launches()
    if any(launches.values()):
        raise AssertionError(f"zamba reference: kernels launched {launches}")
    if not worst <= 1e-4 * max(scale, 1.0):
        raise AssertionError(f"zamba reference: card logits or cache leaves "
                             f"differ from the CPU by {worst} (scale "
                             f"{scale})")
    # two launches of one eager decode step from the same cache
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 24))
                            .astype(np.int32)).to(dev)
    lg, cg = model.prefill(gpu, {"tokens": toks}, capacity=32)
    tok = lg.argmax(-1).to(torch.int32)[:, None]
    saved = {k: v.clone() for k, v in cg.items()}
    outs = []
    for _ in range(2):
        for k, v in saved.items():
            cg[k].copy_(v)
        outs.append(model.decode(gpu, cg, {"token": tok})[0])
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("zamba reference: two launches of one decode "
                             "step differ")
    prompts = [rng.integers(0, cfg.vocab_size, size=(3, S)).astype(np.int32)
               for S in (8, 24, 32)]
    want = [ExpertEngine(model, cpu, max_len=64, device="cpu").generate(t, 12)
            for t in prompts]
    graph = ExpertEngine(model, gpu, max_len=64, device=dev)
    got = [graph.generate(t, 12) for t in prompts]
    eager = ExpertEngine(model, gpu, max_len=64, device=dev,
                         capture_decode=False)
    got_eager = [eager.generate(t, 12) for t in prompts]
    if not all(np.array_equal(a, c) and np.array_equal(b, c)
               for a, b, c in zip(got, got_eager, want)):
        raise AssertionError(f"zamba reference: greedy tokens differ (graph,"
                             f" eager, CPU)\n{got}\n{got_eager}\n{want}")
    if not graph.stats.decode_captured:
        raise AssertionError("zamba reference: no decode graph captured")
    # the loss and its gradients
    seq = rng.integers(0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(seq[:, :-1]),
             "labels": torch.from_numpy(seq[:, 1:])}
    (loss_c, _), grad_c = value_and_grad(model.loss, cpu, batch)
    (loss_g, _), grad_g = value_and_grad(
        model.loss, gpu, {k: v.to(dev) for k, v in batch.items()})
    grad_err = 0.0
    for a, b in zip(leaves(grad_g), leaves(grad_c)):
        d = (a.cpu() - b).abs()
        bound = ZAMBA_GRAD_TOL * (b.abs() + b.abs().max())
        grad_err = max(grad_err, (d / (b.abs() + b.abs().max())
                                  .clamp_min(1e-30)).max().item())
        if not bool((d <= bound).all()):
            raise AssertionError(f"zamba reference: a gradient leaf differs "
                                 f"by {d.max().item()}")
    if abs(loss_g.item() - loss_c.item()) > 1e-5 * abs(loss_c.item()):
        raise AssertionError(f"zamba reference: loss {loss_g.item()} on the "
                             f"card, {loss_c.item()} on the CPU")
    return {"config": cfg.name, "n_layers": cfg.n_layers,
            "attn_every": cfg.attn_every, "attn_apps": model.n_attn_apps,
            "ssm_chunk": cfg.ssm_chunk, "prompt_lens": [8, 24, 32],
            "decode_steps": n_steps, "launches": launches,
            "max_abs_err": worst, "logits_scale": scale,
            "tol": "abs 1e-4 x max(|logit|, 1), logits and cache leaves",
            "decode_bit_equal": True, "tokens_equal_graph_eager_cpu": True,
            "new_tokens": 12, "loss": loss_c.item(),
            "loss_abs_err": abs(loss_g.item() - loss_c.item()),
            "grad_max_err_of_scale": grad_err,
            "grad_tol": f"{ZAMBA_GRAD_TOL} x (|cpu| + max|cpu|)"}


def serve_zamba_phase(np, torch, dev, ops, shapes):
    """Two full-width bf16 ``zamba2_7b`` engines (81 Mamba2 layers, d_model
    3584, d_inner 7168, 112 SSM heads of 64, state 64, conv 4, chunk 128;
    one shared attention block of 32 heads of 112 over 32 KV heads and
    d_ff 14336, applied after every 6th layer: 13 applications, each
    with its own K/V; vocab 32000 untied; random seeded weights, ring,
    ``max_len`` 256) and two ``llama3_2_1b`` engines sharing the serve
    phase's weight tensors, behind an AE bank of K = 4 built from seeded
    AEs (coarse scoring through ``expert_score``). The 24 fingerprints
    are chosen by their route on the CPU copy of the bank (relative
    margin >= 1e-3): 7 per Zamba2 expert, 5 per llama one; prompts of
    8-64 tokens, 16 new each. Graph serial, graph overlapped, eager
    serial, eager overlapped. Held: every run's tokens equal the first's;
    ``host_blocks`` the executor's count (192 / 12, as serve_rwkv's fleet
    of the same shape);
    ``decode_attention`` launches = 16 x the llama decode steps (the
    Zamba2 engines attend through plain ``attention``: none of theirs),
    no other decode kernel; ``expert_score`` / ``cosine_scores`` once per
    route chunk; each request's expert and class equal a CPU Router's."""
    from repro_torch.configs import get_config
    from repro_torch.core import (ExpertRegistry, MatcherConfig,
                                  build_matcher, init_ae)
    from repro_torch.models import build_model
    from repro_torch.serve import ExpertEngine, Request, RoutedServer

    rng = np.random.default_rng(SEED + 13)
    names = [n for n, _, _ in ZAMBA_FLEET]
    aes = [init_ae(torch.Generator().manual_seed(SEED + 90 + i),
                   device="cpu") for i in range(len(names))]
    cent_data = [(rng.random((256, 784), dtype=np.float32),
                  np.arange(256) % 4) for _ in names]
    m_cpu = build_matcher(aes, names, cent_data, device="cpu")
    matcher = build_matcher(aes, names, cent_data,
                            MatcherConfig(use_kernel=True), device=dev)
    cands, best, margin = routed_candidates(np, torch, m_cpu, rng)
    picks = []
    for e, (name, _, n) in enumerate(ZAMBA_FLEET):
        idx = np.flatnonzero((best == e) & (margin >= 1e-3))
        if len(idx) < n:
            raise AssertionError(f"serve_zamba: only {len(idx)} of 4096 "
                                 f"fingerprints route to {name}")
        picks += [(name, cands[j], int(rng.integers(8, 65)))
                  for j in idx[:n]]
    picks = [picks[i] for i in rng.permutation(len(picks))]

    zcfg = get_config("zamba2_7b")
    zmodel = build_model(zcfg)
    ring = shapes["registry"]
    lmodel = shapes["engine"].model
    registry, eager = ExpertRegistry(), ExpertRegistry()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    for e, (name, family, _) in enumerate(ZAMBA_FLEET):
        if family == "hybrid":
            gen = torch.Generator(device=dev).manual_seed(SEED + 110 + e)
            model, params = zmodel, zmodel.init(gen, device=dev)
        else:
            model, params = lmodel, ring[e - 2].backend.params
        registry.add(name, ExpertEngine(model, params, max_len=256,
                                        device=dev))
        eager.add(name, ExpertEngine(model, params, max_len=256, device=dev,
                                     capture_decode=False))
    torch.cuda.synchronize()
    zamba_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
    engines = [registry[e].backend for e in range(len(registry))]
    is_zamba = [f == "hybrid" for _, f, _ in ZAMBA_FLEET]

    def requests(uid0):
        return [Request(uid=uid0 + u, features=f,
                        prompt=np.random.default_rng(SEED + 200 + u).integers(
                            0, zcfg.vocab_size, size=n).astype(np.int32),
                        max_new_tokens=16)
                for u, (_, f, n) in enumerate(picks)]

    warm_graphs(RoutedServer, matcher, registry, requests(0), dev)
    want_routes = cpu_routes(np, torch, matcher, requests(0))
    runs, tokens = {}, {}
    for capture, executor in RUNS:
        label = f"serve_zamba {'graph' if capture else 'eager'} {executor}"
        reg = registry if capture else eager
        fleet = [reg[e].backend for e in range(len(reg))]
        server = RoutedServer(matcher, reg, executor=executor, device=dev)
        before = [e.stats.as_dict() for e in fleet]
        reqs = requests(0)
        resps, dt, launches, chunks = timed_serve(torch, ops, server, reqs)
        chunks = route_chunks(label, chunks, launches)
        check_routes(label, want_routes, resps)
        for r in resps:
            vocab = fleet[names.index(r.expert)].model.cfg.padded_vocab
            check_responses(label, [r], [reqs[r.uid]], vocab)
        delta = engine_delta(fleet, before)
        steps = [e.stats.decode_steps - b["decode_steps"]
                 for e, b in zip(fleet, before)]
        z_steps = sum(s_ for s_, z in zip(steps, is_zamba) if z)
        l_steps = sum(steps) - z_steps
        check_decode_launches(label, launches, "decode_attention",
                              lmodel.cfg.n_layers, l_steps)
        check_blocks(label, delta, HOST_BLOCKS["serve_zamba"][executor])
        if not z_steps:
            raise AssertionError(f"{label}: no Zamba2 decode step")
        n_tok = sum(len(r.tokens) for r in resps)
        tokens[label] = [(r.expert, r.tokens) for r in resps]
        runs[label] = {
            "seconds": dt, "req_per_s": len(resps) / dt,
            "generated_tok_per_s": n_tok / dt, "tokens": n_tok,
            "decode_steps_zamba": z_steps, "decode_steps_llama": l_steps,
            **delta, "launches": launches, "route_chunks": chunks,
            "routed": {n: sum(r.expert == n for r in resps) for n in names},
            "prefill_buckets": {n: sorted(e.core._prefill_shapes)
                                for n, e in zip(names, fleet)}}
    same_tokens("serve_zamba", tokens,
                lambda a, b: a[0] == b[0] and np.array_equal(a[1], b[1]))
    rows = max(max(e.stats.decode_graphs, default=0)
               for e, z in zip(engines, is_zamba) if z)
    return ({"phase": "serve_zamba", "config": zcfg.name,
             "experts": {n: f for n, f, _ in ZAMBA_FLEET},
             "requests": len(picks), "max_new_tokens": 16,
             "prompt_len": [8, 64], "kv": "ring", "max_len": 256,
             "zamba_param_gb": zamba_gb, "attn_apps": zmodel.n_attn_apps,
             "tokens_equal": True, "tokens_equal_graph_eager": True,
             "routes_equal_cpu": True,
             "runs": {k.split(" ", 1)[1]: v for k, v in runs.items()},
             "graphs": graph_stats(engines)},
            {"cfg": zcfg, "model": zmodel, "params": engines[0].params,
             "decode_rows": rows})


def breakdown_zamba_phase(np, torch, dev, zshapes):
    """One full-width Zamba2 wave's decode tick at B 8 after a 64-token
    prefill (ring of 256): eager wall, device time (the step replayed as
    a CUDA graph), kernels and busy share (``step_times``); the engine's
    own tick replayed and eager (``engine_step``; no ``decode_attention``
    launch in it); where the device time goes, each part captured and
    replayed alone: the tick of the same weights without the shared
    block (``attn_every`` 0: the 13 applications' share is the
    difference), one Mamba2 layer (rmsnorm, ``mamba_step``, residual; x
    81) and its ``w_out`` promoted to f32 (the reference's ``f32 @ bf16``,
    x 81); the tick against its least bytes: every Mamba2 layer's
    parameters, the shared block's once per application, ``ln_f`` and the
    unembedding, the SSM states and conv windows read and written, and
    the K/V of the live slots of each application."""
    from repro_torch.models import build_model
    from repro_torch.models.common import rmsnorm
    from repro_torch.models.mamba2 import mamba_step
    from repro_torch.models.common import stack_views

    cfg, model, params = zshapes["cfg"], zshapes["model"], zshapes["params"]
    B, Sb, n = 8, 64, 20
    rng = np.random.default_rng(SEED + 3)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(B, Sb)).astype(np.int32)).to(dev)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)

    def tick(m, p):
        _, cache = m.prefill(p, {"tokens": toks}, capacity=256)
        fixed = {k: cache[k].clone() for k in ("t", "attn_pos")
                 if k in cache}

        def step():
            # positions restart each call; the states evolve (same work)
            for k, v in fixed.items():
                cache[k].copy_(v)
            return m.decode(p, cache, {"token": tok})[0]
        return step_times(torch, step, n), cache

    timed, cache = tick(model, params)
    timed.pop("by_name")
    timed.pop("launches_by_name")

    def nb(t):
        return t.numel() * t.element_size()

    A = model.n_attn_apps
    layer_b = sum(nb(t) for t in _leaves(params["layers"]))
    shared_b = sum(nb(t) for t in _leaves(params["shared"]))
    head_b = nb(params["unembed"]) + nb(params["ln_f"]) \
        + B * cfg.d_model * params["embed"].element_size()
    state_b = 2 * sum(nb(cache[k]) for k in ("ssm", "conv_x", "conv_B",
                                             "conv_C"))
    kv_b = 2 * A * B * (Sb + 1) * cfg.n_kv_heads * cfg.dh \
        * cache["attn_k"].element_size()
    del cache
    bound_b = layer_b + A * shared_b + head_b + state_b + kv_b

    # the parts, each captured and replayed alone
    plain = build_model(cfg.replace(attn_every=0))
    no_apps, cache = tick(plain, {k: v for k, v in params.items()
                                  if k != "shared"})
    lp = next(stack_views(params["layers"]))
    x = torch.randn((B, 1, cfg.d_model), device=dev).to(
        params["embed"].dtype)
    conv = {k: cache[f"conv_{k}"][0] for k in ("x", "B", "C")}

    def mamba_layer():
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        return x + mamba_step(lp, h, cache["ssm"][0], conv, cfg)[0]

    layer = step_times(torch, mamba_layer, n)
    upcast = step_times(torch, lambda: lp["w_out"].float(), n)
    del cache
    full_ms = timed["graph_device_ms_per_step"]
    parts = {
        "no_shared_block_device_ms": no_apps["graph_device_ms_per_step"],
        "shared_block_apps": A,
        "shared_block_share": 1 - no_apps["graph_device_ms_per_step"]
        / full_ms,
        "mamba_layer_device_ms": layer["graph_device_ms_per_step"],
        "mamba_layers": cfg.n_layers,
        "mamba_layers_share": cfg.n_layers
        * layer["graph_device_ms_per_step"] / full_ms,
        "mamba_layer_kernels": layer["profiler_kernels_per_step"],
        "w_out_f32_device_ms": upcast["graph_device_ms_per_step"],
        "w_out_f32_share": cfg.n_layers
        * upcast["graph_device_ms_per_step"] / full_ms}
    engine = engine_step(np, torch, dev, model, params, B, Sb, n,
                         "decode_attention_kernel")
    if engine["decode_attention_kernel_launches_per_step"]:
        raise AssertionError("breakdown_zamba: decode_attention launched in "
                             "a Zamba2 tick")
    bound_ms = bound_b / HBM_BYTES_PER_S * 1e3
    return {"phase": "breakdown_zamba", "config": cfg.name, "rows": B,
            "prompt_len": Sb, "cache_len": 256, **timed, "parts": parts,
            "engine": engine,
            "engine_busy_share": engine["graph_kernel_ms_per_step"]
            / engine["graph_wall_ms_per_step"],
            "bytes_gb": {"mamba_layers": layer_b / 1e9,
                         "shared_block_x_apps": A * shared_b / 1e9,
                         "head": head_b / 1e9, "states_rw": state_b / 1e9,
                         "kv_live": kv_b / 1e9, "total": bound_b / 1e9},
            "bound_ms": bound_ms,
            "graph_tick_over_bound": engine["graph_wall_ms_per_step"]
            / bound_ms}


def launch_serve_phase(np, torch, dev, ops):
    """``repro_torch.launch.serve.main`` on the card with its default
    device, twice: the reference launcher's family cycle (RWKV6, Zamba2,
    smollm, qwen2_72b, and llama in the encoder-decoder and VLM slots, all
    reduced), then ``--hub-slots 2 --kv paged --trace`` (a reduced llama
    per dataset stored cold under a temporary directory). Each run trains
    its bank (``--n-per-dataset 1500 --epochs 30``) and serves 24
    requests of ``--max-new 8``. Held: every request answered with 8
    tokens; the family cycle's experts as the reference's rule gives
    them, and its RWKV6 and dense experts through their decode kernels;
    the trace file written. The launcher's own lines go to stderr."""
    import contextlib
    import tempfile

    from repro_torch.launch import serve as launch_serve

    base = ["--requests", "24", "--n-per-dataset", "1500", "--epochs", "30",
            "--max-new", "8"]
    out = {}
    with tempfile.TemporaryDirectory(prefix="launch-serve-") as tmp:
        trace = os.path.join(tmp, "serve.json")
        for label, extra in (("family_cycle", []),
                             ("hub", ["--hub-slots", "2", "--kv", "paged",
                                      "--trace", trace])):
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                got = launch_serve.main(base + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launches()
            resps = got["responses"]
            if len(resps) != 24 or any(r.tokens.shape != (8,)
                                       for r in resps):
                raise AssertionError(f"launch_serve {label}: bad responses "
                                     f"{resps}")
            out[label] = {"wall_s": wall, "serve_s": got["seconds"],
                          "req_per_s": len(resps) / got["seconds"],
                          "routing_accuracy": got["accuracy"],
                          "host_blocks": got["host_blocks"],
                          "archs": got["archs"], "launches": launches}
        out["hub"]["trace_bytes"] = os.path.getsize(trace)
        out["hub"]["trace_jsonl_bytes"] = os.path.getsize(trace + "l")
    fams = [launch_serve.expert_config(i, n).family
            for i, n in enumerate(out["family_cycle"]["archs"])]
    if fams != ["rwkv", "hybrid", "dense", "dense", "dense", "dense"]:
        raise AssertionError(f"launch_serve: families {fams}")
    cyc = out["family_cycle"]["launches"]
    if not cyc["wkv_step"] or not cyc["decode_attention"]:
        raise AssertionError(f"launch_serve: family cycle launches {cyc}")
    if not out["hub"]["launches"]["paged_decode_attention"]:
        raise AssertionError(f"launch_serve: hub launches "
                             f"{out['hub']['launches']}")
    return {"phase": "launch_serve", "args": base, **out}


# ---------------------------------------------------------------------------
# encoder-decoder: the reduced model card vs CPU, then full width
# ---------------------------------------------------------------------------

#: the reduced variants: plain attention everywhere, and the blockwise
#: (flash) branch with ``causal=False`` in the encoder and in the
#: prefill's cross-attention
ENCDEC_VARIANTS = {"plain": {},
                   "flash": {"enc_seq_len": 128, "attn_chunk": 32}}
ENCDEC_TOL = 1e-5
ENCDEC_GRAD_TOL = 2e-5
#: the cache leaves a decode step writes (``xk`` / ``xv`` are read only)
ENCDEC_MUTABLE = ("k", "v", "pos", "t")


def capture_step(torch, fn):
    """(graph, static output) of ``fn`` captured once as a CUDA graph,
    after one warm-up call on a side stream (which runs ``fn``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def encdec_greedy(torch, model, params, cache, first, n, graph):
    """n greedy tokens (B, n) on the host, decoding from ``first`` (B, 1)
    on ``cache`` in place; with ``graph`` one step is captured and
    replayed n times, else it runs eagerly. The cache's mutable leaves
    are restored after the warm-up and at the end."""
    saved = {k: cache[k].clone() for k in ENCDEC_MUTABLE}
    tok = first.clone()

    def restore():
        for k in ENCDEC_MUTABLE:
            cache[k].copy_(saved[k])

    def step():
        return model.decode(params, cache, {"token": tok})[0]

    if graph:
        g, logits = capture_step(torch, step)
        restore()

        def run():
            g.replay()
            return logits
    else:
        run = step
    out = []
    t0 = time.perf_counter()
    for _ in range(n):
        nxt = run().argmax(-1).to(torch.int32)
        out.append(nxt)
        tok.copy_(nxt[:, None])
    got = torch.stack(out, 1).cpu()
    wall = time.perf_counter() - t0
    restore()
    return got, wall


def encdec_reference(np, torch, dev):
    """A reduced f32 ``seamless_m4t_large_v2`` (2 encoder + 2 decoder
    layers, GQA 4 over 2) on the card and on the CPU from the same
    weights, in two variants: ``plain`` (``enc_seq_len`` 16, every
    attention on the plain branch) and ``flash`` (``enc_seq_len`` 128,
    ``attn_chunk`` 32: the encoder and the prefill's cross-attention on
    the blockwise branch with ``causal=False``). Held: the prefill's
    logits and every cache leaf, then 6 decode steps fed the CPU's
    tokens past the ring's capacity of 14 (it wraps), within
    ``ENCDEC_TOL`` x max(|CPU|, 1), ``pos`` and ``t`` equal; greedy
    tokens of 6 steps equal; two launches of one decode step bit-equal;
    a decode step captured as a CUDA graph and replayed gives the eager
    tokens; no kernel launched (the family attends through plain
    ``attention``, as the reference's); the loss within rtol 1e-5 and
    each gradient leaf within ``ENCDEC_GRAD_TOL`` x (|CPU| + max|CPU|)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, value_and_grad

    out = {"phase": "encdec_reference",
           "tol": f"abs {ENCDEC_TOL} x max(|cpu|, 1) per leaf",
           "grad_tol": f"{ENCDEC_GRAD_TOL} x (|cpu| + max|cpu|)"}
    for variant, kw in ENCDEC_VARIANTS.items():
        cfg = get_config("seamless_m4t_large_v2").reduced(
            name=f"smoke-encdec-{variant}", **kw)
        model = build_model(cfg)
        cpu = model.init(torch.Generator().manual_seed(SEED), device="cpu")
        gpu = _tree(cpu, lambda t: t.to(dev))
        rng = np.random.default_rng(SEED + 9)
        frames = torch.from_numpy((rng.standard_normal(
            (3, cfg.enc_seq_len, cfg.d_model)) * 0.1).astype(np.float32))
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(3, 12)).astype(np.int32))

        def both(fr=frames, tk=toks):
            return ({"frames": fr, "tokens": tk},
                    {"frames": fr.to(dev), "tokens": tk.to(dev)})

        errs = {}

        def hold(name, got, want):
            e = errs.setdefault(name, [0.0, 0.0])
            e[0] = max(e[0], (got.cpu().float() - want.float()).abs()
                       .max().item())
            e[1] = max(e[1], want.float().abs().max().item())

        ops.reset_launches()
        bc, bg = both()
        lc, cc = model.prefill(cpu, bc, capacity=14)
        lg, cg = model.prefill(gpu, bg, capacity=14)
        hold("prefill_logits", lg, lc)
        for key in cc:
            hold(f"prefill_{key}", cg[key], cc[key])
        for _ in range(6):
            tok = lc.argmax(-1).to(torch.int32)[:, None]
            lc, cc = model.decode(cpu, cc, {"token": tok})
            lg, cg = model.decode(gpu, cg, {"token": tok.to(dev)})
            hold("decode_logits", lg, lc)
        for key in cc:
            hold(f"decode_{key}", cg[key], cc[key])
        bad = {k: v for k, v in errs.items()
               if not v[0] <= ENCDEC_TOL * max(v[1], 1.0)}
        if bad or not (torch.equal(cg["pos"].cpu(), cc["pos"])
                       and int(cg["t"]) == int(cc["t"]) == 18):
            raise AssertionError(f"encdec reference {variant}: card differs "
                                 f"from the CPU (err, scale) {bad}")
        # greedy: each side feeds its own argmax
        bc, bg = both()
        lc, cc = model.prefill(cpu, bc, capacity=14)
        lg, cg = model.prefill(gpu, bg, capacity=14)
        want, got = [], []
        for _ in range(6):
            a = lc.argmax(-1).to(torch.int32)
            b = lg.argmax(-1).to(torch.int32)
            want.append(a)
            got.append(b.cpu())
            lc, cc = model.decode(cpu, cc, {"token": a[:, None]})
            lg, cg = model.decode(gpu, cg, {"token": b[:, None]})
        if not torch.equal(torch.stack(got), torch.stack(want)):
            raise AssertionError(f"encdec reference {variant}: greedy tokens "
                                 f"differ\n{torch.stack(got)}\n"
                                 f"{torch.stack(want)}")
        # two launches of one decode step from the same cache
        lg, cg = model.prefill(gpu, bg, capacity=14)
        first = lg.argmax(-1).to(torch.int32)[:, None]
        saved = {k: cg[k].clone() for k in ENCDEC_MUTABLE}
        twice = []
        for _ in range(2):
            for k, v in saved.items():
                cg[k].copy_(v)
            twice.append(model.decode(gpu, cg, {"token": first})[0].clone())
        if not torch.equal(twice[0], twice[1]):
            raise AssertionError(f"encdec reference {variant}: two launches "
                                 "of one decode step differ")
        for k, v in saved.items():
            cg[k].copy_(v)
        eager, _ = encdec_greedy(torch, model, gpu, cg, first, 8, False)
        replay, _ = encdec_greedy(torch, model, gpu, cg, first, 8, True)
        if not torch.equal(eager, replay):
            raise AssertionError(f"encdec reference {variant}: replayed "
                                 f"tokens differ from eager\n{replay}\n"
                                 f"{eager}")
        launches = ops.launches()
        if any(launches.values()):
            raise AssertionError(f"encdec reference {variant}: kernels "
                                 f"launched {launches}")
        # the loss and its gradients
        seq = rng.integers(0, cfg.vocab_size, size=(2, 17)).astype(np.int32)
        batch = {"frames": frames[:2], "tokens": torch.from_numpy(seq[:, :-1]),
                 "labels": torch.from_numpy(seq[:, 1:])}
        (loss_c, _), grad_c = value_and_grad(model.loss, cpu, batch)
        (loss_g, _), grad_g = value_and_grad(
            model.loss, gpu, {k: v.to(dev) for k, v in batch.items()})
        grad_err = 0.0
        for a, b in zip(leaves(grad_g), leaves(grad_c)):
            d = (a.cpu() - b).abs()
            ref = b.abs() + b.abs().max()
            grad_err = max(grad_err, (d / ref.clamp_min(1e-30)).max().item())
            if not bool((d <= ENCDEC_GRAD_TOL * ref).all()):
                raise AssertionError(f"encdec reference {variant}: a "
                                     f"gradient leaf differs by "
                                     f"{d.max().item()}")
        if abs(loss_g.item() - loss_c.item()) > 1e-5 * abs(loss_c.item()):
            raise AssertionError(f"encdec reference {variant}: loss "
                                 f"{loss_g.item()} on the card, "
                                 f"{loss_c.item()} on the CPU")
        out[variant] = {
            "config": cfg.name, "enc_seq_len": cfg.enc_seq_len,
            "attn_chunk": cfg.attn_chunk,
            "layers": [cfg.n_enc_layers, cfg.n_dec_layers],
            "heads": [cfg.n_heads, cfg.n_kv_heads], "prompt_len": 12,
            "capacity": 14, "decode_steps": 6,
            "max_abs_err_and_scale": errs, "greedy_equal": True,
            "decode_bit_equal": True, "graph_equals_eager": True,
            "launches": launches, "loss": loss_c.item(),
            "loss_abs_err": abs(loss_g.item() - loss_c.item()),
            "grad_max_err_of_scale": grad_err}
    return out


def encdec_prefill_flops(cfg, B, S):
    """Operations of one prefill (encoder + decoder over S prompt tokens,
    the unembedding of the last position), by part, counting a
    multiply-add as two and every attention score unmasked."""
    D, F, H, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.dh
    KV, Se = cfg.n_kv_heads, cfg.enc_seq_len
    Le, Ld = cfg.n_enc_layers, cfg.n_dec_layers
    proj = D * (H + 2 * KV) * dh + H * dh * D
    mlp = 3 * D * F
    return {
        "encoder_gemms": 2 * B * Se * (proj + mlp) * Le,
        "encoder_attention": 4 * B * H * Se * Se * dh * Le,
        "cross_kv_projections": 2 * B * Se * 2 * D * KV * dh * Ld,
        "decoder_gemms": 2 * B * S * (proj + 2 * D * H * dh + mlp) * Ld
        + 2 * B * D * cfg.padded_vocab,
        "decoder_self_attention": 4 * B * H * S * S * dh * Ld,
        "cross_attention": 4 * B * H * S * Se * dh * Ld}


def encdec_phase(np, torch, dev, ops):
    """Full-width bf16 ``seamless_m4t_large_v2``, depth not cut (24 + 24
    layers, d_model 1024, 16 heads of 64 over 16 KV heads, d_ff 8192,
    vocab 256206 padded to 256256, ``enc_seq_len`` 4096; random seeded,
    2.03 B parameters), B 8: stub frames (normal x 0.1) and 64-token
    prompts from ``SEED``, ring capacity 80. Prefill (encode + decoder
    prefill) wall ms, median of 3 after a warm-up, the encoder alone, and
    both against the operation bound at 989 TFLOP/s bf16; 16 greedy
    tokens eager, then with the decode step captured once and replayed:
    equal. No kernel launch in the phase (no ``decode_attention``: the
    reference's encdec decode uses plain ``attention``). The decode tick
    (``step_times``, pos / t restarted each call) against its least bytes
    (the decoder weights a step reads: self-attention, the cross
    attention's ``wq`` / ``wo``, MLP; the unembedding; the cross K/V; the
    self K/V ring) at 3.35 TB/s, and the 24 cross-attentions replayed
    alone (their share of the tick). Peak device memory."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.attention import attention

    cfg = get_config("seamless_m4t_large_v2")
    model = build_model(cfg)
    B, S, C, n_new = 8, 64, 80, 16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init(gen, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    frames = (torch.randn((B, cfg.enc_seq_len, cfg.d_model), generator=gen,
                          device=dev) * 0.1).to(torch.bfloat16)
    rng = np.random.default_rng(SEED + 10)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)).to(dev)
    batch = {"frames": frames, "tokens": toks}
    ops.reset_launches()

    def timed(fn, n=3):
        fn()                                   # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            del got
        return statistics.median(walls), walls

    enc_ms, enc_runs = timed(lambda: model.encode(params, frames))
    pre_ms, pre_runs = timed(lambda: model.prefill(params, batch,
                                                   capacity=C))
    logits, cache = model.prefill(params, batch, capacity=C)
    if not bool(torch.isfinite(logits).all()) or logits.shape != (
            B, cfg.padded_vocab):
        raise AssertionError("encdec: prefill logits not finite or "
                             f"misshapen {tuple(logits.shape)}")
    first = logits.argmax(-1).to(torch.int32)[:, None]
    del logits
    eager, eager_s = encdec_greedy(torch, model, params, cache, first, n_new,
                                   False)
    replay, replay_s = encdec_greedy(torch, model, params, cache, first,
                                     n_new, True)
    if not torch.equal(eager, replay):
        raise AssertionError(f"encdec: replayed tokens differ from eager\n"
                             f"{replay}\n{eager}")
    launches = ops.launches()
    if any(launches.values()):
        raise AssertionError(f"encdec: kernels launched {launches}")

    # the decode tick, restarted from the prefill's pos / t each call
    pos0, t0_ = cache["pos"].clone(), cache["t"].clone()

    def step():
        cache["pos"].copy_(pos0)
        cache["t"].copy_(t0_)
        return model.decode(params, cache, {"token": first})[0]

    tick = step_times(torch, step, 20)
    by_name = tick.pop("by_name")
    launches_by_name = tick.pop("launches_by_name")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the 24 cross-attentions alone
    qx = torch.randn((B, 1, cfg.n_heads, cfg.dh), generator=gen,
                     device=dev).to(torch.bfloat16)
    enc_pos = torch.arange(cfg.enc_seq_len, dtype=torch.int32, device=dev)
    q_pos = cache["t"].reshape(1)

    def cross():
        return [attention(qx, cache["xk"][i], cache["xv"][i], q_pos=q_pos,
                          kv_pos=enc_pos, causal=False)
                for i in range(cfg.n_dec_layers)]

    xt = step_times(torch, cross, 20)
    x_by_name = xt.pop("by_name")
    xt.pop("launches_by_name")

    def nb(t):
        return t.numel() * t.element_size()

    dec = params["dec_layers"]
    weights_b = sum(nb(t) for k, t in dec.items() if not isinstance(t, dict))
    weights_b += sum(nb(t) for part in ("attn", "mlp")
                     for t in dec[part].values())
    weights_b += nb(dec["xattn"]["wq"]) + nb(dec["xattn"]["wo"])
    head_b = nb(params["unembed"]) + nb(params["ln_f"]) \
        + B * cfg.d_model * params["embed"].element_size()
    cross_b = nb(cache["xk"]) + nb(cache["xv"])
    self_b = nb(cache["k"]) + nb(cache["v"])
    bound_b = weights_b + head_b + cross_b + self_b
    bound_ms = bound_b / HBM_BYTES_PER_S * 1e3
    flops = encdec_prefill_flops(cfg, B, S)
    total = sum(flops.values())
    attn = (flops["encoder_attention"] + flops["decoder_self_attention"]
            + flops["cross_attention"])
    pre_bound = total / PEAK_FLOPS["bfloat16"] * 1e3
    enc_bound = (flops["encoder_gemms"] + flops["encoder_attention"]) \
        / PEAK_FLOPS["bfloat16"] * 1e3
    # the attention scores and products run in f32, as the reference's
    f32_bound = ((total - attn) / PEAK_FLOPS["bfloat16"]
                 + attn / PEAK_FLOPS["float32"]) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tick_ms = tick["graph_device_ms_per_step"]
    out = {"phase": "encdec", "config": cfg.name,
           "layers": [cfg.n_enc_layers, cfg.n_dec_layers],
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "dh": cfg.dh, "d_ff": cfg.d_ff, "padded_vocab": cfg.padded_vocab,
           "enc_seq_len": cfg.enc_seq_len, "attn_chunk": cfg.attn_chunk,
           "params": n_params, "param_gb": sum(
               nb(t) for t in _leaves(params)) / 1e9,
           "rows": B, "prompt_len": S, "capacity": C, "new_tokens": n_new,
           "prefill_ms": pre_ms, "prefill_ms_runs": pre_runs,
           "encode_ms": enc_ms, "encode_ms_runs": enc_runs,
           "prefill_tflop": {k: v / 1e12 for k, v in flops.items()},
           "prefill_bound_ms": pre_bound, "prefill_bound_by": "operations",
           "prefill_utilisation": pre_bound / pre_ms,
           "encode_bound_ms": enc_bound,
           "encode_utilisation": enc_bound / enc_ms,
           "prefill_bound_ms_attention_f32": f32_bound,
           "tokens_equal_eager_replayed": True,
           "eager_decode_s": eager_s, "replayed_decode_s": replay_s,
           "launches": launches,
           "tick": {**tick,
                    "top_kernels_ms": [[k[:60], v, launches_by_name[k]]
                                       for k, v in top]},
           "tick_bound_gb": {"decoder_weights": weights_b / 1e9,
                             "head": head_b / 1e9, "cross_kv": cross_b / 1e9,
                             "self_kv": self_b / 1e9,
                             "total": bound_b / 1e9},
           "tick_bound_ms": bound_ms, "tick_bound_by": "bytes",
           "tick_over_bound": tick_ms / bound_ms,
           "cross_attention": {
               "device_ms": xt["graph_device_ms_per_step"],
               "wall_ms": xt["wall_ms_per_step"],
               "kernels": xt["profiler_kernels_per_step"],
               "share_of_tick": xt["graph_device_ms_per_step"] / tick_ms,
               "bound_ms": cross_b / HBM_BYTES_PER_S * 1e3,
               "top_kernels_ms": [[k[:60], v] for k, v in sorted(
                   x_by_name.items(), key=lambda kv: -kv[1])[:4]]},
           "peak_memory_gb": peak_gb}
    del params, cache, frames
    return out


# ---------------------------------------------------------------------------
# examples: the port's three examples on the card
# ---------------------------------------------------------------------------

#: every kernel the examples' paths launch between them
EXAMPLE_KERNELS = ("expert_score", "cosine_scores", "decode_attention",
                   "paged_decode_attention", "wkv_step")


def examples_phase(np, torch, dev, ops):
    """``repro_torch.examples.<name>.main([... "--device", "cuda"])`` on the
    card: ``quickstart`` at its defaults, ``train_expert --steps 50`` and
    ``serve_routing --n-per-dataset 600 --requests 24`` in each mode (the
    default overlapped executor, ``--executor serial``, ``--banked``,
    ``--hub --resident 2``, ``--long-prompt``). Held: the default mode's
    matcher routes more than 90% of every client_a row (900 rows, after
    the launch counts are read; the 24 requests' accuracy is reported,
    not held: at a true ~97% three misroutes in 24 are a few percent
    likely) and quickstart's coarse accuracy > 0.9 on each client
    split; serial == overlapped and banked == per-engine
    (expert, fine class, tokens) per request; the hub's cold request
    parked, loaded, then served by its expert; long-prompt tokens equal
    chunked and storage-only, with fewer prompt tokens computed chunked;
    the checkpoint round trip bit-equal and the loss falling; each of
    ``EXAMPLE_KERNELS`` launched in the phase (a replay counts the
    launches its capture recorded). The examples' own lines go to
    stderr."""
    import contextlib

    from repro_torch.data import load_benchmark
    from repro_torch.examples import quickstart, serve_routing, train_expert

    torch.cuda.synchronize()
    ops.reset_launches()
    t_phase = time.perf_counter()
    runs = {}

    def run(label, mod, argv):
        torch.cuda.synchronize()
        before = ops.launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            got = mod.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        after = ops.launches()
        runs[label] = {"wall_s": time.perf_counter() - t0,
                       "launches": {k: after[k] - before[k] for k in after}}
        return got

    qs = run("quickstart", quickstart, [])
    if min(np.mean(a) for a in qs["coarse_accuracy"].values()) <= 0.9:
        raise AssertionError(f"examples: quickstart coarse accuracy "
                             f"{qs['coarse_accuracy']}")
    runs["quickstart"]["coarse_accuracy"] = qs["coarse_accuracy"]
    te = run("train_expert", train_expert, ["--steps", "50"])
    hist = te["history"]
    if not te["round_trip_bit_equal"] or not hist[-1][1] < hist[0][1]:
        raise AssertionError(f"examples: train_expert {hist}")
    runs["train_expert"].update(history=hist, n_params=te["n_params"])
    base = ["--n-per-dataset", "600", "--requests", "24"]
    modes = {"default": [], "serial": ["--executor", "serial"],
             "banked": ["--banked"], "hub": ["--hub", "--resident", "2"],
             "long_prompt": ["--long-prompt"]}
    got = {m: run(f"serve_routing {m}", serve_routing, base + extra)
           for m, extra in modes.items()}
    ref = got["default"]["responses"]
    for m in ("serial", "banked"):
        if got[m]["responses"] != ref:
            bad = [u for u in ref if got[m]["responses"][u] != ref[u]]
            raise AssertionError(f"examples: {m} responses differ from the "
                                 f"default run's at uids {bad}")
    cold = got["hub"]["cold_start"]
    states = [s for _, s in cold["states"]]
    if not (states[0] != "resident" and states[-1] == "resident"
            and cold["misses"] >= 1 and cold["loads"] >= 1
            and cold["served_by"] == cold["expert"]):
        raise AssertionError(f"examples: hub cold start {cold}")
    lp = got["long_prompt"]["long_prompt"]
    if not (lp["chunked+suffix"]["tokens"] == lp["storage-only"]["tokens"]
            and lp["chunked+suffix"]["computed"]
            < lp["storage-only"]["computed"]):
        raise AssertionError("examples: long-prompt chunked vs storage-only")
    for m, g in got.items():
        r = runs[f"serve_routing {m}"]
        if m == "long_prompt":
            r["computed"] = {k: v["computed"] for k, v in lp.items()}
            continue
        r.update(serve_s=g["seconds"], req_per_s=24 / g["seconds"],
                 accuracy=g["accuracy"], repeat_s=g["repeat"]["seconds"],
                 host_blocks=sum(c["host_blocks"]
                                 for c in g["engines"].values()))
    runs["serve_routing hub"].update(cold_start=cold,
                                     hub_stats=got["hub"]["hub_stats"])
    launches = ops.launches()
    missing = [k for k in EXAMPLE_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"examples: {missing} never launched "
                             f"({launches})")
    # the default run's matcher over every client_a row (the same process
    # draws the same data: load_benchmark salts by the process's hash)
    bench = load_benchmark(n_per_dataset=600, seed=0)
    names, matcher = got["default"]["names"], got["default"]["matcher"]
    hits = rows = 0
    for i, n in enumerate(names):
        x = torch.from_numpy(np.ascontiguousarray(bench[n]["client_a"][0]))
        pred = matcher.route(x.to(dev))["coarse"][:, 0].cpu().numpy()
        hits, rows = hits + int((pred == i).sum()), rows + len(pred)
    runs["serve_routing default"]["client_a_accuracy"] = hits / rows
    if hits / rows <= 0.9:
        raise AssertionError(f"examples: routing accuracy {hits}/{rows} "
                             f"over every client_a row")
    return {"phase": "examples", "wall_s": time.perf_counter() - t_phase,
            "launches": launches, "runs": runs}


# ---------------------------------------------------------------------------
# kernels: each against its plain version, timed beside its bound
# ---------------------------------------------------------------------------


def make_timers(torch, dev):
    """(device_ms, record): ``device_ms(fn)`` is the median device time of
    one call with L2 flushed before each; ``record`` holds a kernel's
    result to its plain version's and times the kernel, the plain
    version and a library yardstick, as a summary row."""
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

    return device_ms, record


def kernel_phase(np, torch, dev, ops, shapes):
    import torch.nn.functional as F

    from repro_torch.kernels import build

    gen = torch.Generator(device=dev).manual_seed(SEED)
    device_ms, record = make_timers(torch, dev)

    # the launch floor: the least a flushed launch reads here
    one = torch.zeros(1, device=dev)
    floor = [device_ms(lambda: one.add_(1))]
    out = []

    # -- kernel 1: expert_score at the router's row bucket, and at B = 64,
    # where two row tiles make 12 clusters that the plan keeps in one wave
    row = expert_kernel_row(torch, dev, ops, build, gen, record, device_ms,
                            shapes["route_rows"])
    row["ptxas"] = ptxas_report(build.build_log, "expert_score_kernel")
    wide = expert_kernel_row(torch, dev, ops, build, gen, record, device_ms,
                             64)
    row["cases"] = {"b64": {k: wide[k] for k in (
        "max_abs_err", "rtol", "atol", "ms", "ms_runs", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "shape", "plan")}}
    out.append(row)

    # -- kernel 2: cosine_fine over the serve phase's route chunk, and
    # cosine_scores (the same body, one expert) at its largest group ----
    row = cosine_kernel_row(torch, F, dev, ops, gen, record, shapes)
    row["ptxas"] = ptxas_report(build.build_log, "cosine_fine_kernel",
                                "Lb1E")
    out.append(row)

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
    row = record(
        "decode_attention",
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:76", got, want, 4e-3, 4e-3,
        kern, plain, lib3,
        "F.scaled_dot_product_attention(enable_gqa=True, bool mask)",
        2 * (2 * B3 * Hq * dh + 2 * B3 * live * KV * dh) + 4 * (S + 1),
        4 * B3 * Hq * live * dh, "bfloat16", [B3, Hq, KV, dh, S, live])
    row.update(decode_body(ops, build, "RingAddr", B3, KV, Hq // KV, S, 0,
                           dh))
    # a long ring at B = 1: 8 (row, kv head) pairs, so the split fills the
    # card
    row["cases"] = {"ring_b1_s4096": ring_case(
        torch, F, ops, gen, dev, record, L, 1, Hq, KV, dh, 4096, 4000)}
    # the olmoe decode shape (serve_moe's fullest ring at B 8): dh 128,
    # 16 heads over 16 KV heads
    mo = shapes["moe"]
    mc = mo["cfg"]
    olmoe = ring_case(torch, F, ops, gen, dev, record, mc.n_layers, 8,
                      mc.n_heads, mc.n_kv_heads, mc.dh, 256,
                      mo["decode_q_pos"] + 1)
    olmoe.update(decode_body(ops, build, "RingAddr", 8, mc.n_kv_heads,
                             mc.n_heads // mc.n_kv_heads, 256, 0, mc.dh))
    row["cases"]["olmoe_b8_dh128"] = olmoe
    out.append(row)

    # -- kernel 4: paged_decode_attention over one paged decode step's 16
    # layers, at the serve_paged phase's largest decode bucket ----------
    ps = shapes["paged"]
    B4, live4 = ps["rows"], ps["live"]
    row, q4 = paged_row(np, torch, F, ops, gen, dev, record, L, B4, Hq, KV,
                        dh, ps["page"], ps["n_logical"], ps["n_pages"], live4)
    # the other page size and a window: plain version and bit equality
    extra = {}
    for name, pg, n, win in (("page16", 16, 16, 0), ("window", 8, 32, 40)):
        pk = torch.randn(3 * B4 * n + 1, 2, pg, KV, dh, generator=gen,
                         device=dev).to(bf)
        pv = torch.randn(pk.shape, generator=gen, device=dev).to(bf)
        tb, po, tq = paged_case(np, torch, dev, B4, n, pg, pk.shape[0] - 1,
                                live4)
        a = ops.paged_decode_attention(q4, pk[:, 1], pv[:, 1], tb, tq, po,
                                       window=win)
        b = ops.paged_decode_attention_plain(q4, pk[:, 1], pv[:, 1], tb, tq,
                                             po, window=win)
        err = (a.float() - b.float()).abs().max().item()
        if not torch.allclose(a.float(), b.float(), rtol=4e-3, atol=4e-3):
            raise AssertionError(f"paged_decode_attention {name}: max abs "
                                 f"err {err}")
        extra[name] = {"max_abs_err": err, "equals_ring": paged_equals_ring(
            torch, ops, q4, pk[:, 1], pv[:, 1], tb, tq, po, win)}
    del pk, pv
    # the olmoe paged decode shape (serve_moe's largest paged decode
    # bucket of a MoE engine, its fullest step): dh 128, group 1
    mp = mo["paged"]
    olmoe4, _ = paged_row(np, torch, F, ops, gen, dev, record, mc.n_layers,
                          mp["rows"], mc.n_heads, mc.n_kv_heads, mc.dh,
                          mp["page"], mp["n_logical"], mp["n_pages"],
                          mp["live"])
    extra["olmoe_paged"] = {k: olmoe4[k] for k in CASE_KEYS
                            + ("equals_ring_bitwise",)}
    extra["olmoe_paged"].update(decode_body(
        ops, build, "PagedAddr", mp["rows"], mc.n_kv_heads,
        mc.n_heads // mc.n_kv_heads, mp["n_logical"] * mp["page"],
        mp["n_logical"], mc.dh))
    row["cases"] = extra
    row.update(decode_body(ops, build, "PagedAddr", B4, KV, Hq // KV,
                           ps["n_logical"] * ps["page"], ps["n_logical"],
                           dh))
    out.append(row)
    row = wkv_kernel_row(torch, dev, ops, gen, record, shapes["rwkv_rows"])
    row["ptxas"] = ptxas_report(build.build_log, "wkv_step_kernel",
                                "__nv_bfloat16", "Li64E")
    big = wkv_kernel_row(torch, dev, ops, gen, record, 32)
    row["cases"] = {"b32": {k: big[k] for k in (
        "max_abs_err", "rtol", "atol", "ms", "ms_runs", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "shape", "chain_steps",
        "chain_max_abs_err_o", "chain_max_abs_err_state")}}
    out.append(row)
    floor.append(device_ms(lambda: one.add_(1)))
    for r in out:
        for c in (r, *r.get("cases", {}).values()):
            if "ms" in c:
                c["ms_minus_floor"] = c["ms"] - min(floor)
    return out, floor


def expert_kernel_row(torch, dev, ops, build, gen, record, device_ms, B):
    """Kernel 1 at B rows, the router's bank widths (K 6, D 784, H 128),
    against the plain version at rtol 2e-5, atol 1e-6, two launches
    bit-equal, with the planner's launch shape. ``plan.ms_by_n`` times
    the same launch at the planned cluster size and at 8, 11 and 16
    blocks (through the C entry, uncounted): the evidence that the
    largest size whose clusters are all resident at once is the fastest."""
    from repro_torch.kernels.expert_score import max_clusters
    K, D, H = 6, 784, 128
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

    row = record(
        "expert_score", "src/repro_torch/kernels/csrc/expert_score.cu",
        "src/repro/kernels/expert_score.py:39", got, want, 2e-5, 1e-6,
        lambda: ops.expert_score_folded(folded, x),
        lambda: ops.expert_score_plain(folded, x), lib1,
        "torch.baddbmm x2 + square/sum", 4 * (B * D + K * (2 * D * H + H + D)
                                              + B * K),
        2 * B * K * 2 * D * H, "float32", [B, K, D, H])
    if not torch.equal(got, ops.expert_score_folded(folded, x)):
        raise AssertionError(f"expert_score B={B}: two launches differ")

    lib = build.library()

    def active(m, r):
        return max_clusters(torch.cuda.current_device(), D, H, m, r)

    n, rows = ops.expert_split(B, D, H, K, active)
    tiles = -(-B // rows)

    def at(m):
        res = torch.empty_like(got)

        def call():
            build.check(lib.expert_score_f32(
                x.data_ptr(), folded["w1"].data_ptr(),
                folded["b1"].data_ptr(), folded["w2"].data_ptr(),
                folded["b2"].data_ptr(), res.data_ptr(), B, D, H, K, m,
                rows, torch.cuda.current_stream().cuda_stream),
                "expert_score")
        call()
        if not torch.allclose(res, want, rtol=2e-5, atol=1e-6):
            raise AssertionError(f"expert_score B={B} n={m}: off the plain")
        return device_ms(call)

    row.update({"bit_equal_launches": True, "plan": {
        "n_rank": n, "rows": rows, "blocks": n * tiles * K,
        "clusters": tiles * K, "active_clusters": active(n, rows),
        "active_clusters_by_n": {m: active(m, rows) for m in range(7, 17)},
        "slices": ops.expert_slices(D, n),
        "dynamic_smem_bytes": lib.expert_score_smem_bytes(D, H, n, rows),
        "ms_by_n": {m: at(m) for m in sorted({n, 8, 11, 16})}}})
    return row


def cosine_kernel_row(torch, F, dev, ops, gen, record, shapes):
    """Kernel 2 as the main path launches it: one route chunk of the
    serve phase, every routed expert group's row bucket stacked (a
    group's rows, then its zero padding, as the router pads), each row
    against its own expert's centroids in the serve matcher's stacked
    (K 6, M 10, h 128) tensor with its class masks, and the argmax. Held
    to ``cosine_fine_plain`` at rtol 2e-5, atol 1e-6 with the same -inf
    positions and equal classes; two launches, and ``cosine_scores``
    launched group by group, give the same bits. The library yardstick
    gathers ``centroids[expert]`` and runs F.normalize x2 + bmm +
    masked_fill + argmax. Case ``single_group``: ``cosine_scores`` (the
    TPU kernel's signature) at the largest group's bucket, and its
    classes through ``cosine_fine`` with one expert, equal to the plain
    version's."""
    m = shapes["matcher"]
    C, Mk = m.centroids, m.centroid_mask
    K, M, h = C.shape
    groups = shapes["route_groups"]
    zs, ex = [], []
    for e, n, nb in groups:
        z = torch.zeros(nb, h, device=dev)
        z[:n] = torch.relu(torch.randn(n, h, generator=gen, device=dev))
        zs.append(z)
        ex += [e] * nb
    z = torch.cat(zs)
    R = len(z)
    ex = torch.tensor(ex, dtype=torch.int32, device=dev)
    exl = ex.long()
    got, cls = ops.cosine_fine(z, C, Mk, ex)
    want, want_cls = ops.cosine_fine_plain(z, C, Mk, ex)
    if not torch.equal(cls, want_cls):
        raise AssertionError(f"cosine_fine: classes {cls.tolist()} differ "
                             f"from the plain version's {want_cls.tolist()}")
    again = ops.cosine_fine(z, C, Mk, ex)
    if not (torch.equal(again[0], got) and torch.equal(again[1], cls)):
        raise AssertionError("cosine_fine: two launches differ")
    o = 0
    for e, _, nb in groups:
        if not torch.equal(ops.cosine_scores(z[o:o + nb], C[e], Mk[e]),
                           got[o:o + nb]):
            raise AssertionError(f"cosine_fine: expert {e}'s rows differ "
                                 "from its own cosine_scores launch")
        o += nb

    def lib():
        cn = F.normalize(C[exl], dim=-1)
        s = torch.bmm(cn, F.normalize(z, dim=-1)[:, :, None])[:, :, 0]
        s = s.masked_fill_(Mk[exl] <= 0, float("-inf"))
        return s, s.argmax(-1)

    used = len(groups)          # each routed expert's centroids, read once
    row = record(
        "cosine_scores", "src/repro_torch/kernels/csrc/cosine_scores.cu",
        "src/repro/kernels/cosine_topk.py:27", got, want, 2e-5, 1e-6,
        lambda: ops.cosine_fine(z, C, Mk, ex),
        lambda: ops.cosine_fine_plain(z, C, Mk, ex), lib,
        "centroids[expert] gather + F.normalize x2 + bmm + masked_fill + "
        "argmax", 4 * (R * h + used * (M * h + M) + R + R * M) + 8 * R,
        2 * R * M * h + 2 * R * h + 2 * used * M * h, "float32", [R, K, M, h])
    row.update({"entry": "cosine_fine", "groups": groups,
                "classes_equal": True, "bit_equal_launches": True,
                "bit_equal_per_group": True})

    # the TPU kernel's signature at the largest group's bucket
    B2 = shapes["group_rows"]
    zs = torch.relu(torch.randn(B2, h, generator=gen, device=dev))
    zs[-1] = 0.0                     # a router zero-padding row
    cents = torch.relu(torch.randn(M, h, generator=gen, device=dev))
    mask = (torch.arange(M, device=dev) < M - 3).float()
    got = ops.cosine_scores(zs, cents, mask)
    if not torch.equal(got, ops.cosine_scores(zs, cents, mask)):
        raise AssertionError("cosine_scores: two launches differ")
    # its classes: the same inputs through the grouped entry, one expert
    one_ex = torch.zeros(B2, dtype=torch.int32, device=dev)
    fine1, cls1 = ops.cosine_fine(zs, cents[None], mask[None], one_ex)
    want_cls1 = ops.cosine_fine_plain(zs, cents[None], mask[None], one_ex)[1]
    if not (torch.equal(fine1, got) and torch.equal(cls1, want_cls1)):
        raise AssertionError(
            f"cosine_scores: classes {cls1.tolist()} (or scores) through "
            f"cosine_fine differ from the plain version's "
            f"{want_cls1.tolist()}")

    def lib1():
        s = F.normalize(zs, dim=-1) @ F.normalize(cents, dim=-1).T
        return s.masked_fill_(mask <= 0, float("-inf"))

    one = record(
        "cosine_scores", "", "", got, ops.cosine_scores_plain(zs, cents, mask),
        2e-5, 1e-6, lambda: ops.cosine_scores(zs, cents, mask),
        lambda: ops.cosine_scores_plain(zs, cents, mask), lib1,
        "F.normalize x2 + matmul + masked_fill",
        4 * (B2 * h + M * h + M + B2 * M), 2 * B2 * M * h + 2 * (B2 + M) * h,
        "float32", [B2, M, h])
    row["cases"] = {"single_group": {"classes_equal": True, **{
        k: one[k] for k in ("max_abs_err", "rtol", "atol", "ms", "ms_runs",
                            "plain_ms", "bound_ms", "bound_by", "library_ms",
                            "library_call", "shape")}}}
    return row


def decode_body(ops, build, addr, B, KV, G, S, n_lp, dh):
    """The decode kernel's launch shape at these inputs (its cluster
    split, the dynamic shared memory a block asks for) and what ptxas
    reported for its bf16 instantiation."""
    from repro_torch.kernels.build import sm_count
    return {"n_split": ops.decode_split(B, KV, S, sm_count(0)),
            "dynamic_smem_bytes": build.library().decode_attention_smem_bytes(
                S, n_lp, G, dh, 1),
            "ptxas": ptxas_report(build.build_log, "decode_attention_kernel",
                                  "__nv_bfloat16", f"Li{dh}E", addr)}


def ptxas_report(log, *needles):
    """Registers, spills and static shared memory that ``nvcc -Xptxas -v``
    printed for the entry function whose mangled name holds every
    needle; None if the log has no such entry."""
    import re
    found, cur = None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if all(n in m.group(1) for n in needles) \
                else None
            if cur:
                found = {"entry": cur}
            continue
        if cur is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("static_smem_bytes", r"(\d+) bytes smem"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m:
                found[key] = int(m.group(1))
    return found


def paged_row(np, torch, F, ops, gen, dev, record, L, B, Hq, KV, dh, page,
              nlp, P, live):
    """Row 4 at one shape: pools of ``P`` pages + trash over L layers
    (bf16, each layer's pool taken in turn), ``paged_case``'s table of B
    rows x ``nlp`` pages with ``live`` slots written. The kernel against
    its plain version (rtol = atol = 4e-3) and against row 3 on the
    gathered view (bit-equal), timed beside the plain version and a
    gather + SDPA. Returns the row and its q (B, Hq, dh)."""
    bf = torch.bfloat16
    pool_k = torch.randn(P + 1, L, page, KV, dh, generator=gen,
                         device=dev).to(bf)
    pool_v = torch.randn(P + 1, L, page, KV, dh, generator=gen,
                         device=dev).to(bf)
    q = torch.randn(B, Hq, dh, generator=gen, device=dev).to(bf)
    tbl, pos, t = paged_case(np, torch, dev, B, nlp, page, P, live)
    got = ops.paged_decode_attention(q, pool_k[:, 0], pool_v[:, 0], tbl, t,
                                     pos)
    want = ops.paged_decode_attention_plain(q, pool_k[:, 0], pool_v[:, 0],
                                            tbl, t, pos)
    same_as_ring = paged_equals_ring(torch, ops, q, pool_k[:, 0],
                                     pool_v[:, 0], tbl, t, pos, 0)
    layer = [0]

    def step(fn):
        def run():
            i = layer[0] = (layer[0] + 1) % L
            return fn(i)
        return run

    idx = tbl.long()
    amask = ((pos >= 0) & (pos <= t))[None, None, None, :]

    def sdpa(i):
        kd = pool_k[:, i][idx].reshape(B, nlp * page, KV, dh)
        vd = pool_v[:, i][idx].reshape(B, nlp * page, KV, dh)
        return F.scaled_dot_product_attention(
            q[:, :, None, :], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=amask, enable_gqa=True)

    # bytes it must move: the distinct live (page, slot) pairs' K/V, the
    # table, kv_pos, q and out
    live_slots = torch.nonzero((pos >= 0) & (pos <= t))[:, 0]
    phys = tbl[:, live_slots // page].long() * page \
        + (live_slots % page)[None, :]
    n_phys = int(torch.unique(phys).numel())
    row = record(
        "paged_decode_attention",
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:123", got, want, 4e-3, 4e-3,
        step(lambda i: ops.paged_decode_attention(
            q, pool_k[:, i], pool_v[:, i], tbl, t, pos)),
        step(lambda i: ops.paged_decode_attention_plain(
            q, pool_k[:, i], pool_v[:, i], tbl, t, pos)),
        step(sdpa),
        "composite: paged_gather index + F.scaled_dot_product_attention("
        "enable_gqa=True, bool mask)",
        2 * (2 * B * Hq * dh + 2 * n_phys * KV * dh) + 4 * (B * nlp
                                                       + nlp * page + 1),
        4 * B * Hq * live * dh, "bfloat16",
        [B, Hq, KV, dh, page, nlp, P + 1, live, n_phys])
    row.update({"equals_ring_bitwise": same_as_ring,
                "page_stride": pool_k[:, 0].stride(0)})
    return row, q


#: the keys a kernel row's extra case keeps
CASE_KEYS = ("max_abs_err", "rtol", "atol", "ms", "ms_runs", "plain_ms",
             "bound_ms", "bound_by", "library_ms", "library_call", "shape")


def ring_case(torch, F, ops, gen, dev, record, L, B, Hq, KV, dh, S, live):
    """Row 3 at another shape (``live`` of S slots written in each of B
    rows, bf16, L layers' caches taken in turn), with the plain version
    and SDPA beside it: a long ring at B = 1 (the grid without a split
    has KV blocks), and the olmoe decode shape (dh 128, group 1)."""
    bf = torch.bfloat16
    q = torch.randn(B, Hq, dh, generator=gen, device=dev).to(bf)
    kc = torch.randn(L, B, S, KV, dh, generator=gen, device=dev).to(bf)
    vc = torch.randn(L, B, S, KV, dh, generator=gen, device=dev).to(bf)
    q_pos = torch.tensor(live - 1, dtype=torch.int32, device=dev)
    ar = torch.arange(S, dtype=torch.int32, device=dev)
    kv_pos = torch.where(ar < live, ar, torch.full_like(ar, -1))
    layer = [0]

    def step(fn):
        def run():
            i = layer[0] = (layer[0] + 1) % L
            return fn(i)
        return run

    amask = (kv_pos >= 0)[None, None, None, :]
    ks = [kc[i].transpose(1, 2) for i in range(L)]
    vs = [vc[i].transpose(1, 2) for i in range(L)]
    row = record(
        "decode_attention", "", "",
        ops.decode_attention(q, kc[0], vc[0], q_pos, kv_pos),
        ops.decode_attention_plain(q, kc[0], vc[0], q_pos, kv_pos),
        4e-3, 4e-3,
        step(lambda i: ops.decode_attention(q, kc[i], vc[i], q_pos, kv_pos)),
        step(lambda i: ops.decode_attention_plain(q, kc[i], vc[i], q_pos,
                                                  kv_pos)),
        step(lambda i: F.scaled_dot_product_attention(
            q[:, :, None, :], ks[i], vs[i], attn_mask=amask,
            enable_gqa=True)),
        "F.scaled_dot_product_attention(enable_gqa=True, bool mask)",
        2 * (2 * B * Hq * dh + 2 * B * live * KV * dh) + 4 * (S + 1),
        4 * B * Hq * live * dh, "bfloat16", [B, Hq, KV, dh, S, live])
    from repro_torch.kernels.build import sm_count
    out = {k: row[k] for k in CASE_KEYS}
    out["n_split"] = ops.decode_split(B, KV, S, sm_count(0))
    return out


def wkv_kernel_row(torch, dev, ops, gen, record, B):
    """Kernel 5 at B rows (serve_rwkv's largest RWKV decode bucket, and
    32), ``rwkv6_7b`` widths (H 64, P 64): bf16 r/k/v, f32 logw/u/state,
    the state updated in place as the decode runs it. One step against
    the plain version (rtol = atol = 1e-4: f32 sums in another order, an
    FMA in the state update; two launches must give the same bits), then
    256 chained in-place kernel steps against 256 plain ones at the same
    tolerance. The library yardstick is a composite (no
    single PyTorch call computes the step): ``torch.bmm`` for r @ S, an
    ``addcmul_`` for the bonus term and ``mul_`` / ``addcmul_`` for the
    state update."""
    H, P = 64, 64
    bf = torch.bfloat16

    def inputs():
        r, k, v = (torch.randn(B, H, P, generator=gen, device=dev).to(bf)
                   for _ in range(3))
        logw = -torch.exp(torch.randn(B, H, P, generator=gen, device=dev)
                          * 0.5 - 1.0)
        return r, k, v, logw

    r, k, v, logw = inputs()
    u = torch.randn(H, P, generator=gen, device=dev) * 0.5
    S = torch.randn(B, H, P, P, generator=gen, device=dev)
    got_o, got_s = ops.wkv_step(r, k, v, logw, u, S,
                                out_state=torch.empty_like(S))
    want_o, want_s = ops.wkv_step_plain(r, k, v, logw, u, S)
    again = ops.wkv_step(r, k, v, logw, u, S, out_state=torch.empty_like(S))
    if not (torch.equal(again[0], got_o) and torch.equal(again[1], got_s)):
        raise AssertionError(f"wkv_step B={B}: two launches differ")
    got = torch.cat([got_o.flatten(), got_s.flatten()])
    want = torch.cat([want_o.flatten(), want_s.flatten()])
    # the chain: both start from zeros, each fed the same 256 inputs
    Sk = torch.zeros(B, H, P, P, device=dev)
    Sp = torch.zeros_like(Sk)
    chain_err = 0.0
    for _ in range(256):
        args = inputs()
        ok, _ = ops.wkv_step(*args, u, Sk, out_state=Sk)
        op, _ = ops.wkv_step_plain(*args, u, Sp, out_state=Sp)
        chain_err = max(chain_err, (ok - op).abs().max().item())
        if not torch.allclose(ok, op, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"wkv_step B={B} chain: outputs differ "
                                 f"by {chain_err}")
    if not torch.allclose(Sk, Sp, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"wkv_step B={B} chain: states differ by "
                             f"{(Sk - Sp).abs().max().item()}")
    chain_state_err = (Sk - Sp).abs().max().item()
    S1, S2, S3 = S.clone(), S.clone(), S.clone()

    def lib5():
        rf, kf, vf = r.float(), k.float(), v.float()
        o = torch.bmm(rf.view(B * H, 1, P), S3.view(B * H, P, P)).view(B, H,
                                                                       P)
        o.addcmul_((rf * u * kf).sum(-1, keepdim=True), vf)
        S3.mul_(torch.exp(logw)[..., None]).addcmul_(kf[..., :, None],
                                                     vf[..., None, :])
        return o

    nbytes = 2 * B * H * P * P * 4 + 3 * B * H * P * 2 + B * H * P * 4 \
        + H * P * 4 + B * H * P * 4
    row = record(
        "wkv_step", "src/repro_torch/kernels/csrc/wkv_step.cu",
        "src/repro/kernels/wkv_step.py:36", got, want, 1e-4, 1e-4,
        lambda: ops.wkv_step(r, k, v, logw, u, S1, out_state=S1),
        lambda: ops.wkv_step_plain(r, k, v, logw, u, S2, out_state=S2),
        lib5, "composite: torch.bmm (r @ S) + addcmul_ (bonus) + mul_/"
        "addcmul_ (state update)",
        nbytes, 5 * B * H * P * P + 3 * B * H * P, "float32", [B, H, P])
    row.update({"chain_steps": 256, "chain_max_abs_err_o": chain_err,
                "chain_max_abs_err_state": chain_state_err,
                "in_place": True, "bit_equal_launches": True})
    return row


# ---------------------------------------------------------------------------
# train_bank: the paper's protocol, trained on the card
# ---------------------------------------------------------------------------

#: the paper's Sec. 4 recipe (the trainers' defaults, stated)
RECIPE = {"epochs": 45, "batch_size": 256, "base_lr": 1e-2,
          "lr_decay_epochs": 15}
#: samples per dataset: None is each generator's Table 1 count
N_PER_DATASET = None
#: one optimizer step, card against CPU (tests/test_torch_trainer.py):
#: rtol 1e-5 where |clipped grad| >= GRAD_FLOOR, else within the step's
#: bound lr; the pre-BN biases' gradients below PRE_BN_GRAD instead
STEP_RTOL, STEP_ATOL, GRAD_FLOOR, PRE_BN_GRAD = 1e-5, 1e-7, 1e-5, 1e-6
#: a route that differs from the CPU Router's must be a near tie: the two
#: choices' CPU scores within this relative distance
ROUTE_RTOL = 2e-5
CLIENTS = ("client_a", "client_b")


def train_bank_phase(np, torch, dev, ops, record):
    """Six generators at their Table 1 counts; the bank and the MLP
    baseline trained on the server splits at the paper's recipe; every
    (dataset, client) split routed through a card Router and held to a
    CPU Router over a copy of the bank."""
    from repro_torch.core import (MatcherConfig, build_matcher, train_bank,
                                  train_mlp, trainer)
    from repro_torch.core import mlp_baseline as tmlp
    from repro_torch.data import load_benchmark

    t0 = time.perf_counter()
    bench = load_benchmark(n_per_dataset=N_PER_DATASET, seed=SEED)
    data_s = time.perf_counter() - t0
    names = list(bench)
    first = first_steps(np, torch, dev, bench)

    # train_bank's AEs, each timed: train_ae wrapped where train_bank
    # calls it
    per_ae, inner = [], trainer.train_ae

    def timed(x, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(x, **kw)
        torch.cuda.synchronize()
        steps = kw["epochs"] * (len(x) // min(kw["batch_size"], len(x)))
        per_ae.append({"seconds": time.perf_counter() - t, "rows": len(x),
                       "steps": steps, "seed": kw["seed"]})
        if float(out[1]["count"]) != steps:
            raise AssertionError(f"train_bank: {steps} steps, BN count "
                                 f"{float(out[1]['count'])}")
        return out

    trainer.train_ae = timed
    try:
        aes, got_names = train_bank(
            [(n, bench[n]["server"][0]) for n in names], device=dev,
            **RECIPE)
    finally:
        trainer.train_ae = inner
    if got_names != names:
        raise AssertionError(f"train_bank: names {got_names}")
    bank_s = sum(a["seconds"] for a in per_ae)
    bank_steps = sum(a["steps"] for a in per_ae)
    # one more epoch of the mnist AE's loop, profiled: its device share
    prof = ae_epoch_profile(np, torch, dev, aes[names.index("mnist")],
                            bench["mnist"]["server"][0])
    matcher = build_matcher(aes, names, [bench[n]["server"] for n in names],
                            MatcherConfig(use_kernel=True), device=dev)
    routed = route_splits(np, torch, ops, matcher, bench)
    whole = whole_splits(torch, ops, matcher, bench, record)

    # the MLP-softmax baseline: which dataset a row came from
    xs = np.concatenate([bench[n]["server"][0] for n in names])
    ys = np.concatenate([np.full(len(bench[n]["server"][0]), i, np.int32)
                         for i, n in enumerate(names)])
    torch.cuda.synchronize()
    t = time.perf_counter()
    mp, mst = train_mlp(xs, ys, n_classes=len(names), device=dev, **RECIPE)
    torch.cuda.synchronize()
    mlp_s = time.perf_counter() - t
    mlp_steps = RECIPE["epochs"] * (len(xs) // RECIPE["batch_size"])
    mlp_acc = {}
    for c in CLIENTS:
        accs = [float((tmlp.predict(mp, mst, torch.from_numpy(
            bench[n][c][0]).to(dev)).cpu().numpy() == i).mean())
            for i, n in enumerate(names)]
        mlp_acc[c] = {"mean": float(np.mean(accs)),
                      "per_dataset": dict(zip(names, accs))}

    chance2 = 2.0 / (int(bench["mnist"]["server"][1].max()) + 1)
    for c in CLIENTS:
        if not routed["coarse_acc"][c]["mean"] > 0.9:
            raise AssertionError(f"train_bank: mean coarse accuracy on {c} "
                                 f"{routed['coarse_acc'][c]}")
        if not routed["mnist_fine_acc"][c] > chance2:
            raise AssertionError(f"train_bank: mnist fine accuracy on {c} "
                                 f"{routed['mnist_fine_acc'][c]} <= "
                                 f"{chance2}")
    return {"phase": "train_bank", "recipe": RECIPE,
            "n_per_dataset": N_PER_DATASET or "Table 1 counts",
            "rows": {n: {s: len(bench[n][s][0]) for s in bench[n]}
                     for n in names},
            "data_s": data_s, "first_step": first,
            "ae": dict(zip(names, per_ae)), "bank_s": bank_s,
            "bank_steps": bank_steps,
            "bank_steps_per_s": bank_steps / bank_s,
            "ae_epoch_profile": prof, "mlp_s": mlp_s, "mlp_steps": mlp_steps,
            "mlp_steps_per_s": mlp_steps / mlp_s, "mlp_acc": mlp_acc,
            "mnist_fine_bar": chance2, **routed, "whole_split": whole}


def ae_epoch_profile(np, torch, dev, ae_, x):
    """One epoch of ``fit_ae`` from a trained AE (a copy), timed and then
    profiled: wall ms a step, kernels and their device ms a step, and the
    device's busy share of the step."""
    from repro_torch.core.trainer import fit_ae
    from repro_torch.optim import adamw_init
    p = _tree(ae_[0], lambda t: t.clone())
    st = _tree(ae_[1], lambda t: t.clone())
    steps = len(x) // RECIPE["batch_size"]

    def epoch():
        fit_ae(x, p, st, adamw_init(p), epochs=1,
               batch_size=RECIPE["batch_size"])

    epoch()
    torch.cuda.synchronize()
    t = time.perf_counter()
    epoch()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / steps
    prof = profile_kernels(torch, epoch)
    return {"steps": steps, "wall_ms_per_step": wall,
            "kernels_per_step": prof["kernels"] / steps,
            "kernel_ms_per_step": prof["kernel_ms"] / steps,
            "busy_share": prof["kernel_ms"] / steps / wall,
            "top_kernels_ms_per_epoch": prof["top_kernels_ms"]}


def first_steps(np, torch, dev, bench):
    """One ``fit_ae`` and one ``fit_mlp`` step (256 ``mnist`` rows) from
    one CPU init, on the card and on the CPU: BN statistics at rtol 1e-5
    and every parameter leaf as ``step_agrees`` holds it, but the pre-BN
    biases, whose gradients must be below 1e-6 on both devices (zero in
    exact arithmetic; AdamW's first step turns their noise into a full
    step)."""
    from repro_torch.bridge import to_numpy
    from repro_torch.core import autoencoder as tae
    from repro_torch.core import mlp_baseline as tmlp
    from repro_torch.core.trainer import fit_ae, fit_mlp
    from repro_torch.optim import adamw_init
    from repro_torch.tree import value_and_grad

    x, y = (a[:256] for a in bench["mnist"]["server"])
    n_cls = int(y.max()) + 1
    out = {}
    for name, init, fit, loss, pre_bn, data in (
            ("ae", lambda: tae.init_ae(SEED, device="cpu"), fit_ae,
             tae.loss_fn, "b_enc", (x,)),
            ("mlp", lambda: tmlp.init_mlp(SEED, 784, n_cls, device="cpu"),
             fit_mlp, tmlp.loss_fn, "b", (x, y))):
        p0, s0 = init()
        res, grads = {}, {}
        for where in ("cpu", dev):
            p = _tree(p0, lambda t: t.to(where))
            st = _tree(s0, lambda t: t.to(where))
            args = [torch.from_numpy(np.asarray(a)).to(where) for a in data]
            _, grads[str(where)] = value_and_grad(loss, p, st, *args)
            res[str(where)] = to_numpy(fit(*data, p, st, adamw_init(p),
                                           epochs=1, batch_size=256)[:2])
        gflat = {k: _flat(to_numpy(g)) for k, g in grads.items()}
        for k, g in gflat.items():
            worst = max(float(np.abs(v).max()) for path, v in g.items()
                        if path.split("/")[-1] == pre_bn)
            if not worst < PRE_BN_GRAD:
                raise AssertionError(f"first step {name} on {k}: pre-BN "
                                     f"bias gradient {worst}")
        (pc, sc), (pd, sd) = res["cpu"], res[str(dev)]
        sd, worst_bn = _flat(sd), 0.0
        for path, want in _flat(sc).items():
            if not np.allclose(sd[path], want, rtol=STEP_RTOL,
                               atol=STEP_ATOL):
                raise AssertionError(f"first step {name}: BN {path} differs")
            worst_bn = max(worst_bn, float(np.abs(sd[path] - want).max()))
        out[name] = {"params": step_agrees(
            np, _flat(pd), _flat(pc), _flat(to_numpy(p0)), gflat["cpu"],
            1.0, RECIPE["base_lr"], skip=pre_bn, label=f"first step {name}"),
            "bn_max_abs_err": worst_bn,
            "pre_bn_grad_max": {k: max(float(np.abs(v).max())
                                       for path, v in g.items()
                                       if path.split("/")[-1] == pre_bn)
                                for k, g in gflat.items()}}
    return out


def step_agrees(np, got, want, p0, grad, scale, lr, skip, label):
    """Flat leaves after one AdamW step: rtol 1e-5 (atol 1e-7) where the
    clipped gradient ``grad * scale`` is at least GRAD_FLOOR (AdamW's
    first step, ``lr * g / (|g| + 1e-8)``, is insensitive to g's rounding
    there), else moved from ``p0`` by at most ``lr``; leaves named
    ``skip`` are left out. Returns the worst error and the share held at
    rtol."""
    worst, held, n = 0.0, 0, 0
    for path, w in want.items():
        if path.split("/")[-1] == skip:
            continue
        gf = got[path].astype(np.float32)
        wf = w.astype(np.float32)
        big = np.abs(grad[path].astype(np.float32) * scale) >= GRAD_FLOOR
        if not np.allclose(gf[big], wf[big], rtol=STEP_RTOL, atol=STEP_ATOL):
            raise AssertionError(f"{label}: {path} differs, max "
                                 f"{np.abs(gf - wf)[big].max()}")
        p = p0[path].astype(np.float32)
        if not (np.abs(gf - p) <= lr * (1 + STEP_RTOL)
                + np.spacing(np.abs(p))).all():
            raise AssertionError(f"{label}: {path} moved beyond lr")
        if big.any():
            worst = max(worst, float(np.abs(gf - wf)[big].max()))
        held, n = held + int(big.sum()), n + big.size
    return {"max_abs_err": worst, "share_at_rtol": held / n,
            "tol": f"rtol {STEP_RTOL} atol {STEP_ATOL} where |clipped "
                   f"grad| >= {GRAD_FLOOR}, else |step| <= lr"}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree
                for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def route_splits(np, torch, ops, matcher, bench):
    """Each (dataset, client) split routed as one ``Router.route`` call on
    the card (a fresh router: 256-row chunks, all misses), the counts
    reset just before and read just after: ``expert_score`` and
    ``cosine_fine`` once per route chunk and no other kernel. Then the
    same split through a CPU Router over a copy of the bank: each
    (expert, fine class) equal, but for near ties
    (``check_near_ties``)."""
    from repro_torch.serve.router import Router
    names = matcher.names
    cpu = cpu_matcher(matcher)
    acc = {c: {} for c in CLIENTS}
    fine = {}
    launches = {"expert_score": 0, "cosine_scores": 0}
    splits, ties, route_s, rows = [], 0, 0.0, 0
    for c in CLIENTS:
        for i, n in enumerate(names):
            x, y = bench[n][c]
            router = Router(matcher)
            seen = []
            chunks = _record_route(router, seen)
            torch.cuda.synchronize()
            ops.reset_launches()
            t = time.perf_counter()
            res = router.route(x)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            got = ops.launches()
            _unrecord_route(router)
            label = f"train_bank {n}/{c}"
            k = route_chunks(label, chunks, got)
            if any(v for name, v in got.items() if name not in launches):
                raise AssertionError(f"{label}: other kernels ran {got}")
            if len(seen) != 1 or seen[0][1]:
                raise AssertionError(f"{label}: {len(seen)} route calls")
            want = Router(cpu).route(x)
            ties += check_near_ties(np, torch, cpu, x, res, want, label)
            acc[c][n] = float((res.coarse[:, 0] == i).mean())
            if n == "mnist":
                fine[c] = float((res.fine == y).mean())
            for name in launches:
                launches[name] += got[name]
            route_s += dt
            rows += len(x)
            splits.append({"split": f"{n}/{c}", "rows": len(x),
                           "route_chunks": k, "seconds": dt})
    return {"coarse_acc": {c: {"mean": float(np.mean(list(acc[c].values()))),
                               "per_dataset": acc[c]} for c in CLIENTS},
            "mnist_fine_acc": fine, "routes_equal_cpu": True,
            "route_near_ties": ties, "route_launches": launches,
            "route_s": route_s, "routed_rows": rows,
            "rows_per_s": rows / route_s, "splits": splits}


def check_near_ties(np, torch, cpu, x, got, want, label):
    """Rows whose card (expert, fine class) differ from the CPU Router's
    must be near ties there: the CPU's scores of the two experts within
    ROUTE_RTOL of each other (or, for one expert, the two classes'
    cosines within ROUTE_RTOL). Returns how many rows differed."""
    ge, we = got.coarse[:, 0], want.coarse[:, 0]
    bad = np.nonzero((ge != we) | (got.fine != want.fine))[0]
    for r in bad:
        xr = torch.from_numpy(x[r:r + 1])
        if ge[r] != we[r]:
            s = cpu.coarse_scores(xr)[0]
            a, b = float(s[ge[r]]), float(s[we[r]])
            near = abs(a - b) <= ROUTE_RTOL * abs(b)
        else:
            s = cpu.fine_scores(xr, torch.tensor([int(we[r])]))[0]
            a, b = float(s[got.fine[r]]), float(s[want.fine[r]])
            near = abs(a - b) <= ROUTE_RTOL
        if not near:
            raise AssertionError(
                f"{label}: row {r} routes to ({ge[r]}, {got.fine[r]}) on "
                f"the card and ({we[r]}, {want.fine[r]}) on the CPU, "
                f"scores {a} vs {b}")
    return len(bad)


def whole_splits(torch, ops, matcher, bench, record):
    """``assign_coarse`` on each whole (dataset, client) split: one
    ``expert_score`` launch at B = the split's rows (up to 11274, the
    ``nlos`` splits), against the plain version on the same card inputs:
    scores at rtol 2e-5 (atol 1e-6), top-1 experts equal but for near
    ties. Then the kernel timed against its plain version and a library
    yardstick on the trained bank at a route chunk's rows (B 256) and
    at the largest split's."""
    folded = ops.fold_bank(matcher.bank_params, matcher.bank_states)
    worst, ties, biggest = 0.0, 0, None
    for c in CLIENTS:
        for n in matcher.names:
            x = torch.from_numpy(bench[n][c][0]).to(matcher.device)
            ops.reset_launches()
            got = matcher.assign_coarse(x)
            if ops.launches()["expert_score"] != 1:
                raise AssertionError(f"whole split {n}/{c}: "
                                     f"{ops.launches()}")
            scores = ops.expert_score_folded(folded, x)
            want = ops.expert_score_plain(folded, x)
            if not torch.allclose(scores, want, rtol=2e-5, atol=1e-6):
                raise AssertionError(f"whole split {n}/{c}: scores differ "
                                     "from the plain version")
            worst = max(worst, (scores - want).abs().max().item())
            plain = want.argmin(-1)
            for r in torch.nonzero(got != plain)[:, 0].tolist():
                sa, sb = want[r, got[r]].item(), want[r, plain[r]].item()
                if abs(sa - sb) > ROUTE_RTOL * abs(sb):
                    raise AssertionError(f"whole split {n}/{c}: row {r} "
                                         f"top-1 {got[r]}, plain {plain[r]}")
                ties += 1
            if biggest is None or len(x) > len(biggest):
                biggest = x
    return {"splits": 2 * len(matcher.names), "max_abs_err": worst,
            "tol": "rtol 2e-5 atol 1e-6", "near_ties": ties,
            "kernel": {"b256": expert_score_case(torch, ops, folded,
                                                 biggest[:256], record),
                       "largest": expert_score_case(torch, ops, folded,
                                                    biggest, record)}}


def expert_score_case(torch, ops, folded, x, record):
    """Kernel 1 on the trained bank at x's rows, timed as the kernels
    phase times it (``record``)."""
    B, D = x.shape
    K, _, H = folded["w1"].shape
    xk = x.expand(K, B, D)

    def lib():
        h = torch.baddbmm(folded["b1"][:, None, :], xk, folded["w1"])
        xhat = torch.baddbmm(folded["b2"][:, None, :], h.relu_(),
                             folded["w2"])
        return (xhat - x).square_().sum(-1).div_(D).T

    row = record(
        "expert_score", "src/repro_torch/kernels/csrc/expert_score.cu",
        "src/repro/kernels/expert_score.py:39",
        ops.expert_score_folded(folded, x), ops.expert_score_plain(folded, x),
        2e-5, 1e-6, lambda: ops.expert_score_folded(folded, x),
        lambda: ops.expert_score_plain(folded, x), lib,
        "torch.baddbmm x2 + square/sum",
        4 * (B * D + K * (2 * D * H + H + D) + B * K),
        2 * B * K * 2 * D * H, "float32", [B, K, D, H])
    return {k: row[k] for k in ("ms", "ms_runs", "plain_ms", "library_ms",
                                "bound_ms", "bound_by", "max_abs_err",
                                "shape")}


# ---------------------------------------------------------------------------
# train_lm: the LM train step at published widths
# ---------------------------------------------------------------------------

#: the reference launcher's defaults (``launch/train.py``)
LM_SEQ, LM_BATCH, LM_LR = 128, 8, 1e-3


def train_lm_phase(np, torch, dev, ops):
    """``Trainer`` steps of full-width ``llama3_2_1b`` (16 layers, bf16,
    remat, 2 microbatches, clip 1.0) and of ``rwkv6_7b`` at published
    widths with 4 of its 32 layers (params, grads, f32 accumulators and
    moments of all 32 need ~124 GB), on ``synthetic_token_stream``;
    then one ``make_train_step`` of each and of ``olmoe_1b_7b`` (capacity
    dispatch, the balance loss in the total), reduced and f32, on the
    card against the CPU. No hand-written kernel runs in a train step."""
    from repro_torch.configs import get_config

    ops.reset_launches()
    out = {"phase": "train_lm", "seq": LM_SEQ, "batch": LM_BATCH,
           "lr": LM_LR,
           "llama3_2_1b": lm_run(np, torch, dev, get_config("llama3_2_1b"),
                                 20),
           "rwkv6_7b": lm_run(np, torch, dev,
                              get_config("rwkv6_7b").replace(n_layers=4),
                              10, reduced={"n_layers": [32, 4]})}
    if any(ops.launches().values()):
        raise AssertionError(f"train_lm: a kernel launched in a train "
                             f"step: {ops.launches()}")
    out["card_vs_cpu"] = {a: lm_step_check(np, torch, dev, a, S, tol)
                          for a, S, tol in (("llama3_2_1b", 128, 2e-5),
                                            ("rwkv6_7b", 32, 1e-4),
                                            ("olmoe_1b_7b", 32, 2e-5))}
    return out


def lm_run(np, torch, dev, cfg, steps, reduced=None):
    """``steps`` Trainer steps from a seeded init; the loss read back each
    step (one host sync), so a step's wall time is the gap between two
    readings. Returns the step times, tokens/s, the model FLOP rate (6 x
    params x tokens) against the bf16 peak, the peak memory and the
    losses, which must be finite and end below where they began."""
    from repro_torch.data import synthetic_token_stream
    from repro_torch.models import build_model
    from repro_torch.train import Trainer
    from repro_torch.tree import leaves

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(build_model(cfg), lr=LM_LR, total_steps=steps, seed=SEED,
                 device=dev)
    n_params = sum(p.numel() for p in leaves(tr.state["params"]))
    stream = synthetic_token_stream(cfg.vocab_size, LM_SEQ, LM_BATCH,
                                    seed=SEED)
    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = tr.fit(stream, steps, log_every=1,
                  callback=lambda i, m: stamps.append(time.perf_counter()))
    step_s = np.diff([t0] + stamps)
    ms = float(np.median(step_s[-10:])) * 1e3
    tokens = LM_BATCH * LM_SEQ
    losses = [l for _, l in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_lm {cfg.name}: losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    prof = profile_kernels(torch, lambda: tr.fit(stream, 1, log_every=1))
    prof["busy_share_of_median_step"] = prof["kernel_ms"] / ms
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.param_dtype,
            "remat": cfg.remat, "microbatches": cfg.train_microbatches,
            "reduced": reduced, "params": n_params, "steps": steps,
            "ms_per_step": ms, "ms_per_step_runs": [x * 1e3 for x in step_s],
            "tokens_per_s": tokens / (ms / 1e3),
            "model_flops_per_step": 6 * n_params * tokens,
            "flop_share_of_bf16_peak": 6 * n_params * tokens / (ms / 1e3)
            / PEAK_FLOPS["bfloat16"],
            "peak_gb": peak / 1e9, "held_before_gb": held / 1e9,
            "losses": losses, "profiled_step": prof}


def profile_kernels(torch, call):
    """The kernels one ``call`` launches (``torch.profiler``, the host
    synchronised after it): how many, their device ms in all and the
    eight largest by name; and the eight host operators with the most
    self time (the host's share of a step the device waits on)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    by_name = {}
    kern = [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    for ev in kern:
        by_name[ev.name] = by_name.get(ev.name, 0.0) \
            + ev.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"kernels": len(kern), "kernel_ms": sum(by_name.values()),
            "top_kernels_ms": [[k[:70], v] for k, v in top],
            "top_host_ops_self_ms": [[e.key[:50], e.self_cpu_time_total / 1e3,
                                      e.count] for e in host[:8]]}


def lm_step_check(np, torch, dev, arch, S, tol):
    """One ``make_train_step`` (2 microbatches, clip 1.0, lr 1e-3) of the
    reduced f32 ``arch`` from the same params and batch on the card and
    on the CPU (``tests/test_torch_train_loop.py``'s tolerances): loss at
    rtol ``tol``, each gradient leaf within ``tol * (|cpu| + max|cpu|)``,
    the updated params as ``step_agrees`` holds them, against the step's
    own gradient (the mean of its microbatches': for a capacity-dispatch
    MoE not the whole batch's, since the capacity follows T). A MoE's
    router top-k is logged on both devices (``route_flips``: any choice
    that differs is reported with its f32 gap, and named in a failure)."""
    from repro_torch.bridge import to_numpy
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_token_stream
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import constant_lr, global_norm
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_map, value_and_grad

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    s0 = init_train_state(model, torch.Generator().manual_seed(SEED),
                          device="cpu")
    if cfg.family == "rwkv":
        trained_like(torch, s0["params"], torch.Generator().manual_seed(1))
    batch = next(synthetic_token_stream(cfg.vocab_size, S, 8, seed=SEED))
    step = make_train_step(model, lr_fn=constant_lr(1e-3), microbatches=2)
    res, logs = {}, {}
    for where in ("cpu", dev):
        st = _tree(s0, lambda t: t.to(where))
        b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        log = logs[str(where)] = []
        undo = route_log(moe_mod, log)
        try:
            _, g = value_and_grad(model.loss, st["params"], b)
            new, met = step(st, b)
        finally:
            undo()
        res[str(where)] = (float(met["loss"]), _flat(to_numpy(g)),
                           _flat(to_numpy(new["params"])))
    (lc, gcpu, pc), (ld, gd, pd) = res["cpu"], res[str(dev)]
    flips = route_flips(np, logs["cpu"], logs[str(dev)])
    mbs = [value_and_grad(model.loss, s0["params"], {
        k: torch.from_numpy(v[i * 4:(i + 1) * 4]) for k, v in batch.items()})[1]
        for i in range(2)]
    gstep = tree_map(lambda a, b: (a + b) / 2, *mbs)
    label = f"train_lm {arch}" + (f" (router flips {flips})" if flips
                                  else "")
    if not abs(ld - lc) <= tol * abs(lc):
        raise AssertionError(f"{label}: loss {ld}, CPU {lc}")
    worst = 0.0
    for path, w in gcpu.items():
        err = np.abs(gd[path] - w)
        if not (err <= tol * (np.abs(w) + np.abs(w).max())).all():
            raise AssertionError(f"{label}: grad {path} differs, "
                                 f"max {err.max()}")
        worst = max(worst, float(err.max()))
    fstep = _flat(to_numpy(gstep))
    sstep = min(1.0, 1.0 / max(float(global_norm(gstep)), 1e-9))
    params = step_agrees(np, pd, pc, _flat(to_numpy(s0["params"])), fstep,
                         sstep, 1e-3, skip=None, label=label)
    # why the mask follows the step's gradient: the whole batch's (CPU)
    # against it, the entries the whole batch's would hold at rtol where
    # the step's own is under GRAD_FLOOR (AdamW's first step is sensitive
    # to g's rounding there), and whether the update check passes under
    # the whole batch's mask (reported, not asserted)
    swhole = min(1.0, 1.0 / max(float(np.sqrt(sum(
        np.square(v.astype(np.float64)).sum() for v in gcpu.values()))), 1e-9))
    params["whole_batch_grad_max_rel_diff"] = max(
        float(np.abs(gcpu[k] - fstep[k]).max() / np.abs(fstep[k]).max())
        for k in fstep)
    params["whole_batch_mask_under_floor"] = sum(
        int(((np.abs(gcpu[k]) * swhole >= GRAD_FLOOR)
             & (np.abs(fstep[k]) * sstep < GRAD_FLOOR)).sum()) for k in fstep)
    try:
        step_agrees(np, pd, pc, _flat(to_numpy(s0["params"])), gcpu, swhole,
                    1e-3, skip=None, label="whole-batch mask")
        params["whole_batch_mask_check"] = "holds"
    except AssertionError as e:
        params["whole_batch_mask_check"] = str(e)
    return {"config": cfg.name, "seq": S, "microbatches": 2,
            "loss_card": ld, "loss_cpu": lc, "grad_max_abs_err": worst,
            "grad_tol": f"{tol} x (|cpu| + max|cpu|) per leaf",
            "params": params, "router_calls": len(logs["cpu"]),
            "router_flips": flips}


SHARDED_TOL = {"loss": 1e-4, "params": 5e-4, "moments_rel": 1e-4}


def train_sharded_phase(np, torch, dev, ops):
    """One ``make_train_step`` of full-width ``llama3_2_1b`` as train_lm
    runs it (bf16, remat, 2 microbatches, clip 1.0, lr 1e-3, seq 128 x
    batch 8), unsharded and then as DTensors on the host mesh with
    ``fsdp`` specs, from the same init and batch; each twice (the first
    sharded step pays DTensor's sharding propagation). Held: loss within
    1e-4, params max |diff| within 5e-4, AdamW's moments within 1e-4 of
    each leaf's max |plain|, every state leaf back in its placements, no
    kernel launched. Then the multi-card case, or the line saying why it
    is skipped."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_token_stream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import constant_lr
    from repro_torch.sharding import mesh_context
    from repro_torch.train import (init_train_state, make_train_step,
                                   shard_batch, shard_train_state)
    from repro_torch.tree import leaves

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("llama3_2_1b")
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator(device=dev)
                             .manual_seed(SEED), device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(
        synthetic_token_stream(cfg.vocab_size, LM_SEQ, LM_BATCH,
                               seed=SEED)).items()}
    step = make_train_step(model, lr_fn=constant_lr(LM_LR), clip_norm=1.0,
                           microbatches=2)

    def timed(st, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, met = step(st, b)
        loss = met["loss"]
        loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                     else loss)
        torch.cuda.synchronize()
        return new, loss, (time.perf_counter() - t0) * 1e3

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    new, loss_plain, ms_plain = timed(state, batch)
    # the plain step's moments wait in host memory (10 GB off the card)
    want = {"params": new["params"],
            "opt": _tree(new["opt"], lambda t: t.cpu())}
    del new
    ms_plain = [ms_plain, timed(state, batch)[2]]
    mesh = make_host_mesh(dev)
    try:
        with mesh_context(mesh):
            sst = shard_train_state(state, mesh, fsdp=True)
            sbatch = shard_batch(batch, mesh)
            got, loss_sharded, ms_sharded = timed(sst, sbatch)
            kept = all(tuple(a.placements) == tuple(b.placements)
                       for a, b in zip(leaves(got), leaves(sst)))
            # params max |diff|; AdamW's moments (the clipped gradient and
            # its square) max |diff| over each leaf's max |plain|
            diff, n_diff = {}, {}
            for part, g, w in (("params", got["params"], want["params"]),
                               ("m", got["opt"]["m"], want["opt"]["m"]),
                               ("v", got["opt"]["v"], want["opt"]["v"])):
                diff[part], n_diff[part] = 0.0, 0
                for a, b in zip(leaves(g), leaves(w)):
                    b = b.to(dev)
                    d = (a.to_local().float() - b.float()).abs()
                    scale = 1.0 if part == "params" else max(
                        float(b.float().abs().max()), 1e-30)
                    diff[part] = max(diff[part], float(d.max()) / scale)
                    n_diff[part] += int((d > 0).sum())
            del got
            ms_sharded = [ms_sharded, timed(sst, sbatch)[2]]
        sharded = sorted({str(tuple(x.placements)) for x in leaves(sst)})
        peak = torch.cuda.max_memory_allocated()
        del sst, sbatch
    finally:
        dist.destroy_process_group()
    del want, state
    gc.collect()
    torch.cuda.empty_cache()
    if any(ops.launches().values()):
        raise AssertionError(f"train_sharded: a kernel launched in a "
                             f"train step: {ops.launches()}")
    if not kept:
        raise AssertionError("train_sharded: a state leaf left its "
                             "placements")
    if not (abs(loss_sharded - loss_plain) <= SHARDED_TOL["loss"]
            and diff["params"] <= SHARDED_TOL["params"]
            and max(diff["m"], diff["v"]) <= SHARDED_TOL["moments_rel"]):
        raise AssertionError(f"train_sharded: loss {loss_sharded} vs "
                             f"{loss_plain}, max |diff| {diff}")
    out = {"phase": "train_sharded", "config": cfg.name,
           "dtype": cfg.param_dtype, "remat": cfg.remat, "microbatches": 2,
           "seq": LM_SEQ, "batch": LM_BATCH, "mesh": {"data": 1, "model": 1},
           "fsdp": True, "state_placements": sharded,
           "loss_plain": loss_plain, "loss_sharded": loss_sharded,
           "loss_abs_diff": abs(loss_sharded - loss_plain),
           "params_max_abs_diff": diff["params"],
           "moments_max_rel_diff": {"m": diff["m"], "v": diff["v"]},
           "n_differ": n_diff,
           "tol": SHARDED_TOL, "ms_plain": ms_plain,
           "ms_sharded": ms_sharded, "peak_gb": peak / 1e9,
           "launches": ops.launches()}
    n = torch.cuda.device_count()
    if n >= 4:
        out["multi_card"] = multi_card_case(np, torch, dev, (2, 2))
    else:
        out["multi_card"] = f"skipped: {n} device(s)"
        print(json.dumps({"multi_card": out["multi_card"]}), flush=True)
    return out


#: the dry run's predicted peak against the real step's
DRYRUN_PEAK_RTOL = 0.10
#: seconds each dry-run CLI line may take
DRYRUN_CLI_CAP_S = 420
#: qwen2_72b's dry-run lines and the depth of each, at published widths:
#: decode at full depth (80 layers); prefill cut to 40 and train (16
#: microbatches through every layer) to 2, to keep the smoke well inside
#: its limit (full-depth prefill took 71.5-106.9 s of the H100 host's
#: CPU, train at 80 layers more than 420 s)
DRYRUN_SHAPES = {"train_4k": 2, "prefill_32k": 40, "decode_32k": 0}
SERVE_SHARDED_PROMPT, SERVE_SHARDED_STEPS = 64, 16
#: config -> (layers, or None for its published depth; the decode kernel)
SERVE_SHARDED = {"llama3_2_1b": (None, "decode_attention"),
                 "rwkv6_7b": (4, "wkv_step")}


def dryrun_phase(np, torch, dev, ops):
    """(i) the dry-run CLI on the card, (ii) its accounting against a
    real step, (iii) sharded serves through the decode kernels (see the
    module docstring, 13b)."""
    t0 = time.perf_counter()
    out = {"phase": "dryrun"}
    # the CLI's processes work on the CPU (fake tensors) while this one
    # runs (ii) and (iii) on the card
    procs = dryrun_cli_start()
    try:
        out["accounting"] = dryrun_accounting(np, torch, dev, ops)
        gc.collect()
        torch.cuda.empty_cache()
        out["serve_sharded"] = serve_sharded(np, torch, dev, ops)
    except BaseException:
        for p in procs.values():
            p.kill()
            p.communicate()
        raise
    out["cli"] = dryrun_cli(torch, procs)
    out["seconds"] = time.perf_counter() - t0
    return out


#: rules the contracts phase counts
CONTRACT_RULES = ("H001", "H002", "H003", "H004", "K001", "K002", "K003",
                  "K004")


def contracts_phase(np, torch, dev, smi):
    """The port's graph and kernel contract passes on the card (see the
    module docstring, 13c). Raises on an unbaselined error."""
    from repro_torch.analysis import (apply_baseline, format_report,
                                      load_baseline)
    from repro_torch.analysis import graph_contracts, kernel_check
    from repro_torch.kernels import build
    from repro_torch.kernels.expert_score import max_clusters

    t0 = time.perf_counter()
    card = torch.device("cuda", torch.cuda.current_device())
    found = graph_contracts.run(card, reduced=False)
    graphs_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    found += kernel_check.run()
    kernels_s = time.perf_counter() - t1
    counts = {r: sum(v.rule == r for v in found) for r in CONTRACT_RULES}
    active, suppressed = apply_baseline(found, load_baseline())
    errors = [v for v in active if v.severity == "error"]
    # the H100 table the planners read, against this card
    props = torch.cuda.get_device_properties(card)
    table = kernel_check.H100
    card_vals = {"sm_count": props.multi_processor_count,
                 "smem_optin": getattr(props, "shared_memory_per_block_optin",
                                       None)}
    problems = []
    if card_vals["sm_count"] != table["sm_count"] or card_vals[
            "smem_optin"] not in (None, table["smem_optin"]):
        problems.append(f"H100 table {table} against the card's "
                        f"{card_vals}")
    # every cluster size the planner can choose at the served widths
    # (D 784, H 128: 7 to 16 for any batch), at a 1-row and a full tile
    D, H = 784, 128
    clusters, off = {}, {}
    for rows in (1, 32):
        for n in kernel_check.expert_plans(32, D, H, 6):
            key = f"n{n}_rows{rows}"
            clusters[key] = max_clusters(card.index, D, H, n, rows)
            want = kernel_check.h100_clusters(n, rows)
            if clusters[key] != want:
                off[key] = (want, clusters[key])
    if off:
        problems.append(f"expert_score clusters resident (table, card) "
                        f"differ at n = {off}")
    # the pass's shared-memory formulas against the C entries'
    lib, limits = build.library(), kernel_check.read_limits()
    smem_off = []
    for D_, H_, n, r in ((784, 128, 16, 32), (784, 128, 8, 17),
                         (98, 128, 8, 17), (784, 256, 13, 32)):
        want = lib.expert_score_smem_bytes(D_, H_, n, r)
        if kernel_check.expert_smem(D_, H_, n, r) != want:
            smem_off.append(("expert_score", D_, H_, n, r, want))
    for S, n_lp, G, dh, bf in ((256, 0, 4, 64, 1), (4096, 0, 16, 128, 1),
                               (256, 32, 3, 64, 1), (64, 8, 2, 32, 0)):
        want = lib.decode_attention_smem_bytes(S, n_lp, G, dh, bf)
        if kernel_check.decode_smem(limits, S, n_lp, G, dh,
                                    2 if bf else 4) != want:
            smem_off.append(("decode_attention", S, n_lp, G, dh, want))
    if smem_off:
        problems.append(f"shared-memory formulas differ from the C "
                        f"entries at {smem_off}")
    if errors or problems:
        print(json.dumps({"contracts_counts": counts,
                          "expert_score_clusters": clusters,
                          "card": card_vals}), file=sys.stderr)
        raise AssertionError("contracts: " + "; ".join(problems) + (
            "\nunbaselined findings\n" + format_report(errors)
            if errors else ""))
    return {"phase": "contracts", "gpu": smi, "rule_counts": counts,
            "baselined": len(suppressed),
            "warnings": sum(v.severity != "error" for v in active),
            "engines": "smollm_135m full width (bf16, every layer): ring "
                       "and chunked paged 4-slot hubs over 2 mesh "
                       "positions, a spec k 2 engine; rwkv6_7b full width "
                       "with row slots",
            "sm_count": card_vals["sm_count"],
            "smem_optin": card_vals["smem_optin"],
            "expert_score_clusters": clusters,
            "graphs_s": graphs_s, "kernels_s": kernels_s,
            "seconds": time.perf_counter() - t0}


def dryrun_cli_start():
    """``python -m repro_torch.launch.dryrun --arch qwen2-72b --shape S``
    for each of ``DRYRUN_SHAPES`` (with ``--layers`` where it cuts the
    depth), three processes started at once: {shape: process}."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return {s: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-72b", "--shape", s, "--layers", str(n)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for s, n in DRYRUN_SHAPES.items()}


def dryrun_cli(torch, procs):
    """The lines of ``dryrun_cli_start``'s processes, each within
    ``DRYRUN_CLI_CAP_S`` of being read: every line ``ok``; its peak GB
    against the card's memory."""
    from repro_torch.launch.mesh import HW

    total = torch.cuda.get_device_properties(0).total_memory
    rows = []
    for s, p in procs.items():
        t = time.perf_counter()
        try:
            so, se = p.communicate(timeout=DRYRUN_CLI_CAP_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
                q.communicate()
            raise AssertionError(f"dryrun: {s} took more than "
                                 f"{DRYRUN_CLI_CAP_S} s")
        if p.returncode != 0:
            raise AssertionError(f"dryrun: the CLI at {s} exited "
                                 f"{p.returncode}: {se[-3000:]}")
        r = json.loads([ln for ln in so.splitlines()
                        if ln.startswith("{")][-1])
        if r["status"] != "ok":
            raise AssertionError(f"dryrun: {s}: {r}")
        peak = r["memory"]["peak_bytes"]
        rows.append({"shape": s, "status": r["status"],
                     "n_layers": DRYRUN_SHAPES[s] or 80,
                     "device": r["device"],
                     "fsdp": r["fsdp"],
                     "train_microbatches": r["train_microbatches"],
                     "n_params": r["n_params"],
                     "args_gb": r["memory"]["argument_bytes"] / 1e9,
                     "params_gb": r["memory"]["param_bytes"] / 1e9,
                     "state_gb": r["memory"]["state_bytes"] / 1e9,
                     "peak_gb": peak / 1e9, "hbm_gb": total / 1e9,
                     "peak_over_hbm": peak / total,
                     "flops_per_device": r["flops_per_device"],
                     "kernel_flops": r["kernel_flops"],
                     "collectives_gb": {k: v / 1e9 for k, v in
                                        r["collectives"].items()},
                     "roofline": r["roofline"], "cli_s": r["compile_s"],
                     "wait_s": time.perf_counter() - t})
        print(json.dumps({"dryrun_cli": rows[-1]}), flush=True)
    return {"hbm_bytes": total, "HW_hbm_bytes": HW["hbm_bytes"],
            "rows": rows}


def dryrun_accounting(np, torch, dev, ops):
    """train_sharded's step (full-width bf16 ``llama3_2_1b``, remat, 2
    microbatches, seq 128 x batch 8, ``fsdp`` specs) dry-run on a
    one-rank fake group through ``build_dryrun``'s pieces, then the same
    step for real on the 1 x 1 NCCL host mesh, both counted by
    ``trace_step``: the predicted peak within ``DRYRUN_PEAK_RTOL`` of
    ``max_memory_allocated`` over the real step (less what was allocated
    before its state), equal local flops, no collective."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import ShapeConfig
    from repro_torch.sharding.context import Spec
    from repro_torch.sharding.rules import (batch_spec, distribute,
                                            param_specs)
    from repro_torch.train import init_train_state

    sc = ShapeConfig("train_128", LM_SEQ, LM_BATCH, "train")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        built, meta = dryrun.build_dryrun(
            "llama3_2_1b", sc, fsdp=True, mesh=mesh,
            overrides={"train_microbatches": 2})
        fn, args, _, model, fake = built
        t = time.perf_counter()
        dry = dryrun.trace_step(fn, args, mesh, fake)
        dry_s = time.perf_counter() - t
    finally:
        dist.destroy_process_group()
    del args
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    state = init_train_state(model, torch.Generator(device=dev)
                             .manual_seed(SEED), device=dev)
    tokens = torch.randint(0, model.cfg.vocab_size, (LM_BATCH, LM_SEQ),
                           generator=torch.Generator(device=dev)
                           .manual_seed(SEED), device=dev,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    mesh = make_host_mesh(dev)
    try:
        ps = param_specs(state["params"], mesh, fsdp=True)
        state = distribute(state, {"params": ps, "opt": {
            "m": ps, "v": ps, "step": Spec()}, "step": Spec()}, mesh)
        batch = distribute(batch, batch_spec(batch, mesh), mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t = time.perf_counter()
        real = dryrun.trace_step(fn, (state, batch), mesh, None)
        torch.cuda.synchronize()
        real_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - before
    finally:
        dist.destroy_process_group()
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    pred = dry["memory"]["peak_bytes"]
    res = {"config": "llama3_2_1b", "seq": LM_SEQ, "batch": LM_BATCH,
           "microbatches": meta["train_microbatches"], "fsdp": True,
           "predicted_peak_gb": pred / 1e9, "measured_peak_gb": peak / 1e9,
           "peak_rel_err": (pred - peak) / peak,
           "tracker_peak_real_step_gb": real["memory"]["peak_bytes"] / 1e9,
           "flops_dry": dry["flops_per_device"],
           "flops_real": real["flops_per_device"],
           "collectives_dry": dry["collectives"],
           "collectives_real": real["collectives"],
           "dry_s": dry_s, "real_s": real_s, "tol": DRYRUN_PEAK_RTOL,
           "launches": ops.launches()}
    print(json.dumps({"dryrun_accounting": res}), flush=True)
    if abs(pred - peak) > DRYRUN_PEAK_RTOL * peak:
        raise AssertionError(f"dryrun: predicted peak {pred} vs measured "
                             f"{peak}")
    if dry["flops_per_device"] != real["flops_per_device"]:
        raise AssertionError(f"dryrun: flops {dry['flops_per_device']} "
                             f"vs the real step's "
                             f"{real['flops_per_device']}")
    if dry["collectives"]["total"] or real["collectives"]["total"]:
        raise AssertionError(f"dryrun: a collective on one rank: dry "
                             f"{dry['collectives']}, real "
                             f"{real['collectives']}")
    return res


def serve_sharded(np, torch, dev, ops):
    """Each of ``SERVE_SHARDED``: 8 prompts of ``SERVE_SHARDED_PROMPT``
    tokens prefilled and ``SERVE_SHARDED_STEPS`` greedy tokens decoded,
    plain and then with params and cache as DTensors on the 1 x 1 NCCL
    host mesh: tokens bit-equal, and the config's decode kernel launched
    n_layers x steps times in the sharded decode (counts reset just
    before it): full-width bf16 ``llama3_2_1b`` through
    ``decode_attention`` (B3), and ``rwkv6_7b`` at full width, cut in
    depth, through ``wkv_step`` (B5). {config: result}."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    out = {}
    mesh = make_host_mesh(dev)
    try:
        for arch, (layers, kernel) in SERVE_SHARDED.items():
            out[arch] = _serve_sharded_one(torch, dev, ops, mesh, arch,
                                           layers, kernel)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def _serve_sharded_one(torch, dev, ops, mesh, arch, layers, kernel):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.sharding import mesh_context
    from repro_torch.sharding.rules import distribute, param_specs
    from repro_torch.train import shard_batch

    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED + 7),
                        device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (8, SERVE_SHARDED_PROMPT),
                           generator=torch.Generator(device=dev)
                           .manual_seed(SEED + 8), device=dev,
                           dtype=torch.int32)
    cap = SERVE_SHARDED_PROMPT + SERVE_SHARDED_STEPS

    def greedy(params, batch, sharded):
        logits, cache = model.prefill(params, batch, capacity=cap)
        toks = []
        for i in range(SERVE_SHARDED_STEPS + 1):
            full = logits.full_tensor() if sharded else logits
            tok = torch.argmax(full, dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
            if i == SERVE_SHARDED_STEPS:
                break
            if i == 0:
                ops.reset_launches()
            logits, cache = model.decode(params, cache, {"token": tok})
        torch.cuda.synchronize()
        return torch.cat(toks, dim=1).cpu(), ops.launches()

    t = time.perf_counter()
    with torch.no_grad():
        plain, plain_launches = greedy(params, {"tokens": prompt}, False)
    plain_s = time.perf_counter() - t
    sparams = distribute(params, param_specs(params, mesh), mesh)
    t = time.perf_counter()
    with torch.no_grad(), mesh_context(mesh), implicit_replication():
        sharded, launches = greedy(
            sparams, shard_batch({"tokens": prompt}, mesh), True)
    sharded_s = time.perf_counter() - t
    del params, sparams
    want = cfg.n_layers * SERVE_SHARDED_STEPS
    res = {"config": cfg.name, "layers": cfg.n_layers, "rows": 8,
           "prompt": SERVE_SHARDED_PROMPT, "steps": SERVE_SHARDED_STEPS,
           "mesh": {"data": 1, "model": 1},
           "tokens_equal": bool(torch.equal(plain, sharded)),
           "kernel": kernel, "kernel_launches": launches[kernel],
           "want_launches": want, "plain_launches": plain_launches,
           "launches": launches, "plain_s": plain_s, "sharded_s": sharded_s}
    print(json.dumps({"serve_sharded": res}), flush=True)
    if not res["tokens_equal"]:
        raise AssertionError(f"serve_sharded {arch}: tokens differ: plain "
                             f"{plain[:2].tolist()} sharded "
                             f"{sharded[:2].tolist()}")
    if launches[kernel] != want:
        raise AssertionError(f"serve_sharded {arch}: {kernel} launched "
                             f"{launches[kernel]}, want {want}")
    return res


def multi_card_case(np, torch, dev, shape):
    """``tests/_sharded_worker.py``'s cases over NCCL on a ``shape`` mesh
    of cards, one rank a card, from seeded inits and batches: each
    against the plain step on ``dev`` under a mesh of the same axis
    sizes (its MoE groups tokens by ``data`` as the sharded one does):
    the loss and params at ``SHARDED_TOL``, the moments at its relative
    bound, every state leaf back in its placements."""
    import importlib.util
    import tempfile
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import constant_lr
    from repro_torch.sharding import mesh_context
    from repro_torch.sharding.rules import leaf_paths
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import leaves

    path = os.path.join(ROOT, "tests", "_sharded_worker.py")
    spec = importlib.util.spec_from_file_location("_sharded_worker", path)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    rng = np.random.default_rng(SEED)
    arrays, plain = {"meta": json.dumps(worker.CASES)}, {}
    for case, (arch, widths, mb, _) in worker.CASES.items():
        model = build_model(get_config(arch).reduced(**widths))
        state = init_train_state(model, torch.Generator(device=dev)
                                 .manual_seed(SEED), device=dev)
        tokens = rng.integers(0, model.cfg.vocab_size, (8, 32),
                              dtype=np.int32)
        arrays[f"{case}/tokens"] = tokens
        arrays[f"{case}/labels"] = np.roll(tokens, -1, axis=1)
        for p, x in zip(leaf_paths(state["params"]),
                        leaves(state["params"])):
            arrays[f"{case}/init/{p}"] = x.cpu().numpy()
        batch = {k: torch.from_numpy(arrays[f"{case}/{k}"]).to(dev)
                 for k in ("tokens", "labels")}
        step = make_train_step(model, lr_fn=constant_lr(1e-3),
                               clip_norm=1.0, microbatches=mb)
        with mesh_context(SimpleNamespace(
                shape=dict(zip(("data", "model"), shape)))):
            new, met = step(state, batch)
        plain[case] = (float(met["loss"]), {
            part: dict(zip(leaf_paths(tree), (x.cpu().numpy()
                                              for x in leaves(tree))))
            for part, tree in (("new", new["params"]),
                               ("m", new["opt"]["m"]),
                               ("v", new["opt"]["v"]))})
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(src, **arrays)
        subprocess.run([sys.executable, path, src, out, "cuda",
                        "x".join(map(str, shape))], check=True, timeout=600,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(ROOT, "src")))
        got = dict(np.load(out))
    for case, (loss, ref) in plain.items():
        r = {"loss": float(got[f"{case}/loss"]), "loss_plain": loss,
             "kept": bool(got[f"{case}/kept"])}
        r["loss_abs_diff"] = abs(r["loss"] - loss)
        r["params_max_abs_diff"] = max(
            float(np.abs(got[f"{case}/new/{p}"] - w).max())
            for p, w in ref["new"].items())
        r["moments_max_rel_diff"] = {part: max(
            float(np.abs(got[f"{case}/{part}/{p}"] - w).max()
                  / max(float(np.abs(w).max()), 1e-30))
            for p, w in ref[part].items()) for part in ("m", "v")}
        if not (r["kept"] and r["loss_abs_diff"] <= SHARDED_TOL["loss"]
                and r["params_max_abs_diff"] <= SHARDED_TOL["params"]
                and max(r["moments_max_rel_diff"].values())
                <= SHARDED_TOL["moments_rel"]):
            raise AssertionError(f"multi_card {case}: {r}")
        res[case] = r
    return {"mesh": dict(zip(("data", "model"), shape)), "device": "cuda",
            "cases": res}


def _record_decode(core, seen):
    """``core._decode_step`` that also keeps, per step, the wave's rows
    and copies of its post-step ``pos``/``t`` (device-to-device: nothing
    is synchronised while the path runs)."""
    step = core._decode_step

    def wrapped(w):
        tok = step(w)
        # one mesh position: the wave's (E, ...) tensors are its [0]
        seen.append((w.tok[0].shape[1], w.pos[0].clone(), w.t[0].clone()))
        return tok
    return wrapped


def _record_route(router, seen):
    """Wrap ``router.route`` and ``router._fine_grouped`` on the
    instance: per route call, ``seen`` keeps the rows it was given, its
    LRU hits and its top-1 experts; the list returned gets one entry per
    ``_fine_grouped`` call, the fine match of one route chunk with
    misses (nothing is copied to the card). ``_unrecord_route`` takes
    both wrappers off."""
    route, fine = router.route, router._fine_grouped
    chunks = []

    def wrapped(feats):
        res = route(feats)
        seen.append((len(feats), res.cache_hits, res.coarse[:, 0].copy()))
        return res

    def fine_wrapped(x, coarse_top1):
        chunks.append(len(x))
        return fine(x, coarse_top1)
    router.route, router._fine_grouped = wrapped, fine_wrapped
    return chunks


def _unrecord_route(router):
    del router.route, router._fine_grouped


def route_chunks(label, chunks, launches):
    """The route chunks with misses, one per ``_fine_grouped`` call that
    ``_record_route`` recorded; each launches ``expert_score`` once and
    ``cosine_scores`` (the grouped fine entry) once, however many expert
    groups it holds."""
    chunks = len(chunks)
    for name in ("expert_score", "cosine_scores"):
        if launches[name] != chunks:
            raise AssertionError(f"{label}: {name} launched {launches[name]}"
                                 f" times for {chunks} route chunks with "
                                 "misses")
    return chunks


def cpu_routes(np, torch, matcher, reqs):
    """(expert name, fine class) of each request through the CPU plain
    path: a Router over a CPU copy of the bank, coarse scoring and fine
    match through the kernels' plain versions."""
    from repro_torch.serve.router import Router
    res = Router(cpu_matcher(matcher)).route(
        np.stack([q.features for q in reqs]))
    return [(matcher.names[int(e)], int(f))
            for e, f in zip(res.coarse[:, 0], res.fine)]


def cpu_matcher(matcher):
    """The matcher over a CPU copy of its bank and centroids, default
    config: coarse scores through the plain bank math."""
    from repro_torch.core import ExpertMatcher
    return ExpertMatcher(_tree(matcher.bank_params, lambda t: t.cpu()),
                         _tree(matcher.bank_states, lambda t: t.cpu()),
                         matcher.names, matcher.centroids.cpu(),
                         matcher.centroid_mask.cpu())


def check_routes(label, want, resps):
    got = [(r.expert, r.fine_class) for r in resps]
    if got != want:
        bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise AssertionError(f"{label}: (expert, fine class) differ from the "
                             f"CPU plain path at (request, card, CPU) {bad}")


def paged_case(np, torch, dev, B, nlp, page, n_pages, live):
    """A scrambled page table (B, nlp) over ``n_pages`` pages + trash, in
    which every row shares its first (prefix) page with row 0, the pages
    holding the ``live`` written slots are distinct otherwise, and the
    tail maps to the trash page; kv_pos and q_pos of the decode step
    that wrote slot ``live - 1``."""
    rng = np.random.default_rng(SEED + B + page)
    n_valid = -(-live // page)
    perm = rng.permutation(n_pages)
    tbl = np.full((B, nlp), n_pages, np.int32)
    for b in range(B):
        tbl[b, :n_valid] = perm[b * nlp:b * nlp + n_valid]
    tbl[1:, 0] = tbl[0, 0]
    C = nlp * page
    pos = np.where(np.arange(C) < live, np.arange(C), -1).astype(np.int32)
    return (torch.from_numpy(tbl).to(dev), torch.from_numpy(pos).to(dev),
            torch.tensor(live - 1, dtype=torch.int32, device=dev))


def paged_equals_ring(torch, ops, q, kp, vp, tbl, q_pos, kv_pos, window):
    """Kernel 4 against kernel 3 on the gathered, contiguous view: the
    same tiles in the same order, so the results must be equal."""
    from repro_torch.models.attention import paged_gather
    kd, vd = paged_gather(kp, vp, tbl)
    a = ops.paged_decode_attention(q, kp, vp, tbl, q_pos, kv_pos,
                                   window=window)
    b = ops.decode_attention(q, kd.contiguous(), vd.contiguous(), q_pos,
                             kv_pos, window=window)
    if not torch.equal(a, b):
        raise AssertionError(
            "paged_decode_attention differs from decode_attention on the "
            f"gathered view: max {(a.float() - b.float()).abs().max()}")
    return True


if __name__ == "__main__":
    sys.exit(main())
