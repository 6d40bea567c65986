"""Launch-geometry validator for the port's CUDA kernels (rules
K001-K004): the counterpart of the reference's ``pallas_check``
(P001-P004), checked on a CPU-only runner.

A kernel's Python planner (``expert_split``, ``decode_split``) and its
wrapper choose a launch the C entry may refuse (``configure`` in
``csrc/expert_score.cu``: ``MAX_RANKS``, ``MAX_ROWS``, ``MAX_SMEM``;
``csrc/decode_attention.cu``: shared memory against ``MAX_SMEM``, a grid
of ``(n_split, KV, B)``), and CUDA refuses what no entry checks (a
cluster past its limit, a grid dim past 65535). Without this pass either
shows only at the first launch on the card. Rules:

  K001  cluster size: within the C source's limit (``MAX_RANKS`` /
        ``MAX_SPLIT``), within 8 unless the source sets the non-portable
        cluster attribute (then within 16), dividing its grid dim, and
        the Python planner's limit equal to the C source's.
  K002  block and grid: threads per block at most 1024 and a multiple
        of 32, grid dims within CUDA's limits (x < 2^31, y and z <=
        65535), and the shape limits the C entry checks (``MAX_ROWS``,
        ``MAX_G``, the head sizes it has a body for).
  K003  dynamic shared memory, from the kernel's own layout formula (the
        C ``Layout`` / ``smem_bytes``, mirrored here), at most the C
        source's ``MAX_SMEM`` and the 227 KB a block may opt in to.
  K004  (warning) the 16-byte / float4 path is eligible: the rows a
        kernel copies 16 bytes at a time start on 16 bytes.

Capture, not execution: the wrappers' ``library()`` is swapped for a
recorder that notes each C entry's arguments and returns success, and
the tensors are fake CUDA tensors, so each wrapper's own Python (its
checks, its planner, its argument packing) runs for real on the CPU and
the checked launch is exactly the one the card would get. The limits
are read from the ``.cu`` sources' text, so the check cannot drift from
C. Where a planner needs device properties (``sm_count``,
``max_clusters``), it reads ``H100``; on the card, ``chip_smoke.py``
holds that table against ``torch.cuda.get_device_properties`` and the
C occupancy query.

Shapes: every shape the port's engines, matcher and trainers reach —
each attention family's heads and ``dh`` at its dtype (published and
reduced), the decode batch ladder, ring capacities and paged pages, the
router's row buckets and bank sizes, the RWKV head sizes — and at each,
every plan the planner could return: ``expert_split``'s n over its whole
allowed range, ``decode_split``'s every power of two, as ``pallas_check``
evaluates the corners of its grid.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from . import REPO_ROOT, Violation

CSRC = os.path.join(REPO_ROOT, "src", "repro_torch", "kernels", "csrc")
KERNELS = "src/repro_torch/kernels"

#: the H100 SXM the port targets: what a planner reads off the card.
#: ``clusters``: ``cudaOccupancyMaxActiveClusters`` of ``expert_score``
#: (one block an SM at its register count) by cluster size, as measured
#: for 7 to 16 blocks, every size the planner can choose at the served
#: widths (D 784, H 128); below 7, where the card is not read, as on 8
#: GPCs of 16 SMs
H100 = {
    "sm_count": 132,
    "max_threads_per_block": 1024,
    "max_grid": (2 ** 31 - 1, 65535, 65535),
    "smem_optin": 232448,               # 227 KB a block may opt in to
    "max_cluster_portable": 8,
    "max_cluster_nonportable": 16,
    "clusters": {7: 15, 8: 15, 9: 9, 10: 7, 11: 7, 12: 7, 13: 7, 14: 7,
                 15: 7, 16: 7},
}


def h100_clusters(n: int, rows: int) -> int:
    """Clusters of ``n`` blocks of ``expert_score`` the H100 holds at
    once (``H100["clusters"]``; 8 GPCs of 16 SMs below 7)."""
    return H100["clusters"].get(n, 8 * (16 // n))


# ---------------------------------------------------------------------------
# the C sources' limits, read from their text
# ---------------------------------------------------------------------------

_CONST = re.compile(
    r"constexpr\s+(?:int|size_t|unsigned)\s+(\w+)\s*=\s*(\w+)\s*;")


@dataclasses.dataclass
class Limits:
    expert: Dict[str, int]
    expert_nonportable: bool
    decode: Dict[str, int]
    decode_nonportable: bool
    cosine: Dict[str, int]
    wkv_threads: Dict[int, int]         # P -> threads a block


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name), encoding="utf-8") as fh:
        return fh.read()


def _consts(text: str) -> Dict[str, int]:
    out = {}
    for name, val in _CONST.findall(text):
        try:
            out[name] = int(val, 0)
        except ValueError:
            pass
    return out


def read_limits() -> Limits:
    es, da = _source("expert_score.cu"), _source("decode_attention.cu")
    cs, wk = _source("cosine_scores.cu"), _source("wkv_step.cu")
    wkv = {int(p): int(t) for p, t in re.findall(
        r"case\s+(\d+):\s*wkv_step_kernel<T,\s*\d+><<<grid,\s*(\d+)", wk)}
    flag = "cudaFuncAttributeNonPortableClusterSizeAllowed"
    return Limits(expert=_consts(es), expert_nonportable=flag in es,
                  decode=_consts(da), decode_nonportable=flag in da,
                  cosine=_consts(cs), wkv_threads=wkv)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Launch:
    """One C entry call a wrapper made: its name and integer arguments."""
    entry: str
    args: Dict[str, int]


# the integer arguments of each launching entry, by position
_ARGS = {
    "expert_score_f32": (6, ("B", "D", "H", "K", "n_rank", "rows")),
    "cosine_fine_f32": (6, ("R", "K", "M", "h")),
    "decode_attention": (7, ("B", "H", "KV", "S", "dh", "window",
                             "scale", "is_bf16", "n_split")),
    "paged_decode_attention": (7, ("B", "H", "KV", "n_lp", "page",
                                   "page_stride", "dh", "window", "scale",
                                   "is_bf16", "n_split")),
    "wkv_step": (8, ("B", "H", "P", "is_bf16")),
}


class _Recorder:
    """Stands in for the ctypes library: every launching entry records
    its arguments and returns success; the query entries answer from the
    mirrored formulas and the H100 table."""

    def __init__(self, limits: Limits, launches: List[Launch]):
        self._limits, self._launches = limits, launches

    def __getattr__(self, name):
        if name in _ARGS:
            first, names = _ARGS[name]

            def entry(*args):
                vals = args[first:first + len(names)]
                self._launches.append(Launch(name, dict(zip(names, vals))))
                return 0
            return entry
        if name == "expert_score_smem_bytes":
            return lambda D, H, n, rows: expert_smem(D, H, n, rows)
        if name == "expert_score_max_clusters":
            return lambda D, H, n, rows: h100_clusters(n, rows)
        if name == "decode_attention_smem_bytes":
            return lambda S, n_lp, G, dh, bf16: decode_smem(
                self._limits, S, n_lp, G, dh, 2 if bf16 else 4)
        raise AttributeError(name)


class _Stream:
    cuda_stream = 0


@contextlib.contextmanager
def capture_launches(limits: Optional[Limits] = None
                     ) -> Iterator[List[Launch]]:
    """Run the kernel wrappers against a recorder: inside the block,
    every wrapper's ``library()`` is the recorder, device queries read
    ``H100``, ``torch.cuda.device`` / ``current_stream`` are inert, and
    fake tensors are not short-cut (the wrappers' dry-run branch is for
    the dry run, not for this check). The wrappers' launch counters are
    put back on exit. Yields the list of launches."""
    import torch

    from ..kernels import (cosine_topk, decode_attention, expert_score, ops,
                           paged_decode_attention, wkv_step)
    limits = limits or read_limits()
    counts = ops.launches()            # a recorded launch ran nothing
    launches: List[Launch] = []
    rec = _Recorder(limits, launches)
    patches = []
    for mod in (cosine_topk, decode_attention, expert_score,
                paged_decode_attention, wkv_step):
        patches.append((mod, "library", lambda: rec))
        if hasattr(mod, "sm_count"):
            patches.append((mod, "sm_count",
                            lambda index: H100["sm_count"]))
        if hasattr(mod, "is_fake"):
            patches.append((mod, "is_fake", lambda t: False))
    patches.append((expert_score, "max_clusters",
                    lambda index, D, H, n, rows: h100_clusters(n, rows)))
    patches.append((torch.cuda, "device",
                    lambda dev=None: contextlib.nullcontext()))
    patches.append((torch.cuda, "current_stream",
                    lambda dev=None: _Stream()))
    saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
    try:
        for m, a, v in patches:
            setattr(m, a, v)
        with warnings.catch_warnings():
            # a fake tensor's data_ptr() is 0 (so it reads as aligned)
            warnings.simplefilter("ignore")
            yield launches
    finally:
        for m, a, v in saved:
            setattr(m, a, v)
        for name, n in counts.items():
            ops.WRAPPERS[name].launches = n


# ---------------------------------------------------------------------------
# the C side's formulas, mirrored
# ---------------------------------------------------------------------------


def expert_layout_floats(rows: int, D: int, H: int, n: int) -> int:
    """``Layout(rows, D, H, n).total`` of ``csrc/expert_score.cu``."""
    G = (D + 3) // 4
    R4 = (rows + 3) & ~3
    HP = (H + 3) & ~3
    DCS = 4 * ((G + n - 1) // n)
    return (DCS * R4 + DCS * HP + HP * DCS + HP + DCS + HP * R4
            + HP * R4 + R4 * (DCS // 4) + n * R4)


def expert_smem(D: int, H: int, n: int, rows: int) -> int:
    return 4 * expert_layout_floats(rows, D, H, n)


def decode_smem(limits: Limits, S: int, n_lp: int, G: int, dh: int,
                elt: int) -> int:
    """``smem_bytes`` of ``csrc/decode_attention.cu``."""
    c = limits.decode
    nt = (S + c["TILE"] - 1) // c["TILE"]
    tile = c["TILE"] * (dh * elt + c["PAD"])
    return 2 * c["STAGES"] * tile + 2 * G * dh * 4 + 2 * nt * 4 + n_lp * 4


@dataclasses.dataclass
class Geometry:
    grid: Tuple[int, int, int]
    block: int
    cluster: int
    smem: int
    smem_limit: int
    cluster_limit: int
    nonportable: bool
    refused: List[str]                  # what the C entry itself refuses
    wide: bool                          # the 16-byte path is eligible
    wide_why: str = ""


def geometry(launch: Launch, limits: Limits) -> Geometry:
    """The launch configuration the C entry would build for ``launch``."""
    a, e = launch.args, launch.entry
    refused: List[str] = []
    if e == "expert_score_f32":
        c = limits.expert
        B, D, H, K, n, rows = (a[k] for k in ("B", "D", "H", "K", "n_rank",
                                              "rows"))
        if n > (D + 3) // 4:
            refused.append(f"n_rank {n} > the {(D + 3) // 4} column groups")
        if not 1 <= rows <= c["MAX_ROWS"]:
            refused.append(f"rows {rows} outside 1..MAX_ROWS "
                           f"{c['MAX_ROWS']}")
        tiles = -(-B // rows)
        return Geometry((n * tiles, K, 1), c["THREADS"], n,
                        expert_smem(D, H, n, rows), c["MAX_SMEM"],
                        c["MAX_RANKS"], limits.expert_nonportable, refused,
                        D % 4 == 0 and H % 4 == 0,
                        f"D {D} and H {H} multiples of 4")
    if e in ("decode_attention", "paged_decode_attention"):
        c = limits.decode
        B, H, KV, dh = a["B"], a["H"], a["KV"], a["dh"]
        elt = 2 if a["is_bf16"] else 4
        paged = e == "paged_decode_attention"
        n_lp = a["n_lp"] if paged else 0
        S = a["n_lp"] * a["page"] if paged else a["S"]
        G = H // KV if KV and H % KV == 0 else 0
        if not G or G > c["MAX_G"]:
            refused.append(f"H {H} / KV {KV}: not a group of 1..MAX_G "
                           f"{c['MAX_G']}")
        if dh not in (32, 64, 128):
            refused.append(f"dh {dh}: no body (32, 64, 128)")
        if a["n_split"] not in (1, 2, 4, 8):
            refused.append(f"n_split {a['n_split']} not 1, 2, 4 or 8")
        wide = dh * elt % 16 == 0
        why = f"dh {dh} x {elt} bytes a multiple of 16"
        if paged:
            wide = wide and a["page_stride"] * elt % 16 == 0
            why += f", page stride {a['page_stride']} x {elt} too"
        return Geometry((a["n_split"], KV, B), 32 * max(G, 1),
                        a["n_split"],
                        decode_smem(limits, S, n_lp, max(G, 1), dh, elt),
                        c["MAX_SMEM"], c["MAX_SPLIT"],
                        limits.decode_nonportable, refused, wide, why)
    if e == "wkv_step":
        B, H, P = a["B"], a["H"], a["P"]
        threads = limits.wkv_threads.get(P)
        if threads is None:
            refused.append(f"P {P}: no body ({sorted(limits.wkv_threads)})")
        return Geometry((B * H, 1, 1), threads or 0, 1, 0,
                        H100["smem_optin"], 1, False, refused, P % 4 == 0,
                        f"P {P} a multiple of 4 (float4 state rows)")
    if e == "cosine_fine_f32":
        w = limits.cosine["WARPS"]
        R, h = a["R"], a["h"]
        return Geometry((-(-R // w), 1, 1), 32 * w, 1, 0,
                        H100["smem_optin"], 1, False, refused, h % 4 == 0,
                        f"h {h} a multiple of 4")
    raise KeyError(e)


def check_launch(launch: Launch, case: str, limits: Limits
                 ) -> List[Violation]:
    out: List[Violation] = []
    g = geometry(launch, limits)
    path = f"{KERNELS}/csrc/" + {
        "expert_score_f32": "expert_score.cu",
        "cosine_fine_f32": "cosine_scores.cu",
        "decode_attention": "decode_attention.cu",
        "paged_decode_attention": "decode_attention.cu",
        "wkv_step": "wkv_step.cu"}[launch.entry]
    func = f"{launch.entry}[{case}]"

    def v(rule: str, msg: str, severity: str = "error") -> None:
        out.append(Violation(rule, path, 0, func, msg, severity=severity))

    # K001 — cluster size
    hw = H100["max_cluster_nonportable"] if g.nonportable else \
        H100["max_cluster_portable"]
    if g.cluster < 1 or g.cluster > g.cluster_limit:
        v("K001", f"cluster of {g.cluster} outside 1..{g.cluster_limit} "
          "(the C source's limit)")
    elif g.cluster > hw:
        v("K001", f"cluster of {g.cluster} > {hw} "
          + ("(the non-portable maximum)" if g.nonportable else
             "without the non-portable cluster attribute"))
    if g.grid[0] % max(g.cluster, 1):
        v("K001", f"grid x {g.grid[0]} is not a multiple of the cluster "
          f"of {g.cluster}")
    # K002 — block and grid
    if not 0 < g.block <= H100["max_threads_per_block"] or g.block % 32:
        v("K002", f"{g.block} threads a block: not a multiple of 32 in "
          f"1..{H100['max_threads_per_block']}")
    for d, (n, lim) in enumerate(zip(g.grid, H100["max_grid"])):
        if not 1 <= n <= lim:
            v("K002", f"grid dim {'xyz'[d]} = {n} outside 1..{lim} "
              f"(grid {g.grid})")
    for why in g.refused:
        v("K002", f"the C entry refuses it: {why}")
    # K003 — dynamic shared memory
    cap = min(g.smem_limit, H100["smem_optin"])
    if g.smem > cap:
        v("K003", f"{g.smem} bytes of dynamic shared memory > {cap} "
          f"(MAX_SMEM {g.smem_limit}, the 227 KB opt-in)")
    # K004 — the 16-byte path (warning)
    if not g.wide:
        v("K004", f"the 16-byte path is not eligible: needs {g.wide_why}",
          severity="warning")
    return out


def check_planner_limits(limits: Limits) -> List[Violation]:
    """K001/K002: the Python planners' limits equal the C sources'."""
    from ..kernels import decode_attention as da, expert_score as es
    out = []
    pairs = [("K001", "expert_score.py", "MAX_RANKS", es.MAX_RANKS,
              limits.expert["MAX_RANKS"]),
             ("K002", "expert_score.py", "MAX_ROWS", es.MAX_ROWS,
              limits.expert["MAX_ROWS"]),
             ("K001", "decode_attention.py", "MAX_SPLIT", da.MAX_SPLIT,
              limits.decode["MAX_SPLIT"]),
             ("K002", "decode_attention.py", "MAX_GROUP", da.MAX_GROUP,
              limits.decode["MAX_G"]),
             ("K002", "decode_attention.py", "TILE", da.TILE,
              limits.decode["TILE"])]
    for rule, f, name, py, c in pairs:
        if py != c:
            out.append(Violation(
                rule, f"{KERNELS}/{f}", 0, name,
                f"the planner's {name} = {py}, the C source's {c}"))
    return out


# ---------------------------------------------------------------------------
# the shapes the port reaches
# ---------------------------------------------------------------------------

#: decode batch buckets (``make_buckets(1, 16)``) and the wider steps the
#: card runs (``wkv_step`` to B 32)
BATCHES = (1, 2, 4, 8, 16, 32)
#: ring capacities: engine ``max_len`` ladders, the kernels phase's
#: long caches, a 32k decode
CAPACITIES = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 32768)
PAGES = (8, 16)
#: router row buckets (``make_buckets(1, 256)``) and a whole split
#: routed at once (the matcher's evaluation over a dataset)
ROUTE_ROWS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 11274)
BANK_SIZES = tuple(range(1, 17))
CLASSES = (10, 26)


def attention_shapes() -> List[Tuple[str, int, int, int, bool]]:
    """(config, H, KV, dh, bf16) of every family that decodes through
    ``decode_attention``: published widths and the reduced ones."""
    from ..configs import all_configs
    out = []
    for name, cfg in sorted(all_configs().items()):
        if cfg.family not in ("dense", "moe", "vlm"):
            continue
        for tag, c in (("", cfg), ("-reduced", cfg.reduced()),
                       ("-reduced-kv1", cfg.reduced(n_kv_heads=1))):
            row = (name + tag, c.n_heads, c.n_kv_heads, c.dh,
                   c.compute_dtype == "bfloat16")
            if row[1:] not in [r[1:] for r in out]:
                out.append(row)
    return out


def rwkv_shapes() -> List[Tuple[str, int, int]]:
    from ..configs import all_configs
    out = []
    for name, cfg in sorted(all_configs().items()):
        if cfg.family == "rwkv":
            for tag, c in (("", cfg), ("-reduced", cfg.reduced())):
                out.append((name + tag, c.n_heads, c.dh))
    return out


def expert_plans(B: int, D: int, H: int, K: int) -> List[int]:
    """Every n ``expert_split`` could return for this shape (whatever
    the card's cluster counts): the planner itself, run against an
    ``active`` that holds everything up to each n and nothing past."""
    from ..kernels.expert_score import MAX_RANKS, expert_split
    plans = set()
    for top in range(0, MAX_RANKS + 1):
        plans.add(expert_split(B, D, H, K,
                               lambda n, r, top=top: 10 ** 9 if n <= top
                               else 0)[0])
    return sorted(plans)


def decode_plans(B: int, KV: int, S: int) -> List[int]:
    """Every n ``decode_split`` could return for this shape, over SM
    counts from 1 to many."""
    from ..kernels.decode_attention import decode_split
    return sorted({decode_split(B, KV, S, n_sm)
                   for n_sm in (1, 2, 4, 8, 16, 32, 64, 132, 4096,
                                1 << 20)})


def _cases() -> List[Tuple[str, Callable[[], None],
                           Callable[[Launch], List[Launch]]]]:
    """(case, call the wrapper, the launch's alternative plans)."""
    import torch

    from ..kernels import ops

    dev = "cuda"
    f32, bf16 = torch.float32, torch.bfloat16
    made: Dict[Any, Any] = {}

    def t(*shape, dtype=f32):
        # one fake tensor a (shape, dtype): the wrappers only read them
        key = (shape, dtype)
        if key not in made:
            made[key] = torch.empty(shape, dtype=dtype, device=dev)
        return made[key]

    cases = []
    # B1: expert_score at the router's row buckets x bank sizes
    for B in ROUTE_ROWS:
        for K in BANK_SIZES:
            D, H = 784, 128

            def call(B=B, K=K, D=D, H=H):
                ops.expert_score_folded(
                    {"w1": t(K, D, H), "b1": t(K, H), "w2": t(K, H, D),
                     "b2": t(K, D)}, t(B, D))

            def alts(launch, B=B, K=K, D=D, H=H):
                return [Launch(launch.entry, dict(launch.args, n_rank=n))
                        for n in expert_plans(B, D, H, K)]
            cases.append((f"B{B}_K{K}_D{D}_H{H}", call, alts))
    # B2: cosine_fine over a route chunk's stacked groups
    for R in ROUTE_ROWS + (512,):
        for M in CLASSES:
            def call(R=R, M=M):
                ops.cosine_fine(t(R, 128), t(6, M, 128), t(6, M),
                                t(R, dtype=torch.int32))
            cases.append((f"R{R}_M{M}_h128", call, lambda launch: []))
    # B3 / B4: every attention family, batch and capacity
    for name, H, KV, dh, is_bf16 in attention_shapes():
        dt = bf16 if is_bf16 else f32
        for B in BATCHES:
            for S in CAPACITIES:
                def call(B=B, H=H, KV=KV, dh=dh, S=S, dt=dt):
                    ops.decode_attention(
                        t(B, H, dh, dtype=dt), t(B, S, KV, dh, dtype=dt),
                        t(B, S, KV, dh, dtype=dt),
                        t(dtype=torch.int32), t(S, dtype=torch.int32))

                def alts(launch, B=B, KV=KV, S=S):
                    return [Launch(launch.entry,
                                   dict(launch.args, n_split=n))
                            for n in decode_plans(B, KV, S)]
                cases.append((f"{name}_B{B}_S{S}", call, alts))
                for page in PAGES:
                    if S % page or S > 4096:
                        continue
                    n_lp, L = S // page, 2
                    P1 = B * n_lp + 1

                    def call(B=B, H=H, KV=KV, dh=dh, n_lp=n_lp, page=page,
                             P1=P1, dt=dt, L=L):
                        # one layer's view of a (P1, L, page, KV, dh)
                        # pool: the page axis strided, as the engine
                        # passes it
                        stride = (L * page * KV * dh, page * KV * dh,
                                  KV * dh, dh, 1)
                        pool = torch.empty_strided(
                            (P1, page, KV, dh), stride[:1] + stride[2:],
                            dtype=dt, device=dev)
                        ops.paged_decode_attention(
                            t(B, H, dh, dtype=dt), pool, pool,
                            t(B, n_lp, dtype=torch.int32),
                            t(dtype=torch.int32),
                            t(n_lp * page, dtype=torch.int32))

                    def alts(launch, B=B, KV=KV, S=S):
                        return [Launch(launch.entry,
                                       dict(launch.args, n_split=n))
                                for n in decode_plans(B, KV, S)]
                    cases.append((f"{name}_B{B}_S{S}_page{page}", call,
                                  alts))
    # B5: wkv_step at every RWKV head count and every P it has a body for
    from ..kernels.wkv_step import SUPPORTED_P
    heads = sorted({(H, P) for _, H, P in rwkv_shapes()}
                   | {(64, p) for p in SUPPORTED_P})
    for H, P in heads:
        for B in BATCHES:
            for is_bf16 in (False, True):
                dt = bf16 if is_bf16 else f32

                def call(B=B, H=H, P=P, dt=dt):
                    st = t(B, H, P, P)
                    ops.wkv_step(t(B, H, P, dtype=dt), t(B, H, P, dtype=dt),
                                 t(B, H, P, dtype=dt), t(B, H, P), t(H, P),
                                 st, st)
                cases.append((f"H{H}_P{P}_B{B}_{'bf16' if is_bf16 else 'f32'}",
                              call, lambda launch: []))
    return cases


def run(limits: Optional[Limits] = None) -> List[Violation]:
    """K001-K004 over every case; a case whose wrapper raises, or makes
    no launch, is itself a K002 finding (the capture is broken or the
    wrapper refuses a shape the port reaches)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    limits = limits or read_limits()
    out = check_planner_limits(limits)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with capture_launches(limits) as launches, fake:
        for case, call, alts in _cases():
            del launches[:]
            try:
                call()
            except Exception as exc:     # noqa: BLE001 — a finding
                out.append(Violation(
                    "K002", KERNELS, 0, case,
                    f"the wrapper raised {type(exc).__name__}: {exc}"))
                continue
            if len(launches) != 1:
                out.append(Violation(
                    "K002", KERNELS, 0, case,
                    f"{len(launches)} launches recorded, expected 1 "
                    "(capture broken?)"))
                continue
            seen = set()
            for launch in [launches[0]] + alts(launches[0]):
                key = tuple(sorted(launch.args.items()))
                if key in seen:
                    continue
                seen.add(key)
                out.extend(check_launch(launch, case, limits))
    return out
