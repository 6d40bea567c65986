"""The comparison that decides ``correct``: what the timed path served,
held to the plain references once the window has closed and the
program's state is freed.

Three numbers; a cell compares those its ``limits/<cell>.json`` gives a
limit, and prints the others:

* ``route_err``: over every request harvested, the worst routing error
  against the float64 router reference (``reference/router.py``
  ``route_errors``).
* ``logit_gap``: over a sample of the harvested requests drawn from the
  seed, the longest among them and at least ``SAMPLE_TOKENS`` served
  tokens in all, the widest gap by which a served token's reference
  logit lies below the reference's best at its position. The reference
  runs the model's full forward in float32 over the prompt as the
  system pads it (zeros on the right up to its length bucket) followed
  by the served tokens. Valid for greedy decoding, which the system
  serves.
* ``logit_gap_mean``: the mean of the same gaps over every compared
  position: steadier than the widest where a deep random bf16 stack
  amplifies rounding into a long tail of near-tie flips.

The controls put the reference in the program's place at the nearest
precision below the configuration's: the router in bfloat16 for its
float32, the model's bfloat16 weights rounded to float8 e4m3. Each
control's reading is the same number taken of its answers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .reference import decoder, router, rwkv6

SAMPLE_TOKENS = 256


def length_bucket(n: int, lo: int, hi: int) -> int:
    """The power-of-two ladder lo, 2 lo, ... capped at hi, that the
    system pads a prompt of ``n`` tokens up to."""
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


@dataclasses.dataclass
class Reading:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


def forward_fn(cfg):
    return rwkv6.forward if cfg["family"] == "rwkv" else decoder.forward


def sample(records, seed: int) -> List:
    """The requests whose generation is compared: the longest harvested
    one, then others in an order drawn from ``seed`` until their served
    tokens reach ``SAMPLE_TOKENS``."""
    done = [r for r in records if r.tokens is not None]
    if not done:
        return []
    done.sort(key=lambda r: r.spec.uid)
    longest = max(done, key=lambda r: (len(r.spec.prompt) + r.spec.max_new,
                                       -r.spec.uid))
    rng = np.random.default_rng(seed)
    out, n = [longest], len(longest.tokens)
    for i in rng.permutation(len(done)):
        if n >= SAMPLE_TOKENS:
            break
        r = done[int(i)]
        if r is not longest:
            out.append(r)
            n += len(r.tokens)
    return out


def gen_logits(cfg, params, picked, device, weight=decoder.as_f32):
    """Reference logits at every served position of each picked request:
    (served tokens, logits (n, V)) pairs."""
    fl = cfg["fleet"]
    seqs, need = [], []
    for r in picked:
        p = np.asarray(r.spec.prompt, np.int64)
        sb = length_bucket(len(p), int(fl.get("min_len_bucket", 8)),
                           int(fl["max_len"]))
        padded = np.zeros(sb, np.int64)
        padded[:len(p)] = p[-sb:]
        seq = np.concatenate([padded, np.asarray(r.tokens[:-1], np.int64)])
        seqs.append(torch.from_numpy(seq).to(device))
        need.append(sb - 1)
    with torch.no_grad():
        logits = forward_fn(cfg)(params, cfg, seqs, need, weight)
    return [(np.asarray(r.tokens, np.int64), lg) for r, lg in zip(picked,
                                                                 logits)]


def gaps(pairs, picks=None) -> List[torch.Tensor]:
    """Each position's (reference best - reference logit of the token
    served there), or of ``picks`` where given (a control's tokens)."""
    out = []
    for i, (toks, lg) in enumerate(pairs):
        t = (torch.from_numpy(toks).to(lg.device) if picks is None
             else picks[i])
        if (t < 0).any() or (t >= lg.shape[1]).any():
            out.append(torch.full((len(t),), float("inf"),
                                  device=lg.device))
            continue
        out.append(lg.max(1).values - lg.gather(1, t[:, None].long())[:, 0])
    return out


def host_bank(aes):
    return [({k: v.detach().cpu().numpy() for k, v in p.items()},
             {k: v.detach().cpu().numpy() for k, v in s.items()})
            for p, s in aes]


def route_readings(fleet, done) -> Dict[str, float]:
    """``route_err`` of the served answers, and of the control's."""
    if not done:
        return {"route_err": float("inf"), "route_err_control": float("nan")}
    aes = host_bank(fleet.aes)
    x = np.stack([r.spec.features for r in done]).astype(np.float64)
    idx = {n: i for i, n in enumerate(fleet.names)}
    expert = np.array([idx.get(r.expert, -1) for r in done])
    if (expert < 0).any():
        return {"route_err": float("inf"), "route_err_control": float("nan")}
    score = np.array([r.score for r in done])
    fine = np.array([r.fine for r in done])
    err = router.route_errors(aes, fleet.centroid_data, x, expert, score,
                              fine)
    ce, cs, cf = router.answers(aes, fleet.centroid_data, x, torch.bfloat16)
    cerr = router.route_errors(aes, fleet.centroid_data, x, ce, cs, cf)
    return {"route_err": float(err.max()),
            "route_err_control": float(cerr.max())}


def judge(fleet, window, limits: Dict[str, float], seed: int, device,
          control: bool = False) -> Dict:
    """Readings, limits and the verdict of one run; with ``control`` the
    controls' readings too (calibration only)."""
    # float32 products stay float32: TF32 keeps about three digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recs = sorted(window.records.values(), key=lambda r: r.spec.uid)
    done = [r for r in recs if r.tokens is not None]
    bad = [r for r in done if len(r.tokens) != r.spec.max_new]
    failed = len(recs) - len(done) + len(bad)
    rr = route_readings(fleet, done)
    picked = sample([r for r in done if r not in bad], seed)
    out = {"attempted": len(recs), "failed": failed,
           "sampled_requests": len(picked),
           "sampled_tokens": int(sum(len(r.tokens) for r in picked))}
    # generation: by expert, each expert's sample against its weights
    g, cg = [], []
    for e, name in enumerate(fleet.names):
        mine = [r for r in picked if r.expert == name]
        if not mine:
            continue
        ref = gen_logits(fleet.cfg, fleet.weights[e], mine, device)
        g += [x.float().cpu() for x in gaps(ref)]
        if control:
            ctl = gen_logits(fleet.cfg, fleet.weights[e], mine, device,
                             decoder.quantize_fp8)
            cg += [x.float().cpu() for x in
                   gaps(ref, [lg.argmax(1) for _, lg in ctl])]
            del ctl
        del ref
    values = {"route_err": rr["route_err"], **gap_numbers(g)}
    readings = [Reading(k, values[k], float(limits[k])) for k in limits]
    out["readings"] = readings
    out["values"] = values
    out["correct"] = failed == 0 and all(r.ok for r in readings)
    if control:
        out["control"] = {"route_err": rr["route_err_control"],
                          **gap_numbers(cg)}
    return out


def gap_numbers(g: List[torch.Tensor]) -> Dict[str, float]:
    """``logit_gap``, the widest of the gaps, and ``logit_gap_mean``,
    their mean over every compared position (inf with none)."""
    if not g:
        return {"logit_gap": float("inf"), "logit_gap_mean": float("inf")}
    a = torch.cat(g)
    return {"logit_gap": float(a.max()), "logit_gap_mean": float(a.mean())}
