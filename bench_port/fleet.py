"""The system under test, built from a configuration file: the expert
models' weights drawn on the device from the seed, the AE bank trained
on the fleet's datasets, and ``repro_torch.serve.RoutedServer`` over one
``ExpertEngine`` an expert.

A configuration file (``configs/<name>.json``) holds the model's sizes
under the port's ``ArchConfig`` keys (``port_arch`` names the port's
config they replace), ``fleet`` (how many experts, their datasets, the
engine and scheduler settings), ``bank`` (the AE recipe) and ``init``
(how each weight is drawn). Nothing here is specific to one family.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from . import bank, synth

#: ArchConfig keys a configuration file may set
MODEL_KEYS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "n_experts",
              "experts_per_token", "moe_capacity_factor", "moe_impl",
              "rope_theta", "norm_eps", "tie_embeddings", "qkv_bias",
              "sliding_window", "rwkv_lora_dim", "ssm_chunk", "param_dtype",
              "compute_dtype")
ALIGN = 128          # elements: every weight view starts on 256 bytes


def stream(seed: int, *key: int) -> int:
    """A 63-bit integer drawn from ``seed`` and ``key``: independent
    streams (weights, bank, traffic) from one ``--seed``."""
    return int(np.random.SeedSequence([int(seed), *key]).generate_state(
        2, np.uint64)[0] >> np.uint64(1))


def arch_config(cfg: Dict[str, Any]):
    """The port's ``ArchConfig`` the file describes; every key the file
    sets must exist there."""
    from repro_torch.configs import get_config
    base = get_config(cfg["port_arch"])
    over = {k: cfg[k] for k in MODEL_KEYS if k in cfg}
    known = {f.name for f in dataclasses.fields(base)}
    bad = sorted(set(over) - known)
    if bad:
        raise KeyError(f"{cfg['name']}: unknown model keys {bad}")
    return base.replace(**over)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _rule(rules, name: str, shape):
    """(mean, deviation) of the first rule [pattern, mean, deviation(,
    factor)] whose pattern matches the leaf's path: deviation a number,
    or ``"fan_in"`` for 1 / sqrt(the leaf's second-last dim), times
    ``factor`` where given."""
    for rule in rules:
        pat, mean, std = rule[:3]
        if fnmatch.fnmatchcase(name, pat):
            if std == "fan_in":
                std = 1.0 / np.sqrt(shape[-2])
            return float(mean), float(std) * float(
                rule[3] if len(rule) > 3 else 1.0)
    raise KeyError(f"no init rule matches {name}")


def draw_weights(model, rules, vocab: int, gen: torch.Generator):
    """The model's params on ``gen``'s device: one flat buffer a dtype,
    filled by one ``torch.randn`` call in that dtype, cut into the
    port's leaves (views on 256-byte boundaries), each scaled in place
    to its rule's mean and deviation (``_rule``). Rows of ``embed`` and columns of
    ``unembed`` past ``vocab`` (the padding to 256) are zeroed, as a
    trained model never moves them. The views keep the buffers alive."""
    dev = gen.device
    shapes = list(_leaves(model.param_shapes()))
    offs, total = [], {}
    for path, meta in shapes:
        n = int(np.prod(meta.shape))
        o = total.get(meta.dtype, 0)
        offs.append(o)
        total[meta.dtype] = o + (n + ALIGN - 1) // ALIGN * ALIGN
    flats = {dt: torch.randn(n, generator=gen, dtype=dt, device=dev)
             for dt, n in sorted(total.items(), key=lambda kv: str(kv[0]))}
    params: Dict[str, Any] = {}
    with torch.no_grad():
        for (path, meta), o in zip(shapes, offs):
            n = int(np.prod(meta.shape))
            w = flats[meta.dtype][o:o + n].view(meta.shape)
            name = "/".join(path)
            mean, std = _rule(rules, name, meta.shape)
            w.mul_(std)
            if mean:
                w.add_(mean)
            if name == "embed":
                w[vocab:].zero_()
            elif name == "unembed":
                w[:, vocab:].zero_()
            _set(params, path, w)
    return params


@dataclasses.dataclass
class Fleet:
    cfg: Dict[str, Any]
    arch: Any
    model: Any
    names: List[str]
    weights: List[Any]          # per expert: params tree
    aes: List[Tuple[Dict, Dict]]
    centroid_data: List[Tuple[np.ndarray, np.ndarray]]
    server: Any = None
    engines: List[Any] = dataclasses.field(default_factory=list)

    def free_program(self) -> None:
        """Drop everything the program built (engines, caches, pools,
        graphs, matcher); the benchmark's weights and bank stay."""
        if self.server is not None:
            self.server.close()
        self.server = None
        self.engines = []


def build(cfg: Dict[str, Any], seed: int, device) -> Fleet:
    """Weights, bank and server for configuration ``cfg`` from ``seed``."""
    from repro_torch.models import build_model
    dev = torch.device(device)
    arch = arch_config(cfg)
    model = build_model(arch)
    fl = cfg["fleet"]
    names = list(fl["datasets"])[:int(fl["experts"])]
    weights = [draw_weights(model, cfg["init"], arch.vocab_size,
                            torch.Generator(device=dev).manual_seed(
                                stream(seed, 1, e)))
               for e in range(len(names))]
    bk = cfg["bank"]
    data = [synth.draw(n, int(bk["samples"]), stream(seed, 2, i) % 2**32)
            for i, n in enumerate(names)]
    aes = bank.train_bank([(n, x) for n, (x, _) in zip(names, data)],
                          stream(seed, 3) % 2**31, epochs=int(bk["epochs"]),
                          batch=int(bk["batch"]), lr=float(bk["lr"]),
                          decay_every=int(bk["decay_every"]), device=dev)
    fleet = Fleet(cfg, arch, model, names, weights, aes,
                  [(x, y) for x, y in data])
    build_server(fleet, dev)
    return fleet


def build_server(fleet: Fleet, dev) -> None:
    """``RoutedServer`` over one engine an expert, as ``fleet`` sets."""
    from repro_torch.core import ExpertRegistry, MatcherConfig, build_matcher
    from repro_torch.serve import ExpertEngine, RoutedServer
    fl = fleet.cfg["fleet"]
    eng_kw = {k: fl[k] for k in ("max_len", "min_len_bucket", "kv_layout",
                                 "page_size", "pool_pages", "chunk_len")
              if fl.get(k) is not None}
    matcher = build_matcher(
        fleet.aes, fleet.names, fleet.centroid_data,
        MatcherConfig(use_kernel=bool(fl.get("coarse_kernel", True))),
        device=dev)
    reg = ExpertRegistry()
    for name, params in zip(fleet.names, fleet.weights):
        eng = ExpertEngine(fleet.model, params,
                           batch_buckets=tuple(fl["batch_buckets"]),
                           device=dev, **eng_kw)
        reg.add(name, eng)
        fleet.engines.append(eng)
    fleet.server = RoutedServer(
        matcher, reg, max_batch=int(fl["max_batch"]),
        executor=fl.get("executor", "overlapped"),
        prefill_tokens_per_step=int(fl.get("prefill_tokens_per_step", 0)),
        device=dev)
