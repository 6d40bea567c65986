"""Zamba2-style hybrid, the reference's ``repro.models.zamba``: a Mamba2
backbone with a *shared* full-attention transformer block (attention +
MLP, one set of weights) applied after every ``cfg.attn_every``-th Mamba2
layer (arXiv:2411.15242). As in the reference, Zamba2's per-invocation
LoRA adapters and initial-embedding concat are omitted: the shared block
is applied to the running residual stream with plain weight reuse.

The reference picks the attention branch per layer with ``lax.cond`` on
static flags; here a Python branch over the fixed layer ids, so a
captured decode step has no data-dependent control flow.

The cache is {ssm (L, B, H, N, P), conv_x / conv_B / conv_C (L, B, W - 1,
C), all in the compute dtype; attn_k / attn_v (A, B, C, KV, dh), one K/V
group per shared-block application (A = n_layers // attn_every: the
activations differ though the weights are shared), attn_pos (C,), t ()}.
Decode writes every leaf in place: the SSM states and conv windows
through ``mamba_step``, the slot ``t % C`` of each application's K/V,
``attn_pos`` once a step before the layers (every application attends
with it) and ``t`` after them. Decode attention is the plain
``attention``, as the reference's (its Pallas decode kernel is not used
here; ``zamba2_7b``'s head_dim is 112). Ring layout only: the family has
no paged or speculative-verify protocol, in the reference either.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from ..sharding import shard_act
from ..sharding.context import (reduce_grad, reduce_sums,
                                unshard_batch_axes)
from ..tree import tree_map
from .api import BaseModel, register_family
from .attention import attention, cache_prefill, init_kv_cache, ring_write
from .common import (dense_init, dt, embed_init, embed_lookup, init_device,
                     rmsnorm, softmax_xent, stack_views)
from .dense import _init_layers as init_attn_layers
from .dense import _layer_decode, _layer_full
from .mamba2 import init_mamba_layer, mamba_seq, mamba_step

BATCH = ("pod", "data")


@register_family("hybrid")
class Zamba2(BaseModel):
    """Mamba2 LM with one shared attention block, ring layout."""

    def _attn_layer_ids(self) -> List[int]:
        """The Mamba2 layers after which the shared block runs."""
        cfg = self.cfg
        if not cfg.attn_every:
            return []
        return list(range(cfg.attn_every - 1, cfg.n_layers, cfg.attn_every))

    @property
    def n_attn_apps(self) -> int:
        return len(self._attn_layer_ids())

    def init(self, generator, device=None):
        """Params from ``generator`` (a ``torch.Generator`` on the target
        device, or an int seed for one). Runs on ``cuda`` unless
        ``device="cpu"``; ``device="meta"`` gives shapes only. ``shared``
        is one unstacked dense layer (the reference's ``init_attn_layer``
        leaves), present when the config applies it at all."""
        cfg = self.cfg
        dev, generator = init_device(generator, device)
        dtype = dt(cfg.param_dtype)
        params = {
            "embed": embed_init(generator, (cfg.padded_vocab, cfg.d_model),
                                dtype),
            "layers": init_mamba_layer(generator, cfg, dtype, cfg.n_layers),
            "ln_f": torch.ones((cfg.d_model,), dtype=torch.float32,
                               device=dev),
            "unembed": dense_init(generator,
                                  (cfg.d_model, cfg.padded_vocab), dtype),
        }
        if self.n_attn_apps:
            one = init_attn_layers(generator, cfg.replace(n_layers=1), dtype)
            params["shared"] = tree_map(lambda a: a[0], one)
        return params

    # ------------------------------------------------------------------
    def _run_full(self, params, x, positions, collect: bool = False):
        """Every layer over the full sequence (train / prefill): (x,
        collected). With ``collect``, ``collected`` holds each layer's
        final SSM state and the raw conv inputs of its last W - 1
        positions, and each application's (k, v); else None. Under
        ``cfg.remat`` (training) each layer with its shared-block
        application runs under ``torch.utils.checkpoint``."""
        cfg = self.cfg
        shared = params.get("shared")
        if shared is not None:
            shared = tree_map(unshard_batch_axes, shared)
        apps = set(self._attn_layer_ids())
        tail = cfg.ssm_conv_width - 1
        got = {"ssm": [], "conv_x": [], "conv_B": [], "conv_C": [],
               "k": [], "v": []}

        def layer(x, lp, with_attn):
            h = reduce_grad(rmsnorm(x, lp["ln1"], cfg.norm_eps))
            o, s_fin = mamba_seq(lp, h, cfg)
            x = x + reduce_sums(o)
            kv = None
            if with_attn:
                x, kv, _ = _layer_full(x, shared, cfg, positions)
            return shard_act(x, (BATCH, None, None)), kv, s_fin, h

        for i, lp in enumerate(stack_views(params["layers"])):
            if collect:
                x, kv, s_fin, h = layer(x, lp, i in apps)
                got["ssm"].append(s_fin)
                for key, w in (("conv_x", "w_in_x"), ("conv_B", "w_B"),
                               ("conv_C", "w_C")):
                    got[key].append(h[:, -tail:] @ lp[w])
                if kv is not None:
                    got["k"].append(kv[0])
                    got["v"].append(kv[1])
            elif cfg.remat:
                x = checkpoint(lambda x, lp, a: layer(x, lp, a)[0], x, lp,
                               i in apps, use_reentrant=False)
            else:
                x = layer(x, lp, i in apps)[0]
        return x, (got if collect else None)

    def _unembed(self, params, x):
        return reduce_grad(x) @ unshard_batch_axes(
            params["unembed"]).to(x.dtype)

    def loss(self, params, batch):
        """Mean next-token cross-entropy of batch {"tokens", "labels"} (B,
        S) over the padded vocab: (ce, {"ce"})."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], batch["tokens"]).to(
            dt(cfg.compute_dtype))
        x = shard_act(x, (BATCH, None, None))
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        x, _ = self._run_full(params, x, positions)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        ce = softmax_xent(self._unembed(params, x), batch["labels"])
        return ce, {"ce": ce}

    # ------------------------------------------------------------------
    def init_cache(self, batch_size, capacity, device=None):
        cfg = self.cfg
        L, H, N, P = (cfg.n_layers, cfg.ssm_heads, cfg.ssm_state,
                      cfg.ssm_head_dim)
        Wm1, B = cfg.ssm_conv_width - 1, batch_size
        cdt = dt(cfg.compute_dtype)

        def zeros(*shape):
            return torch.zeros(shape, dtype=cdt, device=device)

        cache = {
            "ssm": zeros(L, B, H, N, P),
            "conv_x": zeros(L, B, Wm1, cfg.d_inner),
            "conv_B": zeros(L, B, Wm1, N),
            "conv_C": zeros(L, B, Wm1, N),
            "t": torch.zeros((), dtype=torch.int32, device=device),
        }
        A = self.n_attn_apps
        if A:
            kv = init_kv_cache(B, capacity, cfg.n_kv_heads, cfg.dh, cdt,
                               device=device)
            cache["attn_k"] = kv["k"].new_zeros((A,) + tuple(kv["k"].shape))
            cache["attn_v"] = torch.zeros_like(cache["attn_k"])
            cache["attn_pos"] = kv["pos"]
        return cache

    def prefill(self, params, batch, capacity=None):
        """batch {"tokens": (B, S)} -> (last-position logits (B, Vp), the
        cache above with t = S). Right padding is part of the prompt: its
        tokens enter the SSM states and conv windows, as in the
        reference."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_lookup(params["embed"], tokens).to(dt(cfg.compute_dtype))
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        x, got = self._run_full(params, x, positions, collect=True)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        logits = self._unembed(params, x[:, -1])
        cache = self.new_cache(B, capacity or self.cache_capacity(S),
                               like=x)
        for key in ("ssm", "conv_x", "conv_B", "conv_C"):
            cache[key].copy_(torch.stack(got[key]))
        cache["t"].fill_(S)
        if self.n_attn_apps:
            kv = cache_prefill({"k": cache["attn_k"], "v": cache["attn_v"]},
                               torch.stack(got["k"]), torch.stack(got["v"]))
            cache["attn_pos"] = kv["pos"]
        return logits, cache

    def decode(self, params, cache, batch):
        """batch {"token": (B, 1)} -> (logits (B, Vp), cache updated in
        place)."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], batch["token"]).to(
            dt(cfg.compute_dtype))
        t = cache["t"]
        app_of: Dict[int, int] = {l: a for a, l in
                                  enumerate(self._attn_layer_ids())}
        shared = tree_map(unshard_batch_axes, params.get("shared", {}))
        if app_of:
            C = cache["attn_k"].shape[2]
            slot = (t % C).reshape(1).long()
            kv_pos = cache["attn_pos"]
            kv_pos.index_copy_(0, slot, t.reshape(1))
        for i, lp in enumerate(stack_views(params["layers"])):
            h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
            o, _, _ = mamba_step(lp, h, cache["ssm"][i], {
                "x": cache["conv_x"][i], "B": cache["conv_B"][i],
                "C": cache["conv_C"][i]}, cfg)
            x = x + o
            if i in app_of:
                ck = cache["attn_k"][app_of[i]]
                cv = cache["attn_v"][app_of[i]]

                def write_attend(q, k1, v1, ck=ck, cv=cv):
                    ring_write(ck, cv, k1, v1, slot)
                    return attention(q[:, None], ck, cv, q_pos=t.reshape(1),
                                     kv_pos=kv_pos,
                                     window=cfg.sliding_window)[:, 0]

                x = _layer_decode(x, shared, t, cfg, write_attend)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        logits = self._unembed(params, x[:, 0])
        t.add_(1)
        return logits, cache
