"""Draft models for speculative decoding.

A draft proposes ``k`` cheap continuation tokens a wave row; the target
expert scores the whole (B, k+1) window in one pass
(``models.dense.DecoderLM.verify``) and the engine accepts the matched
greedy prefix. The emitted tokens never depend on the draft — any
proposals give the same tokens, only the acceptance rate (and so the
speed) changes — so drafts may be heuristic, adversarial, or learn online
from the verifier.

State is engine-level: ``init_state`` returns a tree of tensors stacked
on a leading E axis (one slice per expert), on the engine's device, drawn
from an explicit ``torch.Generator``. ``propose`` and ``observe`` see one
expert's slice (views of the stacked tensors), and ``observe`` updates it
**in place**, so a captured verify graph carries the state from one
replay to the next and the bigram draft keeps learning for the engine's
lifetime.

Drafts:

- ``MLPBaselineDraft`` ("mlp", default): the paper's MLP-Softmax baseline
  (``core/mlp_baseline.py``) over a fixed random token embedding, as a
  next-token proposer. Static.
- ``BigramTableDraft`` ("table"): a (V+1,) successor table learnt online
  from every verified (window token -> greedy continuation) pair; on the
  greedy cycles small models fall into it converges to the target's own
  transition function.
- ``AlwaysWrongDraft`` ("always-wrong"): proposes the id ``vocab``, which
  argmax never returns, so nothing is ever accepted (the verifier clamps
  the id in its embedding lookup). Proves the one-token-per-verify
  progress guarantee.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.mlp_baseline import forward as mlp_forward, init_mlp
from ..models.attention import last_writer
from ..tree import tree_map


def _stack(per_expert):
    return tree_map(lambda *xs: torch.stack(xs), *per_expert)


class DraftModel:
    """Interface. ``propose`` / ``observe`` see ONE expert's state slice."""

    name = "?"

    def init_state(self, generator: torch.Generator, n_experts: int):
        """Stacked (leading E axis) per-expert state on
        ``generator.device``."""
        raise NotImplementedError

    def propose(self, state, tok: torch.Tensor, k: int) -> torch.Tensor:
        """tok (B,) int32 last emitted token -> (B, k) int32 proposals."""
        raise NotImplementedError

    def observe(self, state, window, greedy, adv) -> None:
        """Learn from a verify outcome, in place: window / greedy (B,
        K+1), adv (B,) tokens emitted this verify (0 for frozen rows).
        Static drafts do nothing."""

    def describe(self) -> Dict[str, Any]:
        """Identity metadata for the metrics snapshot (host data only)."""
        return {"name": self.name, "kind": type(self).__name__}

    @staticmethod
    def _chain(tok, k, step):
        cur, out = tok, []
        for _ in range(k):
            cur = step(cur)
            out.append(cur)
        return torch.stack(out, dim=1)


class MLPBaselineDraft(DraftModel):
    name = "mlp"

    def __init__(self, vocab: int, in_dim: int = 32):
        self.vocab = vocab
        self.in_dim = in_dim

    def _init_one(self, gen):
        params, states = init_mlp(gen, in_dim=self.in_dim,
                                  n_classes=self.vocab, device=gen.device)
        emb = torch.randn((self.vocab, self.in_dim), generator=gen,
                          device=gen.device)
        return {"params": params, "states": states, "emb": emb}

    def init_state(self, generator, n_experts):
        return _stack([self._init_one(generator) for _ in range(n_experts)])

    def propose(self, state, tok, k):
        def step(cur):
            logits, _ = mlp_forward(state["params"], state["states"],
                                    state["emb"][cur.long()], train=False)
            return torch.argmax(logits, dim=-1).to(torch.int32)

        return self._chain(tok, k, step)


class BigramTableDraft(DraftModel):
    name = "table"

    def __init__(self, vocab: int):
        self.vocab = vocab

    def init_state(self, generator, n_experts):
        # identity successor (propose repetition) + sentinel row `vocab`
        # taking the masked observe writes
        tbl = torch.arange(self.vocab + 1, dtype=torch.int32,
                           device=generator.device)
        return {"table": tbl.expand(n_experts, -1).clone()}

    def propose(self, state, tok, k):
        table = state["table"]
        return self._chain(tok, k, lambda cur: table[cur.long()])

    def observe(self, state, window, greedy, adv):
        # every emitted pair (window[:, i] -> greedy[:, i]), i < adv, is a
        # verified transition; unemitted columns (and frozen rows) write 0
        # to the sentinel row, which propose never reads
        K1 = window.shape[1]
        dev = window.device
        mask = torch.arange(K1, device=dev)[None, :] < adv[:, None]
        idx = torch.where(mask, window, self.vocab).reshape(-1).long()
        val = torch.where(mask, greedy, 0).reshape(-1).to(torch.int32)
        # one token may appear several times with different successors;
        # the reference's scatter applies the writes in row-major order,
        # so the last one wins. index_put_ leaves the winner undefined,
        # so every write to an index carries its last writer's value
        last = last_writer(idx, self.vocab + 1)
        state["table"].index_put_((idx,), val[last])


class AlwaysWrongDraft(DraftModel):
    name = "always-wrong"

    def __init__(self, vocab: int):
        self.vocab = vocab

    def init_state(self, generator, n_experts):
        return {"_": torch.zeros((n_experts,), dtype=torch.int32,
                                 device=generator.device)}

    def propose(self, state, tok, k):
        # argmax never returns `vocab`, so nothing is ever accepted; the
        # verifier's embedding lookup clamps the id
        return torch.full(tuple(tok.shape) + (k,), self.vocab,
                          dtype=torch.int32, device=tok.device)


_DRAFTS = {
    "mlp": MLPBaselineDraft,
    "table": BigramTableDraft,
    "always-wrong": AlwaysWrongDraft,
}


def build_draft(name: str, vocab: int) -> DraftModel:
    if name not in _DRAFTS:
        raise ValueError(
            f"unknown draft {name!r}; choose from {sorted(_DRAFTS)}")
    return _DRAFTS[name](vocab)
