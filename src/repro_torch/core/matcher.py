"""ExpertMatcher: coarse (CA) and fine-grained (FA) expert assignment.

The paper's landscape (Fig. 1 axes): coarse resolution by minimum
reconstruction MSE under each AE of the bank (or cosine of the
reconstruction), fine resolution by maximum cosine of the bottleneck
against per-class centroids; top-1 or top-K fusion. With
``MatcherConfig(use_kernel=True)`` coarse scoring goes through the
hand-written ``expert_score`` kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import autoencoder as ae


@dataclasses.dataclass
class MatcherConfig:
    metric: str = "mse"          # coarse metric: mse | cosine
    fine_metric: str = "cosine"  # fine metric: cosine | mse
    top_k: int = 1               # fusion: number of experts returned
    use_kernel: bool = False     # coarse scoring through the CUDA kernel


class ExpertMatcher:
    """Routes client samples to expert models.

    Attributes:
      bank_params/bank_states: stacked AE params over K expert datasets.
      centroids: (K, N_max, hid) per-class mean bottleneck features,
        padded with zeros; centroid_mask: (K, N_max) validity mask.
      names: dataset/expert names, index-aligned with the bank.
    """

    def __init__(self, bank_params, bank_states, names: Sequence[str],
                 centroids=None, centroid_mask=None,
                 config: Optional[MatcherConfig] = None):
        self.bank_params = bank_params
        self.bank_states = bank_states
        self.names = list(names)
        self.centroids = centroids
        self.centroid_mask = centroid_mask
        self.config = config or MatcherConfig()

    @property
    def n_experts(self) -> int:
        return len(self.names)

    @property
    def device(self) -> torch.device:
        return self.bank_params["w_enc"].device

    # -- coarse ----------------------------------------------------------
    def coarse_scores(self, x) -> torch.Tensor:
        """(B, K) matching score; LOWER is better (MSE convention)."""
        if self.config.use_kernel:
            from ..kernels import ops as kops
            return kops.expert_score(self.bank_params, x, self.bank_states)
        if self.config.metric == "cosine":
            z = ae.bank_encode(self.bank_params, self.bank_states, x)
            xhat = ae.decode(self.bank_params, z)          # (K, B, D)
            return -_cos(xhat, x[None]).T                  # (B, K)
        return ae.bank_scores(self.bank_params, self.bank_states, x)

    def assign_coarse(self, x) -> torch.Tensor:
        """Top-1 expert index per sample: (B,)."""
        return torch.argmin(self.coarse_scores(x), dim=-1)

    def assign_coarse_topk(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fusion: (indices (B, top_k), scores (B, top_k))."""
        s = self.coarse_scores(x)
        neg, idx = torch.topk(-s, self.config.top_k, dim=-1)
        return idx, -neg

    # -- fine ------------------------------------------------------------
    def fine_scores(self, x, expert_idx) -> torch.Tensor:
        """Similarity of each sample to each class centroid of its expert.

        x: (B, D); expert_idx: (B,). Returns (B, N_max), invalid classes
        = -inf so argmax is safe.
        """
        z = ae.bank_encode(self.bank_params, self.bank_states, x)  # (K,B,h)
        zi = z[expert_idx, torch.arange(x.shape[0], device=x.device)]
        cent = self.centroids[expert_idx]                # (B, N_max, h)
        mask = self.centroid_mask[expert_idx]            # (B, N_max)
        if self.config.fine_metric == "mse":
            sim = -(cent - zi[:, None, :]).square().mean(dim=-1)
        else:
            sim = _cos(cent, zi[:, None, :])
        return torch.where(mask > 0, sim, torch.full_like(sim, -np.inf))

    def assign_fine(self, x, expert_idx=None) -> torch.Tensor:
        """Class/model index within the coarse-assigned expert: (B,)."""
        if expert_idx is None:
            expert_idx = self.assign_coarse(x)
        return torch.argmax(self.fine_scores(x, expert_idx), dim=-1)

    def route(self, x) -> Dict[str, torch.Tensor]:
        """Hierarchical CA -> FA routing (Fig. 2)."""
        coarse_idx, coarse_score = self.assign_coarse_topk(x)
        fine_idx = self.assign_fine(x, coarse_idx[:, 0])
        return {"coarse": coarse_idx, "coarse_score": coarse_score,
                "fine": fine_idx}


def _cos(a, b, eps: float = 1e-8):
    """Cosine similarity over the last axis with broadcasting; eps bounds
    the product of the norms."""
    num = (a * b).sum(dim=-1)
    den = torch.linalg.vector_norm(a, dim=-1) \
        * torch.linalg.vector_norm(b, dim=-1)
    return num / torch.clamp(den, min=eps)


def class_centroids(params, state, xs: np.ndarray, ys: np.ndarray,
                    n_max: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class mean bottleneck features for one AE (paper's mu^n).

    Returns (centroids (n_max, hid), mask (n_max,)) on ``device``.
    """
    x = torch.from_numpy(np.asarray(xs, np.float32)).to(device)
    z = ae.encode(params, state, x).cpu().numpy()
    hid = z.shape[-1]
    cent = np.zeros((n_max, hid), np.float32)
    mask = np.zeros((n_max,), np.float32)
    for c in range(int(ys.max()) + 1):
        sel = ys == c
        if sel.any():
            cent[c] = z[sel].mean(axis=0)
            mask[c] = 1.0
    return torch.from_numpy(cent).to(device), torch.from_numpy(mask).to(device)


def build_matcher(aes, names, centroid_data=None,
                  config: Optional[MatcherConfig] = None,
                  device=None) -> ExpertMatcher:
    """aes: list of (params, bn_state); centroid_data: optional list of
    (xs, ys) numpy arrays per expert for FA centroids. The bank lives on
    ``device`` (``cuda`` unless ``device="cpu"``)."""
    dev = resolve_device(device)
    aes = [({k: v.to(dev) for k, v in p.items()},
            {k: v.to(dev) for k, v in s.items()}) for p, s in aes]
    bank_params, bank_states = ae.stack_bank(aes)
    centroids = centroid_mask = None
    if centroid_data is not None:
        n_max = max(int(ys.max()) + 1 for _, ys in centroid_data)
        cents, masks = [], []
        for (params, state), (xs, ys) in zip(aes, centroid_data):
            c, m = class_centroids(params, state, xs, ys, n_max, dev)
            cents.append(c)
            masks.append(m)
        centroids = torch.stack(cents)
        centroid_mask = torch.stack(masks)
    return ExpertMatcher(bank_params, bank_states, names, centroids,
                         centroid_mask, config)
