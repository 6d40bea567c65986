"""ExpertMatcher core — the paper's contribution (eval mode; training
arrives with port slice A11).

  1. ``autoencoder`` — the AE bank: eval-mode encode/decode and scores
  2. ``matcher.build_matcher`` — freeze bank + per-class centroids
  3. ``matcher.route`` — coarse (MSE argmin) then fine (cosine) routing
  4. ``registry`` — resolve routed indices to serving backends
"""
from .autoencoder import (bank_encode, bank_scores, decode, encode, init_ae,
                          recon_mse, stack_bank)
from .matcher import (ExpertMatcher, MatcherConfig, build_matcher,
                      class_centroids)
from .registry import ExpertEntry, ExpertRegistry, ExpertSpec

__all__ = [
    "init_ae", "encode", "decode", "recon_mse", "stack_bank",
    "bank_scores", "bank_encode",
    "ExpertMatcher", "MatcherConfig", "build_matcher", "class_centroids",
    "ExpertEntry", "ExpertRegistry", "ExpertSpec",
]
