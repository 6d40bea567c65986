"""ExpertMatcher core — the paper's contribution as a composable module.

Pipeline (Fig. 2 of the paper):
  1. ``trainer.train_bank`` — one AE per expert dataset (server side)
  2. ``matcher.build_matcher`` — freeze bank + per-class centroids
  3. ``matcher.route`` — coarse (MSE argmin) then fine (cosine) routing
  4. ``registry`` — resolve routed indices to serving backends

``trainer.train_mlp`` trains the paper's MLP-softmax baseline.
"""
from .autoencoder import (bank_encode, bank_scores, decode, encode, forward,
                          init_ae, recon_mse, stack_bank)
from .matcher import (ExpertMatcher, MatcherConfig, build_matcher,
                      class_centroids)
from .mlp_baseline import init_mlp
from .registry import ExpertEntry, ExpertRegistry, ExpertSpec
from .trainer import train_ae, train_bank, train_mlp

__all__ = [
    "init_ae", "encode", "decode", "forward", "recon_mse", "stack_bank",
    "bank_scores", "bank_encode",
    "ExpertMatcher", "MatcherConfig", "build_matcher", "class_centroids",
    "init_mlp", "ExpertEntry", "ExpertRegistry", "ExpertSpec",
    "train_ae", "train_bank", "train_mlp",
]
