"""Public kernel entry points (the counterpart of the reference's
``repro.kernels.ops``). Each wrapper launches a hand-written CUDA kernel
on a CUDA tensor and runs its plain PyTorch version on a CPU tensor;
each carries a ``launches`` counter that only real kernel launches bump.
"""
from .cosine_topk import (cosine_fine, cosine_fine_plain, cosine_scores,
                          cosine_scores_plain)
from .decode_attention import (decode_attention, decode_attention_plain,
                               decode_split)
from .expert_score import (expert_score, expert_score_folded,
                           expert_score_plain, expert_slices, expert_split,
                           fold_bank)
from .paged_decode_attention import (paged_decode_attention,
                                     paged_decode_attention_plain)
from .wkv_step import wkv_step, wkv_step_plain

#: every kernel wrapper of the port, by name (``cosine_fine`` counts on
#: ``cosine_scores``: one kernel body)
WRAPPERS = {
    "expert_score": expert_score_folded,
    "cosine_scores": cosine_scores,
    "decode_attention": decode_attention,
    "paged_decode_attention": paged_decode_attention,
    "wkv_step": wkv_step,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def add_launches(counts: dict) -> None:
    """Add ``counts`` (wrapper name -> launches) to the counters. A CUDA
    graph's replay launches the kernels its capture recorded without a
    wrapper call to count them, so the graph adds what its capture
    counted on every replay (and takes it back after the capture, which
    launched nothing)."""
    for name, n in counts.items():
        WRAPPERS[name].launches += n


__all__ = ["WRAPPERS", "add_launches", "cosine_fine", "cosine_fine_plain",
           "cosine_scores", "cosine_scores_plain", "decode_attention",
           "decode_attention_plain", "decode_split",
           "expert_score", "expert_score_folded", "expert_score_plain",
           "expert_slices", "expert_split", "fold_bank", "launches",
           "paged_decode_attention", "paged_decode_attention_plain",
           "reset_launches", "wkv_step", "wkv_step_plain"]
