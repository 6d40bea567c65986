"""Expert registry: binds matcher bank indices to actual expert backends.

An expert entry carries a handle to the serving backend and optional
per-class sub-experts for fine-grained routing. The registry is
intentionally dumb: the matcher picks indices, the registry resolves
them. ``ExpertSpec`` is the serving-facing description of an expert:
architecture config plus engine geometry, what banked placement groups
experts by and what the expert hub keys its slots on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


def bankable_arch(arch) -> bool:
    """Whether experts of this architecture may share one banked dispatch:
    not capacity-dispatch MoE, whose per-row outputs depend on the batch
    padding (padding rows take capacity slots)."""
    return not (arch.n_experts and arch.moe_impl == "dispatch")


@dataclasses.dataclass(frozen=True)
class ExpertSpec:
    """Serving-relevant description of one expert: two experts with equal
    specs run identical shapes (same architecture with the per-expert
    name normalised out, same bucket ladders, same KV layout and pool
    geometry, same speculative decoding), which is what lets them share
    one ``BankedEngine`` (``plan_placement``) or one hub slot bank."""

    arch: Any                           # ArchConfig, name stripped
    max_len: int
    len_buckets: Tuple[int, ...]
    batch_buckets: Tuple[int, ...]
    kv_layout: str = "ring"
    page: Optional[int] = None          # paged-layout pool geometry
    pool_pages: Optional[int] = None
    chunk_len: Optional[int] = None     # chunked-prefill grid
    speculate_k: int = 0                # draft-k/verify-1 decoding
    draft: Optional[str] = None         # the draft's name

    @classmethod
    def of_engine(cls, engine) -> "ExpertSpec":
        """The spec of a live ``ExpertEngine``."""
        core = engine.core
        paged = engine.kv_layout == "paged"
        return cls(arch=engine.model.cfg.replace(name=""),
                   max_len=engine.max_len,
                   len_buckets=tuple(engine.len_buckets),
                   batch_buckets=tuple(engine.batch_buckets),
                   kv_layout=engine.kv_layout,
                   page=core.page if paged else None,
                   pool_pages=core.pool.n_pages if paged else None,
                   chunk_len=core.chunk_len if paged else None,
                   speculate_k=core.speculate_k, draft=core.draft_name)

    @property
    def bankable(self) -> bool:
        return bankable_arch(self.arch)


@dataclasses.dataclass
class ExpertEntry:
    name: str
    backend: Any = None                     # serving engine / callable
    fine_backends: Optional[List[Any]] = None  # per-class sub-experts
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    spec: Optional[ExpertSpec] = None


class ExpertRegistry:
    def __init__(self):
        self._entries: List[ExpertEntry] = []

    def add(self, name: str, backend=None, fine_backends=None,
            spec: Optional[ExpertSpec] = None, **meta) -> int:
        self._entries.append(
            ExpertEntry(name, backend, fine_backends, meta, spec))
        return len(self._entries) - 1

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, idx: int) -> ExpertEntry:
        return self._entries[idx]

    @property
    def names(self) -> List[str]:
        return [e.name for e in self._entries]

    def resolve(self, coarse_idx: int, fine_idx: Optional[int] = None):
        e = self._entries[coarse_idx]
        if fine_idx is not None and e.fine_backends:
            return e.fine_backends[fine_idx]
        return e.backend
