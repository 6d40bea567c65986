"""Banked placement: homogeneous experts served by one engine core,
laid out over a 1-D ``expert`` device mesh.

  * ``plan_placement`` walks an ``ExpertRegistry``, groups experts whose
    ``ExpertSpec`` is equal (same architecture, bucket ladders, KV layout
    and pool geometry, speculative decoding) and bankable, and rebinds
    each group of at least ``min_bank`` to one ``BankedEngine``; other
    experts keep a singleton shard. The ``PlacementPlan`` it returns is
    what the router (``shard_of``) and the scheduler consume.
  * ``BankedEngine`` is the E > 1 view of the shared ``EngineCore``: one
    wave carries every member's micro-batch, and on CUDA one captured
    ``DecodeGraph`` (and ``VerifyGraph``) per batch bucket steps every
    member in one replay. That graph is the port's counterpart of the
    reference's single vmapped dispatch, so the bank takes its members'
    parameter tensors as they are: nothing is stacked or copied. The
    bank holds ``len(batch_buckets)`` decode graphs a mesh position, not
    per member.
  * with ``mesh`` (``launch.mesh.make_expert_mesh``, or an explicit
    ``ExpertMesh``) each bank is split over the largest slice of the
    mesh whose size divides it (``_bank_submesh``, the reference's), a
    cursor moving each next bank onto other devices; the bank's members
    move to their positions (a member already there is not copied) and
    each position steps its own members in graphs of its own.

A bank's tick computes every member, rows or not, as the reference's
vmap does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.registry import ExpertSpec
from ..launch.mesh import ExpertMesh
from ..sharding import leading_sharding
from ..tree import tree_map
from .core import EngineCore, EngineStats
from .engine import EngineFacade, ExpertEngine


class BankedEngine(EngineFacade):
    """E homogeneous experts behind one ``EngineCore``. Runs on ``cuda``
    unless ``device="cpu"``, or over ``mesh`` (its ``expert`` axis
    dividing E: member ``e`` on position ``e // (E // n)``); every
    member's params must live on its device and are used in place.
    Options as ``ExpertEngine``'s."""

    def __init__(self, model, params_list: Sequence[Any], *,
                 max_len: int = 256, min_len_bucket: int = 8,
                 batch_buckets: Optional[Sequence[int]] = None,
                 mesh=None, kv_layout: str = "ring", page_size: int = 8,
                 pool_pages: Optional[int] = None,
                 chunk_len: Optional[int] = None,
                 speculate_k: int = 0, draft=None, device=None,
                 capture_decode: bool = True):
        if not params_list:
            raise ValueError("BankedEngine needs at least one expert")
        super().__init__(model, EngineCore(
            model, params_list, max_len=max_len,
            min_len_bucket=min_len_bucket, batch_buckets=batch_buckets,
            mesh=mesh, kv_layout=kv_layout, page_size=page_size,
            pool_pages=pool_pages, chunk_len=chunk_len,
            speculate_k=speculate_k, draft=draft, device=device,
            capture_decode=capture_decode))
        self.n_experts = self.core.n_experts
        self.mesh = self.core.mesh

    @property
    def params(self) -> List[Any]:
        """The members' params, one tree per local expert (the tensors a
        hub slot install writes into)."""
        return self.core.params

    def admit(self, groups: Mapping[int, Tuple[Sequence[Any],
                                               Sequence[np.ndarray],
                                               Sequence[int]]],
              *, defer: bool = False) -> None:
        """Prefill one (E, Bb, Sb) wave holding every member's
        micro-batch (``groups``: local expert -> (uids, prompts,
        max_new)). A wave with no rows is a no-op. See
        ``EngineCore.admit_wave``."""
        self.core.admit_wave(groups, defer=defer)

    def poll(self) -> List[Tuple[int, Any, np.ndarray]]:
        """Drain finished (local expert, uid, tokens) triples."""
        return self.core.poll()


class BankHandle:
    """The engine surface a registry handle on a bank delegates to that
    bank (``BankMember``'s fixed bank, ``HubMember``'s slot bank)."""

    @property
    def _bank(self) -> BankedEngine:
        raise NotImplementedError

    def pad_shape(self, n_rows: int, prompt_len: int) -> Tuple[int, int]:
        return self._bank.pad_shape(n_rows, prompt_len)

    @property
    def batch_buckets(self) -> Tuple[int, ...]:
        return self._bank.batch_buckets

    @property
    def kv_layout(self) -> str:
        return self._bank.kv_layout

    @property
    def device(self):
        return self._bank.device

    @property
    def stats(self) -> EngineStats:
        return self._bank.stats


@dataclasses.dataclass
class BankMember(BankHandle):
    """Registry-facing handle: one expert's slot inside a BankedEngine."""
    bank: BankedEngine
    local: int

    @property
    def _bank(self) -> BankedEngine:
        return self.bank


# ---------------------------------------------------------------------------
# Placement planning
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Shard:
    """One dispatch group: a bank of experts, or a single expert served
    by whatever backend the registry holds."""
    sid: int
    experts: Tuple[int, ...]            # global registry indices
    bank: Optional[BankedEngine] = None
    devices: Tuple[Any, ...] = ()       # the bank's mesh positions

    @property
    def banked(self) -> bool:
        return self.bank is not None


@dataclasses.dataclass
class PlacementPlan:
    shards: List[Shard]
    shard_of: Dict[int, int]            # expert index -> shard id
    mesh: Any = None

    def describe(self, names: Optional[Sequence[str]] = None) -> str:
        lines = []
        for s in self.shards:
            label = ", ".join(names[e] if names else str(e)
                              for e in s.experts)
            dev = (f" on {len(s.devices)} device(s)" if s.devices else "")
            kind = "bank" if s.banked else "solo"
            lines.append(f"shard {s.sid} [{kind}]{dev}: {label}")
        return "\n".join(lines)


def _bank_submesh(n_experts: int, mesh, offset: int = 0):
    """Largest-divisor slice of the expert mesh this bank can shard over.

    ``offset`` rotates the device pool so successive banks land on
    *disjoint* slices (wrapping once the pool is exhausted) instead of
    all piling onto the mesh's first devices.
    """
    if mesh is None or "expert" not in mesh.shape:
        return None, ()
    devs = np.roll(np.asarray(mesh.devices).reshape(-1),
                   -(offset % max(mesh.shape["expert"], 1)))
    for d in range(min(len(devs), n_experts), 0, -1):
        if n_experts % d == 0:
            if d == 1:
                return None, ()   # unsharded: the bank stays on its
                #                   members' device, claims no position
            return ExpertMesh(tuple(devs[:d])), tuple(devs[:d])
    return None, ()


def plan_placement(registry, *, mesh=None,
                   min_bank: int = 2) -> PlacementPlan:
    """Group homogeneous ``ExpertEngine`` backends into ``BankedEngine``s
    and lay the banks out over ``mesh`` (1-D ``expert`` axis, see
    ``launch.mesh.make_expert_mesh``).

    Mutates ``registry`` in place: banked entries' backends become
    ``BankMember`` handles and every engine's spec is published on its
    entry. A bank runs with its members' ``capture_decode`` and takes
    their params tensors without a copy; without a mesh it runs on their
    device. With a mesh, members group by spec alone (as the
    reference's), each bank takes the slice ``_bank_submesh`` gives it
    and its members' params move to their positions (``.to``: those
    already there stay put); a bank no slice divides stays on its first
    member's device. Groups smaller than ``min_bank`` and other backends
    keep singleton shards.
    """
    by_sig: Dict[Tuple[ExpertSpec, Any, bool], List[int]] = {}
    for e in range(len(registry)):
        backend = registry[e].backend
        if isinstance(backend, BankMember):
            raise ValueError(
                f"expert {registry[e].name!r} is already bank-placed; "
                "plan_placement rebinds backends in place and cannot "
                "re-plan a planned registry — rebuild it from engines")
        if isinstance(backend, ExpertEngine):
            spec = backend.spec
            registry[e].spec = spec
            if spec.bankable:
                # one bank per (spec, device, capture): without a mesh a
                # bank steps its members on one device; with one, the
                # plan places them
                key = (spec, None if mesh is not None else backend.device,
                       backend.core.capture_decode)
                by_sig.setdefault(key, []).append(e)

    shards: List[Shard] = []
    shard_of: Dict[int, int] = {}
    cursor = 0                      # rotates banks onto disjoint devices
    for experts in by_sig.values():
        if len(experts) < min_bank:
            continue
        engines = [registry[e].backend for e in experts]
        first = engines[0]
        paged = first.kv_layout == "paged"
        submesh, devices = _bank_submesh(len(experts), mesh, cursor)
        cursor += len(devices)
        params, device = [eng.params for eng in engines], first.device
        if mesh is not None:
            home = first.params["embed"].device
            where = leading_sharding(len(experts), "expert", submesh)
            params = [tree_map(lambda t, d=(submesh.devices[where[i]]
                                            if where else home): t.to(d), p)
                      for i, p in enumerate(params)]
            device = None if where else home
        bank = BankedEngine(
            first.model, params,
            max_len=first.max_len, min_len_bucket=first.len_buckets[0],
            batch_buckets=first.batch_buckets, mesh=submesh,
            kv_layout=first.kv_layout,
            page_size=first.core.page if paged else 8,
            pool_pages=first.core.pool.n_pages if paged else None,
            chunk_len=first.core.chunk_len if paged else None,
            speculate_k=first.core.speculate_k,
            draft=first.core.draft_name, device=device,
            capture_decode=first.core.capture_decode)
        sid = len(shards)
        shards.append(Shard(sid=sid, experts=tuple(experts), bank=bank,
                            devices=devices))
        for local, e in enumerate(experts):
            registry[e].backend = BankMember(bank, local)
            shard_of[e] = sid
    for e in range(len(registry)):
        if e in shard_of:
            continue
        sid = len(shards)
        shards.append(Shard(sid=sid, experts=(e,)))
        shard_of[e] = sid
    return PlacementPlan(shards=shards, shard_of=shard_of, mesh=mesh)
