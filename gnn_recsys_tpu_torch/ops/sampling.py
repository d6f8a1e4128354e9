"""Neighbour sampling over padded CSC relations, and the step's draw source.

Port of ``gnn_recsys_tpu/ops/sampling.py`` (``sample_neighbors``,
``full_neighbors_packed``, ``exclusion_table``, ``exclusion_flags``), plus
:func:`unique_capped`, the static-capacity ``jnp.unique`` of the dedup'd
block forward's plan, and :func:`unique_plan`, which also keeps the unique
count and the transpose that the gather-mean backward walks.  Sampling is
WITH replacement into ``fanout`` static slots, uniform over each node's
true neighbour list; ``mode='full'`` takes the whole padded row.  Excluded
edges (the minibatch edges and their reverses) are masked after sampling:
an excluded draw becomes an invalid slot.

The sampler takes its uniform draws ``u`` as an argument.  A training step
takes every random number from one :class:`Draws` object, in a fixed call
order (the pool, then the tree walk's samplers), so that a test can replay
the numbers the JAX package drew (:class:`ReplayDraws`): the two frameworks'
random streams differ.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from gnn_recsys_tpu_torch.graph.hetero import Relation

# Widest padded row for which uniform sampling picks its slots out of one
# gathered row; wider (uncapped, power-law) rows gather each slot by its
# flat position instead (the JAX package's threshold, sampling.py:37).
ROW_GATHER_KMAX = 64

_SIGN_BIT = -(2**31)
_LOW_BITS = 2**31 - 1


class Draws:
    """Random numbers of a step from a ``torch.Generator``, in call order.

    ``record=True`` keeps every draw, so that :meth:`replay` can hand the
    same numbers to a second run."""

    def __init__(self, generator: torch.Generator, record: bool = False):
        self.generator = generator
        self.device = generator.device
        self.uniforms: Optional[List[torch.Tensor]] = [] if record else None
        self.randints: Optional[List[torch.Tensor]] = [] if record else None

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        """f32 in [0, 1) of ``shape`` (``jax.random.uniform``)."""
        out = torch.rand(tuple(shape), generator=self.generator, device=self.device)
        if self.uniforms is not None:
            self.uniforms.append(out)
        return out

    def randint(self, shape: Sequence[int], high: int) -> torch.Tensor:
        """int32 in [0, high) of ``shape`` (``jax.random.randint``)."""
        out = torch.randint(0, high, tuple(shape), generator=self.generator,
                            device=self.device, dtype=torch.int32)
        if self.randints is not None:
            self.randints.append(out)
        return out

    def replay(self) -> "ReplayDraws":
        if self.uniforms is None:
            raise ValueError("replay needs Draws(record=True)")
        return ReplayDraws(self.uniforms, self.randints)


class ReplayDraws:
    """Hands out given arrays in order; each must have the asked shape."""

    def __init__(self, uniforms: Sequence, randints: Sequence = ()):
        self._uniforms = [torch.as_tensor(a, dtype=torch.float32) for a in uniforms]
        self._randints = [torch.as_tensor(a, dtype=torch.int32) for a in randints]

    @staticmethod
    def _next(queue: list, shape: Sequence[int], what: str) -> torch.Tensor:
        if not queue:
            raise ValueError(f"no {what} draw left for shape {tuple(shape)}")
        out = queue.pop(0)
        if tuple(out.shape) != tuple(shape):
            raise ValueError(f"{what} draw of shape {tuple(out.shape)} replayed "
                             f"where {tuple(shape)} was asked")
        return out

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return self._next(self._uniforms, shape, "uniform")

    def randint(self, shape: Sequence[int], high: int) -> torch.Tensor:
        return self._next(self._randints, shape, "randint")

    @property
    def exhausted(self) -> bool:
        return not self._uniforms and not self._randints


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids``, ids clamped into range (``jnp.take``'s
    ``mode='clip'``)."""
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def sample_neighbors(
    rel: Relation,
    ids: torch.Tensor,
    fanout: int,
    u: Optional[torch.Tensor] = None,
    mode: str = "uniform",
    exclude_flags: Optional[torch.Tensor] = None,
    nbr_table: Optional[torch.Tensor] = None,
    with_eids: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Sample incoming neighbours of ``ids`` (int, any shape ``[*s]``) under
    ``rel``.  Returns ``(nbr, eid, mask)``:

    * ``mode='uniform'``: shapes ``[*s, fanout]``, uniform with replacement
      over each node's true neighbours; ``u`` [*s, fanout] f32 in [0, 1) are
      the draws.
    * ``mode='full'``: shapes ``[*s, K]``, every valid slot of the row.

    Exclusion: ``nbr_table`` is a sign-marked copy of ``rel.nbr``
    (:func:`exclusion_table`), ``exclude_flags`` a [N_dst*K] bool table
    (:func:`exclusion_flags`).  ``eid`` is None unless ``with_eids``.
    Invalid slots carry node 0, an in-range id (``sampling.py:181``).
    """
    kmax = rel.max_fanout
    table = rel.nbr if nbr_table is None else nbr_table
    eid = None
    if mode == "full":
        nbr = _rows(table, ids)  # [*s, K]
        if with_eids:
            eid = _rows(rel.nbr_eid, ids)
        mask = _rows(rel.nbr_mask, ids)
        if exclude_flags is not None:
            mask = mask & ~_rows(exclude_flags.reshape(-1, kmax), ids)
    elif mode == "uniform":
        if u is None:
            raise ValueError("uniform sampling needs its draws u")
        if tuple(u.shape) != (*ids.shape, fanout):
            raise ValueError(f"draws of shape {tuple(u.shape)} for ids {tuple(ids.shape)} "
                             f"and fanout {fanout}")
        if kmax <= ROW_GATHER_KMAX:
            row = _rows(table, ids)  # [*s, K]
            # Degree counts every slot that is not padding: sign-marked
            # (excluded) slots count too (sampling.py:108-112).
            deg = (row != -1).sum(dim=-1, dtype=torch.int32)
        else:
            deg = _rows(rel.deg, ids)
        # The slot in f32, as the JAX package computes it (f64 picks others).
        slot = torch.minimum(
            (u * deg.clamp(min=1)[..., None]).to(torch.int32),
            (deg - 1).clamp(min=0)[..., None],
        ).long()
        if kmax <= ROW_GATHER_KMAX:
            nbr = row.gather(-1, slot)
            if with_eids:
                eid = _rows(rel.nbr_eid, ids).gather(-1, slot)
            if exclude_flags is not None:
                excluded = _rows(exclude_flags.reshape(-1, kmax), ids).gather(-1, slot)
        else:
            flat = (ids.long()[..., None] * kmax + slot).clamp(0, table.numel() - 1)
            nbr = table.reshape(-1)[flat]
            if with_eids:
                eid = rel.nbr_eid.reshape(-1)[flat]
            if exclude_flags is not None:
                excluded = exclude_flags[flat]
        mask = (deg > 0)[..., None].expand(nbr.shape)
        if exclude_flags is not None:
            mask = mask & ~excluded
    else:
        raise KeyError(f"sampling mode {mode} not recognized.")
    if nbr_table is not None:
        mask = mask & (nbr >= 0)
        nbr = nbr & _LOW_BITS
    nbr = torch.where(mask, nbr, torch.zeros_like(nbr))
    return nbr, eid, mask


def full_neighbors_packed(rel: Relation, ids: torch.Tensor,
                          nbr_table: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every neighbour's raw features from the packed leaf cache
    (``rel.nbr_feat``, :func:`~gnn_recsys_tpu_torch.graph.hetero.attach_leaf_features`):
    one contiguous ``[K*F]`` row a node instead of K row gathers
    (``sampling.py:185-227``).  Returns ``(raw [*s, K, F], mask [*s, K])``;
    the mask is ``row >= 0`` of the neighbour row, so padding and the slots
    that ``nbr_table`` (:func:`exclusion_table`) sign-marks are invalid."""
    if rel.nbr_feat is None:
        raise ValueError("relation has no nbr_feat cache; call attach_leaf_features")
    kmax = rel.max_fanout
    table = rel.nbr if nbr_table is None else nbr_table
    row = _rows(table, ids)  # [*s, K]
    feat = _rows(rel.nbr_feat, ids).reshape(*ids.shape, kmax, rel.nbr_feat.shape[-1] // kmax)
    return feat, row >= 0


class UniquePlan(NamedTuple):
    """One table of the dedup'd block forward's plan (:func:`unique_plan`).

    ``uniq`` [cap] and ``inv`` [L] int32 as :func:`unique_capped`; ``count``
    int32 [1], on the device, the number of distinct ids (rows at or past it
    are padding).  With ``transpose``: ``order`` int32 [L], the positions of
    ``flat`` grouped by unique position and ascending within one, and
    ``start`` int32 [cap + 1], where each unique position's begin in
    ``order`` (the gather-mean backward walks it)."""

    uniq: torch.Tensor
    inv: torch.Tensor
    count: torch.Tensor
    order: Optional[torch.Tensor] = None
    start: Optional[torch.Tensor] = None


def unique_plan(flat: torch.Tensor, cap: int, transpose: bool = False) -> UniquePlan:
    """``jnp.unique(flat, return_inverse=True, size=cap, fill_value=0)`` with
    static shapes, and what the plan keeps beside it (:class:`UniquePlan`).
    Built from a stable sort, the first element of each run, a cumulative
    sum, two scatters and (for the transpose) a ``searchsorted`` of the run
    starts, so nothing waits on a data-dependent size (``torch.unique`` on
    CUDA synchronises with the host).  ``cap`` must be at least the number of
    distinct ids."""
    srt, order = torch.sort(flat, stable=True)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    run = torch.cumsum(first, dim=0, dtype=torch.int32) - 1  # each sorted element's position
    uniq = torch.zeros(cap, dtype=flat.dtype, device=flat.device)
    uniq[run] = srt  # the elements of one run write the same value
    inv = torch.empty_like(run)
    inv[order] = run
    count = run[-1:] + 1
    if not transpose:
        return UniquePlan(uniq, inv, count)
    positions = torch.arange(cap + 1, dtype=torch.int32, device=flat.device)
    start = torch.searchsorted(run, positions, out_int32=True)
    return UniquePlan(uniq, inv, count, order.to(torch.int32), start)


def unique_capped(flat: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.unique(flat, return_inverse=True, size=cap, fill_value=0)`` with
    static shapes: the sorted distinct ids of the 1-D ``flat``, padded with 0
    to ``cap`` entries, and each element's position among them (int32), from
    :func:`unique_plan`."""
    plan = unique_plan(flat, cap)
    return plan.uniq, plan.inv


def _slot_positions(rel: Relation, eids: torch.Tensor) -> torch.Tensor:
    """Flat padded-table positions of ``eids``; an edge dropped by the
    fanout cap maps to ``rel.nbr.numel()``, one sink slot past the table,
    which the scatters below write and then cut off (the JAX scatter's
    ``mode='drop'``, without a data-dependent shape or a host sync)."""
    if rel.eid_pos is None:
        raise ValueError("relation has no eid_pos")
    return rel.eid_pos[eids.reshape(-1).long()].long().clamp(max=rel.nbr.numel())


def exclusion_table(rel: Relation, eids: torch.Tensor) -> torch.Tensor:
    """[N_dst, K] copy of ``rel.nbr`` with the slots of ``eids`` sign-marked:
    the sampler's own row gather then carries the exclusion bit."""
    pos = _slot_positions(rel, eids)
    n = rel.nbr.numel()
    marked = torch.cat([rel.nbr.reshape(-1), rel.nbr.new_zeros(1)])  # the sink last
    marked[pos] = marked[pos] | _SIGN_BIT
    return marked[:n].reshape(rel.nbr.shape)


def exclusion_flags(rel: Relation, eids: torch.Tensor) -> torch.Tensor:
    """[N_dst*K] bool table, True at the padded-table slot of each of
    ``eids``."""
    n = rel.nbr.numel()
    flags = torch.zeros(n + 1, dtype=torch.bool, device=rel.nbr.device)  # the sink last
    flags[_slot_positions(rel, eids)] = True
    return flags[:n]
