"""Resource-sharing (binding) pass over the Calyx-like IR.

The paper's toolchain instantiates a fresh functional unit for every static
operation and defers resource sharing to future work; this pass supplies the
missing binding stage, in the spirit of LegUp/HIR-style HLS binding: expensive
units (HardFloat adders/multipliers/dividers/exp, constant integer
multiply/divmod) used by *mutually exclusive* groups are rebound onto a shared
pool, so a design pays for its peak concurrency instead of its statement count.

The pass has three parts:

1. **Mutual-exclusion analysis** (:func:`concurrent_pairs`) over the control
   tree.  Children of ``seq`` execute one after another and a ``repeat`` body
   only ever races itself across iterations — both are exclusive.  The two
   arms of an ``if`` are exclusive by definition.  Only the children of a
   ``par`` may be active in the same cycle window, so group pairs drawn from
   *different* par arms are the (only) concurrent pairs.

2. **Binding** (:func:`share_cells`): every use of a shareable cell is
   greedily colored onto the lowest-indexed pool slot whose current users are
   all exclusive with it — a clique-per-``par``-arm lower bound that the
   greedy order achieves on these series-parallel control trees.  Pool slots
   are per ``(kind, const)`` class: a multiply-by-12 unit is different
   hardware from a multiply-by-48 unit and is never merged with it.

3. **Rewrite + verification**: ``Component.cells`` shrinks to the pool (plus
   untouched unshareable cells), every ``Group.cells`` list is rewritten to
   the bound names — and so is every group's micro-op list, where each
   rebound ``UAlu`` keeps its own operand temporaries plus its pre-binding
   cell as provenance, so per-user operand routing through the pool stays
   explicit and the simulator can arbitrate single ownership — and
   :func:`verify_sharing` re-checks that no pool cell is
   referenced from two concurrent groups — sharing must never serialize
   ``par`` arms, and because group latencies, ports, and the control tree are
   untouched, ``estimator.cycles`` is provably unchanged (the pipeline
   asserts it anyway).

The cost model charges each pool cell a steering overhead (operand muxes plus
a grant register) per extra user via ``float_lib.sharing_mux_cost`` — sharing
is therefore not free, and stops paying once a unit is cheaper than its mux.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Set, Tuple

from . import dataflow as D
from . import float_lib as F
from .calyx import (Cell, CIf, CNode, CPar, CRepeat, CSeq, Component, GEnable,
                    Group)

# Cells worth pooling: everything whose unit cost dwarfs a 32-bit mux.
# Cheap fabric (relu/neg/min/max, address adders, cmp, mux, registers) is
# excluded — a shared copy plus steering would cost *more* than duplicates,
# and registers carry state so they are never shareable at all.
SHAREABLE_KINDS = frozenset({
    "fp_add", "fp_sub", "fp_mul", "fp_div", "fp_exp",
    "int_mul", "int_divmod",
})


# ---------------------------------------------------------------------------
# Mutual-exclusion analysis
# ---------------------------------------------------------------------------


def concurrent_pairs(control: CNode) -> Set[frozenset]:
    """Unordered pairs of groups that may be active in the same cycle.

    Exactly the pairs that sit in *different* arms of some ``par`` node;
    every other pair (seq siblings, repeat iterations, if arms) is mutually
    exclusive under Calyx's one-subtree-at-a-time semantics.
    """
    pairs: Set[frozenset] = set()

    def walk(node: CNode) -> Set[str]:
        if isinstance(node, GEnable):
            return {node.group}
        if isinstance(node, (CSeq, CPar)):
            child_sets = [walk(ch) for ch in node.children]
            if isinstance(node, CPar):
                for i in range(len(child_sets)):
                    for j in range(i + 1, len(child_sets)):
                        for a in child_sets[i]:
                            for b in child_sets[j]:
                                pairs.add(frozenset((a, b)))
            out: Set[str] = set()
            for s in child_sets:
                out |= s
            return out
        if isinstance(node, CRepeat):
            return walk(node.body)
        if isinstance(node, CIf):
            return walk(node.then) | walk(node.els)
        raise TypeError(node)

    walk(control)
    return pairs


def mutually_exclusive(control: CNode, g1: str, g2: str) -> bool:
    """True iff groups ``g1`` and ``g2`` can never be active together."""
    if g1 == g2:
        return False
    return frozenset((g1, g2)) not in concurrent_pairs(control)


# ---------------------------------------------------------------------------
# Binding
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SharingReport:
    cells_before: int                       # shareable-kind cells pre-binding
    cells_after: int                        # pool cells post-binding
    pools: Dict[str, List[str]]             # pool cell -> original cell names
    by_kind: Dict[str, Tuple[int, int]]     # kind -> (before, after)

    @property
    def removed(self) -> int:
        return self.cells_before - self.cells_after

    def summary(self) -> str:
        per_kind = " ".join(f"{k}:{b}->{a}"
                            for k, (b, a) in sorted(self.by_kind.items()))
        return (f"shared {self.cells_before}->{self.cells_after} cells "
                f"({per_kind})")


def _pool_name(kind: str, const: int, idx: int) -> str:
    tag = f"_c{const}" if const else ""
    return f"shared_{kind}{tag}_{idx}"


def _pinned_cells(comp: Component) -> Set[str]:
    """Cells that must keep their identity: referenced from if-condition
    logic (active outside any group's window) or from more than one group
    (already structurally shared by construction, e.g. named registers)."""
    pinned: Set[str] = set()

    def walk(node: CNode) -> None:
        if isinstance(node, CIf):
            pinned.update(node.cond_cells)
            walk(node.then)
            walk(node.els)
        elif isinstance(node, (CSeq, CPar)):
            for ch in node.children:
                walk(ch)
        elif isinstance(node, CRepeat):
            walk(node.body)

    walk(comp.control)
    seen_in: Dict[str, str] = {}
    for g in comp.groups.values():
        for c in g.cells:
            if seen_in.setdefault(c, g.name) != g.name:
                pinned.add(c)
    return pinned


def share_cells(comp: Component) -> Tuple[Component, SharingReport]:
    """Bind shareable cells of mutually-exclusive groups onto shared pools.

    Returns a new :class:`Component` (control tree, group latencies, and
    port lists are reused untouched) plus a :class:`SharingReport`.
    """
    pairs = concurrent_pairs(comp.control)
    pinned = _pinned_cells(comp)

    def conflicts(g1: str, g2: str) -> bool:
        # Same group: both uses live in one activation window.  Different
        # groups: conflict iff some par makes them co-active.
        return g1 == g2 or frozenset((g1, g2)) in pairs

    # (kind, const) -> pool slots; each slot is the list of (group, orig).
    slots: Dict[Tuple[str, int], List[List[Tuple[str, str]]]] = {}
    bound: Dict[str, str] = {}              # original cell name -> pool name

    for g in comp.groups.values():          # deterministic lowering order
        for orig in g.cells:
            cell = comp.cells.get(orig)
            if (cell is None or cell.kind not in SHAREABLE_KINDS
                    or orig in pinned):
                continue
            key = (cell.kind, cell.const)
            pool = slots.setdefault(key, [])
            for idx, users in enumerate(pool):
                if all(not conflicts(g.name, ug) for ug, _ in users):
                    users.append((g.name, orig))
                    bound[orig] = _pool_name(*key, idx)
                    break
            else:
                bound[orig] = _pool_name(*key, len(pool))
                pool.append([(g.name, orig)])

    # Rebuild the cell table: pool cells appear at the position of their
    # first original, annotated with their user count for the mux model.
    pool_users: Dict[str, List[str]] = {}
    pool_cell: Dict[str, Cell] = {}
    for (kind, const), pool in slots.items():
        for idx, users in enumerate(pool):
            name = _pool_name(kind, const, idx)
            pool_users[name] = [orig for _, orig in users]
            pool_cell[name] = Cell(name, kind, const=const, users=len(users))

    new_cells: Dict[str, Cell] = {}
    for name, cell in comp.cells.items():
        if name in bound:
            pname = bound[name]
            if pname not in new_cells:
                new_cells[pname] = pool_cell[pname]
        else:
            new_cells[name] = cell

    def _route(u: D.UOp) -> D.UOp:
        # Rebind the FU invocation onto its pool cell while keeping the
        # use's own operand temporaries and pre-binding identity — the
        # per-user operand routing the simulator arbitrates against.
        if isinstance(u, D.UAlu) and u.cell in bound:
            return dataclasses.replace(u, cell=bound[u.cell],
                                       orig_cell=u.orig_cell or u.cell)
        return u

    # Rebuild only groups that actually drive a pooled cell; untouched
    # groups keep their identity, so the stage-boundary verifier's
    # already-checked cache stays valid across the sharing boundary.
    new_groups = {
        g.name: (Group(g.name, g.latency,
                       [bound.get(c, c) for c in g.cells], g.ports,
                       [_route(u) for u in g.uops])
                 if any(c in bound for c in g.cells)
                 or any(isinstance(u, D.UAlu) and u.cell in bound
                        for u in g.uops) else g)
        for g in comp.groups.values()
    }

    by_kind: Dict[str, Tuple[int, int]] = {}
    for (kind, _), pool in slots.items():
        b, a = by_kind.get(kind, (0, 0))
        by_kind[kind] = (b + sum(len(u) for u in pool), a + len(pool))
    report = SharingReport(
        cells_before=len(bound),
        cells_after=len(pool_cell),
        pools=pool_users,
        by_kind=by_kind,
    )
    shared = Component(comp.name, new_cells, new_groups, comp.control,
                       meta=dict(comp.meta))
    shared.meta["sharing"] = report.summary()
    verify_sharing(shared, pairs=pairs)
    return shared, report


# ---------------------------------------------------------------------------
# Verification — sharing must never serialize par arms
# ---------------------------------------------------------------------------


def pool_cells_by_group(comp: Component) -> Dict[str, Set[str]]:
    """group name -> shared pool cells (``users > 1``) it drives.  Shared
    by :func:`verify_sharing` and the static single-owner proof in
    ``core.verify`` (RV021)."""
    return {
        g.name: {c for c in g.cells
                 if comp.cells.get(c) is not None
                 and comp.cells[c].users > 1}
        for g in comp.groups.values()
    }


def verify_sharing(comp: Component,
                   pairs: "Set[frozenset] | None" = None) -> None:
    """Check no two concurrent groups reference the same shared pool cell.

    A pool cell reachable from two arms of one ``par`` would force those
    arms to serialize on the real hardware — exactly what the binding's
    exclusivity constraint forbids.  O(pairs x cells); cheap on the static
    group counts this IR produces.  Raises (not asserts: the invariant must
    survive ``python -O``).  ``pairs`` lets callers reuse an
    already-computed concurrency relation.
    """
    shared_by_group = pool_cells_by_group(comp)
    if pairs is None:
        pairs = concurrent_pairs(comp.control)
    for pair in pairs:
        tup = tuple(pair)
        # a singleton means a group enabled in two arms of one par — it
        # races itself, so any pooled cell it drives is a conflict
        g1, g2 = tup if len(tup) == 2 else (tup[0], tup[0])
        overlap = shared_by_group.get(g1, set()) & shared_by_group.get(g2, set())
        if overlap:
            raise ValueError(
                f"shared cell(s) {sorted(overlap)} bound into concurrent "
                f"groups {g1!r} and {g2!r}: sharing would serialize a par")


def mux_overhead(comp: Component) -> F.OpCost:
    """Total steering overhead the shared pools add (for reports)."""
    lut = ff = 0
    for cell in comp.cells.values():
        c = F.sharing_mux_cost(cell.kind, cell.users)
        lut += c.lut
        ff += c.ff
    return F.OpCost(0, lut, ff, 0)
