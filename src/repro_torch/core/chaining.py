"""Operation chaining / group fusion over the Calyx-like IR (opt_level 1).

The lowering emits one group per source statement, and the paper's control
compilation pays for that granularity twice: every group owns a go/done
handshake and an FSM state (attention at factor 4 burns >1300 states and
drops fmax to ~130 MHz), and every ``par`` of tiny groups pays a join
handshake per loop iteration.  This pass fuses groups at the IR level so
downstream stages — estimator, Calyx simulator, RTL lowering, RTL
simulator — all price and execute the *same* coarser schedule:

* **seq fusion** — a run of consecutive group enables inside a ``seq``
  becomes one group: micro-ops are concatenated with their cycle offsets
  shifted by the running latency, so the dependent chain
  (address compute -> load -> ALU -> store -> next statement) executes in
  one activation window.  Cycle-neutral by construction (the fused
  latency is the sum the ``seq`` already paid) but it collapses FSM
  states and go/done fabric — and it is what turns a multi-statement
  loop body into the single-group form the pipelining pass needs.

* **par fusion** — arms of a ``par`` that are single groups and provably
  port-compatible (pairwise non-conflicting under the estimator's
  bank-affine test: distinct banks, or broadcast-equal load addresses)
  fuse into one group of latency ``max(arms)``.  The arms' memory
  accesses keep their per-arm cycle offsets — the simulators still stamp
  and police every port claim — but the fork/join handshake and the
  per-arm FSM controllers disappear.  Arms that do conflict are left
  behind as separate arms (greedy bucketing), so fusion never serializes
  anything the conflict partition would have run concurrently.

A ``par`` whose arms all fuse into one group loses the par node entirely
(no join reduction); a ``seq`` left with one child collapses to that
child.  Fused groups are renamed deterministically in traversal order, so
emitted text stays byte-reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from . import dataflow as D
from . import estimator
from .calyx import (CIf, CNode, CPar, CRepeat, CSeq, Component, GEnable,
                    Group, referenced_groups)


def _max_temp(uops: List[D.UOp]) -> int:
    """Highest SSA temp id used in a micro-op list (-1 if none)."""
    hi = -1
    for u in uops:
        for field in D.TEMP_FIELDS:
            v = getattr(u, field, None)
            if isinstance(v, int):
                hi = max(hi, v)
    return hi


def _shift_uop(u: D.UOp, tmp_base: int, cyc_base: int) -> D.UOp:
    """Renumber one micro-op's temps by ``tmp_base`` and shift its cycle
    offset by ``cyc_base`` (the fused group's running latency)."""
    kw: Dict[str, int] = {}
    for field in D.TEMP_FIELDS:
        v = getattr(u, field, None)
        if isinstance(v, int):
            kw[field] = v + tmp_base
    if hasattr(u, "off"):
        kw["off"] = u.off + cyc_base
    return dataclasses.replace(u, **kw)


def _fuse(groups: List[Group], name: str, sequential: bool) -> Group:
    """Concatenate ``groups`` into one.

    ``sequential=True`` chains them back to back (offsets shifted by the
    running latency, total = sum) — the seq-fusion shape; ``False`` runs
    them concurrently from cycle 0 (total = max) — the par-fusion shape.
    Temps are renumbered into one dense SSA space either way.
    """
    uops: List[D.UOp] = []
    cells: List[str] = []
    ports = []
    tmp_base = 0
    cyc_base = 0
    latency = 0
    for g in groups:
        base = cyc_base if sequential else 0
        uops += [_shift_uop(u, tmp_base, base) for u in g.uops]
        cells += g.cells
        ports += list(g.ports)
        tmp_base += _max_temp(g.uops) + 1
        if sequential:
            cyc_base += g.latency
            latency = cyc_base
        else:
            latency = max(latency, g.latency)
    return Group(name, latency, cells, ports, uops)


class _Chainer:
    def __init__(self, comp: Component):
        self.comp = comp
        self.groups: Dict[str, Group] = dict(comp.groups)
        self._n = 0
        self.seq_fused = 0
        self.par_fused = 0

    def _name(self) -> str:
        self._n += 1
        return f"fused{self._n}"

    def _install(self, parts: List[Group], sequential: bool) -> GEnable:
        fused = _fuse(parts, self._name(), sequential)
        for g in parts:
            del self.groups[g.name]
        self.groups[fused.name] = fused
        if sequential:
            self.seq_fused += len(parts)
        else:
            self.par_fused += len(parts)
        return GEnable(fused.name)

    # -- seq: fuse maximal runs of group enables ------------------------------
    def _rewrite_seq(self, node: CSeq) -> CNode:
        children = [self.rewrite(ch) for ch in node.children]
        out: List[CNode] = []
        run: List[Group] = []

        def flush() -> None:
            if len(run) == 1:
                out.append(GEnable(run[0].name))
            elif run:
                out.append(self._install(list(run), sequential=True))
            run.clear()

        for ch in children:
            if isinstance(ch, GEnable):
                run.append(self.groups[ch.group])
            else:
                flush()
                out.append(ch)
        flush()
        if len(out) == 1:
            return out[0]
        return CSeq(out)

    # -- par: fuse compatible single-group arms -------------------------------
    def _rewrite_par(self, node: CPar) -> CNode:
        children = [self.rewrite(ch) for ch in node.children]
        if len(children) <= 1:
            return children[0] if children else CPar([])
        # Only arms that conflict with *no* sibling fuse (their singleton
        # conflict components).  Fusing across components could chain two
        # previously-independent serializations through the union of the
        # fused arm's ports — restricting to conflict-free arms makes par
        # fusion a guaranteed improvement (max of latencies, no join for
        # whatever collapses), never a regression.  A pair of accesses
        # conflicts for the union iff it conflicts for some member, so
        # conflict-free arms stay conflict-free after fusing.
        tmp = Component(self.comp.name, self.comp.cells, self.groups,
                        node)
        ports = [estimator._collect_ports(tmp, ch, set())
                 for ch in children]
        conflicted = [False] * len(children)
        for i in range(len(children)):
            for j in range(i + 1, len(children)):
                if estimator.ports_conflict(ports[i], ports[j]):
                    conflicted[i] = conflicted[j] = True
        # greedy bucketing of the conflict-free single-group arms; arm
        # order is preserved (each bucket lands at its first member's
        # position) so the interpreter's value order survives fusion
        buckets: List[List[Group]] = []
        bucket_of: Dict[int, int] = {}          # child index -> bucket index
        for i, ch in enumerate(children):
            if conflicted[i] or not isinstance(ch, GEnable):
                continue
            g = self.groups[ch.group]
            for bi, bucket in enumerate(buckets):
                if not self._shares_pool_cell(g, bucket):
                    bucket.append(g)
                    bucket_of[i] = bi
                    break
            else:
                bucket_of[i] = len(buckets)
                buckets.append([g])
        emitted: set = set()
        arms: List[CNode] = []
        for i, ch in enumerate(children):
            if i not in bucket_of:
                arms.append(ch)
                continue
            bi = bucket_of[i]
            if bi in emitted:
                continue
            emitted.add(bi)
            bucket = buckets[bi]
            if len(bucket) == 1:
                arms.append(GEnable(bucket[0].name))
            else:
                arms.append(self._install(bucket, sequential=False))
        if not arms:
            return CPar([])
        if len(arms) == 1:
            return arms[0]          # the join handshake disappears with it
        return CPar(arms)

    def _shares_pool_cell(self, g: Group, bucket: List[Group]) -> bool:
        """Refuse to fuse two arms driving one shared pool cell — their
        activation windows would overlap on a single-owner unit.  (Only
        reachable when chaining runs after binding; the standard pipeline
        chains first, where every cell is still private.)"""
        pooled = {c for c in g.cells
                  if self.comp.cells.get(c) is not None
                  and self.comp.cells[c].users > 1}
        if not pooled:
            return False
        for other in bucket:
            if pooled & {c for c in other.cells
                         if self.comp.cells.get(c) is not None
                         and self.comp.cells[c].users > 1}:
                return True
        return False

    # -- dispatch -------------------------------------------------------------
    def rewrite(self, node: CNode) -> CNode:
        if isinstance(node, GEnable):
            return node
        if isinstance(node, CSeq):
            return self._rewrite_seq(node)
        if isinstance(node, CPar):
            return self._rewrite_par(node)
        if isinstance(node, CRepeat):
            return dataclasses.replace(node, body=self.rewrite(node.body))
        if isinstance(node, CIf):
            return dataclasses.replace(node, then=self.rewrite(node.then),
                                       els=self.rewrite(node.els))
        raise TypeError(node)


def chain_component(comp: Component) -> Component:
    """Fuse groups along ``seq`` runs and across compatible ``par`` arms.

    Returns a new component over the same cells; group count, FSM states,
    and par-join handshakes shrink, while every memory port claim keeps a
    definite cycle offset the simulators still verify.  Seq fusion is
    cycle-neutral; par fusion removes join/fork cycles the coarser
    schedule genuinely no longer pays.
    """
    chainer = _Chainer(comp)
    control = chainer.rewrite(comp.control)
    live = referenced_groups(control)
    groups = {name: g for name, g in chainer.groups.items() if name in live}
    out = Component(comp.name, comp.cells, groups, control,
                    meta=dict(comp.meta))
    out.meta["chained"] = {"seq_fused": chainer.seq_fused,
                          "par_fused": chainer.par_fused,
                          "groups": len(groups)}
    return out
