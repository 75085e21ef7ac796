"""Mixture-of-Experts with the paper's banking discipline applied to experts;
the port of ``repro.models.moe``.

``banked`` dispatch (default, the layout-embedded scheme): experts are
memory banks.  Tokens are moved into a static expert-leading capacity
buffer (E, C, D), row-wise data movement of O(T*k*D), and all compute is
dense products over the expert dimension.

``gather`` dispatch (the "branchy" analogue, for the ablation): per-token
expert-weight gathers, O(T*D*F) data movement with data-dependent indexing.

Expert-parallel dispatch (``moe_block_banked_ep``, the reference's
``shard_map``): under sharding rules whose model axis is larger than one
and divides the experts, ``moe_block`` runs the banked dispatch on each
device's tokens and its own experts (``local_map`` over the DTensors) and
sums the expert outputs over the model axis; on one card, or with no mesh,
it takes the banked path, as the reference does.  Two traps are kept
(C.12): the top-k breaks ties toward the
lower expert index, as ``jax.lax.top_k`` does (a stable descending sort;
``torch.topk`` promises no order), and dropped assignments scatter zero rows
onto the last capacity slot with an add (``index_put_(...,
accumulate=True)``), never an overwrite.  The router runs in float32
whatever the model dtype, in full float32 (``device.full_f32``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..device import full_f32
from . import common as _common
from .common import activation, constrain
from .config import ModelConfig
from .params import gated_mlp


def _router(cfg: ModelConfig, p, x2: torch.Tensor, aux: bool = True):
    """x2: (T, D) -> (probs (T,k), idx (T,k), aux metrics).  ``aux=False``
    skips the two auxiliary losses (an empty dict), which the decode step
    discards, as the reference's jitted step lets XLA drop them."""
    with full_f32():
        logits = x2.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = srt[:, :k], order[:, :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    if not aux:
        return top_p, top_i, {}
    e = cfg.num_experts
    me = F.one_hot(top_i, e).sum(1).float().mean(dim=0)       # load/expert
    pe = probs.mean(dim=0)
    moe_aux = e * torch.sum(me / k * pe)
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_p, top_i, {"moe_aux": moe_aux, "moe_zloss": zloss}


def capacity(cfg: ModelConfig, tokens: int) -> int:
    c = int(math.ceil(tokens * cfg.experts_per_token
                      * cfg.moe_capacity_factor / cfg.num_experts))
    return max(8, -(-c // 8) * 8)   # pad to lane multiple


def _assign(cfg: ModelConfig, top_p, top_i, cap: int):
    """The flat (T*k,) assignment stream, token-major: (expert, gate, kept,
    slot), the slot inside each expert's capacity buffer being the number of
    earlier assignments to it, clamped to the last."""
    eid = top_i.reshape(-1)
    gate = top_p.reshape(-1)
    oh = F.one_hot(eid, cfg.num_experts)                      # (T*k, E)
    pos = torch.cumsum(oh, dim=0) - oh                        # exclusive
    pos = torch.take_along_dim(pos, eid[:, None], dim=1)[:, 0]
    return eid, gate, pos < cap, torch.clamp_max(pos, cap - 1)


def _expert_ffn(cfg: ModelConfig, p, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, D) -> (E, C, D): dense over the leading expert 'banks'."""
    h = torch.bmm(xe, p["w1"])
    if gated_mlp(cfg):
        g = torch.bmm(xe, p["wg"])
        h = activation(cfg, g) * h
    else:
        h = activation(cfg, h)
    return constrain(torch.bmm(h, p["w2"]), "experts", "capacity", None)


def moe_block_banked(cfg: ModelConfig, p, x: torch.Tensor, aux: bool = True
                     ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, D).  Static-capacity dispatch: scatter rows into the
    expert-leading buffer, dense expert FFN, gather back."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = capacity(cfg, t)
    x2 = x.reshape(t, d)
    top_p, top_i, aux_m = _router(cfg, p, x2, aux)
    eid, gate, keep, pos_c = _assign(cfg, top_p, top_i, cap)

    # dropped assignments add zero rows onto the last slot (C.12)
    x_rep = torch.repeat_interleave(x2, k, dim=0)             # (T*k, D)
    upd = x_rep * keep[:, None].to(x.dtype)
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((eid, pos_c), upd, accumulate=True)
    ye = _expert_ffn(cfg, p, buf)
    y_rows = ye[eid, pos_c]                                   # (T*k, D)
    y_rows = y_rows.float() * (gate * keep.float())[:, None]
    y2 = y_rows.reshape(t, k, d).sum(dim=1)
    return y2.to(x.dtype).reshape(b, s, d), aux_m


def moe_block_gather(cfg: ModelConfig, p, x: torch.Tensor, aux: bool = True
                     ) -> Tuple[torch.Tensor, Dict]:
    """Ablation path: per-token expert-weight gathers (the 'branchy'
    analogue), only sane at small scale."""
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    top_p, top_i, aux_m = _router(cfg, p, x2, aux)
    y2 = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for slot in range(cfg.experts_per_token):
        idx = top_i[:, slot]                       # (T,) dynamic
        w1 = p["w1"][idx]                          # (T, D, F) gather
        w2 = p["w2"][idx]
        h = torch.bmm(x2[:, None], w1)[:, 0]
        if gated_mlp(cfg):
            wg = p["wg"][idx]
            h = activation(cfg, torch.bmm(x2[:, None], wg)[:, 0]) * h
        else:
            h = activation(cfg, h)
        y = torch.bmm(h[:, None], w2)[:, 0]
        y2 = y2 + top_p[:, slot, None] * y.float()
    return y2.to(x.dtype).reshape(b, s, d), aux_m


def _ep_context():
    """(mesh, model_axis, batch_axes, tp_size) when EP is available."""
    mesh = _common._MESH
    if mesh is None:
        return None
    rules = _common._RULES
    model_axis = rules.get("experts")
    batch_axes = rules.get("batch")
    if not isinstance(model_axis, str):
        return None
    from ..sharding.rules import axis_sizes
    tp = axis_sizes(mesh).get(model_axis, 1)
    if tp <= 1:
        return None
    return mesh, model_axis, batch_axes, tp


def _axis_mean(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of ``t`` over the mesh ``axes`` (a name or a tuple), one
    sum over each axis's group in turn (``pmean`` over the tuple)."""
    from torch.distributed import _functional_collectives as funcol
    names = axes if isinstance(axes, (tuple, list)) else (axes,)
    for a in names:
        t = funcol.all_reduce(t, "sum", mesh.get_group(a)) / mesh.size(
            list(mesh.mesh_dim_names).index(a))
    return t


def moe_block_banked_ep(cfg: ModelConfig, p, x: torch.Tensor, mesh,
                        model_axis, batch_axes, tp: int, aux: bool = True
                        ) -> Tuple[torch.Tensor, Dict]:
    """Expert-parallel dispatch, the reference's ``shard_map`` body on each
    device's local tensors (``local_map``).

    Tokens are replicated across the model axis after batch sharding, so
    each expert owner selects the rows bound for its experts locally: the
    dispatch moves no bytes; one all-reduce (sum) over the model axis
    combines expert outputs.  The device index is the bank index.  The
    capacity is the local one, ``capacity(cfg, tokens on the device)``, and
    the auxiliary losses are averaged over the batch axes, then over the
    model axis."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor.experimental import local_map
    from ..sharding.rules import PartitionSpec as P, to_placements

    k = cfg.experts_per_token
    e_loc = cfg.num_experts // tp
    gated = gated_mlp(cfg)
    m = mesh.get_local_rank(model_axis)
    group = mesh.get_group(model_axis)

    def local_fn(xl, router, w1, w2, wg):
        bl, s, d = xl.shape
        tl = bl * s
        x2 = xl.reshape(tl, d)
        top_p, top_i, aux_m = _router(cfg, {"router": router}, x2, aux)
        cap = capacity(cfg, tl)                       # local capacity
        eid, gate, keep, pos_c = _assign(cfg, top_p, top_i, cap)

        mine = (eid >= m * e_loc) & (eid < (m + 1) * e_loc) & keep
        loc_e = torch.where(mine, eid - m * e_loc, 0)
        x_rep = torch.repeat_interleave(x2, k, dim=0)
        upd = x_rep * mine[:, None].to(xl.dtype)
        buf = torch.zeros((e_loc, cap, d), dtype=xl.dtype, device=xl.device)
        buf.index_put_((loc_e, pos_c), upd, accumulate=True)

        h = torch.bmm(buf, w1)
        if gated:
            h = activation(cfg, torch.bmm(buf, wg)) * h
        else:
            h = activation(cfg, h)
        ye = torch.bmm(h, w2)

        y_rows = ye[loc_e, pos_c]
        w_gate = (gate * mine.float())[:, None]
        y2 = (y_rows.float() * w_gate).reshape(tl, k, d).sum(dim=1)
        y2 = funcol.all_reduce(y2, "sum", group)      # combine experts
        aux_m = {kk: _axis_mean(_axis_mean(vv, mesh, batch_axes), mesh,
                                model_axis)
                 for kk, vv in aux_m.items()}
        return y2.to(xl.dtype).reshape(bl, s, d), aux_m

    pl = lambda *axes: to_placements(P(*axes), mesh)   # noqa: E731
    bank = pl(model_axis, None, None)
    wg_param = p.get("wg", p["w1"])
    n_aux = 2 if aux else 0
    fn = local_map(
        local_fn,
        out_placements=(pl(batch_axes, None, None),) + (pl(),) * n_aux,
        in_placements=(pl(batch_axes, None, None), pl(None, None), bank,
                       bank, bank),
        device_mesh=mesh, redistribute_inputs=True)
    return fn(x, p["router"], p["w1"], p["w2"], wg_param)


def moe_block(cfg: ModelConfig, p, x: torch.Tensor, aux: bool = True
              ) -> Tuple[torch.Tensor, Dict]:
    if cfg.moe_dispatch == "banked":
        ep = _ep_context()
        if ep is not None and cfg.num_experts % ep[3] == 0:
            mesh, model_axis, batch_axes, tp = ep
            return moe_block_banked_ep(cfg, p, x, mesh, model_axis,
                                       batch_axes, tp, aux)
        return moe_block_banked(cfg, p, x, aux)
    return moe_block_gather(cfg, p, x, aux)
