"""``moe_block_banked`` with its capacity buffer addressed by (expert, slot)
pairs: filled by ``index_put_(accumulate=True)`` and read by advanced
indexing, which a card runs as sorting scatters, forward or backward.  The
formulation the flat slot index (``index_add_`` / ``index_select``) is held
against, on the CPU (``test_torch_moe.py``) and on the card
(``test_torch_card.py``); it imports no JAX."""
import torch

from repro_torch.models import moe as MOE


def indexed_banked(cfg, p, x):
    """x: (B, S, D) -> (y, aux) as ``MOE.moe_block_banked`` gives them."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = MOE.capacity(cfg, t)
    x2 = x.reshape(t, d)
    top_p, top_i, aux_m = MOE._router(cfg, p, x2)
    held = (cfg.expert_offset, e) if cfg.routed_experts != e else None
    eid, gate, keep, pos_c = MOE._assign(top_p, top_i, cap, held)
    upd = torch.repeat_interleave(x2, k, dim=0) * keep[:, None].to(x.dtype)
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((eid, pos_c), upd, accumulate=True)
    ye = MOE._expert_ffn(cfg, p, buf)
    y_rows = ye[eid, pos_c].float() * (gate * keep.float())[:, None]
    y2 = y_rows.reshape(t, k, d).sum(dim=1)
    return y2.to(x.dtype).reshape(b, s, d), aux_m
