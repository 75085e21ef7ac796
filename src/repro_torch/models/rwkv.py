"""RWKV6 "Finch" block: data-dependent-decay time mix + channel mix; the
port of ``repro.models.rwkv``.

Time mix: data-dependent token-shift interpolation (ddlerp with a shared
low-rank adapter), per-channel decay ``w_t = -exp(w0 + lora(x))``, WKV
recurrence with bonus ``u`` (strictly-past state + current-token bonus:
``diag_mode='bonus'`` of the decay scan), per-head group norm, output gate.

Channel mix: token-shift lerp, squared-ReLU FFN with a receptance gate.

The model path runs on torch ops and the model-side scan
(``models.ssm_ops``), as the reference's runs on jnp: it calls no kernel.
The decay LoRA runs in float32 with upcast weights, in full float32
(``device.full_f32``).  The decode halves return the new cache entries and
leave the cache as it was; ``models.decode`` writes them.  The shift caches
hold the *normed* inputs ``xn``/``xn2``, not the residual stream
(``ROADMAP.md`` C.10).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..device import full_f32
from .common import constrain, layer_norm, unshard
from .config import ModelConfig
from .ssm_ops import chunked_decay_scan, decay_scan_step


def _group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm over (B, S, H*dh)."""
    bsz, s, d = x.shape
    xh = x.reshape(bsz, s, heads, d // heads).float()
    mu = xh.mean(-1, keepdim=True)
    var = ((xh - mu) ** 2).mean(-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    out = xh.reshape(bsz, s, d) * w.float() + b.float()
    return out.to(x.dtype)


def _shift(x: torch.Tensor, prev: torch.Tensor = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros/``prev`` for t=0)."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev
    return torch.cat([pad, x[:, :-1]], dim=1)


def _ddlerp(p, x: torch.Tensor, xx: torch.Tensor):
    """Finch data-dependent lerp producing the 5 mixed inputs (r,k,v,w,g)."""
    delta = xx - x
    # shared low-rank adapter: (B,S,D) -> 5 x (B,S,D)
    mixed = x + delta * 0.5
    low = unshard(torch.tanh(mixed @ p["mix_A"]), -1)
    low = low.reshape(*low.shape[:-1], 5, -1)                 # (B,S,5,r)
    adj = torch.einsum("bsir,ird->bsid", low, p["mix_B"])     # (B,S,5,D)
    mu = p["mu"][None, None]                                  # (1,1,5,D)
    out = x[:, :, None] + delta[:, :, None] * (mu + adj)
    return [out[:, :, i] for i in range(5)]


def _time_mix_core(cfg: ModelConfig, p, xr, xk, xv, xw, xg):
    h, dh = cfg.num_heads, cfg.head_dim
    b, s, _ = xr.shape
    r = (xr @ p["wr"]).reshape(b, s, h, dh)
    k = (xk @ p["wk"]).reshape(b, s, h, dh)
    v = (xv @ p["wv"]).reshape(b, s, h, dh)
    # as channel_mix's products (ROADMAP.md C.24)
    g = constrain(xg @ p["wg"], "batch", "seq", "embed")
    with full_f32():
        lora = constrain((xw.float() @ p["wlora_A"].float())
                         @ p["wlora_B"].float(), "batch", "seq", "embed")
        w_log = -torch.exp(p["w0"].float() + lora)            # (B,S,D) <= 0
    w_log = w_log.reshape(b, s, h, dh)
    return r, k, v, g, w_log


def time_mix(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    h = cfg.num_heads
    xx = _shift(x)
    xr, xk, xv, xw, xg = _ddlerp(p, x, xx)
    r, k, v, g, w_log = _time_mix_core(cfg, p, xr, xk, xv, xw, xg)
    # (B,S,H,dh) -> (B,H,S,dh)
    tr = lambda t: t.transpose(1, 2)                          # noqa: E731
    o = chunked_decay_scan(tr(r), tr(k), tr(v), tr(w_log), u=p["u"],
                           chunk=64, diag_mode="bonus")       # (B,H,S,dh)
    o = o.transpose(1, 2).reshape(b, s, d)
    o = _group_norm(o, p["gn_w"], p["gn_b"], heads=h)
    o = o * F.silu(g)
    out = o.to(x.dtype) @ p["wo"]
    return constrain(out, "batch", "seq", "embed")


def _channel_ffn(p, x: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """The gated squared-ReLU FFN over ``x`` and its shifted ``xx``."""
    xk = x + (xx - x) * p["mu_k"]
    xr = x + (xx - x) * p["mu_r"]
    # on a mesh each product may come out a partial sum, which DTensor
    # resolves in the next pointwise op by scattering over the sequence, a
    # layout no later product can flatten: each takes its layer's layout
    # first, as mlp.mlp_block's (ROADMAP.md C.24)
    k = torch.square(torch.clamp_min(
        constrain(xk @ p["wk"], "batch", "seq", "mlp"), 0.0))
    kv = constrain(k @ p["wv"], "batch", "seq", "embed")
    r = torch.sigmoid(constrain(xr @ p["wr"], "batch", "seq", "embed"))
    return r * kv


def channel_mix(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    return _channel_ffn(p, x, _shift(x))


def rwkv_block(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    x = x + time_mix(cfg, p["tm"],
                     layer_norm(x, p["ln1"]["w"], p["ln1"]["b"]))
    x = x + channel_mix(cfg, p["cm"],
                        layer_norm(x, p["ln2"]["w"], p["ln2"]["b"]))
    return x


# ---------------------------------------------------------------------------
# Decode (O(1): wkv state + two shift states)
# ---------------------------------------------------------------------------


def rwkv_cache_shape(cfg: ModelConfig, batch: int):
    return {
        "wkv": (batch, cfg.num_heads, cfg.head_dim, cfg.head_dim),
        "shift_tm": (batch, 1, cfg.d_model),
        "shift_cm": (batch, 1, cfg.d_model),
    }


def rwkv_time_mix_step(cfg: ModelConfig, p, x1: torch.Tensor, cache: Dict
                       ) -> Tuple[torch.Tensor, Dict]:
    """Time-mix half of the decode step (ln1 + WKV recurrence + gate).

    Reads ``cache['wkv']``/``cache['shift_tm']``; returns the residual
    stream after the time mix and the new halves of the cache: the float32
    wkv state and ``xn``.  Split out of :func:`rwkv_decode_step` so the
    layer profiler can time the two operators separately.
    """
    b, _, d = x1.shape
    h, dh = cfg.num_heads, cfg.head_dim
    xn = layer_norm(x1, p["ln1"]["w"], p["ln1"]["b"])
    xx = cache["shift_tm"]
    xr, xk, xv, xw, xg = _ddlerp(p["tm"], xn, xx)
    r, k, v, g, w_log = _time_mix_core(cfg, p["tm"], xr, xk, xv, xw, xg)
    sq = lambda t: t[:, 0].reshape(b, h, dh)                  # noqa: E731
    o, wkv_new = decay_scan_step(cache["wkv"], sq(r), sq(k), sq(v),
                                 sq(w_log), u=p["tm"]["u"], diag_mode="bonus")
    o = o.reshape(b, 1, d)
    o = _group_norm(o, p["tm"]["gn_w"], p["tm"]["gn_b"], heads=h)
    o = o * F.silu(g)
    x1 = x1 + o.to(x1.dtype) @ p["tm"]["wo"]
    return x1, {"wkv": wkv_new, "shift_tm": xn}


def rwkv_channel_mix_step(cfg: ModelConfig, p, x1: torch.Tensor, cache: Dict
                          ) -> Tuple[torch.Tensor, Dict]:
    """Channel-mix half of the decode step (ln2 + gated squared-ReLU FFN)."""
    xn2 = layer_norm(x1, p["ln2"]["w"], p["ln2"]["b"])
    return x1 + _channel_ffn(p["cm"], xn2, cache["shift_cm"]), {"shift_cm": xn2}


def rwkv_decode_step(cfg: ModelConfig, p, x1: torch.Tensor, cache: Dict
                     ) -> Tuple[torch.Tensor, Dict]:
    x1, c_tm = rwkv_time_mix_step(cfg, p, x1, cache)
    x1, c_cm = rwkv_channel_mix_step(cfg, p, x1, cache)
    return x1, {**c_tm, **c_cm}
