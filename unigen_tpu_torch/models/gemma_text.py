"""Gemma-2, the SANA family's prompt encoder (port of
``unigen_tpu/models/gemma_text.py``): a decoder-only causal transformer
whose last hidden states condition SANA as T5's do FLUX.

Gemma-2's particulars, all as in JAX: RMSNorm multiplies by (1 + scale) in
fp32; the token embedding is scaled by sqrt(hidden) in the embedding's
dtype; grouped-query attention repeats k and v; RoPE in the half-split
``rotate_half`` layout (not FLUX's interleaved pairs, so neither
``ops/rope.py`` nor the kernels' rotation pass applies); fp32 logits
scaled by ``query_pre_attn_scalar ** -0.5`` and soft-capped as
cap * tanh(x / cap); masked logits at -1e30; sandwich norms inside both
residual branches; a GeGLU MLP with the tanh GELU; sliding-window layers
alternating from layer 0 (a no-op for prompts within the window). The
attention is plain PyTorch (JAX writes its own einsums, no Pallas); the
linears go through ``layers.core.linear``, so a quantized tower runs the
W4A8 / W8A8 kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from unigen_tpu_torch.layers.core import gelu_tanh, init_linear, linear


@dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int = 256000
    hidden_size: int = 2304
    intermediate_size: int = 9216
    num_layers: int = 26
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    attn_logit_softcapping: float = 50.0
    query_pre_attn_scalar: float = 256.0
    sliding_window: int = 4096


def tiny_gemma_config(**overrides) -> GemmaConfig:
    base = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
                query_pre_attn_scalar=8.0, sliding_window=16)
    base.update(overrides)
    return GemmaConfig(**base)


def init_gemma_params(cfg: GemmaConfig, *, gen=None, device=None,
                      dtype=torch.float32) -> dict:
    """A random tree in the layout of ``io/torch_bridge.load_gemma_text``:
    linears without bias, norm scales N(0, 0.1) (they act as 1 + scale),
    the embedding N(0, 0.02)."""
    kw = dict(bias=False, gen=gen, device=device, dtype=dtype)
    d, hd = cfg.hidden_size, cfg.head_dim

    def norm():
        return {"scale": torch.empty(d, device=device, dtype=dtype).normal_(
            0.0, 0.1, generator=gen)}

    def layer():
        return {"input_ln": norm(), "post_attn_ln": norm(), "pre_ff_ln": norm(),
                "post_ff_ln": norm(),
                "attn": {"q": init_linear(d, cfg.num_heads * hd, **kw),
                         "k": init_linear(d, cfg.num_kv_heads * hd, **kw),
                         "v": init_linear(d, cfg.num_kv_heads * hd, **kw),
                         "o": init_linear(cfg.num_heads * hd, d, **kw)},
                "gate": init_linear(d, cfg.intermediate_size, **kw),
                "up": init_linear(d, cfg.intermediate_size, **kw),
                "down": init_linear(cfg.intermediate_size, d, **kw)}

    embed = torch.empty((cfg.vocab_size, d), device=device, dtype=dtype)
    return {"embed": embed.normal_(0.0, 0.02, generator=gen),
            "layers": [layer() for _ in range(cfg.num_layers)],
            "final_ln": norm()}


def _rms(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    normed = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (normed * (1.0 + p["scale"].to(torch.float32))).to(x.dtype)


def _rope_tables(cfg: GemmaConfig, s: int, device):
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, cfg.head_dim, 2, dtype=torch.float32, device=device)
        / cfg.head_dim))
    freqs = torch.arange(s, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)          # half-split layout
    return emb.cos(), emb.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _attention(p: dict, cfg: GemmaConfig, x, cos, sin, mask):
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def proj(name, nh):
        return linear(p[name], x).reshape(b, s, nh, hd).permute(0, 2, 1, 3)

    q, k, v = proj("q", h), proj("k", kvh), proj("v", kvh)
    # the fp32 tables promote q and k to fp32, as jnp's promotion does
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    rep = h // kvh
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k.to(torch.float32))
    logits = logits * (cfg.query_pre_attn_scalar ** -0.5)
    cap = cfg.attn_logit_softcapping
    logits = cap * torch.tanh(logits / cap)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return linear(p["o"], out.permute(0, 2, 1, 3).reshape(b, s, h * hd))


def _layer(p: dict, cfg: GemmaConfig, x, cos, sin, mask):
    eps = cfg.rms_norm_eps
    h = _attention(p["attn"], cfg, _rms(p["input_ln"], x, eps), cos, sin, mask)
    x = x + _rms(p["post_attn_ln"], h, eps)
    h = _rms(p["pre_ff_ln"], x, eps)
    h = linear(p["down"], gelu_tanh(linear(p["gate"], h)) * linear(p["up"], h))
    return x + _rms(p["post_ff_ln"], h, eps)


def gemma_encode(params: dict, cfg: GemmaConfig, input_ids: torch.Tensor,
                 attention_mask=None) -> torch.Tensor:
    """[B, S] token ids (and an optional [B, S] padding mask, 1 = token) ->
    the last hidden states [B, S, hidden] in the embedding's dtype."""
    embed = params["embed"]
    input_ids = torch.as_tensor(input_ids, device=embed.device).long()
    s = input_ids.shape[1]
    x = embed[input_ids] * torch.tensor(cfg.hidden_size ** 0.5, dtype=embed.dtype,
                                        device=embed.device)
    cos, sin = _rope_tables(cfg, s, embed.device)
    cos, sin = cos[None, None], sin[None, None]
    pos = torch.arange(s, device=embed.device)
    causal = (pos[:, None] >= pos[None, :])[None, None]
    if attention_mask is not None:
        am = torch.as_tensor(attention_mask, device=embed.device)
        causal = causal & (am[:, None, None, :] > 0)
    sliding = causal & ((pos[:, None] - pos[None, :]) < cfg.sliding_window)[None, None]
    for i, lp in enumerate(params["layers"]):
        x = _layer(lp, cfg, x, cos, sin, sliding if i % 2 == 0 else causal)
    return _rms(params["final_ln"], x, cfg.rms_norm_eps)
