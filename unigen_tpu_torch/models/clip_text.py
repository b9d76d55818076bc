"""CLIP text encoder, the ViT-L/14 text tower (port of
``unigen_tpu/models/clip_text.py``): token + learned position embeddings,
pre-LN transformer layers with causal attention and GELU-family MLPs, a
final LayerNorm, and the pooled output at the EOS token (projected when a
``text_projection`` exists). The MLP's activation is the config's
``hidden_act``: quick-GELU (CLIP-L, the JAX package's only one) or the
exact GELU (CLIP-G, SD3's ``text_encoder_2``). Its attention is the plain
``sdpa_xla`` with the causal mask: the text towers reach no attention
kernel (their quantized linears reach W4A8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from unigen_tpu_torch.layers.core import init_linear, layer_norm, linear
from unigen_tpu_torch.ops.attention import merge_heads, sdpa_xla, split_heads
from unigen_tpu_torch.utils import index_params, init_stacked


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    projection_dim: Optional[int] = None   # set for CLIPTextModelWithProjection
    eos_token_id: int = 49407
    hidden_act: str = "quick_gelu"         # or "gelu" (exact, erf)


def tiny_clip_config(**kw) -> CLIPTextConfig:
    base = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                num_layers=2, num_heads=4, max_position_embeddings=16,
                eos_token_id=90)
    base.update(kw)
    return CLIPTextConfig(**base)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


def _layer_norm_params(d, device, dtype):
    return {"scale": torch.ones(d, device=device, dtype=dtype),
            "bias": torch.zeros(d, device=device, dtype=dtype)}


def init_clip_params(cfg: CLIPTextConfig, *, gen=None, device=None,
                     dtype=torch.float32) -> dict:
    """Random CLIP tree in the JAX layout (embeddings N(0, 0.02) and
    N(0, 0.01), torch-default uniform linears, LayerNorms 1 and 0), drawn
    from ``gen`` on ``device``."""
    kw = dict(gen=gen, device=device, dtype=dtype)
    d = cfg.hidden_size

    def layer():
        return {"ln1": _layer_norm_params(d, device, dtype),
                "q": init_linear(d, d, **kw), "k": init_linear(d, d, **kw),
                "v": init_linear(d, d, **kw), "o": init_linear(d, d, **kw),
                "ln2": _layer_norm_params(d, device, dtype),
                "fc1": init_linear(d, cfg.intermediate_size, **kw),
                "fc2": init_linear(cfg.intermediate_size, d, **kw)}

    def normal(*shape, std):
        return torch.empty(shape, device=device, dtype=dtype).normal_(0.0, std,
                                                                      generator=gen)
    p = {"token_embedding": normal(cfg.vocab_size, d, std=0.02),
         "position_embedding": normal(cfg.max_position_embeddings, d, std=0.01),
         "layers": init_stacked(cfg.num_layers, layer),
         "final_ln": _layer_norm_params(d, device, dtype)}
    if cfg.projection_dim:
        p["text_projection"] = init_linear(d, cfg.projection_dim, bias=False, **kw)
    return p


def _ln(p, x):
    return layer_norm(x, eps=1e-5, weight=p["scale"], bias=p["bias"])


def clip_encode(params: dict, cfg: CLIPTextConfig, input_ids
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """input_ids [B, T] -> (last_hidden [B, T, D], penultimate_hidden (the
    residual stream after the second-to-last layer, before the final LN),
    pooled [B, D']). Pooled is the final hidden state at the EOS token (the
    first id equal to ``eos_token_id``; with the legacy ``eos_token_id == 2``
    the largest id, as transformers does), projected when the tree has a
    ``text_projection``."""
    emb = params["token_embedding"]
    ids = torch.as_tensor(input_ids).to(emb.device, torch.long)
    b, t = ids.shape
    x = emb[ids] + params["position_embedding"][None, :t]
    causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=emb.device))[None, None]
    heads = cfg.num_heads
    if cfg.hidden_act not in ACTIVATIONS:
        raise ValueError(f"CLIP hidden_act {cfg.hidden_act!r}: expected one of "
                         f"{sorted(ACTIVATIONS)}")
    act = ACTIVATIONS[cfg.hidden_act]
    penultimate = x
    for i in range(cfg.num_layers):
        lp = index_params(params["layers"], i)
        h = _ln(lp["ln1"], x)
        q, k, v = (split_heads(linear(lp[n], h), heads) for n in ("q", "k", "v"))
        x = x + linear(lp["o"], merge_heads(sdpa_xla(q, k, v, causal)))
        h = _ln(lp["ln2"], x)
        x = x + linear(lp["fc2"], act(linear(lp["fc1"], h)))
        if i == cfg.num_layers - 2:
            penultimate = x
    if cfg.num_layers < 2:
        penultimate = x
    last = _ln(params["final_ln"], x)
    if cfg.eos_token_id == 2:
        eos_pos = ids.argmax(dim=-1)
    else:
        eos_pos = (ids == cfg.eos_token_id).to(torch.int32).argmax(dim=-1)
    pooled = last[torch.arange(b, device=emb.device), eos_pos]
    if "text_projection" in params:
        pooled = linear(params["text_projection"], pooled)
    return last, penultimate, pooled
