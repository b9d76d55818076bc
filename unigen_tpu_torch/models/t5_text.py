"""T5 v1.1 encoder, the T5-XXL text tower of FLUX/SD3 (port of
``unigen_tpu/models/t5_text.py``): pre-norm RMSNorm layers without biases,
a relative position bias (one table, shared by every layer) with the
attention mask as an additive bias, no 1/sqrt(d) scaling of the logits, a
gated-GELU MLP and a final RMSNorm. Plain PyTorch: no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from unigen_tpu_torch.layers.core import init_linear, init_rms_norm, linear, rms_norm
from unigen_tpu_torch.ops.attention import merge_heads, split_heads
from unigen_tpu_torch.utils import index_params, init_stacked


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


def tiny_t5_config(**kw) -> T5Config:
    base = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                num_heads=4)
    base.update(kw)
    return T5Config(**base)


def relative_position_buckets(qlen: int, klen: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """Bidirectional T5 relative-position buckets [qlen, klen] (a host
    table)."""
    rel = np.arange(klen)[None, :] - np.arange(qlen)[:, None]
    nb = num_buckets // 2
    ret = (rel > 0).astype(np.int64) * nb
    n = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (np.log(n.clip(1) / max_exact) / np.log(max_distance / max_exact)
                         * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return ret + np.where(n < max_exact, n, large)


def init_t5_params(cfg: T5Config, *, gen=None, device=None,
                   dtype=torch.float32) -> dict:
    """Random T5 tree in the JAX layout (token embedding N(0, 1), position
    bias N(0, 0.1), torch-default uniform linears, RMSNorm scales 1), drawn
    from ``gen`` on ``device``."""
    kw = dict(gen=gen, device=device, dtype=dtype, bias=False)
    d, inner = cfg.d_model, cfg.num_heads * cfg.d_kv

    def layer():
        return {"ln1": init_rms_norm(d, device=device, dtype=dtype),
                "q": init_linear(d, inner, **kw), "k": init_linear(d, inner, **kw),
                "v": init_linear(d, inner, **kw), "o": init_linear(inner, d, **kw),
                "ln2": init_rms_norm(d, device=device, dtype=dtype),
                "wi_0": init_linear(d, cfg.d_ff, **kw),
                "wi_1": init_linear(d, cfg.d_ff, **kw),
                "wo": init_linear(cfg.d_ff, d, **kw)}

    def normal(*shape, std):
        return torch.empty(shape, device=device, dtype=dtype).normal_(0.0, std,
                                                                      generator=gen)
    return {"token_embedding": normal(cfg.vocab_size, d, std=1.0),
            "rel_bias": normal(cfg.relative_attention_num_buckets, cfg.num_heads,
                               std=0.1),
            "layers": init_stacked(cfg.num_layers, layer),
            "final_ln": init_rms_norm(d, device=device, dtype=dtype)}


def t5_encode(params: dict, cfg: T5Config, input_ids, attention_mask=None
              ) -> torch.Tensor:
    """input_ids [B, T] -> hidden states [B, T, d_model]; keys where
    ``attention_mask`` is 0 get a -1e9 bias."""
    emb = params["token_embedding"]
    dev = emb.device
    ids = torch.as_tensor(input_ids).to(dev, torch.long)
    t = ids.shape[1]
    x = emb[ids]
    buckets = torch.as_tensor(relative_position_buckets(
        t, t, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance), device=dev)
    bias = params["rel_bias"][buckets].permute(2, 0, 1)[None]      # [1, H, T, T]
    if attention_mask is not None:
        keep = torch.as_tensor(attention_mask).to(dev)[:, None, None, :] > 0
        bias = bias + torch.where(keep, 0.0, -1e9).to(bias.dtype)
    bias = bias.to(torch.float32)
    eps = cfg.layer_norm_epsilon
    for i in range(cfg.num_layers):
        lp = index_params(params["layers"], i)
        h = rms_norm(lp["ln1"], x, eps=eps)
        q, k, v = (split_heads(linear(lp[n], h), cfg.num_heads) for n in ("q", "k", "v"))
        logits = q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2) + bias
        attn = torch.softmax(logits, dim=-1).to(v.dtype) @ v
        x = x + linear(lp["o"], merge_heads(attn))
        h = rms_norm(lp["ln2"], x, eps=eps)
        ff = F.gelu(linear(lp["wi_0"], h), approximate="tanh") * linear(lp["wi_1"], h)
        x = x + linear(lp["wo"], ff)
    return rms_norm(params["final_ln"], x, eps=eps)
