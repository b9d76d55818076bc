"""Prompt encoding of the FLUX stack (port of the FLUX part of
``unigen_tpu/models/text_encoder.py``): the CLIP-L pooled embedding alone
(the condition task name's embedding) and the full FLUX prompt encoding
(T5 sequence embeddings, CLIP pooled, zero text ids).

The tokenizers are duck-typed: any callable taking ``(prompts,
padding="max_length", max_length=n, truncation=True,
return_tensors="np")`` and returning an object with numpy ``input_ids``,
as a transformers tokenizer does. The port
depends on no transformers.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from unigen_tpu_torch.models.clip_text import CLIPTextConfig, clip_encode
from unigen_tpu_torch.models.t5_text import T5Config, t5_encode


def tokenize(tokenizer, prompts: Sequence[str], max_length: int):
    """-> input_ids, a numpy array [B, max_length]."""
    return tokenizer(list(prompts), padding="max_length", max_length=max_length,
                     truncation=True, return_tensors="np").input_ids


def encode_pooled_only(clip_params, clip_cfg: CLIPTextConfig, tokenizer,
                       prompts: Sequence[str]) -> torch.Tensor:
    """The 1-encoder mode: CLIP's pooled embedding of e.g. the condition task
    name, at 77 tokens."""
    ids = tokenize(tokenizer, prompts, 77)
    return clip_encode(clip_params, clip_cfg, ids)[2]


def flux_encode_prompt(clip_params, clip_cfg: CLIPTextConfig, t5_params,
                       t5_cfg: T5Config, tokenizer, tokenizer_2,
                       prompts: Sequence[str], max_sequence_length: int = 512
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (prompt_embeds [B, T, d_model], pooled [B, D], text_ids [T, 3])."""
    pooled = encode_pooled_only(clip_params, clip_cfg, tokenizer, prompts)
    t5_ids = tokenize(tokenizer_2, prompts, max_sequence_length)
    embeds = t5_encode(t5_params, t5_cfg, t5_ids)
    return embeds, pooled, torch.zeros(embeds.shape[1], 3, device=embeds.device)
