"""Prompt encoding of the FLUX and SD3 stacks (port of
``unigen_tpu/models/text_encoder.py``): the CLIP pooled embedding alone
(the condition task name's embedding), the FLUX prompt encoding (T5
sequence embeddings, CLIP pooled, zero text ids) and the SD3 one (CLIP-L
and CLIP-G penultimate states side by side, channel-padded, with the T5
sequence or a zero block after them; the two pooled embeddings joined).

The tokenizers are duck-typed: any callable taking ``(prompts,
padding="max_length", max_length=n, truncation=True,
return_tensors="np")`` and returning an object with numpy ``input_ids``,
as a transformers tokenizer does. The port
depends on no transformers.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

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


def sd3_encode_prompt(clip_l, clip_l_cfg: CLIPTextConfig, clip_g,
                      clip_g_cfg: CLIPTextConfig, t5_params, t5_cfg: Optional[T5Config],
                      tokenizer, tokenizer_2, tokenizer_3, prompts: Sequence[str],
                      max_sequence_length: int = 256,
                      pad_to_dim: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SD3 triple-encoder prompt embedding -> (context, pooled):
    context = [pad(concat(clip_l_h, clip_g_h)) ; t5_h] along the sequence,
    pooled = [l | g]. Without T5 (``t5_params`` None) the CLIP block is
    channel-padded to ``pad_to_dim`` and a zero
    [B, max_sequence_length, pad_to_dim] block takes T5's place, as diffusers
    does with no ``text_encoder_3``; without ``pad_to_dim`` the context is
    the CLIP block alone."""
    _, hid_l, pooled_l = clip_encode(clip_l, clip_l_cfg, tokenize(tokenizer, prompts, 77))
    _, hid_g, pooled_g = clip_encode(clip_g, clip_g_cfg, tokenize(tokenizer_2, prompts, 77))
    clip_h = torch.cat([hid_l, hid_g], dim=-1)
    pooled = torch.cat([pooled_l, pooled_g], dim=-1)
    if t5_params is not None:
        t5_h = t5_encode(t5_params, t5_cfg, tokenize(tokenizer_3, prompts,
                                                     max_sequence_length))
        clip_h = F.pad(clip_h, (0, t5_h.shape[-1] - clip_h.shape[-1]))
        return torch.cat([clip_h, t5_h], dim=1), pooled
    if pad_to_dim is not None:
        t5_h = clip_h.new_zeros(clip_h.shape[0], max_sequence_length, pad_to_dim)
        clip_h = F.pad(clip_h, (0, pad_to_dim - clip_h.shape[-1]))
        return torch.cat([clip_h, t5_h], dim=1), pooled
    return clip_h, pooled
