"""Serving: prefill + KV-cache decode steps (batched requests).

The port of ``repro/training/serve_step.py``.  Greedy sampling is
``argmax``; temperature sampling draws from a ``torch.Generator`` (one per
request in the engine) — ``jax.random`` key streams cannot be reproduced,
so cross-framework tests compare greedy tokens only.  Encoder-decoder
memory and vision patches come with those archs (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Params, forward, init_caches


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache_len: int, lengths: Optional[torch.Tensor] = None,
            attn_backend: Optional[str] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Process the prompt into fresh caches.  Returns (last_logits, caches).

    ``lengths``: (B,) true prompt lengths for a LEFT-padded mixed batch;
    pads are masked out of attention and the KV cache, and the returned
    last-position logits are each row's true final-token logits.  Decode
    positions must then start at ``lengths[b]``.
    """
    caches = init_caches(cfg, tokens.shape[0], cache_len, tokens.device)
    logits, caches = forward(params, cfg, tokens, caches=caches,
                             last_only=True, lengths=lengths,
                             attn_backend=attn_backend)
    return logits[:, -1], caches


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, caches: Params, *,
                attn_backend: Optional[str] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One token for every sequence.  tokens/positions (B, 1); the caches
    are updated in place and returned."""
    logits, caches = forward(params, cfg, tokens, positions=positions,
                             caches=caches, attn_backend=attn_backend)
    return logits[:, -1], caches


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int32."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    lf = logits.float() / temperature
    if top_k:
        kth = torch.topk(lf, top_k, dim=-1).values[..., -1:]
        lf = lf.masked_fill(lf < kth, -1e30)
    probs = torch.softmax(lf, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def sample_per_slot(logits: torch.Tensor,
                    generators: Sequence[Optional[torch.Generator]],
                    temperature: float = 0.0, top_k: int = 0
                    ) -> torch.Tensor:
    """logits (B, V), one generator per row (None for a row whose token is
    ignored: it gets the argmax).  Continuous-batching slots each belong to
    a different request, so rows must not share a random stream."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    return torch.cat([
        sample(logits[i:i + 1], g, temperature, top_k) if g is not None
        else logits[i:i + 1].argmax(dim=-1).to(torch.int32)
        for i, g in enumerate(generators)])


def generate(params: Params, cfg: ModelConfig, prompt: torch.Tensor, *,
             max_new_tokens: int, cache_len: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0,
             attn_backend: Optional[str] = None) -> torch.Tensor:
    """Greedy/temperature generation loop: prompt (B, S) -> (B, new)."""
    b, s = prompt.shape
    last, caches = prefill(params, cfg, prompt, cache_len=cache_len,
                           attn_backend=attn_backend)
    tok = sample(last, generator, temperature)
    out = [tok]
    for i in range(1, max_new_tokens):
        pos = torch.full((b, 1), s + i - 1, dtype=torch.int32,
                         device=prompt.device)
        logits, caches = decode_step(params, cfg, tok[:, None], pos, caches,
                                     attn_backend=attn_backend)
        tok = sample(logits, generator, temperature)
        out.append(tok)
    return torch.stack(out, dim=1)
