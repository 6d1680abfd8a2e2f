"""Token sampling for AR stages: greedy / temperature / top-k."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 32
    temperature: float = 0.0           # 0 => greedy
    top_k: int = 0                     # 0 => no top-k filter
    eos_token: int = -1                # -1 => never stops early


def sample_tokens(logits: torch.Tensor, temperature: float, top_k: int,
                  gen: torch.Generator | None = None) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32, sampled on logits' device.

    Greedy takes the first maximal index.  Otherwise the logits are
    divided by ``temperature``, cut to the ``top_k`` largest (ties with
    the k-th kept), and one token per row is drawn from ``gen``, which
    must live on the logits' device.
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
