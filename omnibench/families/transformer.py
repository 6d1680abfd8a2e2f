"""The ``transformer`` family: the port's uniform pre-norm block (GQA
attention with RoPE, then a SwiGLU MLP or a softmax-routed MoE) stacked
``num_layers`` deep as ``blocks``.  A configuration that names no
``family`` takes this one.

Its weight layout is ``weights.py``, its plain reference
``reference/model.py`` and its work counts ``counts.py``; this module
hands each call on to them unchanged."""
from __future__ import annotations

from omnibench import counts, weights
from omnibench.reference import model as reference


def program_params(m: dict, seed: int, device) -> dict:
    return weights.program_params(m, seed, device)


def logits(m: dict, seed: int, seqs: list, rows: list, device, quant=None) -> list:
    return reference.logits(m, seed, seqs, rows, device, quant=quant)


def decode_step(m: dict, contexts, routed_experts=None) -> tuple:
    return counts.decode_step(m, contexts, routed_experts)


def prefill_chunk_flops(m: dict, start: int, valid: int) -> int:
    return counts.prefill_chunk_flops(m, start, valid)
