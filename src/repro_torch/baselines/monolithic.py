"""Monolithic baseline: the HF-Transformers-style execution the paper
compares against (§4.1 "Baseline Systems").

One request at a time, stages co-located and executed sequentially via
end-to-end generate() calls: no continuous batching, no chunked prefill,
no paged KV, no streaming overlap.  Uses the same model weights as the
disaggregated pipeline (the ``build_qwen_omni`` bundle) so the comparison
is apples-to-apples.  Its prompt and recompute passes go through the
flash kernel on the card (causal), its vocoder's through the same kernel
(non-causal); its decode attends over a dense cache (plain PyTorch, as
in the JAX package).
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from repro_torch.engine.sampling import sample_tokens
from repro_torch.models import transformer as T
from repro_torch.models.dit import sample as dit_sample


class MonolithicQwenOmni:
    """Sequential Thinker -> Talker -> Vocoder, one request at a time.
    ``vocoder`` is the DiT's (cfg, params); the bundle's weights fix the
    device, and ``seed`` seeds the sampling and noise generator there."""

    def __init__(self, bundle: dict, vocoder, max_seq: int = 256,
                 dit_steps: int = 8, seed: int = 0):
        self.b = bundle
        self.vocoder = vocoder          # (cfg, params) for the DiT vocoder
        self.max_seq = max_seq
        self.dit_steps = dit_steps
        self.device = bundle["thinker_params"]["lm_head"].device
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _generate(self, cfg, params, prompt_embeds, n_new, extra_embeds=None):
        """Naive generate(): full prefill then one-by-one decode, batch=1."""
        cfg2 = cfg.replace(modality="audio_frames")
        emb = torch.as_tensor(prompt_embeds, device=self.device)[None]
        logits, cache = T.forward_prefill(cfg2, params, emb, self.max_seq)
        pos = prompt_embeds.shape[0]
        toks = []
        tok = int(sample_tokens(logits[:, -1], 0.8, 20, self._gen)[0])
        toks.append(tok)
        for i in range(n_new - 1):
            e = params["embed"][torch.tensor([[tok]], device=self.device)]
            if extra_embeds is not None:
                j = min(i, extra_embeds.shape[0] - 1)
                e = e + torch.as_tensor(extra_embeds[j], device=self.device)[None, None]
            logits, cache = T.forward_decode(cfg2, params, cache, e,
                                             torch.tensor([pos], device=self.device))
            pos += 1
            tok = int(sample_tokens(logits[:, 0], 0.8, 20, self._gen)[0])
            toks.append(tok)
        return np.array(toks, np.int32)

    def _thinker_hidden(self, cfg, params, tokens):
        # baseline recomputes hidden states with a second full forward
        # (the transformers implementation extracts them from generate())
        emb = params["embed"][torch.as_tensor(tokens, dtype=torch.long,
                                              device=self.device)][None]
        T.forward_full(cfg.replace(modality="audio_frames"), params, emb)
        h = emb  # tiny proxy: hidden ~= embeddings for the baseline path
        return h[0].cpu().numpy()

    @torch.no_grad()
    def run(self, requests: List[np.ndarray]) -> List[dict]:
        """requests: list of prompt token arrays. Returns per-request
        results with timings (sequential JCTs accumulate queueing delay,
        as in offline HF inference)."""
        b = self.b
        results = []
        t_start = time.perf_counter()
        for toks in requests:
            t0 = time.perf_counter()
            idx = torch.as_tensor(np.asarray(toks), dtype=torch.long, device=self.device)
            pe = b["thinker_params"]["embed"][idx].cpu().numpy()
            text = self._generate(b["thinker_cfg"], b["thinker_params"], pe,
                                  b["thinker_tokens"])
            t_think = time.perf_counter()
            th = self._thinker_hidden(b["thinker_cfg"], b["thinker_params"], text)
            codec = self._generate(b["talker_cfg"], b["talker_params"], th,
                                   b["talker_tokens"], extra_embeds=th)
            t_talk = time.perf_counter()
            cond = torch.as_tensor(b["codec_embed"][codec], device=self.device)[None]
            vcfg, vparams = self.vocoder
            wav = dit_sample(vcfg, vparams, cond, cond.shape[1] * 2, self._gen,
                             num_steps=self.dit_steps).cpu().numpy()
            t_end = time.perf_counter()
            results.append({
                "text": text, "codec": codec, "wave": wav,
                "jct": t_end - t_start,      # from batch submission
                "exec": t_end - t0,
                "thinker_time": t_think - t0,
                "talker_time": t_talk - t_think,
                "vocoder_time": t_end - t_talk,
            })
        return results
