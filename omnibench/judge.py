"""How ``correct`` is decided: the served tokens against the plain reference.

Once the window has closed and the program's state is freed, a sample of
the requests the run finished, drawn from the seed and holding the one
with the most served tokens, goes through the plain reference of the
configuration's family (``families/<family>.py: logits``; the default
``transformer``'s is ``reference/model.py``): each prompt with its
served tokens, once, in f32.  At every served position the reference's
best logit is compared with its logit of the token the program served;
the widest gap over the sample is held to the cell's limit
(``limits/<workload>.json``).  The
program decodes greedily, so a sound run serves, at every position, a
token within its own rounding of the reference's best.

Besides, exact comparisons: every finished request served as many tokens
as it asked for, and (a MoE) no (token, expert) pair was dropped, as the
configuration states its routing dropless.

The control (``--calibrate``) reads the same sample through the
reference in fp8: the gap of the token the fp8 forward puts first.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from omnibench import spec

#: the sample holds the longest request and others until this many served tokens
SAMPLE_TOKENS = 600
SAMPLE_MAX = 12


@dataclass
class Verdict:
    correct: bool
    compared: dict            # name -> {"value", "limit"}


def sample(records: list, seed: int) -> list:
    """Finished requests, counted ones first: the one with the most served
    tokens and then others in an order drawn from the seed."""
    done = [r for r in records if r.done and not r.failed and r.served()]
    pool = [r for r in done if r.counted] or done
    if not pool:
        return []
    longest = max(pool, key=lambda r: (len(r.served()), -r.req.req_id))
    rest = [r for r in pool if r is not longest]
    order = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), 7])).permutation(
        len(rest))
    picked, total = [longest], len(longest.served())
    for i in order:
        if total >= SAMPLE_TOKENS or len(picked) >= SAMPLE_MAX:
            break
        picked.append(rest[i])
        total += len(rest[i].served())
    return picked


def gaps(family: str, model: dict, seed: int, records: list, device,
         control: bool = False) -> dict:
    """Per sampled request, the gap at each served position of the served
    token (``program``) and, with ``control``, of the fp8 forward's first
    choice, both in the logits of ``family``'s f32 reference."""
    ref = spec.family(family)
    seqs, rows, served = [], [], []
    for r in records:
        toks = r.served()
        prompt = [int(t) for t in np.asarray(r.req.inputs["tokens"]).ravel()]
        p = len(prompt)
        seqs.append(prompt + toks[:-1])
        rows.append(list(range(p - 1, p - 1 + len(toks))))
        served.append(toks)
    out = {"program": [], "control": []}
    full = ref.logits(model, seed, seqs, rows, device)
    low = ref.logits(model, seed, seqs, rows, device, quant="fp8") if control else None
    for j, lg in enumerate(full):
        best = lg.max(dim=-1).values
        idx = torch.as_tensor(served[j], dtype=torch.long, device=lg.device)
        out["program"].append((best - lg.gather(1, idx[:, None])[:, 0]).cpu().numpy())
        if low is not None:
            pick = low[j].argmax(dim=-1)
            out["control"].append((best - lg.gather(1, pick[:, None])[:, 0]).cpu().numpy())
    return out


def statistics(per_req: list) -> dict:
    """The gap statistics a limits file may name: ``logit_gap``, the widest
    gap over the sample, and ``logit_gap_mean``, the mean over every
    served position of the sample."""
    if not per_req:
        return {"logit_gap": math.inf, "logit_gap_mean": math.inf}
    allg = np.concatenate(per_req)
    return {"logit_gap": float(allg.max()), "logit_gap_mean": float(allg.mean())}


def judge(measured, seed: int, device) -> Verdict:
    """Compares the statistics the cell's limits file names, and the exact
    counts, each against its limit."""
    limits = measured.cell.limits
    picked = sample(measured.records, seed)
    per_req = (gaps(measured.cell.family, measured.model, seed, picked, device)["program"]
               if picked else [])
    stats = statistics(per_req)
    compared = {k: {"value": stats[k], "limit": limits[k]} for k in stats if k in limits}
    finished = [r for r in measured.counted if r.done and not r.failed]
    short = sum(1 for r in finished if len(r.served()) != r.out_len)
    compared["short_answers"] = {"value": short, "limit": 0}
    if measured.moe_drops is not None:
        compared["moe_dropped_pairs"] = {"value": measured.moe_drops, "limit": 0}
    correct = bool(picked) and all(c["value"] <= c["limit"] for c in compared.values())
    for c in compared.values():
        if not math.isfinite(c["value"]):
            c["value"] = None
    return Verdict(correct, compared)
