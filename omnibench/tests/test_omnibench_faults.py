"""Whole runs on the CPU at small sizes, the card's look skipped: a sound
run comes out correct, and each fault planted in the timed path makes
``correct`` false."""
import pytest
import torch

import cpu_cell
from repro_torch.engine import ar_engine
from repro_torch.engine.runner import PagedRunner, StateRunner

MAMBA = cpu_cell.MAMBA_CELL["name"]


@pytest.mark.parametrize("workload", ["pd_internlm2.chat_backlog", MAMBA])
@pytest.mark.parametrize("loop", ["closed", "open"])
def test_a_sound_run_is_correct(loop, workload):
    res = cpu_cell.run(workload, loop=loop)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0


def _altered_token(monkeypatch):
    orig = ar_engine.sample_tokens

    def sample(logits, *a, **k):
        return (orig(logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(ar_engine, "sample_tokens", sample)


def _state_unchanged(monkeypatch):
    orig = PagedRunner.decode

    def decode(self, *a, **k):
        self._write_kv = lambda *x: None
        try:
            return orig(self, *a, **k)
        finally:
            del self._write_kv

    monkeypatch.setattr(PagedRunner, "decode", decode)


def _recurrent_state_unchanged(monkeypatch):
    """Each decode step reads the state and writes back what it read."""
    orig = StateRunner.decode

    def decode(self, *a, **k):
        kept = {name: c.clone() for name, c in self.cache.items()}
        try:
            return orig(self, *a, **k)
        finally:
            for name, c in self.cache.items():
                c.copy_(kept[name])

    monkeypatch.setattr(StateRunner, "decode", decode)


def _recurrent_state_dropped(monkeypatch):
    """Each decode step starts from a zero state."""
    orig = StateRunner.decode

    def decode(self, *a, **k):
        for c in self.cache.values():
            c.zero_()
        return orig(self, *a, **k)

    monkeypatch.setattr(StateRunner, "decode", decode)


def _half_batch(runner):
    def plant(monkeypatch):
        orig = runner.decode

        def decode(self, embeds, tables, positions, active):
            logits, hidden = orig(self, embeds, tables, positions, active)
            rows = torch.nonzero(torch.as_tensor(active))[:, 0]
            if len(rows) > 1:
                kept, dropped = rows[:len(rows) // 2], rows[len(rows) // 2:]
                logits = logits.clone()
                logits[dropped] = logits[kept].mean(0)
            return logits, hidden

        monkeypatch.setattr(runner, "decode", decode)

    plant.__name__ = f"_half_batch_{runner.__name__}"
    return plant


def _no_exchange(monkeypatch):
    monkeypatch.setattr(PagedRunner, "inject_kv", lambda self, *a, **k: None)


@pytest.mark.parametrize("fault,workload", [
    (_altered_token, "moe_qwen3.decode_closed"),
    (_altered_token, "pd_internlm2.chat_backlog"),
    (_altered_token, MAMBA),
    (_state_unchanged, "moe_qwen3.decode_closed"),
    (_state_unchanged, "pd_internlm2.chat_backlog"),
    (_recurrent_state_unchanged, MAMBA),
    (_recurrent_state_dropped, MAMBA),
    (_half_batch(PagedRunner), "moe_qwen3.decode_closed"),
    (_half_batch(PagedRunner), "pd_internlm2.chat_backlog"),
    (_half_batch(StateRunner), MAMBA),
    (_no_exchange, "pd_internlm2.chat_backlog"),
], ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_a_fault_is_not_correct(monkeypatch, fault, workload):
    fault(monkeypatch)
    res = cpu_cell.run(workload)
    assert not res["correct"], res["compared"]
