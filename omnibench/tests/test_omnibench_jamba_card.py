"""The ``jamba`` family on the card (``-m card``; skips without one): its
layers at published widths are drawn again the same, one at a time, as
the plain reference draws them after a run."""
import pytest
import torch

from omnibench import spec, weights

pytestmark = pytest.mark.card


def test_layers_are_drawn_again_the_same_on_the_card(card):
    fam = spec.family("jamba")
    m = spec.read_json(spec.ROOT / "omnibench/configs/jamba2_mini_ep2.json")["model"]
    m = dict(m, num_layers=6)          # Mamba and attention mixers, dense and MoE layers
    p = fam.program_params(m, 2**31 + 5, card)
    kinds = fam.kinds(m)
    for i in (3, 4):                   # Mamba + MoE, attention + dense MLP
        again = weights.draw(fam.layer_leaves(m, i), 2**31 + 5, i, card)
        for kind in kinds[i]:
            row = sum(kind in pair for pair in kinds[:i])
            for key, t in again[kind].items():
                got = p[kind][key]
                if isinstance(t, dict):
                    t, got = t["scale"], got["scale"]
                assert torch.equal(got[row], t), (i, kind, key)
        del again
