"""The port's monolithic baseline (``baselines/monolithic.py``) against
the JAX package's, on the same qwen_omni bundle weights (carried across)
and the same prompts.  Sampling is made greedy in both modules for this
test only, so the Thinker's text and the Talker's codec tokens must be
equal; the vocoder's waves come from different noise streams
(``torch.Generator`` vs ``jax.random``) and are held to shape and
finiteness.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import monolithic as jmono
from repro.configs.pipelines import build_qwen_omni as jbuild
from repro.models.dit import DiTConfig as JDiTConfig
from repro.models.dit import init_dit as jinit_dit
from repro_torch.baselines import monolithic as tmono
from repro_torch.configs.pipelines import build_qwen_omni as tbuild
from repro_torch.convert import params_from_numpy
from repro_torch.models.dit import DiTConfig as TDiTConfig

torch.set_num_threads(1)
KW = dict(max_batch=2, thinker_tokens=5, talker_tokens=9, dit_steps=2, seed=0)
VOC = dict(name="v", num_layers=2, d_model=128, num_heads=4, d_ff=256, in_dim=32,
           cond_dim=128, num_steps=2)


def _greedy_jax(logits, temperature, top_k, key):
    return jnp.argmax(logits, axis=-1).astype(jnp.int32)


def _greedy_torch(logits, temperature, top_k, gen=None):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _bundles():
    _, _, jb = jbuild(**KW)
    _, _, tb = tbuild(**KW, device="cpu")
    for name in ("thinker_params", "talker_params"):      # the JAX weights, carried across
        tb[name] = params_from_numpy(jax.tree.map(np.asarray, jb[name]))
    tb["codec_embed"] = np.asarray(jb["codec_embed"])
    jv = (JDiTConfig(**VOC), jinit_dit(JDiTConfig(**VOC), jax.random.PRNGKey(0)))
    tv = (TDiTConfig(**VOC), params_from_numpy(jax.tree.map(np.asarray, jv[1])))
    return jb, jv, tb, tv


def test_monolithic_greedy_tokens_match_jax(monkeypatch):
    monkeypatch.setattr(jmono, "sample_tokens", _greedy_jax)
    monkeypatch.setattr(tmono, "sample_tokens", _greedy_torch)
    jb, jv, tb, tv = _bundles()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 200, size=int(n)).astype(np.int32) for n in (6, 13, 22)]
    want = jmono.MonolithicQwenOmni(jb, jv, dit_steps=2).run(prompts)
    got = tmono.MonolithicQwenOmni(tb, tv, dit_steps=2).run(prompts)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["text"], w["text"])
        np.testing.assert_array_equal(g["codec"], w["codec"])
        assert g["text"].shape == (5,) and g["codec"].shape == (9,)
        assert g["wave"].shape == np.asarray(w["wave"]).shape == (1, 18, 32)
        assert np.isfinite(g["wave"]).all()
        assert 0 <= g["exec"] <= g["jct"]
        assert g["thinker_time"] + g["talker_time"] + g["vocoder_time"] == \
            pytest.approx(g["exec"])
    # sequential execution: each request's JCT holds the ones before it
    assert [r["jct"] for r in got] == sorted(r["jct"] for r in got)


def test_monolithic_samples_with_its_own_generator():
    """Sampled (not greedy) runs draw from the baseline's seeded generator:
    the same seed gives the same tokens, and every token is in the vocab."""
    _, _, tb, tv = _bundles()
    prompts = [np.arange(7, dtype=np.int32)]
    a = tmono.MonolithicQwenOmni(tb, tv, dit_steps=2, seed=3).run(prompts)[0]
    b = tmono.MonolithicQwenOmni(tb, tv, dit_steps=2, seed=3).run(prompts)[0]
    np.testing.assert_array_equal(a["text"], b["text"])
    np.testing.assert_array_equal(a["codec"], b["codec"])
    np.testing.assert_array_equal(a["wave"], b["wave"])
    assert a["text"].max() < tb["thinker_cfg"].vocab_size
    assert a["codec"].max() < tb["talker_cfg"].vocab_size
