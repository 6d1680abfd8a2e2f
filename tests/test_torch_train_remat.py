"""The port's training step beyond the f32 parity of
tests/test_torch_train_parity.py:

  - bf16, one dense architecture: one step against the JAX package's
    ``make_train_step`` on the same weights and batch, at 2e-2;
  - the three ``remat`` settings (False, True, "dots") give the same
    loss and gradients (recompute changes what is kept, not the values);
  - a stacked leaf's gradient is one tensor of the stack's shape.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import transformer as jT
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.train.data import TokenStream

torch.set_num_threads(1)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _setup(arch, dtype, batch=2, seq=16, seed=0):
    cfg = tbase.get_config(arch, smoke=True).replace(dtype=dtype)
    jcfg = jbase.ModelConfig(**dataclasses.asdict(cfg))
    jparams = jT.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    b = next(TokenStream(cfg, batch, seq, seed=seed))
    return cfg, jcfg, jparams, tparams, b


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _step_both(arch, dtype):
    cfg, jcfg, jparams, tparams, b = _setup(arch, dtype)
    opt = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
    jp, js, jm = jax.jit(jstep.make_train_step(jcfg, jopt.AdamWConfig(**opt)))(
        jparams, jopt.init_opt_state(jparams), jnp.asarray(b["inputs"]),
        jnp.asarray(b["labels"]))
    tp, ts, tm = tstep.make_train_step(cfg, topt.AdamWConfig(**opt))(
        tparams, topt.init_opt_state(tparams), torch.from_numpy(b["inputs"]),
        torch.from_numpy(b["labels"]))
    return (jp, js, jm), (tp, ts, tm)


def _check_step(jax_out, port_out, tol):
    (jp, js, jm), (tp, ts, tm) = jax_out, port_out
    assert set(tm) == {"loss", "ce", "aux", "grad_norm", "lr"} <= set(jm) | {"loss"}
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        _close(tm[key], jm[key], tol)
    assert int(ts["step"]) == int(js["step"]) == 1
    for got, want in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
        g_leaves, w_leaves = list(topt.leaves(got)), jax.tree.leaves(want)
        assert len(g_leaves) == len(w_leaves)
        for g, w in zip(g_leaves, w_leaves):
            assert tuple(g.shape) == tuple(w.shape)
            _close(g, w, tol)


def test_train_step_matches_jax_bf16():
    jax_out, port_out = _step_both("internlm2_1_8b", "bfloat16")
    _check_step(jax_out, port_out, TOL["bfloat16"])
    tp = port_out[0]
    assert all(p.dtype == torch.bfloat16 for k, p in tp["blocks"]["attn"].items())


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x7b", "hubert_xlarge",
                                  "falcon_mamba_7b", "zamba2_2_7b"])
def test_remat_settings_give_the_same_grads(arch):
    """Recompute changes what is kept for the backward, never the values:
    per block, per Mamba layer, per hybrid group, and with the products'
    outputs kept ("dots")."""
    cfg, _, _, tparams, b = _setup(arch, "float32", seq=12, seed=1)
    x, y = torch.from_numpy(b["inputs"]), torch.from_numpy(b["labels"])
    runs = [tstep.loss_and_grads(cfg, tparams, x, y, remat=r) for r in (False, True, "dots")]
    for loss, parts, grads in runs[1:]:
        torch.testing.assert_close(loss, runs[0][0], rtol=0, atol=0)
        for g, w in zip(topt.leaves(grads), topt.leaves(runs[0][2])):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


def test_stacked_leaves_get_one_gradient_per_stack():
    """Each stacked leaf's gradient is one tensor of the stack's shape
    (``unbind``'s backward stacks the layers once)."""
    cfg, _, _, tparams, b = _setup("internlm2_1_8b", "float32", seq=8)
    _, _, grads = tstep.loss_and_grads(cfg, tparams, torch.from_numpy(b["inputs"]),
                                       torch.from_numpy(b["labels"]))
    wq = grads["blocks"]["attn"]["wq"]
    assert wq.shape == tparams["blocks"]["attn"]["wq"].shape
    assert all(bool(wq[i].abs().sum() > 0) for i in range(cfg.num_layers))
