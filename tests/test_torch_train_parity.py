"""One training step of the port against the JAX package's
``make_train_step`` on the same weights (made by the JAX package and
carried across with ``params_from_numpy``) and the same ``TokenStream``
batch, for every architecture's smoke config:

  - f32: loss, ce, aux, grad_norm and lr, and every updated parameter and
    both moments of every leaf, at 2e-5 (MoE routing is f32 in both, so
    the same (token, expert) pairs are dropped);
  (tests/test_torch_train_remat.py holds a bf16 step and the
    ``remat`` settings).

On the CPU the port differentiates the plain attention and scans; the
card's kernels are held to these in chip_smoke.py and
tests/test_torch_cuda.py.
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


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_train_step_matches_jax_f32(arch):
    jax_out, port_out = _step_both(arch, "float32")
    _check_step(jax_out, port_out, TOL["float32"])
    if tbase.get_config(arch, smoke=True).is_moe:
        assert float(port_out[2]["aux"]) > 0
