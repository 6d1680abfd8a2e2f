"""The port's training substrate against the JAX package, on the CPU:

  - the optimizer: ``lr_at`` over warm-up and the cosine, one
    ``adamw_update`` on the same numpy trees (clipped and not), leaf order;
  - ``TokenStream`` bit for bit for each modality;
  - checkpoints written by either package loading in the other, f32 and
    bf16, bit for bit;
  - the launcher's ``main`` with ``--device cpu``, and its refusal to run
    without a card when no ``--device`` is given;
  - the attention backward: ``ref.flash_attention_bwd`` against
    ``jax.vjp`` of the JAX oracle, and ``ops.FlashAttention`` on CPU tensors
    against the grads of the JAX package's ``flash_attention_trainable``.

Tolerances: 1e-6 for the optimizer (f32 arithmetic in the same order),
2e-5 for the attention gradients (f32), as tests/test_kernels.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as tlaunch
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt

torch.set_num_threads(1)
F32 = dict(rtol=2e-5, atol=2e-5)
OPT = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree(rng, dtype=np.float32):
    """A nested dict with unsorted keys and leaves of several shapes."""
    return {"w": rng.standard_normal((4, 3)).astype(dtype),
            "b": {"z": rng.standard_normal(5).astype(dtype),
                  "a": rng.standard_normal((2, 2, 2)).astype(dtype)},
            "emb": rng.standard_normal((7, 4)).astype(dtype)}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 250, 999, 1000, 1500])
def test_lr_at_matches_jax(step):
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=1000)
    want = jopt.lr_at(jopt.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32))
    got = topt.lr_at(topt.AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(_np(got), _np(want), **OPT)


@pytest.mark.parametrize("grad_scale,clip", [(1.0, 1.0), (0.01, 1.0), (3.0, 100.0)])
@pytest.mark.parametrize("start_step", [0, 7])
def test_adamw_update_matches_jax(grad_scale, clip, start_step):
    """One step from a nonzero state; the first case clips (norm > 1), the
    second does not; lr 1e-2 so that every leaf moves."""
    rng = np.random.default_rng(start_step)
    params, grads = _tree(rng), _tree(rng)
    grads = {k: (jax.tree.map(lambda a: a * grad_scale, v)) for k, v in grads.items()}
    mu, nu = _tree(rng), jax.tree.map(np.abs, _tree(rng))
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=clip)
    jstate = {"mu": mu, "nu": nu, "step": jnp.asarray(start_step, jnp.int32)}
    jp, js, jm = jopt.adamw_update(jopt.AdamWConfig(**cfg), jax.tree.map(jnp.asarray, params),
                                   jax.tree.map(jnp.asarray, grads), jstate)
    tstate = {"mu": params_from_numpy(mu), "nu": params_from_numpy(nu),
              "step": torch.tensor(start_step, dtype=torch.int32)}
    tp, ts, tm = topt.adamw_update(topt.AdamWConfig(**cfg), params_from_numpy(params),
                                   params_from_numpy(grads), tstate)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == start_step + 1
    np.testing.assert_allclose(_np(tm["grad_norm"]), _np(jm["grad_norm"]), **OPT)
    np.testing.assert_allclose(_np(tm["lr"]), _np(jm["lr"]), **OPT)
    for got, want in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
        for g, w in zip(topt.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(_np(g), _np(w), **OPT)


def test_leaves_follow_jax_flatten_order():
    tree = _tree(np.random.default_rng(0))
    got = [t.shape for t in topt.leaves(params_from_numpy(tree))]
    assert got == [tuple(a.shape) for a in jax.tree.leaves(tree)]


def test_init_opt_state_types():
    params = params_from_numpy(_tree(np.random.default_rng(1), np.float32))
    params["w"] = params["w"].bfloat16()
    st = topt.init_opt_state(params)
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    assert all(m.dtype == torch.float32 and not m.any() for m in topt.leaves(st["mu"]))
    assert st["nu"]["w"].shape == params["w"].shape


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2_1_8b", "hubert_xlarge", "chameleon_34b"])
@pytest.mark.parametrize("seed", [0, 3])
def test_token_stream_bit_identical(arch, seed):
    tcfg = tbase.get_config(arch, smoke=True)
    jcfg = jbase.get_config(arch, smoke=True)
    ts = tdata.TokenStream(tcfg, 3, 24, seed=seed)
    js = jdata.TokenStream(jcfg, 3, 24, seed=seed)
    for _ in range(3):
        a, b = next(ts), next(js)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_trees(dtype):
    rng = np.random.default_rng(4)
    params = _tree(rng)
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), params)
    jopt_state = jopt.init_opt_state(jparams)
    jopt_state = {"mu": jax.tree.map(lambda a: a + 0.5, jopt_state["mu"]),
                  "nu": jax.tree.map(lambda a: a + 0.25, jopt_state["nu"]),
                  "step": jnp.asarray(11, jnp.int32)}
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return jparams, jopt_state, params_from_numpy(to_np(jparams)), \
        params_from_numpy(to_np(jopt_state))


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_cross_loads_bit_for_bit(tmp_path, dtype, writer):
    jparams, jstate, tparams, tstate = _ckpt_trees(getattr(jnp, dtype))
    path = os.path.join(tmp_path, f"{writer}.npz")
    if writer == "port":
        tckpt.save(path, tparams, tstate, step=11)
        p, o, step = jckpt.load(path, jparams, jstate)
        got, want = (p, o), (jparams, jstate)
        flat = lambda t: jax.tree.leaves(t)  # noqa: E731
    else:
        jckpt.save(path, jparams, jstate, step=11)
        p, o, step = tckpt.load(path, tparams, tstate)
        got, want = (p, o), (tparams, tstate)
        flat = topt.leaves
        assert p["w"].dtype == getattr(torch, dtype) and o["step"].dtype == torch.int32
    assert step == 11
    for g_tree, w_tree in zip(got, want):
        g_leaves, w_leaves = flat(g_tree), flat(w_tree)
        g_leaves, w_leaves = list(g_leaves), list(w_leaves)
        assert len(g_leaves) == len(w_leaves)
        for g, w in zip(g_leaves, w_leaves):
            np.testing.assert_array_equal(_bits(g), _bits(w))


def test_checkpoint_keys_match_jax(tmp_path):
    jparams, jstate, tparams, tstate = _ckpt_trees(jnp.bfloat16)
    tckpt.save(os.path.join(tmp_path, "t.npz"), tparams, tstate, step=2)
    jckpt.save(os.path.join(tmp_path, "j.npz"), jparams, jstate, step=2)
    t, j = np.load(os.path.join(tmp_path, "t.npz")), np.load(os.path.join(tmp_path, "j.npz"))
    assert sorted(t.files) == sorted(j.files)
    for key in j.files:
        assert t[key].dtype == j[key].dtype and t[key].shape == j[key].shape, key


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_on_cpu(tmp_path, capsys):
    path = os.path.join(tmp_path, "ck.npz")
    tlaunch.main(["--arch", "internlm2_1_8b", "--steps", "3", "--batch", "2", "--seq", "16",
                  "--device", "cpu", "--ckpt", path, "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "step     1  loss" in out and f"checkpointed -> {path}" in out
    cfg = jbase.get_config("internlm2_1_8b", smoke=True)
    from repro.models import transformer as jT
    template = jT.init_params(cfg, jax.random.PRNGKey(0))
    params, opt, step = jckpt.load(path, template, jopt.init_opt_state(template))
    assert step == 3 and int(opt["step"]) == 3
    assert all(np.isfinite(_np(x)).all() for x in jax.tree.leaves(params))


def test_launcher_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "internlm2_1_8b", "--steps", "1"])


# ---------------------------------------------------------------------------
# attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,nq,nkv,hd,causal,window", [
    (2, 40, 4, 2, 32, True, 0),       # causal, GQA 2
    (1, 48, 6, 2, 16, True, 9),       # a window shorter than the sequence, GQA 3
    (2, 33, 4, 4, 32, False, 0),      # non-causal (the encoder), ragged length
    (1, 40, 8, 1, 16, False, 12),     # a window without causality, GQA 8
])
def test_ref_flash_bwd_matches_jax_vjp(b, s, nq, nkv, hd, causal, window):
    rng = np.random.default_rng(s + nq)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, s, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd)))
    do = rng.standard_normal((b, s, nq, hd)).astype(np.float32)
    out, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention(
        q_, k_, v_, causal=causal, window=window), q, k, v)
    want = vjp(jnp.asarray(do))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = tref.flash_attention_bwd(*t, torch.from_numpy(np.array(out)), torch.from_numpy(do),
                                   causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


def test_flash_attention_function_matches_jax_trainable():
    """``ops.FlashAttention`` on CPU tensors (the wrappers' plain versions,
    forward and backward) against jax.grad through the JAX package's
    custom VJP over its Pallas kernel, interpreted; the shapes of
    tests/test_kernels.py::test_flash_attention_trainable_grads."""
    rng = np.random.default_rng(5)
    b, s, nq, nkv, hd = 1, 64, 4, 2, 32
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, s, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd)))

    def loss_jax(q_, k_, v_):
        return jnp.sum(jops.flash_attention_trainable(q_, k_, v_, True, 0) ** 2)

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(q, k, v)
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    loss = (tops.FlashAttention.apply(*t, True, 0) ** 2).sum()
    loss.backward()
    for g, w in zip(t, want):
        np.testing.assert_allclose(_np(g.grad), _np(w), **F32)


def test_cpu_attention_under_grad_differentiates_the_plain_version(monkeypatch):
    """On the CPU ``ops.flash_attention`` stays the plain version under
    autograd (the kernels' Function is the CUDA path), and its grads are
    the backward's plain version's."""
    monkeypatch.setattr(tops.FlashAttention, "apply",
                        lambda *a: pytest.fail("the CUDA path was taken on the CPU"))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(sh, generator=g).requires_grad_(True)
               for sh in ((1, 20, 4, 16), (1, 20, 2, 16), (1, 20, 2, 16)))
    o = tops.flash_attention(q, k, v, causal=True, window=6)
    do = torch.randn(o.shape, generator=g)
    o.backward(do)
    want = tref.flash_attention_bwd(q.detach(), k.detach(), v.detach(), o.detach(), do,
                                    causal=True, window=6)
    for t, w in zip((q, k, v), want):
        torch.testing.assert_close(t.grad, w, **F32)
