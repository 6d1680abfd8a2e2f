"""The port's dry-run against the JAX package's at full width on the 16x16
mesh of 256 devices.

The JAX side is ``repro.launch.dryrun``: the step lowered and compiled by
XLA for forced host devices (imported in a subprocess, since it forces 512
of them), on a mesh of Auto axes (``jax.make_mesh``'s Explicit axes, jax >=
0.7, reject the embedding's gather), its collectives counted by
``collective_bytes`` from the partitioned HLO, loop bodies multiplied by
their trip counts.  The port's side is ``repro_torch.launch.dryrun.run_one``
on meta DTensors under a fake process group of 256 ranks.

  - XLA's loop correction is what the port's eager count must equal: the
    layer loop's body's collectives times the layer count, plus the rest
    (InternLM2-1.8B's prefill: one loop, 24 trips);
  - twelve combos: the port's collective bytes a device lie within
    ``COLLECTIVE_BAND`` of XLA's loop-corrected total, and no op was
    placed by DTensor's own strategy (``dtensor_ops``), resharded or run
    replicated.

As a script it prints the port-against-XLA table for every arch x shape
(``--all``), and with ``--against DIR`` holds the port's bytes to the
records that ``python -m repro_torch.launch.dryrun --all --out DIR`` wrote
on another machine (another torch version), record for record:

  PYTHONPATH=src python tests/test_torch_dryrun_xla.py --all [--against DIR]
"""
import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor

import pytest
from test_torch_dryrun import COLLECTIVE_BAND

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the combos that lay outside ``COLLECTIVE_BAND`` before the placement
#: rules of ``launch/dryrun.py`` followed GSPMD at full width, and four
#: that lay inside it
COMBOS = ("qwen2_5_14b:prefill_32k", "qwen1_5_4b:prefill_32k", "qwen2_5_14b:train_4k",
          "chameleon_34b:decode_32k", "mixtral_8x7b:prefill_32k", "hubert_xlarge:train_4k",
          "zamba2_2_7b:decode_32k", "falcon_mamba_7b:decode_32k", "internlm2_1_8b:prefill_32k",
          "qwen3_moe_30b_a3b:decode_32k", "starcoder2_7b:prefill_32k", "zamba2_2_7b:prefill_32k")

_JAX_FULL = r"""
import json, sys
import jax
from repro.configs.base import INPUT_SHAPES, get_config, variant_for_shape
from repro.launch import dryrun as D
from repro.sharding.context import DistContext, distribution
mesh = jax.make_mesh((16, 16), ("data", "model"), (jax.sharding.AxisType.Auto,) * 2,
                     devices=jax.devices()[:256])


def loops(hlo):
    # [trip count, the body's own collective bytes] of every while loop
    comps, cur = {}, None
    for line in hlo.splitlines():
        m = D._COMP_RE.match(line.strip())
        if m:
            cur = m.group(2)
            comps[cur] = []
        elif cur is not None:
            comps[cur].append(line)
    out = []
    for lines in comps.values():
        for line in lines:
            w = D._WHILE_RE.search(line)
            if w:
                cond, body = w.group(1), w.group(2)
                trips = max([int(c) for l in comps.get(cond, ())
                             for c in D._CONST_RE.findall(l)] or [1])
                nb = 0
                for l in comps.get(body, ()):
                    for c in D._COLL_RE.finditer(l):
                        n = D._DTYPE_BYTES.get(c.group(1), 4)
                        for d in c.group(2).split(","):
                            n *= int(d) if d else 1
                        nb += n
                out.append([trips, nb])
    return out


out = {}
for combo in sys.argv[1].split(","):
    arch, shape = combo.split(":")
    cfg = variant_for_shape(get_config(arch), INPUT_SHAPES[shape])
    fn, args = D.build_step(cfg, INPUT_SHAPES[shape], mesh)
    with distribution(DistContext(mesh=mesh, data_axes=("data",))), mesh:
        hlo = jax.jit(fn).lower(*args).compile().as_text()
    out[combo] = dict(D.collective_bytes(hlo), loops=loops(hlo))
print("XLA" + json.dumps({"jax": jax.__version__, "combos": out}))
"""


def _port(combo: str):
    """``run_one`` of one combo at 16x16 (in a worker process: each its own
    fake world)."""
    from repro_torch.launch import dryrun as D
    arch, shape = combo.split(":")
    rec = D.run_one(arch, shape, False, "")
    rec.pop("traceback", None)
    return combo, rec


def measure(combos, timeout: int = 300):
    """({combo: port record}, {"jax": version, "combos": {combo: XLA's
    collective_bytes and loops}}): XLA's side compiled in a subprocess
    while the port's combos run in four spawned processes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    with tempfile.TemporaryFile("w+") as out, tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen([sys.executable, "-c", _JAX_FULL, ",".join(combos)], env=env,
                                stdout=out, stderr=err, text=True)
        try:
            with ProcessPoolExecutor(4, mp_context=mp.get_context("spawn")) as ex:
                port = dict(ex.map(_port, combos))
            proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.seek(0)
        err.seek(0)
        line = [ln for ln in out.read().splitlines() if ln.startswith("XLA")]
        assert line, err.read()[-4000:]
    return port, json.loads(line[0][3:])


@pytest.fixture(scope="module")
def both():
    return measure(COMBOS)


def test_xlas_loop_correction_is_the_layer_body_times_the_layers(both):
    from repro_torch.configs.base import get_config
    xla = both[1]["combos"]["internlm2_1_8b:prefill_32k"]
    (trips, body), = [lp for lp in xla["loops"] if lp[1]]
    assert trips == get_config("internlm2_1_8b").num_layers
    assert xla["total"] == xla["uncorrected_total"] + body * (trips - 1)


@pytest.mark.parametrize("combo", COMBOS)
def test_full_width_collective_bytes_lie_in_a_band_of_xlas(combo, both):
    """The port's collective bytes a device lie within ``COLLECTIVE_BAND``
    of XLA's at 16x16, every op placed by the port's own rules."""
    rec, xla = both[0][combo], both[1]["combos"][combo]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["dtensor_ops"] == {} and rec["resharded_ops"] == {}
    assert rec["replicated_ops"] == {}
    lo, hi = COLLECTIVE_BAND
    ratio = rec["collective_bytes"]["total"] / xla["total"]
    assert lo <= ratio <= hi, (ratio, rec["collective_bytes"], xla)


def _table(port, xla, against=""):
    import torch
    print(f"torch {torch.__version__}, jax {xla['jax']}; collective GB a device, 16x16")
    head = "| arch x shape | port | XLA | port / XLA | dtensor_ops |"
    print(head + (" other machine | equal |" if against else ""))
    print("|---" * (5 + 2 * bool(against)) + "|")
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
    same = True
    for combo, rec in port.items():
        if rec["status"] != "ok":
            print(f"| {combo} | {rec['status']}: {rec.get('error', rec.get('reason'))} |")
            continue
        got, want = rec["collective_bytes"], xla["combos"][combo]
        row = (f"| {combo} | {got.get('total', 0) / 1e9:.6g} | {want['total'] / 1e9:.6g} | "
               f"{got.get('total', 0) / want['total']:.3f} | {rec['dtensor_ops'] or ''} |")
        if against:
            arch, shape = combo.split(":")
            with open(os.path.join(against, f"{arch}__{shape}__16_16.json")) as f:
                other = json.load(f).get("collective_bytes", {})
            equal = all(other.get(k, 0) == got.get(k, 0) for k in (*kinds, "total"))
            same &= equal
            row += f" {other.get('total', 0) / 1e9:.6g} | {'yes' if equal else 'NO'} |"
        print(row, flush=True)
    if against:
        print("every record equal" if same else "records differ")
    return same


def main(argv=None) -> int:
    from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config, shape_skips
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true", help="every arch x shape")
    ap.add_argument("--against", default="",
                    help="records of `python -m repro_torch.launch.dryrun --all --out DIR`")
    args = ap.parse_args(argv)
    combos = [f"{a}:{s}" for a in ARCH_IDS for s in INPUT_SHAPES
              if not shape_skips(get_config(a), INPUT_SHAPES[s])] if args.all else list(COMBOS)
    port, xla = measure(combos, timeout=3600)
    return 0 if _table(port, xla, args.against) else 1


if __name__ == "__main__":
    sys.exit(main())
