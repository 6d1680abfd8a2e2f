"""The benchmark's description, ``BENCHMARK.json``, and the files it names.

Everything that belongs to one configuration, traffic mix, metric or cell
sits in a file of its own, found by its name:

  configs/<config>.json      sizes and serving settings (``file`` in BENCHMARK.json)
  families/<family>.py       the weight layout, plain reference and work counts of
                             the architecture family a configuration names
                             (``transformer`` where it names none)
  graphs/<graph>.py          builds the stage graph a configuration names
  traffic/<traffic>.json     parameters of the one traffic generator
  metrics/<metric>.py        the reader of one metric: ``read(ctx) -> float | None``
  limits/<workload>.json     the limits of the numbers ``correct`` compares

A later change adds a cell, a configuration or a metric by adding files
and entries; no file here needs an edit.
"""
from __future__ import annotations

import functools
import importlib.util
import json
import pathlib
import re
from dataclasses import dataclass
from types import ModuleType

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES_END_TO_END = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
DEFAULT_FAMILY = "transformer"


class SpecError(ValueError):
    """BENCHMARK.json, or a file it names, breaks the benchmark's rules."""


def load_benchmark(path: pathlib.Path | None = None) -> dict:
    path = path or ROOT / "BENCHMARK.json"
    with open(path) as f:
        return json.load(f)


def _one_line(text: str, what: str) -> None:
    if not (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text):
        raise SpecError(f"{what}: 1 to 200 characters on one line, no tab")


def validate(bench: dict) -> None:
    """The rules on names, units and cross references that a run relies on."""
    for key in ("command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"):
        if key not in bench:
            raise SpecError(f"BENCHMARK.json has no {key!r}")
    names = []
    for c in bench["configs"]:
        names.append(c["name"])
        for k in c.get("reduced", []):
            if not NAME_RE.fullmatch(k):
                raise SpecError(f"reduced key {k!r} is not a name")
        _one_line(c["source"], f"source of {c['name']}")
        _one_line(c["why"], f"why of {c['name']}")
    cfg_names = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        names.append(w["name"])
        for k in ("config", "traffic"):
            if not NAME_RE.fullmatch(w[k]):
                raise SpecError(f"{w['name']}: {k} {w[k]!r} is not a name")
        if w["config"] not in cfg_names:
            raise SpecError(f"{w['name']}: no configuration {w['config']!r}")
        if w["chips"] not in (1, 4):
            raise SpecError(f"{w['name']}: chips must be 1 or 4")
        _one_line(w["why"], f"why of {w['name']}")
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        if not UNIT_RE.fullmatch(m["unit"]):
            raise SpecError(f"{m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            raise SpecError(f"{m['name']}: better must be lower or higher")
        for cell in m.get("workloads", []):
            if cell not in cells:
                raise SpecError(f"{m['name']}: no workload {cell!r}")
    for m in bench["end_to_end"]:
        if m["source"] not in SOURCES_END_TO_END:
            raise SpecError(f"{m['name']}: end-to-end source {m['source']!r}")
        if not 0.01 <= m["bound"] <= 0.25:
            raise SpecError(f"{m['name']}: bound {m['bound']} outside [0.01, 0.25]")
    for m in bench["per_layer"]:
        if m["source"] not in SOURCES:
            raise SpecError(f"{m['name']}: source {m['source']!r}")
        if m["moves"] not in e2e:
            raise SpecError(f"{m['name']}: moves unknown metric {m['moves']!r}")
        _one_line(m["layer"], f"layer of {m['name']}")
    for n in names:
        if not NAME_RE.fullmatch(n):
            raise SpecError(f"{n!r} is not a name")
    if len(names) != len(set(names)):
        raise SpecError("two entries share a name")


@dataclass(frozen=True)
class Cell:
    """One workload of BENCHMARK.json with what it names, read from disk."""
    name: str
    chips: int
    config_name: str
    config: dict            # configs/<config>.json
    family: str             # families/<family>.py
    traffic_name: str
    traffic: dict           # traffic/<traffic>.json
    end_to_end: tuple       # metric entries this cell reports with --trace 0
    per_layer: tuple        # metric entries this cell reports with --trace 1
    limits: dict            # limits/<workload>.json


def _reports(metric: dict, cell: str, e2e_of_cell: set | None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_of_cell is None:                     # an end-to-end metric
        return True
    return metric["moves"] in e2e_of_cell


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    """The workload ``name`` with its configuration, traffic, metrics and limits."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {sorted(by_name)})")
    w = by_name[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = tuple(m for m in bench["end_to_end"] if _reports(m, name, None))
    e2e_names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"] if _reports(m, name, e2e_names))
    limits_path = HERE / "limits" / f"{name}.json"
    if not limits_path.exists():
        raise SpecError(f"{name}: no limits file {limits_path.relative_to(root)}")
    config = read_json(root / cfg_entry["file"])
    fam = config.get("family", DEFAULT_FAMILY)
    if not (isinstance(fam, str) and NAME_RE.fullmatch(fam)):
        raise SpecError(f"{name}: family {fam!r} is not a name")
    if not (HERE / "families" / f"{fam}.py").exists():
        raise SpecError(f"{name}: no family file omnibench/families/{fam}.py")
    return Cell(name=name, chips=w["chips"], config_name=w["config"],
                config=config, family=fam,
                traffic_name=w["traffic"],
                traffic=read_json(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer,
                limits=read_json(limits_path))


def load_module(kind: str, name: str) -> ModuleType:
    """``omnibench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise SpecError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"omnibench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def family(name: str) -> ModuleType:
    """``families/<name>.py``, loaded once: ``program_params``, ``logits``,
    ``decode_step`` and ``prefill_chunk_flops`` of that architecture."""
    return load_module("families", name)
