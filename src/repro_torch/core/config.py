"""Typed serving configuration (the ``ServeConfig`` API).

One frozen dataclass replaces the kwargs bag that used to sprawl across
``Orchestrator.__init__`` (``backend``, ``queue_capacity``,
``recv_timeout``, ``replicas``, ``routing``, ``engine_factories``,
``warm_seed``, ``isolation``) and the launcher's flag soup:

  - :class:`ServeConfig` — backend-wide knobs plus a per-stage mapping of
    :class:`StageConfig`; validated eagerly in ``__post_init__`` so a bad
    spec fails at construction, not mid-serve.
  - :class:`StageConfig` — replicas, routing override, thread/process
    isolation, prefix-cache override, and the stage's engine sources: an
    in-process ``engine_factory`` closure and/or a picklable
    :class:`EngineSpec` that a spawned process replica rebuilds from.
  - :class:`EngineSpec` — ``"module:callable"`` + kwargs, the only form
    of engine construction that can cross a spawn boundary (closures
    over initialized params cannot be pickled; deterministic builders
    rebuild identical params from the same seed).

``ServeConfig.from_args`` is the one place argparse flags become a
config; ``ServeConfig.from_kwargs`` backs the deprecated Orchestrator
kwargs shim for one release.

This module is import-light (no torch) so spawned worker children can load
it cheaply.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from types import MappingProxyType
from typing import Any, Callable, Dict, Mapping, Optional

BACKENDS = ("threaded", "sync")
ISOLATIONS = ("thread", "process")
ROUTING_NAMES = ("round_robin", "least_loaded", "affinity")


def _valid_routing(routing: Any) -> bool:
    """A routing value is a known policy name or a policy-like object."""
    if isinstance(routing, str):
        return routing in ROUTING_NAMES
    return hasattr(routing, "select")


@dataclass(frozen=True)
class EngineSpec:
    """Picklable recipe for building a stage engine in another process.

    ``target`` is ``"pkg.module:callable"``; the callable is invoked with
    ``kwargs`` and must return a ready engine.  Builders must be
    deterministic (same kwargs → same params) so a process replica is
    byte-equivalent to the in-process engine built from the same spec.
    """
    target: str
    kwargs: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if ":" not in self.target:
            raise ValueError(
                f"EngineSpec target must be 'module:callable', "
                f"got {self.target!r}")
        object.__setattr__(self, "kwargs",
                           MappingProxyType(dict(self.kwargs)))

    def build(self) -> Any:
        mod_name, _, fn_name = self.target.partition(":")
        fn = getattr(importlib.import_module(mod_name), fn_name)
        return fn(**self.kwargs)

    def __reduce__(self):
        # MappingProxyType does not pickle; rebuild from a plain dict
        return (EngineSpec, (self.target, dict(self.kwargs)))


@dataclass(frozen=True)
class StageConfig:
    """Per-stage serving spec inside a :class:`ServeConfig`."""
    replicas: int = 1
    routing: Optional[Any] = None        # None = inherit ServeConfig.routing
    isolation: str = "thread"
    prefix_cache: Optional[bool] = None  # None = pipeline default
    engine_factory: Optional[Callable[[], Any]] = None
    engine_spec: Optional[EngineSpec] = None

    def __post_init__(self) -> None:
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.isolation not in ISOLATIONS:
            raise ValueError(f"isolation must be one of {ISOLATIONS}, "
                             f"got {self.isolation!r}")
        if self.routing is not None and not _valid_routing(self.routing):
            raise ValueError(f"unknown routing {self.routing!r} "
                             f"(have {ROUTING_NAMES})")
        if self.isolation == "process" and self.engine_spec is None:
            raise ValueError(
                "isolation='process' needs an engine_spec — a process "
                "replica rebuilds its engine from a picklable "
                "EngineSpec('module:callable', kwargs), not from an "
                "in-process factory closure")


@dataclass(frozen=True)
class ServeConfig:
    """Validated, immutable serving configuration."""
    backend: str = "threaded"
    queue_capacity: int = 64
    recv_timeout: float = 60.0
    routing: Any = "affinity"
    warm_seed: bool = True
    stages: Mapping[str, StageConfig] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1, "
                             f"got {self.queue_capacity}")
        if self.recv_timeout <= 0:
            raise ValueError("recv_timeout must be > 0, "
                             f"got {self.recv_timeout}")
        if not _valid_routing(self.routing):
            raise ValueError(f"unknown routing {self.routing!r} "
                             f"(have {ROUTING_NAMES})")
        stages = {}
        for name, sc in dict(self.stages).items():
            if not isinstance(sc, StageConfig):
                raise TypeError(f"stages[{name!r}] must be a StageConfig, "
                                f"got {type(sc).__name__}")
            stages[name] = sc
        object.__setattr__(self, "stages", MappingProxyType(stages))
        if self.backend == "sync":
            for name, sc in stages.items():
                if sc.replicas > 1:
                    raise ValueError(
                        f"sync (lock-step) backend is single-replica; "
                        f"stage {name!r} asks for {sc.replicas}")
                if sc.isolation != "thread":
                    raise ValueError(
                        f"sync backend cannot isolate stage {name!r} "
                        f"in a process")

    # -- accessors ---------------------------------------------------------
    def stage(self, name: str) -> StageConfig:
        """Per-stage config, defaulted for stages not explicitly listed."""
        return self.stages.get(name, StageConfig())

    def stage_routing(self, name: str) -> Any:
        sc = self.stage(name)
        return sc.routing if sc.routing is not None else self.routing

    def with_stage(self, name: str, **changes: Any) -> "ServeConfig":
        """A copy with one stage's config replaced/updated."""
        stages = dict(self.stages)
        stages[name] = replace(stages.get(name, StageConfig()), **changes)
        return replace(self, stages=stages)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_kwargs(cls, *, backend: str = "threaded",
                    queue_capacity: int = 64, recv_timeout: float = 60.0,
                    replicas: Optional[Dict[str, int]] = None,
                    routing: Any = "affinity",
                    engine_factories: Optional[Dict[str, Any]] = None,
                    engine_specs: Optional[Dict[str, EngineSpec]] = None,
                    isolation: Any = "thread",
                    warm_seed: bool = True) -> "ServeConfig":
        """Build from the legacy Orchestrator kwargs bag.  ``isolation``
        is either one mode for every stage or a per-stage dict."""
        stages: Dict[str, StageConfig] = {}
        names = set(replicas or ()) | set(engine_factories or ()) \
            | set(engine_specs or ())
        if isinstance(isolation, dict):
            names |= set(isolation)
        for name in sorted(names):
            iso = (isolation.get(name, "thread")
                   if isinstance(isolation, dict) else isolation)
            stages[name] = StageConfig(
                replicas=(replicas or {}).get(name, 1),
                isolation=iso,
                engine_factory=(engine_factories or {}).get(name),
                engine_spec=(engine_specs or {}).get(name))
        return cls(backend=backend, queue_capacity=queue_capacity,
                   recv_timeout=recv_timeout, routing=routing,
                   warm_seed=warm_seed, stages=stages)

    @classmethod
    def from_args(cls, args: Any,
                  engine_factories: Optional[Dict[str, Any]] = None,
                  engine_specs: Optional[Dict[str, EngineSpec]] = None
                  ) -> "ServeConfig":
        """The one argparse → config funnel (``launch/serve.py``).

        Consumes ``--backend``, ``--replicas STAGE=N[,..]``, ``--routing``,
        ``--isolation STAGE=MODE[,..]`` (or a bare MODE for every stage),
        ``--queue-capacity``, ``--recv-timeout`` and ``--no-warm-seed``
        from the parsed namespace; missing attributes fall back to the
        dataclass defaults so partial namespaces (tests) work.
        """
        replicas = _parse_stage_map(getattr(args, "replicas", None), int,
                                    "replicas")
        iso_arg = getattr(args, "isolation", None)
        if iso_arg and "=" not in iso_arg:
            isolation: Any = iso_arg                  # one mode for all
        else:
            isolation = _parse_stage_map(iso_arg, str, "isolation") or {}
        return cls.from_kwargs(
            backend=getattr(args, "backend", "threaded"),
            queue_capacity=getattr(args, "queue_capacity", 64),
            recv_timeout=getattr(args, "recv_timeout", 60.0),
            replicas=replicas,
            routing=getattr(args, "routing", "affinity"),
            engine_factories=engine_factories,
            engine_specs=engine_specs,
            isolation=isolation,
            warm_seed=getattr(args, "warm_seed", True))


def _parse_stage_map(text: Optional[str], cast: Callable[[str], Any],
                     what: str) -> Optional[Dict[str, Any]]:
    """Parse ``STAGE=V[,STAGE=V...]`` flag syntax into a dict."""
    if not text:
        return None
    out: Dict[str, Any] = {}
    for part in text.split(","):
        stage, _, v = part.partition("=")
        if not v:
            raise ValueError(f"--{what}: expected STAGE=VALUE, got {part!r}")
        out[stage.strip()] = cast(v.strip())
    return out
