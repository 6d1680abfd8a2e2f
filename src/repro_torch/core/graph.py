"""Stage graph (paper §3.2): nodes are stages, edges are transfer functions.

The graph is a DAG; sources (in-degree 0) receive the request's initial
inputs, ``is_output`` stages contribute to the request's final outputs.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.stage import StageEdge, StageSpec


class StageGraph:
    def __init__(self) -> None:
        self.stages: Dict[str, StageSpec] = {}
        self.edges: List[StageEdge] = []

    def add_stage(self, spec: StageSpec) -> "StageGraph":
        if spec.name in self.stages:
            raise ValueError(f"duplicate stage {spec.name!r}")
        self.stages[spec.name] = spec
        return self

    def add_edge(self, src: str, dst: str, transfer, *, streaming: bool = False,
                 connector: str = "inline") -> "StageGraph":
        for s in (src, dst):
            if s not in self.stages:
                raise ValueError(f"unknown stage {s!r}")
        self.edges.append(StageEdge(src, dst, transfer, streaming=streaming,
                                    connector=connector))
        return self

    # ---- topology ------------------------------------------------------

    def out_edges(self, name: str) -> List[StageEdge]:
        return [e for e in self.edges if e.src == name]

    def in_edges(self, name: str) -> List[StageEdge]:
        return [e for e in self.edges if e.dst == name]

    def in_degree(self, name: str) -> int:
        return sum(1 for e in self.edges if e.dst == name)

    @staticmethod
    def edge_id(edge: StageEdge) -> str:
        """Canonical edge name used for connector keys and metrics."""
        return f"{edge.src}->{edge.dst}"

    def sources(self) -> List[str]:
        return [n for n in self.stages if self.in_degree(n) == 0]

    def output_stages(self) -> List[str]:
        outs = [n for n, s in self.stages.items() if s.is_output]
        if outs:
            return outs
        # default: sinks
        return [n for n in self.stages if not self.out_edges(n)]

    def topo_order(self) -> List[str]:
        indeg = {n: self.in_degree(n) for n in self.stages}
        order, frontier = [], [n for n, d in indeg.items() if d == 0]
        while frontier:
            n = frontier.pop()
            order.append(n)
            for e in self.out_edges(n):
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    frontier.append(e.dst)
        if len(order) != len(self.stages):
            raise ValueError("stage graph has a cycle")
        return order

    def validate(self) -> None:
        self.topo_order()
        if not self.sources():
            raise ValueError("stage graph has no source stage")
