"""Roofline arithmetic against the card's published figures.

A copy of the arithmetic of the reference package's `launch/roofline.py`:
the three-term `Roofline` (compute, memory, collective) and the per-phase
`PhaseRoofline` the engine's spans are judged by. The figures are the
card's (`launch/mesh.CARDS`), picked at run time from the name CUDA
reports (`card_of`), never the reference's TPU constants; an unknown card
raises.

The reference's exchange roof is the inter-chip link (ICI); here it is
the card's NVLink rate each way. On one card the K servers are virtual
and the exchange moves no bytes over any link, so `phase_roofline`
gives a one-card exchange the roof "none" and no fraction.

`from_cost` is the reference's `from_compiled`: the terms of a dry-run
step, from the per-device counts of `launch/cost_analysis.py`. The
reference's `from_compiled_xla`, which reads XLA's own cost analysis, has
no counterpart: the port compiles no XLA program.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from .mesh import CardFigures, card_figures


def card_of(device: str | torch.device | None = "cuda") -> CardFigures:
    """The published figures of the card `device` names (default the
    current card; raises without one, or for a card not in `CARDS`)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device {dev} is not a card: no roofline figures")
    return card_figures(torch.cuda.get_device_properties(dev).name)


@dataclasses.dataclass
class Roofline:
    """Three-term roofline of one step:

      compute    = flops / peak flop/s
      memory     = bytes / HBM bytes/s
      collective = collective bytes / link bytes/s

    all per device (`chips` devices share the work), at the card's figures
    (`card_of(dev)`: `bf16_flops` or `f32_flops`, `hbm_bw`, `link_bw`)."""

    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: dict[str, int]
    chips: int
    peak_flops: float
    hbm_bw: float
    link_bw: float

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """The least step time: the largest of the three terms (their
        overlap assumed perfect)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def compute_fraction(self, model_flops_per_device: float) -> float:
        """MODEL_FLOPS / (step_time * peak): the roofline fraction score."""
        if self.step_time == 0:
            return 0.0
        return model_flops_per_device / (self.step_time * self.peak_flops)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "coll_breakdown": {k: v for k, v in self.coll_breakdown.items() if v},
        }


def from_cost(cost, chips: int, card: CardFigures | None = None) -> Roofline:
    """The three terms of one device's `cost_analysis.StepCost` (the
    reference's `from_compiled`, which reads its HLO analysis) at `card`'s
    bf16 tensor-core rate, HBM rate and link rate (default: the current
    card, `card_of()`, which raises without one)."""
    fig = card_of() if card is None else card
    breakdown = {k: int(v) for k, v in cost.coll_breakdown.items()}
    return Roofline(cost.flops, cost.bytes_accessed, cost.collective_bytes,
                    breakdown, chips, fig.bf16_flops, fig.hbm_bw, fig.link_bw)


# Which roof each measured engine phase is judged against: the exchange is
# link traffic between cards (NVLink); every other phase streams device
# memory (HBM).
PHASE_ROOFS = {
    "map": "hbm", "encode": "hbm", "exchange": "nvlink",
    "decode": "hbm", "reduce": "hbm",
}


@dataclasses.dataclass(frozen=True)
class PhaseRoofline:
    """A measured phase (seconds + bytes moved) against its bandwidth roof.

    ``fraction`` is achieved bandwidth over the roof's. Roof "none" is an
    exchange on one card, where the virtual servers read each other's
    buffers in place and nothing crosses a link: it has no roof
    bandwidth, a zero roof time and no fraction (None).
    """

    phase: str
    seconds: float
    bytes_moved: float
    roof: str                    # "hbm" | "nvlink" | "none"
    hbm_bw: float
    link_bw: float
    chips: int = 1

    @property
    def roof_bw(self) -> float | None:
        if self.roof == "none":
            return None
        bw = self.hbm_bw if self.roof == "hbm" else self.link_bw
        return bw * self.chips

    @property
    def achieved_bw(self) -> float:
        return self.bytes_moved / self.seconds if self.seconds > 0 else 0.0

    @property
    def roof_seconds(self) -> float:
        bw = self.roof_bw
        return 0.0 if bw is None else self.bytes_moved / bw

    @property
    def fraction(self) -> float | None:
        """Achieved / roof bandwidth (the %-of-roofline figure); None where
        the phase has no roof."""
        bw = self.roof_bw
        return None if bw is None else self.achieved_bw / bw

    def as_dict(self) -> dict:
        return {"phase": self.phase, "seconds": self.seconds,
                "bytes_moved": self.bytes_moved, "roof": self.roof,
                "achieved_bw": self.achieved_bw,
                "roofline_fraction": self.fraction}


def phase_roofline(phase: str, seconds: float, bytes_moved: float, *,
                   chips: int = 1, figures: CardFigures | None = None,
                   device: str | torch.device | None = "cuda"
                   ) -> PhaseRoofline:
    """Judge one measured phase against its roof (see `PHASE_ROOFS`) at
    `figures` (default: the card `device` names, which raises without
    one). The exchange of a one-card run gets the roof "none"."""
    short = phase.split(".")[-1]
    if short not in PHASE_ROOFS:
        raise ValueError(
            f"unknown phase {phase!r}; known: {sorted(PHASE_ROOFS)}")
    fig = card_of(device) if figures is None else figures
    roof = PHASE_ROOFS[short]
    if roof == "nvlink" and chips == 1:
        roof = "none"
    return PhaseRoofline(short, seconds, bytes_moved, roof, fig.hbm_bw,
                         fig.link_bw, chips=chips)
