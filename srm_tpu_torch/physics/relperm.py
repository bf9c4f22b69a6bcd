"""Corey relative-permeability curves (gas/oil SCAL).

Port of ``srm_tpu/physics/relperm.py``: the forward curves with endpoint
scaling and clamps. The dry-gas path uses only ``krgo(Sgi)``; the
gas-condensate path differentiates the curves through a saturation field, so
every bound is JAX's ``maximum``/``minimum`` form (at a tie the gradient
splits 0.5/0.5, where ``torch.clamp`` would pass all of it). The inverse (Sg
from a krg/kro ratio by bisection) is not on a ported path yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

_DEFAULT_END_POINTS = {
    "kro_Somax": 0.90, "krg_Sorg": 0.80, "krg_Swmin": 0.90,
    "Swmin": 0.22, "Sorg": 0.2, "Sgc": 0.05, "Socr": 0.2, "So_max": 0.28,
}
_DEFAULT_COREY = {"nog": 3.0, "ng": 6.0, "nw": 2.0}


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip`` with JAX's gradient at the bounds."""
    lo = lo if isinstance(lo, torch.Tensor) else x.new_full((), lo)
    hi = hi if isinstance(hi, torch.Tensor) else x.new_full((), hi)
    return torch.minimum(torch.maximum(x, lo), hi)


@dataclass(frozen=True)
class RelativePermeability:
    """Corey SCAL parameter bundle."""

    kro_somax: float = _DEFAULT_END_POINTS["kro_Somax"]
    krg_sorg: float = _DEFAULT_END_POINTS["krg_Sorg"]
    krg_swmin: float = _DEFAULT_END_POINTS["krg_Swmin"]
    swmin: float = _DEFAULT_END_POINTS["Swmin"]
    sorg: float = _DEFAULT_END_POINTS["Sorg"]
    sgc: float = _DEFAULT_END_POINTS["Sgc"]
    socr: float = _DEFAULT_END_POINTS["Socr"]
    so_max_frac: float = _DEFAULT_END_POINTS["So_max"]
    nog: float = _DEFAULT_COREY["nog"]
    ng: float = _DEFAULT_COREY["ng"]
    nw: float = _DEFAULT_COREY["nw"]

    @classmethod
    def from_config(cls, end_points: Optional[Dict] = None,
                    corey_exponents: Optional[Dict] = None) -> "RelativePermeability":
        ep = {**_DEFAULT_END_POINTS, **(end_points or {})}
        ce = {**_DEFAULT_COREY, **(corey_exponents or {})}
        return cls(kro_somax=ep["kro_Somax"], krg_sorg=ep["krg_Sorg"],
                   krg_swmin=ep["krg_Swmin"], swmin=ep["Swmin"], sorg=ep["Sorg"],
                   sgc=ep["Sgc"], socr=ep["Socr"], so_max_frac=ep["So_max"],
                   nog=ce["nog"], ng=ce["ng"], nw=ce["nw"])

    @property
    def sg_max(self) -> float:
        return 1.0 - self.swmin

    def compute_krog_krgo(self, sg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(krog, krgo) Corey curves (srm_tpu/physics/relperm.py:66-80)."""
        so = 1.0 - sg - self.swmin
        denom = 1.0 - self.swmin - self.sorg
        zero = sg.new_zeros(())
        krog = self.kro_somax * torch.pow(torch.maximum((so - self.sorg) / denom, zero), self.nog)
        krgo = self.krg_sorg * torch.pow(
            torch.maximum((sg - self.sgc) / (1.0 - self.sgc - self.swmin - self.sorg), zero),
            self.ng)
        sorg_eff = max(self.sorg, self.socr)
        krog = torch.where(so <= (self.swmin + sorg_eff), torch.zeros_like(krog), krog)
        krgo = torch.where(sg > (1.0 - (self.swmin + self.sorg)),
                           torch.full_like(krgo, self.krg_swmin), krgo)
        krog = clip(krog, 0.0, self.kro_somax)
        krgo = clip(krgo, 0.0, self.krg_swmin)
        return krog, krgo

    def __call__(self, sg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.compute_krog_krgo(sg)
