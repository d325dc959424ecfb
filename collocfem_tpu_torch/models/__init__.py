"""Model families ported so far."""

from collocfem_tpu_torch.models.aircraft import AircraftLongitudinal
from collocfem_tpu_torch.models.duffing import Duffing
from collocfem_tpu_torch.models.lti import LinearSystem
from collocfem_tpu_torch.models.pendulum import Pendulum
from collocfem_tpu_torch.models.vdp import VanDerPol

__all__ = ["AircraftLongitudinal", "Duffing", "LinearSystem", "Pendulum",
           "VanDerPol"]
