"""Model families ported so far."""

from collocfem_tpu_torch.models.vdp import VanDerPol

__all__ = ["VanDerPol"]
