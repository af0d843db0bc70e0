"""sRFCI orientation (R1-R10), the simulation drivers and sDAVS effect
estimation (`cigwas_tpu.pag`): host numpy and scipy only."""

from cigwas_tpu_torch.pag.rfci import (
    estimate_pag,
    udag2apag,
    rule_functions,
)

__all__ = ["estimate_pag", "udag2apag", "rule_functions"]
