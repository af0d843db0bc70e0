from cigwas_tpu_torch.pipelines.cusk import CuskContext, cusk, make_blocks
from cigwas_tpu_torch.pipelines.cuskss import CuskssArgs, cuskss

__all__ = ["CuskContext", "CuskssArgs", "cusk", "cuskss", "make_blocks"]
