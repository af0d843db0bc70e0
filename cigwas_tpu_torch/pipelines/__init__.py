from cigwas_tpu_torch.pipelines.cusk import CuskContext, cusk
from cigwas_tpu_torch.pipelines.cuskss import CuskssArgs, cuskss

__all__ = ["CuskContext", "CuskssArgs", "cusk", "cuskss"]
