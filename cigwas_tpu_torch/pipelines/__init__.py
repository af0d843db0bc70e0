from cigwas_tpu_torch.pipelines.cusk import CuskContext, cusk

__all__ = ["CuskContext", "cusk"]
