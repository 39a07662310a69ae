from .pipeline import (DataConfig, SyntheticImageDataset, SyntheticLMDataset,
                       prefetch)

__all__ = ["DataConfig", "SyntheticLMDataset", "SyntheticImageDataset",
           "prefetch"]
