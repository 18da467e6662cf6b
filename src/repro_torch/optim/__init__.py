from repro_torch.optim.optimizer import AdamWConfig, adamw_init, adamw_update, decay_mask
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "constant",
           "decay_mask", "warmup_cosine"]
