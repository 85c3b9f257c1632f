from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, decay_mask,
                                     global_norm)
from repro_torch.optim.schedule import cosine_decay, linear_warmup_linear_decay

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "decay_mask", "global_norm", "linear_warmup_linear_decay",
           "cosine_decay"]
