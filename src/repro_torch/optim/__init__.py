from .adamw import (AdamWState, adamw_init, adamw_update, adamw_update_,
                    clip_by_global_norm)
from .compress import (compress_gradients, decompress_gradients,
                       error_feedback_update)
from .schedule import cosine_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "adamw_update_",
           "clip_by_global_norm", "compress_gradients",
           "decompress_gradients", "error_feedback_update",
           "cosine_schedule"]
