"""AdamW and Adafactor on the port's parameters, with state in the JAX
package's stacked layout.  Gradient compression waits for the
multi-card slice."""

from .optimizer import (OptimizerConfig, adafactor_init, adafactor_update,
                        adamw_init, adamw_update, clip_by_global_norm,
                        global_norm, lr_schedule, make_optimizer)

__all__ = ["OptimizerConfig", "adafactor_init", "adafactor_update",
           "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "lr_schedule", "make_optimizer"]
