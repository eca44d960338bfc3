"""AdamW and Adafactor on the port's parameters, with state in the JAX
package's stacked layout, and int8 gradient compression with error
feedback for the cross-pod reduction."""

from .grad_compress import (compressed_psum, make_compressed_crosspod_reduce,
                            quantize_roundtrip)
from .optimizer import (OptimizerConfig, adafactor_init, adafactor_update,
                        adamw_init, adamw_update, clip_by_global_norm,
                        global_norm, lr_schedule, make_optimizer)

__all__ = ["OptimizerConfig", "adafactor_init", "adafactor_update",
           "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "lr_schedule", "make_optimizer",
           "compressed_psum", "make_compressed_crosspod_reduce",
           "quantize_roundtrip"]
