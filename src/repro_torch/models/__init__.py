from repro_torch.models.convert import (load_jax_checkpoint, opt_state_from_jax,
                                       opt_state_to_numpy, params_from_jax, params_to_jax,
                                       prompt_from_arrays)
from repro_torch.models.transformer import Model

__all__ = ["Model", "load_jax_checkpoint", "opt_state_from_jax", "opt_state_to_numpy",
           "params_from_jax", "params_to_jax", "prompt_from_arrays"]
