from repro_torch.models.convert import load_jax_checkpoint, params_from_jax
from repro_torch.models.transformer import Model

__all__ = ["Model", "load_jax_checkpoint", "params_from_jax"]
